// int8 flash attention for Hopper (sm_90a): int8 q k^T and int8 p v.
//
// Replaces the TPU kernel
// trajectorycrafter_tpu/ops/pallas/int8_flash_attention.py
// `int8_flash_attention` (body `_kernel`).  q, k and v are quantized per
// (batch, head) outside the kernel, symmetric int8 with scales qs, ks, vs;
// the kernel computes the TPU kernel's online softmax, key block by key block
// of `block_k` keys counted from key 0 (the last block holds the valid keys
// only):
//
//   s     = float(sum q8 * k8, int32) * (qs * ks * scale)
//   m_new = max(m, max over the block of s);  alpha = exp(m - m_new)
//   p     = exp(s - m_new);  p8 = rint(p * 127)
//   acc   = acc * alpha + float(sum p8 * v8, int32) * (vs / 127)
//   l     = l * alpha + sum p                (the fp32 p, not p8)
//   out   = acc / max(l, 1e-20)
//
// The int32 q k^T is exact, so the scores, and with the accurate `expf` the
// weights, are the plain version's; every fp32 operation of the block update
// is rounded on its own (no fused multiply-add), in the plain version's
// order.  The block max must be known before any p of the block is
// quantized, so each block makes two passes over its 64-key tiles (the
// second recomputes the exact int32 scores), as flash_pv8.cu does; the int8
// p v product is int8_attention.cuh's.
//
// What bounds it on the H100: at the DiT shape (2 x 48 x 13,330 x 64) it does
// 3 x 2.2 T int8 operations against ~0.3 GB of bf16 q/k/v (read by the
// quantization pass) and ~0.1 GB of int8 codes, so tensor-core throughput and
// the per-score exp, not device memory.  One block per (batch * head,
// 64-query tile), four warps of 16 rows; q8 stays in registers, the K8 and
// V8^T tiles are staged in shared memory.  `wgmma`/TMA are left for later.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libint8_flash_attention.so int8_flash_attention.cu
// (trajectorycrafter_tpu_torch/ops/kernels.py does this at first use).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "int8_attention.cuh"

namespace {

using int8_attn::kKeyTile;
using int8_attn::kVtStride;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockM = 16 * kWarps;  // query rows per block
constexpr float kMasked = -1e30f;     // score of a key past the end

struct Params {
  const int8_t* q;       // (B, Sq, H, D) int8, by strides
  const int8_t* k;       // (B, Skv, H, D) int8, by strides
  const int8_t* vt;      // (batch * heads, D, vt_ld) int8, keys padded with zeros
  const float* logit;    // (batch * heads,) qs * ks * scale
  const float* v127;     // (batch * heads,) vs / 127
  __nv_bfloat16* o;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long o_sb, o_ss, o_sh;
  long long vt_ld;
  int heads;
  int sq;
  int skv;
  int block_k;
};

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage keys [n0, n0 + 64) of k8 as rows of D bytes plus 16 of padding: a
// row stride of D + 16 bytes (20 or 36 words) keeps the fragment loads free
// of bank conflicts.  Rows past the end are zero.
template <int D>
__device__ __forceinline__ void stage_k(const int8_t* k, long long ld, int n0, int skv,
                                        uint8_t* k_s) {
  constexpr int kVecPerRow = D / 16;
  for (int idx = threadIdx.x; idx < kKeyTile * kVecPerRow; idx += kThreads) {
    const int r = idx / kVecPerRow;
    const int c = (idx % kVecPerRow) * 16;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (n0 + r < skv) x = *reinterpret_cast<const uint4*>(k + (n0 + r) * ld + c);
    *reinterpret_cast<uint4*>(k_s + r * (D + 16) + c) = x;
  }
}

// s = float(q8 k8^T) * logit for the warp's 16 rows x the staged 64 keys;
// keys past the end masked.  Both passes call this.
template <int D>
__device__ __forceinline__ void score_tile(const uint32_t (&q_frag)[D / 32][4],
                                           const uint8_t* k_s, int n0, int skv, float logit,
                                           float (&s)[kKeyTile / 8][4]) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < kKeyTile / 8; ++j) {
    int acc[4] = {0, 0, 0, 0};
    const uint8_t* k_row = k_s + (j * 8 + g) * (D + 16) + 4 * t;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      int8_gemm::mma_s8_16832(acc, q_frag[kk], int8_gemm::lds32(k_row + 32 * kk),
                              int8_gemm::lds32(k_row + 32 * kk + 16));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = n0 + j * 8 + 2 * t + (e & 1);
      s[j][e] = key < skv ? __fmul_rn(__int2float_rn(acc[e]), logit) : kMasked;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) int8_flash_attention_kernel(const Params p) {
  __shared__ __align__(16) uint8_t k_s[kKeyTile * (D + 16)];
  __shared__ __align__(16) uint8_t v_s[D * kVtStride];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const int row0 = blockIdx.x * kBlockM + warp * 16 + g;
  const int row1 = row0 + 8;
  const int8_t* q = p.q + b * p.q_sb + h * p.q_sh;
  const int8_t* k = p.k + b * p.k_sb + h * p.k_sh;
  const int8_t* vt = p.vt + static_cast<long long>(bh) * D * p.vt_ld;
  const float logit = p.logit[bh];
  const float v127 = p.v127[bh];

  // the warp's 16 x D slice of q8 as m16n8k32 A fragments; rows past the end zero
  uint32_t q_frag[D / 32][4];
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {
    const int c = 32 * kk + 4 * t;
    q_frag[kk][0] = row0 < p.sq ? ld32(q + row0 * p.q_ss + c) : 0u;
    q_frag[kk][1] = row1 < p.sq ? ld32(q + row1 * p.q_ss + c) : 0u;
    q_frag[kk][2] = row0 < p.sq ? ld32(q + row0 * p.q_ss + c + 16) : 0u;
    q_frag[kk][3] = row1 < p.sq ? ld32(q + row1 * p.q_ss + c + 16) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {kMasked, kMasked};
  float l_run[2] = {0.f, 0.f};

  for (int kb = 0; kb < p.skv; kb += p.block_k) {
    const int kb_end = min(kb + p.block_k, p.skv);

    // pass 1: the block's row max
    float bm[2] = {kMasked, kMasked};
    for (int n0 = kb; n0 < kb_end; n0 += kKeyTile) {
      __syncthreads();
      stage_k<D>(k, p.k_ss, n0, p.skv, k_s);
      __syncthreads();
      float s[kKeyTile / 8][4];
      score_tile<D>(q_frag, k_s, n0, p.skv, logit, s);
#pragma unroll
      for (int j = 0; j < kKeyTile / 8; ++j) {
        bm[0] = fmaxf(bm[0], fmaxf(s[j][0], s[j][1]));
        bm[1] = fmaxf(bm[1], fmaxf(s[j][2], s[j][3]));
      }
    }
    float m_new[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_run[r], int8_attn::quad_max(bm[r]));
      alpha[r] = expf(__fsub_rn(m_run[r], m_new[r]));
    }

    // pass 2: p = exp(s - m_new), its codes times v8, and its fp32 row sum
    int acc_i[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc_i[j][0] = acc_i[j][1] = acc_i[j][2] = acc_i[j][3] = 0;
    float psum[2] = {0.f, 0.f};
    for (int n0 = kb; n0 < kb_end; n0 += kKeyTile) {
      __syncthreads();
      stage_k<D>(k, p.k_ss, n0, p.skv, k_s);
      int8_attn::stage_vt<D, kThreads>(vt, p.vt_ld, n0, v_s);
      __syncthreads();
      float s[kKeyTile / 8][4];
      score_tile<D>(q_frag, k_s, n0, p.skv, logit, s);
      int p8[kKeyTile / 8][4];
#pragma unroll
      for (int j = 0; j < kKeyTile / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = expf(__fsub_rn(s[j][e], m_new[e >> 1]));
          psum[e >> 1] = __fadd_rn(psum[e >> 1], pe);
          p8[j][e] = static_cast<int>(rintf(__fmul_rn(pe, 127.f)));
        }
      }
      int8_attn::pv_tile<D>(p8, v_s, acc_i);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] = __fadd_rn(__fmul_rn(l_run[r], alpha[r]), int8_attn::quad_sum(psum[r]));
      m_run[r] = m_new[r];
    }
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[jd][e] = __fadd_rn(__fmul_rn(acc[jd][e], alpha[e >> 1]),
                               __fmul_rn(__int2float_rn(acc_i[jd][e]), v127));
      }
    }
  }

  const float l0 = fmaxf(l_run[0], 1e-20f), l1 = fmaxf(l_run[1], 1e-20f);
  __nv_bfloat16* o = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd) {
    const int c = jd * 8 + 2 * t;
    if (row0 < p.sq) {
      *reinterpret_cast<__nv_bfloat162*>(o + row0 * p.o_ss + c) =
          __floats2bfloat162_rn(__fdiv_rn(acc[jd][0], l0), __fdiv_rn(acc[jd][1], l0));
    }
    if (row1 < p.sq) {
      *reinterpret_cast<__nv_bfloat162*>(o + row1 * p.o_ss + c) =
          __floats2bfloat162_rn(__fdiv_rn(acc[jd][2], l1), __fdiv_rn(acc[jd][3], l1));
    }
  }
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream` of `device` and returns
// the cudaError_t of the launch (0 = success); it does not synchronise.
extern "C" int int8_flash_attention_fwd(int device, const void* q, const void* k, const void* vt,
                                        const void* logit, const void* v127, void* o, int batch,
                                        int heads, int sq, int skv, int head_dim, int block_k,
                                        long long q_sb, long long q_ss, long long q_sh,
                                        long long k_sb, long long k_ss, long long k_sh,
                                        long long vt_ld, long long o_sb, long long o_ss,
                                        long long o_sh, void* stream) {
  Params p;
  p.q = static_cast<const int8_t*>(q);
  p.k = static_cast<const int8_t*>(k);
  p.vt = static_cast<const int8_t*>(vt);
  p.logit = static_cast<const float*>(logit);
  p.v127 = static_cast<const float*>(v127);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.vt_ld = vt_ld;
  p.heads = heads;
  p.sq = sq;
  p.skv = skv;
  p.block_k = block_k;

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (block_k <= 0 || block_k % kKeyTile) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((sq + kBlockM - 1) / kBlockM, batch * heads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    int8_flash_attention_kernel<64><<<grid, kThreads, 0, s>>>(p);
  } else if (head_dim == 128) {
    int8_flash_attention_kernel<128><<<grid, kThreads, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
