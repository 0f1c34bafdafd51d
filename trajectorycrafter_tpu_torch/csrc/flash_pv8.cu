// PV-int8 attention for Hopper (sm_90a): bf16 q k^T, int8 probability x value.
//
// Replaces the TPU kernel trajectorycrafter_tpu/ops/pallas/flash_pv8.py
// `flash_attention_exp2_t_pv8` (body `_kernel`), which the JAX DiT runs for
// its joint self-attention (d 64) and its Perceiver (d 128) under
// `attention_impl="flash_pv8"`, and the depth UNet under
// TRAJCRAFTER_DEPTH_ATTN=flash_pv8.  It computes the TPU kernel's function,
// block by block of `block_k` keys counted from key 0 (the last block holds
// the valid keys only):
//
//   q'    = bf16(q * scale * log2 e)
//   s     = min(q' . k in fp32, 88)
//   m_adj = max(max over the block of s - log2 127, -88)
//   p8    = rint(exp2(s - m_adj))               in [0, 127]
//   acc  += float(sum p8 * v8, int32) * exp2(m_adj)
//   den  += float(127 * sum p8, int32) * exp2(m_adj)
//   out   = acc / max(den, 1e-30) * (127 * vs)
//
// with v8 = V quantized per (batch, head) outside the kernel (scale vs).  The
// TPU kernel carries the denominator as a 127-valued ones channel of V
// through its int8 matrix unit; here it is the exact int32 row sum of the
// codes.  Every fp32 operation of the block update is rounded on its own
// (no fused multiply-add), in the plain version's order.
//
// The block max must be known before any p of the block is quantized, and a
// block of 1,024 keys x 16 rows of scores does not fit in a warp's registers.
// So each block makes two passes over its 64-key tiles: the first computes
// the scores and their row max, the second computes them again with the same
// inlined code (bit-equal, so s - m_adj <= log2 127 holds exactly),
// quantizes them and runs the int8 PV product (int8_attention.cuh).  The
// price is a third matrix product (two bf16 QK, one int8 PV).
//
// What bounds it on the H100: at the DiT shape (2 x 48 x 13,330 x 64) it does
// 2 x 2.2 TFLOP of bf16 products and 2.2 T int8 operations against ~0.3 GB,
// so tensor-core throughput and the per-score exp2, not device memory.
// Tiles: one block per (batch * head, 64-query tile), four warps of 16 rows, 64-key K and V tiles staged in shared memory, the
// scores kept in registers.  `wgmma`/TMA are left for a later change.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_pv8.so flash_pv8.cu
// (trajectorycrafter_tpu_torch/ops/kernels.py does this at first use).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "int8_attention.cuh"

namespace {

using int8_attn::kKeyTile;
using int8_attn::kVtStride;
using tc_attn::load_u32;
using tc_attn::mma_bf16_16816;
using tc_attn::pack_bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockM = 16 * kWarps;  // query rows per block
constexpr int kPad = 8;               // shared row padding (bf16): conflict-free fragments
constexpr float kMasked = -1e30f;     // score of a key past the end
constexpr float kClamp = 88.f;        // exp2 argument cap: 2^88 x int32 sums < fp32 max
constexpr float kLog2_127 = 6.988684686772166f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const int8_t* vt;    // (batch * heads, D, vt_ld) int8, keys padded with zeros
  const float* vs;     // (batch * heads,) V scales
  __nv_bfloat16* o;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long o_sb, o_ss, o_sh;
  long long vt_ld;     // keys per V^T row (a multiple of 64)
  int heads;
  int sq;
  int skv;
  int block_k;         // keys per quantization block (a multiple of 64)
  float scale_log2;
};

// Two q values times scale_log2, rounded to a bf16 pair.
__device__ __forceinline__ uint32_t scaled_pair(const __nv_bfloat16* p, float s) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return pack_bf16(f.x * s, f.y * s);
}

// Scores of the warp's 16 rows against the staged 64-key tile at n0:
// clamped at 88, keys past the end masked.  Both passes call this.
template <int D>
__device__ __forceinline__ void score_tile(const Params& p, const uint32_t (&q_frag)[D / 16][4],
                                           const __nv_bfloat16* k_s, int n0,
                                           float (&s)[kKeyTile / 8][4]) {
  constexpr int kStride = D + kPad;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < kKeyTile / 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const __nv_bfloat16* k_row = &k_s[(j * 8 + g) * kStride + 2 * t];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      mma_bf16_16816(s[j], q_frag[kk], load_u32(k_row + kk * 16), load_u32(k_row + kk * 16 + 8));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = n0 + j * 8 + 2 * t + (e & 1);
      s[j][e] = key < p.skv ? fminf(s[j][e], kClamp) : kMasked;
    }
  }
}

template <int D>
__device__ __forceinline__ void stage_k(const __nv_bfloat16* k, long long ld, int n0, int skv,
                                        __nv_bfloat16* k_s) {
  constexpr int kStride = D + kPad;
  constexpr int kVecPerRow = D / 8;
  for (int idx = threadIdx.x; idx < kKeyTile * kVecPerRow; idx += kThreads) {
    const int r = idx / kVecPerRow;
    const int c = (idx % kVecPerRow) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (n0 + r < skv) x = *reinterpret_cast<const uint4*>(k + (n0 + r) * ld + c);
    *reinterpret_cast<uint4*>(&k_s[r * kStride + c]) = x;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_pv8_kernel(const Params p) {
  constexpr int kStride = D + kPad;
  __shared__ __align__(16) __nv_bfloat16 k_s[kKeyTile * kStride];
  __shared__ __align__(16) uint8_t v_s[D * kVtStride];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const int row0 = blockIdx.x * kBlockM + warp * 16 + g;
  const int row1 = row0 + 8;
  const __nv_bfloat16* q = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = p.k + b * p.k_sb + h * p.k_sh;
  const int8_t* vt = p.vt + static_cast<long long>(bh) * D * p.vt_ld;

  uint32_t q_frag[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    q_frag[kk][0] = row0 < p.sq ? scaled_pair(q + row0 * p.q_ss + c, p.scale_log2) : 0u;
    q_frag[kk][1] = row1 < p.sq ? scaled_pair(q + row1 * p.q_ss + c, p.scale_log2) : 0u;
    q_frag[kk][2] = row0 < p.sq ? scaled_pair(q + row0 * p.q_ss + c + 8, p.scale_log2) : 0u;
    q_frag[kk][3] = row1 < p.sq ? scaled_pair(q + row1 * p.q_ss + c + 8, p.scale_log2) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float den[2] = {0.f, 0.f};

  for (int kb = 0; kb < p.skv; kb += p.block_k) {
    const int kb_end = min(kb + p.block_k, p.skv);

    // pass 1: the block's row max
    float m[2] = {kMasked, kMasked};
    for (int n0 = kb; n0 < kb_end; n0 += kKeyTile) {
      __syncthreads();
      stage_k<D>(k, p.k_ss, n0, p.skv, k_s);
      __syncthreads();
      float s[kKeyTile / 8][4];
      score_tile<D>(p, q_frag, k_s, n0, s);
#pragma unroll
      for (int j = 0; j < kKeyTile / 8; ++j) {
        m[0] = fmaxf(m[0], fmaxf(s[j][0], s[j][1]));
        m[1] = fmaxf(m[1], fmaxf(s[j][2], s[j][3]));
      }
    }
    float m_adj[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_adj[r] = fmaxf(__fsub_rn(int8_attn::quad_max(m[r]), kLog2_127), -kClamp);
    }

    // pass 2: the same scores, quantized, times v8
    int acc_i[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc_i[j][0] = acc_i[j][1] = acc_i[j][2] = acc_i[j][3] = 0;
    int psum[2] = {0, 0};
    for (int n0 = kb; n0 < kb_end; n0 += kKeyTile) {
      __syncthreads();
      stage_k<D>(k, p.k_ss, n0, p.skv, k_s);
      int8_attn::stage_vt<D, kThreads>(vt, p.vt_ld, n0, v_s);
      __syncthreads();
      float s[kKeyTile / 8][4];
      score_tile<D>(p, q_frag, k_s, n0, s);
      int p8[kKeyTile / 8][4];
#pragma unroll
      for (int j = 0; j < kKeyTile / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p8[j][e] = static_cast<int>(rintf(exp2f(__fsub_rn(s[j][e], m_adj[e >> 1]))));
          psum[e >> 1] += p8[j][e];
        }
      }
      int8_attn::pv_tile<D>(p8, v_s, acc_i);
    }

    // fold the block in: acc += float(int32) * exp2(m_adj), the same for den
    float w[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      w[r] = exp2f(m_adj[r]);
      const int codes = int8_attn::quad_sum(psum[r]);
      den[r] = __fadd_rn(den[r], __fmul_rn(__int2float_rn(127 * codes), w[r]));
    }
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[jd][e] = __fadd_rn(acc[jd][e], __fmul_rn(__int2float_rn(acc_i[jd][e]), w[e >> 1]));
      }
    }
  }

  const float out_scale = __fmul_rn(127.f, p.vs[bh]);
  const float d0 = fmaxf(den[0], 1e-30f), d1 = fmaxf(den[1], 1e-30f);
  __nv_bfloat16* o = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd) {
    const int c = jd * 8 + 2 * t;
    if (row0 < p.sq) {
      *reinterpret_cast<uint32_t*>(o + row0 * p.o_ss + c) =
          pack_bf16(__fmul_rn(__fdiv_rn(acc[jd][0], d0), out_scale),
                    __fmul_rn(__fdiv_rn(acc[jd][1], d0), out_scale));
    }
    if (row1 < p.sq) {
      *reinterpret_cast<uint32_t*>(o + row1 * p.o_ss + c) =
          pack_bf16(__fmul_rn(__fdiv_rn(acc[jd][2], d1), out_scale),
                    __fmul_rn(__fdiv_rn(acc[jd][3], d1), out_scale));
    }
  }
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream` of `device` and returns
// the cudaError_t of the launch (0 = success); it does not synchronise.
// `scale_log2` is the softmax scale times log2(e), rounded once to fp32 by the
// caller, as the plain version rounds it.
extern "C" int flash_pv8_fwd(int device, const void* q, const void* k, const void* vt,
                             const void* vs, void* o, int batch, int heads, int sq, int skv,
                             int head_dim, int block_k, long long q_sb, long long q_ss,
                             long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                             long long vt_ld, long long o_sb, long long o_ss, long long o_sh,
                             float scale_log2, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.vt = static_cast<const int8_t*>(vt);
  p.vs = static_cast<const float*>(vs);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.vt_ld = vt_ld;
  p.heads = heads;
  p.sq = sq;
  p.skv = skv;
  p.block_k = block_k;
  p.scale_log2 = scale_log2;

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (block_k <= 0 || block_k % kKeyTile) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((sq + kBlockM - 1) / kBlockM, batch * heads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    flash_pv8_kernel<64><<<grid, kThreads, 0, s>>>(p);
  } else if (head_dim == 128) {
    flash_pv8_kernel<128><<<grid, kThreads, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_pv8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
