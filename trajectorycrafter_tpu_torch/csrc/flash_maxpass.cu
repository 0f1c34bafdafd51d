// Two-pass softmax attention with the exact row max, for Hopper (sm_90a).
//
// Replaces the TPU kernel trajectorycrafter_tpu/ops/pallas/flash_max.py
// `flash_attention_maxpass` (bodies `_max_kernel` and `_attn_kernel`), the
// DepthCrafter UNet's opt-in spatial self-attention
// (TRAJCRAFTER_DEPTH_ATTN=flash_max): exact attention for unbounded scores,
// with the softmax's per-row constant taken from a first pass instead of a
// running max.
//
//   pass 1: m[row] = max over keys of (q * scale * log2 e) . k
//   pass 2: out[row] = sum_j exp2(s_j - m[row]) v_j / sum_j exp2(s_j - m[row])
//
// As in the TPU kernel, q is multiplied by scale * log2(e) in fp32 and
// rounded to bf16 before the product, keys past the end score -1e30 in both
// passes, the row sum adds the bf16-rounded weights that multiply v, and the
// denominator is floored at 1e-30.  Both passes compute the scores with the
// same code (`score_tile`: the same q fragments, the same `mma.sync` order),
// so pass 2's scores equal pass 1's bit for bit and every exp2 argument is
// <= 0: no rescaling of the accumulator is needed.  The TPU kernel's
// transposed (B, H, D, S) output fills its MXU's 128 lanes; here q, k, v and
// the output are (B, S, H, D), read and written by strides.
//
// What bounds it on the H100: at the depth shape (49 frames x 5 heads x
// 9,216 tokens x 64) pass 2 does ~5.3 TFLOP and pass 1 another ~2.7 against
// ~0.2 GB of q/k/v, so it is bound by tensor-core throughput, as K1 is; the
// extra product of pass 1 is the price of dropping the running-max rescale.
// Tiles as in flash_attention.cu: one block per (batch * head, 64-query
// tile), four warps of 16 rows, 64-key tiles staged in shared memory, the
// scores kept in `mma.sync` accumulator registers and reused as the A
// operand of the P V product.  `wgmma`/TMA are left for a later change.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_maxpass.so flash_maxpass.cu
// (trajectorycrafter_tpu_torch/ops/kernels.py does this at first use).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

using tc_attn::load_u32;
using tc_attn::mma_bf16_16816;
using tc_attn::pack_bf16;

constexpr int kWarps = 4;
constexpr int kBlockM = 16 * kWarps;  // query rows per block
constexpr int kBlockN = 64;           // keys per shared-memory tile
constexpr int kPad = 8;               // shared row padding (bf16): conflict-free fragments
constexpr float kMasked = -1e30f;     // score of a key past the end

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* row_max;  // (batch * heads, sq), written by pass 1, read by pass 2
  // strides in elements over (batch, sequence, head); the head dim is dense
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int heads;
  int sq;
  int skv;
  float scale_log2;  // softmax scale * log2(e)
};

// Two q values times scale_log2, rounded to a bf16 pair.
__device__ __forceinline__ uint32_t scaled_pair(const __nv_bfloat16* p, float s) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return pack_bf16(f.x * s, f.y * s);
}

// Per-thread view of the block's geometry.
struct Tile {
  int g, t;        // lane / 4, lane % 4
  int bh;          // batch * heads index
  int row0, row1;  // this thread's two query rows
};

__device__ __forceinline__ Tile tile_of_thread(const Params& p) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  Tile tl;
  tl.g = lane / 4;
  tl.t = lane % 4;
  tl.bh = blockIdx.y;
  tl.row0 = blockIdx.x * kBlockM + warp * 16 + tl.g;
  tl.row1 = tl.row0 + 8;
  return tl;
}

// The warp's 16 x D slice of q * scale * log2(e) as bf16 A fragments; rows
// past the end are zero.
template <int D>
__device__ __forceinline__ void load_scaled_q(const Params& p, const Tile& tl,
                                              uint32_t (&q_frag)[D / 16][4]) {
  const __nv_bfloat16* q =
      p.q + (tl.bh / p.heads) * p.q_sb + (tl.bh % p.heads) * p.q_sh;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * tl.t;
    const bool in0 = tl.row0 < p.sq, in1 = tl.row1 < p.sq;
    q_frag[kk][0] = in0 ? scaled_pair(q + tl.row0 * p.q_ss + c, p.scale_log2) : 0u;
    q_frag[kk][1] = in1 ? scaled_pair(q + tl.row1 * p.q_ss + c, p.scale_log2) : 0u;
    q_frag[kk][2] = in0 ? scaled_pair(q + tl.row0 * p.q_ss + c + 8, p.scale_log2) : 0u;
    q_frag[kk][3] = in1 ? scaled_pair(q + tl.row1 * p.q_ss + c + 8, p.scale_log2) : 0u;
  }
}

// Copy keys [n0, n0 + kBlockN) of one (batch, head) into shared memory as
// 16-byte vectors; rows past the end are zero.
template <int D>
__device__ __forceinline__ void stage_tile(const __nv_bfloat16* src, long long row_stride,
                                           int n0, int skv, __nv_bfloat16* dst) {
  constexpr int kStride = D + kPad;
  constexpr int kVecPerRow = D / 8;
  for (int idx = threadIdx.x; idx < kBlockN * kVecPerRow; idx += kWarps * 32) {
    const int r = idx / kVecPerRow;
    const int c = (idx % kVecPerRow) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (n0 + r < skv) x = *reinterpret_cast<const uint4*>(src + (n0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(&dst[r * kStride + c]) = x;
  }
}

// S = q k^T for the warp's 16 rows x kBlockN keys, fp32.  B[kd][n] = K[n][kd]
// is a row of the K tile.  Both passes call this, so their scores agree.
template <int D>
__device__ __forceinline__ void score_tile(const uint32_t (&q_frag)[D / 16][4],
                                           const __nv_bfloat16* k_s, const Tile& tl,
                                           float (&s)[kBlockN / 8][4]) {
  constexpr int kStride = D + kPad;
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const __nv_bfloat16* k_row = &k_s[(j * 8 + tl.g) * kStride + 2 * tl.t];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      mma_bf16_16816(s[j], q_frag[kk], load_u32(k_row + kk * 16),
                     load_u32(k_row + kk * 16 + 8));
    }
  }
}

// Pass 1: the row max of the scaled scores over the valid keys.
template <int D>
__global__ void __launch_bounds__(kWarps * 32) row_max_kernel(const Params p) {
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockN * (D + kPad)];
  const Tile tl = tile_of_thread(p);
  const __nv_bfloat16* k = p.k + (tl.bh / p.heads) * p.k_sb + (tl.bh % p.heads) * p.k_sh;
  uint32_t q_frag[D / 16][4];
  load_scaled_q<D>(p, tl, q_frag);

  float m[2] = {kMasked, kMasked};
  for (int n0 = 0; n0 < p.skv; n0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous tile
    stage_tile<D>(k, p.k_ss, n0, p.skv, k_s);
    __syncthreads();
    float s[kBlockN / 8][4];
    score_tile<D>(q_frag, k_s, tl, s);
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + j * 8 + 2 * tl.t + (e & 1);
        m[e >> 1] = fmaxf(m[e >> 1], key < p.skv ? s[j][e] : kMasked);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the 4 lanes of a quad share a row
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }
  if (tl.t == 0) {
    float* out = p.row_max + static_cast<long long>(tl.bh) * p.sq;
    if (tl.row0 < p.sq) out[tl.row0] = m[0];
    if (tl.row1 < p.sq) out[tl.row1] = m[1];
  }
}

// Pass 2: exp2(s - m) against the exact row max, P V and the row sum in fp32.
template <int D>
__global__ void __launch_bounds__(kWarps * 32) attention_kernel(const Params p) {
  constexpr int kStride = D + kPad;
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockN * kStride];
  const Tile tl = tile_of_thread(p);
  const int b = tl.bh / p.heads, h = tl.bh % p.heads;
  const __nv_bfloat16* k = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v = p.v + b * p.v_sb + h * p.v_sh;
  uint32_t q_frag[D / 16][4];
  load_scaled_q<D>(p, tl, q_frag);
  const float* row_max = p.row_max + static_cast<long long>(tl.bh) * p.sq;
  const float m[2] = {tl.row0 < p.sq ? row_max[tl.row0] : 0.f,
                      tl.row1 < p.sq ? row_max[tl.row1] : 0.f};

  float o_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o_acc[j][0] = o_acc[j][1] = o_acc[j][2] = o_acc[j][3] = 0.f;
  }
  float l[2] = {0.f, 0.f};  // this thread's partial row sums

  for (int n0 = 0; n0 < p.skv; n0 += kBlockN) {
    __syncthreads();
    stage_tile<D>(k, p.k_ss, n0, p.skv, k_s);
    stage_tile<D>(v, p.v_ss, n0, p.skv, v_s);
    __syncthreads();
    float s[kBlockN / 8][4];
    score_tile<D>(q_frag, k_s, tl, s);

    // P = exp2(S - m) as bf16 A fragments for P V (the C fragments of key
    // tiles 2kk and 2kk+1 are the A fragment of 16-key chunk kk); the row
    // sum adds the same rounded weights
    uint32_t p_frag[kBlockN / 16][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + j * 8 + 2 * tl.t + (e & 1);
        x[e] = exp2f(key < p.skv ? s[j][e] - m[e >> 1] : kMasked);
      }
      const __nv_bfloat162 p01 = __floats2bfloat162_rn(x[0], x[1]);
      const __nv_bfloat162 p23 = __floats2bfloat162_rn(x[2], x[3]);
      l[0] += __low2float(p01) + __high2float(p01);
      l[1] += __low2float(p23) + __high2float(p23);
      p_frag[j / 2][(j % 2) * 2 + 0] = *reinterpret_cast<const uint32_t*>(&p01);
      p_frag[j / 2][(j % 2) * 2 + 1] = *reinterpret_cast<const uint32_t*>(&p23);
    }

    // O += P V; B[key][d] = V[key][d] is a column of the V tile
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        const __nv_bfloat16* v_col = &v_s[(kk * 16 + 2 * tl.t) * kStride + jd * 8 + tl.g];
        const uint32_t b0 = pack_bf16(v_col[0], v_col[kStride]);
        const uint32_t b1 = pack_bf16(v_col[8 * kStride], v_col[9 * kStride]);
        mma_bf16_16816(o_acc[jd], p_frag[kk], b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* o = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd) {
    const int c = jd * 8 + 2 * tl.t;
    if (tl.row0 < p.sq) {
      *reinterpret_cast<uint32_t*>(o + tl.row0 * p.o_ss + c) =
          pack_bf16(o_acc[jd][0] / l[0], o_acc[jd][1] / l[0]);
    }
    if (tl.row1 < p.sq) {
      *reinterpret_cast<uint32_t*>(o + tl.row1 * p.o_ss + c) =
          pack_bf16(o_acc[jd][2] / l[1], o_acc[jd][3] / l[1]);
    }
  }
}

template <int D>
int launch(const Params& p, int batch, cudaStream_t s) {
  const dim3 grid((p.sq + kBlockM - 1) / kBlockM, batch * p.heads);
  const dim3 block(kWarps * 32);
  row_max_kernel<D><<<grid, block, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_kernel<D><<<grid, block, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  Launches both passes on `stream` of
// `device` and returns the cudaError_t of the launches (0 = success); it does
// not synchronise.  `row_max` is fp32 scratch of batch * heads * sq values.
extern "C" int flash_maxpass_fwd(int device, const void* q, const void* k, const void* v, void* o,
                                 void* row_max, int batch, int heads, int sq, int skv,
                                 int head_dim,
                                 long long q_sb, long long q_ss, long long q_sh,
                                 long long k_sb, long long k_ss, long long k_sh,
                                 long long v_sb, long long v_ss, long long v_sh,
                                 long long o_sb, long long o_ss, long long o_sh,
                                 float scale, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.row_max = static_cast<float*>(row_max);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.heads = heads;
  p.sq = sq;
  p.skv = skv;
  p.scale_log2 = scale * 1.4426950408889634f;

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch<64>(p, batch, s);
  if (head_dim == 128) return launch<128>(p, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_maxpass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
