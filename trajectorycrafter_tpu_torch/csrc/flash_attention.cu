// Non-causal softmax attention, softmax(q k^T * scale) v, for Hopper (sm_90a),
// in three modes that share one kernel body.
//
// Mode kExact (entry point flash_attention_fwd) replaces the TPU kernel
// trajectorycrafter_tpu/ops/pallas/flash_exp2.py `flash_attention_exp2_t`
// (body `_kernel_t`), which the DiT's joint self-attention (head dim 64) and
// the Perceiver cross-attention (head dim 128) run on.  The TPU kernel has no
// running max: it uses a fixed exp2 bias that is exact only for QK-normed
// scores, pads the sequences to its block multiple and corrects the
// denominator for the zero pad rows, and writes a (B, H, D, S) output to
// fill the 128-lane MXU.  None of that carries over.  This mode computes the
// function itself, with an online running max, so it is exact for the
// Perceiver's unnormalised scores too.
//
// It also replaces trajectorycrafter_tpu/ops/attention.py `_flash_attention`,
// JAX's library Pallas flash kernel (online running max, padded keys masked
// by segment ids), which carries the DepthCrafter UNet's large spatial
// self-attention (49 frames x 5 heads x 9,216 tokens x 64 and 49 x 10 x
// 2,304 x 64 at 576x1024): the same exact function, so the same kernel.
//
// Mode kLse (entry point flash_lse_fwd) replaces
// trajectorycrafter_tpu/ops/pallas/flash_lse.py `flash_attention_with_lse`:
// the same running-max attention, which also writes the natural-log
// logsumexp of each query row's scaled scores, lse = m + log(max(l, 1e-30)),
// fp32 (B, H, Sq).  The running max lives in the exp2 domain here, so the
// kernel converts: m = m2 * ln 2.  The TPU kernel masks nothing (callers pad
// to its block multiple and the zero keys count); this mode attends over
// exactly the keys it is given.
//
// Mode kExp2 (entry point flash_exp2_fwd) replaces
// trajectorycrafter_tpu/ops/pallas/flash_exp2.py `flash_attention_exp2`
// (body `_kernel`), the same attention as `_kernel_t` without the transposed
// output: no running max, q' = bf16(q * scale * log2 e), s = q'.k - bias
// (the bias rounded to bf16, as its extra contraction lane is), clamped at
// 110 when asked, p = bf16(exp2(s)); the numerator sums p v and the
// denominator the same bf16 p, over the valid keys (an optional (Skv,) byte
// mask, the TPU kernel's validity column of V).
//
// What bounds it on the H100: at the DiT shape (2 x 48 heads x 13,330 tokens x
// 64) one call does ~4.4 TFLOP against ~0.3 GB of q/k/v, so it is bound by
// tensor-core throughput and by the fp32 softmax work between the two matrix
// products (one exp per score: at d = 64 the SFU's 16 exp2 per clock per SM
// take about as long as the tensor cores' products), not by device memory.
// The design therefore keeps the scores in registers (they never reach shared
// or device memory), runs both products on the tensor cores with `mma.sync`
// m16n8k16 (bf16 in, fp32 accumulate), and keeps one row max and one row sum
// per query in fp32.  `wgmma`, TMA and warp specialisation would raise the
// tensor-core share further; they are left out so that this first kernel
// stays simple.
//
// Layout: one thread block per (batch * head, 64-query tile); each of its four
// warps owns 16 query rows.  A loop over 64-key tiles staged in shared memory
// takes the place of the TPU grid's sequential kv axis.  q, k, v are read in
// the (B, S, H, D) layout the projections produce, by strides, and the output
// is written in (B, S, H, D): no transpose or padding copy goes in or out.
// The ragged tail is masked in the kernel: out-of-range keys load as zero and
// score -inf, out-of-range query rows load as zero and are not stored.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
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
// Row padding of the shared tiles, in bf16 elements: a row stride of D + 8
// puts the eight rows one warp reads for a fragment in eight distinct bank
// groups, so the fragment loads are free of bank conflicts.
constexpr int kPad = 8;
constexpr float kExp2Clamp = 110.f;  // exp2 argument cap of kExp2 mode

enum Mode { kExact = 0, kLse = 1, kExp2 = 2 };

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;                // kLse: (batch * heads, sq)
  const uint8_t* kv_valid;   // kExp2: (skv,) 1 = a real key, or null = all
  // strides in elements over (batch, sequence, head); the head dim is dense
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int heads;
  int sq;
  int skv;
  float scale_log2;  // softmax scale * log2(e): scores live in the exp2 domain
  float bias;        // kExp2: subtracted from every score (bf16-rounded)
  int clamp;         // kExp2: cap the exp2 argument at 110
};

template <int D, int kMode>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const Params p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kStride = D + kPad;
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockN * kStride];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y % p.heads;
  const int row0 = blockIdx.x * kBlockM + warp * 16 + g;  // this thread's rows:
  const int row1 = row0 + 8;                              // row0 and row0 + 8

  const __nv_bfloat16* q = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v = p.v + b * p.v_sb + h * p.v_sh;

  // The warp's 16 x D slice of q, as A fragments, straight into registers;
  // kExp2 rounds q * scale * log2(e) to bf16 first, as its TPU kernel does.
  auto q_pair = [&](int row, int c) -> uint32_t {
    if (row >= p.sq) return 0u;
    const __nv_bfloat16* src = q + row * p.q_ss + c;
    if (kMode != kExp2) return load_u32(src);
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
    return pack_bf16(f.x * p.scale_log2, f.y * p.scale_log2);
  };
  uint32_t q_frag[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    q_frag[kk][0] = q_pair(row0, c);
    q_frag[kk][1] = q_pair(row1, c);
    q_frag[kk][2] = q_pair(row0, c + 8);
    q_frag[kk][3] = q_pair(row1, c + 8);
  }

  float o_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o_acc[j][0] = o_acc[j][1] = o_acc[j][2] = o_acc[j][3] = 0.f;
  }
  // Running max (exp2 domain) and this thread's partial row sums, rows 0 / 1.
  // The max starts finite so that exp2(old - new) is 0, never NaN.
  float m_run[2] = {-1e30f, -1e30f};
  float l_run[2] = {0.f, 0.f};

  const int n_tiles = (p.skv + kBlockN - 1) / kBlockN;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int n0 = tile * kBlockN;

    // Stage the K and V tiles: 16-byte vectors, zero rows past the end.
    __syncthreads();  // every warp is done with the previous tile
    constexpr int kVecPerRow = D / 8;
    for (int idx = threadIdx.x; idx < kBlockN * kVecPerRow; idx += kWarps * 32) {
      const int r = idx / kVecPerRow;
      const int c = (idx % kVecPerRow) * 8;
      const int key = n0 + r;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u);
      uint4 vx = make_uint4(0u, 0u, 0u, 0u);
      if (key < p.skv) {
        kx = *reinterpret_cast<const uint4*>(k + key * p.k_ss + c);
        vx = *reinterpret_cast<const uint4*>(v + key * p.v_ss + c);
      }
      *reinterpret_cast<uint4*>(&k_s[r * kStride + c]) = kx;
      *reinterpret_cast<uint4*>(&v_s[r * kStride + c]) = vx;
    }
    __syncthreads();

    // S = q k^T for 16 rows x kBlockN keys; B[kd][n] = K[n][kd] is a row of K.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* k_row = &k_s[(j * 8 + g) * kStride + 2 * t];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_bf16_16816(s[j], q_frag[kk], load_u32(k_row + kk * 16),
                       load_u32(k_row + kk * 16 + 8));
      }
    }

    // P as bf16 A fragments for PV: the C fragments of key tiles 2kk and
    // 2kk+1 are exactly the A fragment of the 16-key chunk kk, so P never
    // leaves the registers.
    uint32_t p_frag[kBlockN / 16][4];
    if (kMode == kExp2) {
      // fixed bias, no running max; the row sum adds the rounded weights
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = n0 + j * 8 + 2 * t + (e & 1);
          const bool valid = key < p.skv && (p.kv_valid == nullptr || p.kv_valid[key]);
          float a = s[j][e] - p.bias;
          if (p.clamp) a = fminf(a, kExp2Clamp);
          x[e] = valid ? exp2f(a) : 0.f;
        }
        const __nv_bfloat162 p01 = __floats2bfloat162_rn(x[0], x[1]);
        const __nv_bfloat162 p23 = __floats2bfloat162_rn(x[2], x[3]);
        l_run[0] += __low2float(p01) + __high2float(p01);
        l_run[1] += __low2float(p23) + __high2float(p23);
        p_frag[j / 2][(j % 2) * 2 + 0] = *reinterpret_cast<const uint32_t*>(&p01);
        p_frag[j / 2][(j % 2) * 2 + 1] = *reinterpret_cast<const uint32_t*>(&p23);
      }
    } else {
      // Scale into the exp2 domain, mask keys past the end, new row max.
      float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = n0 + j * 8 + 2 * t + (e & 1);
          const float x = key < p.skv ? s[j][e] * p.scale_log2 : -INFINITY;
          s[j][e] = x;
          m_new[e >> 1] = fmaxf(m_new[e >> 1], x);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // the 4 lanes of a quad share a row
        m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
        m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
      }

      // Rescale what was accumulated under the old max.
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        corr[r] = exp2f(m_run[r] - m_new[r]);
        m_run[r] = m_new[r];
        l_run[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o_acc[j][0] *= corr[0];
        o_acc[j][1] *= corr[0];
        o_acc[j][2] *= corr[1];
        o_acc[j][3] *= corr[1];
      }

      // P = exp2(S - max) in fp32 for the row sums, bf16 for PV.
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        const float p0 = exp2f(s[j][0] - m_new[0]);
        const float p1 = exp2f(s[j][1] - m_new[0]);
        const float p2 = exp2f(s[j][2] - m_new[1]);
        const float p3 = exp2f(s[j][3] - m_new[1]);
        l_run[0] += p0 + p1;
        l_run[1] += p2 + p3;
        p_frag[j / 2][(j % 2) * 2 + 0] = pack_bf16(p0, p1);
        p_frag[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
    }

    // O += P V; B[key][d] = V[key][d] is a column of the V tile.
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        const __nv_bfloat16* v_col = &v_s[(kk * 16 + 2 * t) * kStride + jd * 8 + g];
        const uint32_t b0 = pack_bf16(v_col[0], v_col[kStride]);
        const uint32_t b1 = pack_bf16(v_col[8 * kStride], v_col[9 * kStride]);
        mma_bf16_16816(o_acc[jd], p_frag[kk], b0, b1);
      }
    }
  }

  // Full row sums over the quad, normalise, store bf16 pairs.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    if (kMode != kExact) l_run[r] = fmaxf(l_run[r], 1e-30f);
  }
  if (kMode == kLse && t == 0) {
    float* lse = p.lse + static_cast<long long>(blockIdx.y) * p.sq;
    if (row0 < p.sq) lse[row0] = m_run[0] * 0.6931471805599453f + logf(l_run[0]);
    if (row1 < p.sq) lse[row1] = m_run[1] * 0.6931471805599453f + logf(l_run[1]);
  }
  const float inv0 = 1.f / l_run[0];
  const float inv1 = 1.f / l_run[1];
  __nv_bfloat16* o = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd) {
    const int c = jd * 8 + 2 * t;
    if (row0 < p.sq) {
      *reinterpret_cast<uint32_t*>(o + row0 * p.o_ss + c) =
          pack_bf16(o_acc[jd][0] * inv0, o_acc[jd][1] * inv0);
    }
    if (row1 < p.sq) {
      *reinterpret_cast<uint32_t*>(o + row1 * p.o_ss + c) =
          pack_bf16(o_acc[jd][2] * inv1, o_acc[jd][3] * inv1);
    }
  }
}

Params make_params(const void* q, const void* k, const void* v, void* o, int heads, int sq,
                   int skv, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                   long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                   long long v_sh, long long o_sb, long long o_ss, long long o_sh,
                   float scale) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = nullptr;
  p.kv_valid = nullptr;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.heads = heads;
  p.sq = sq;
  p.skv = skv;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.bias = 0.f;
  p.clamp = 0;
  return p;
}

template <int kMode>
int launch(const Params& p, int device, int batch, int head_dim, void* stream) {
  // make the caller's device current for this runtime, as PyTorch has it
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + kBlockM - 1) / kBlockM, batch * p.heads);
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    flash_attention_kernel<64, kMode><<<grid, block, 0, s>>>(p);
  } else if (head_dim == 128) {
    flash_attention_kernel<128, kMode><<<grid, block, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream` of `device` and
// returns the cudaError_t of the launch (0 = success); none synchronises.
#define FLASH_COMMON_ARGS                                                             \
  int batch, int heads, int sq, int skv, int head_dim, long long q_sb, long long q_ss, \
      long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,  \
      long long v_ss, long long v_sh, long long o_sb, long long o_ss, long long o_sh,  \
      float scale
#define FLASH_COMMON_PARAMS                                                               \
  make_params(q, k, v, o, heads, sq, skv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, \
              v_sh, o_sb, o_ss, o_sh, scale)

extern "C" int flash_attention_fwd(int device, const void* q, const void* k, const void* v, void* o,
                                   FLASH_COMMON_ARGS, void* stream) {
  return launch<kExact>(FLASH_COMMON_PARAMS, device, batch, head_dim, stream);
}

// `lse`: fp32 (batch * heads, sq), written as well as the output.
extern "C" int flash_lse_fwd(int device, const void* q, const void* k, const void* v, void* o,
                             void* lse, FLASH_COMMON_ARGS, void* stream) {
  Params p = FLASH_COMMON_PARAMS;
  p.lse = static_cast<float*>(lse);
  return launch<kLse>(p, device, batch, head_dim, stream);
}

// `kv_valid`: a (skv,) byte mask of the real keys, or null; `bias` already
// rounded to bf16; `clamp` nonzero caps the exp2 argument at 110.
extern "C" int flash_exp2_fwd(int device, const void* q, const void* k, const void* v, void* o,
                              const void* kv_valid, FLASH_COMMON_ARGS, float bias, int clamp,
                              void* stream) {
  Params p = FLASH_COMMON_PARAMS;
  p.kv_valid = static_cast<const uint8_t*>(kv_valid);
  p.bias = bias;
  p.clamp = clamp;
  return launch<kExp2>(p, device, batch, head_dim, stream);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
