// The backward pass of non-causal softmax attention, o = softmax(q k^T *
// scale) v, for Hopper (sm_90a): two kernels, one for dK and dV and one for
// dQ, each on `mma.sync` m16n8k16 bf16 tensor-core products with fp32
// accumulators.
//
// They replace the two backward Pallas kernels of JAX's library flash
// attention (jax/experimental/pallas/ops/tpu/flash_attention.py), which
// `jax.grad` reaches through the `custom_vjp` of
// trajectorycrafter_tpu/ops/attention.py `_flash_attention` (K4, the
// `flash_stock` route): `_flash_attention_bwd_dkv` (dK, dV) and
// `_flash_attention_bwd_dq` (dQ).  As there, the forward saves the
// logsumexp of each query row (here the natural-log lse of K5, the
// `flash_lse` entry of csrc/flash_attention.cu: JAX's m + log l), and
// di = sum(o * dO) over the head dim is a plain reduction before the
// kernels (XLA computes it on the TPU).  With p = exp(s * scale - lse) and
// ds = p (dO . v - di):
//
//   dV = p^T dO,   dK = scale ds^T q,   dQ = scale ds k.
//
// The TPU kernels pad the sequences to their blocks and mask the padding by
// segment ids; here the ragged ends are masked in the kernels: rows past the
// sequence are loaded as zeros, a query row past Sq gets lse = +inf (so its p
// is 0 and it adds nothing to dK or dV), a key past Skv gets p = 0 in the dQ
// kernel, and rows past the end are not stored.
//
// What bounds them on the H100: at the DiT's training shape (1 x 48 heads x
// 13,330 tokens x 64) dK/dV does 8 Sq Skv D H = 4.37 TFLOP (four products:
// s, dp, dV, dK) and dQ 6 Sq Skv D H = 3.28 TFLOP (s, dp, dQ) against ~0.3
// GB of operands: both are bound by the tensor cores (4.42 and 3.31 ms at
// 989 TFLOP/s), and next by the SFU's one exp per score (2.04 ms).  This is
// the simple design; it reaches neither bound (its times are in PERF.md):
//
// - One block of 4 warps owns 64 rows (64 keys for dK/dV, 64 queries for
//   dQ), each warp 16 of them, and loops over the other side in tiles of
//   kN rows (64, or 32 query rows for dK/dV at head dim 128 to keep its two
//   fp32 accumulators, 2 x 64 registers a thread, beside the score tiles).
// - The looped tiles go into shared memory by `cp.async` (16 bytes a thread,
//   zero-filled past the end), two stages deep, so tile j + 1 loads while
//   tile j is multiplied.  Rows are padded by 16 bytes so that `ldmatrix`
//   reads eight rows without bank conflicts.
// - Each product is `mma.sync` m16n8k16 with its operands from `ldmatrix`
//   (`.trans` where the operand is stored K-major); the recomputed scores
//   and dp stay in registers, and p and ds go from the fp32 accumulator
//   layout straight into bf16 A fragments (the accumulators of two 8-column
//   tiles are the A fragment of one 16-deep chunk), as in FlashAttention-2.
//   p and ds are rounded to bf16 for their products, as the forward kernel
//   rounds p; the sums stay fp32 and the outputs are rounded to bf16 once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_bwd.so flash_attention_bwd.cu
// (trajectorycrafter_tpu_torch/ops/kernels.py does this at first use).

#include <math.h>

#include "hopper.cuh"

namespace flash_bwd {

using hopper::pack_bf16;
using hopper::smem_u32;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockM = 16 * kWarps;  // rows a block owns: 16 a warp
constexpr int kPad = 8;               // bf16 of padding a shared-memory row
constexpr float kLog2e = 1.4426950408889634f;

// One (batch, head)'s rows of a (B, S, H, D) tensor: row s at base + s * ss.
struct Rows {
  const __nv_bfloat16* base;
  long long ss;
};

struct Args {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *lse, *di;  // (batch * heads, sq)
  __nv_bfloat16 *dq, *dk, *dv;
  int batch, heads, sq, skv, head_dim;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh;
  long long o1_sb, o1_ss, o1_sh, o2_sb, o2_ss, o2_sh;  // dk, dv (or dq, unused)
  float scale;
};

// ---------------------------------------------------------------------------
// Pieces
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  // src-size 0 copies nothing and zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row-major) b (16 x 8, bf16, "col")
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared-memory address of the row-major A fragment (16 x 16) at (row0,
// col0) of a tile with `stride` bf16 a row, or, equally, of the "col" B
// fragments of two 8-column tiles stored as their rows: ldsm_x4 then gives
// a0..a3.
__device__ __forceinline__ uint32_t frag_a(const __nv_bfloat16* tile, int stride, int row0,
                                           int col0, int lane) {
  return smem_u32(tile + (row0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * stride + col0 +
                  8 * (lane >> 4));
}
// B fragments of the two 8-wide n tiles (n0, n0 + 8) over k (k0, k0 + 16)
// when B^T is stored row-major ([n][k], e.g. k for s = q k^T): r0, r1 are
// (b0, b1) of tile n0, r2, r3 those of tile n0 + 8 (ldsm_x4).
__device__ __forceinline__ uint32_t frag_b_nk(const __nv_bfloat16* tile, int stride, int n0,
                                              int k0, int lane) {
  return smem_u32(tile + (n0 + (lane & 7) + 8 * (lane >> 4)) * stride + k0 +
                  8 * ((lane >> 3) & 1));
}
// The same when B is stored row-major ([k][n], e.g. v for p v): ldsm_x4_t.
__device__ __forceinline__ uint32_t frag_b_kn(const __nv_bfloat16* tile, int stride, int k0,
                                              int n0, int lane) {
  return smem_u32(tile + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * stride + n0 +
                  8 * (lane >> 4));
}

// Start loading rows [row0, row0 + R) of `src` (D bf16 each) into `tile`
// (stride D + kPad); rows past `len` are zero-filled.
template <int R, int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* tile, const Rows src, int row0,
                                          int len) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int c = threadIdx.x; c < R * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool valid = row0 + r < len;
    const __nv_bfloat16* from = src.base + (valid ? (row0 + r) * src.ss + col : 0);
    cp_async16(tile + r * (D + kPad) + col, from, valid);
  }
}

// Store the warp's 16 x D accumulator rows (fp32, times `mul`) as bf16.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long ss, const float (&acc)[D / 8][4],
                                           float mul, int row0, int len, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= len) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const uint32_t v = pack_bf16(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
      *reinterpret_cast<uint32_t*>(out + row * ss + n * 8 + 2 * t) = v;
    }
  }
}

// ---------------------------------------------------------------------------
// dK, dV: a block owns 64 keys and loops over the query tiles
// ---------------------------------------------------------------------------

template <int D, int kN>
struct DkvSmem {
  static constexpr int kStride = D + kPad;
  __nv_bfloat16 k[kBlockM * kStride];
  __nv_bfloat16 v[kBlockM * kStride];
  __nv_bfloat16 q[2][kN * kStride];
  __nv_bfloat16 dout[2][kN * kStride];
  float lse2[2][kN];  // lse * log2(e); +inf past Sq
  float di[2][kN];
};

template <int D, int kN>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const Args a) {
  using Smem = DkvSmem<D, kN>;
  constexpr int S = Smem::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int key0 = blockIdx.x * kBlockM;
  const int bh = blockIdx.y;
  const int b = bh / a.heads, h = bh % a.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;

  const Rows q{a.q + b * a.q_sb + h * a.q_sh, a.q_ss};
  const Rows k{a.k + b * a.k_sb + h * a.k_sh, a.k_ss};
  const Rows v{a.v + b * a.v_sb + h * a.v_sh, a.v_ss};
  const Rows dout{a.dout + b * a.do_sb + h * a.do_sh, a.do_ss};
  const float* lse = a.lse + static_cast<long long>(bh) * a.sq;
  const float* di = a.di + static_cast<long long>(bh) * a.sq;

  load_rows<kBlockM, D>(sm.k, k, key0, a.skv);
  load_rows<kBlockM, D>(sm.v, v, key0, a.skv);
  auto load_tile = [&](int tile, int stage) {
    const int row0 = tile * kN;
    load_rows<kN, D>(sm.q[stage], q, row0, a.sq);
    load_rows<kN, D>(sm.dout[stage], dout, row0, a.sq);
    for (int i = threadIdx.x; i < kN; i += kThreads) {
      const bool valid = row0 + i < a.sq;
      sm.lse2[stage][i] = valid ? lse[row0 + i] * kLog2e : INFINITY;
      sm.di[stage][i] = valid ? di[row0 + i] : 0.f;
    }
  };
  const int tiles = (a.sq + kN - 1) / kN;
  load_tile(0, 0);
  cp_async_commit();

  const float scale_log2 = a.scale * kLog2e;
  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;

  for (int j = 0; j < tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < tiles) load_tile(j + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* tq = sm.q[stage];
    const __nv_bfloat16* tdo = sm.dout[stage];

    // s^T = k q^T and dp^T = v dO^T: the warp's 16 keys x kN queries
    float s[kN / 8][4], dp[kN / 8][4];
#pragma unroll
    for (int n = 0; n < kN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      ldsm_x4(ak, frag_a(sm.k, S, warp * 16, kk * 16, lane));
      ldsm_x4(av, frag_a(sm.v, S, warp * 16, kk * 16, lane));
#pragma unroll
      for (int n = 0; n < kN / 8; n += 2) {
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, frag_b_nk(tq, S, n * 8, kk * 16, lane));
        ldsm_x4(bo, frag_b_nk(tdo, S, n * 8, kk * 16, lane));
        mma(s[n], ak, bq[0], bq[1]);
        mma(s[n + 1], ak, bq[2], bq[3]);
        mma(dp[n], av, bo[0], bo[1]);
        mma(dp[n + 1], av, bo[2], bo[3]);
      }
    }
    // p^T = exp(s^T scale - lse), ds^T = p^T (dp^T - di), per query column
#pragma unroll
    for (int n = 0; n < kN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        const float p = exp2f(s[n][e] * scale_log2 - sm.lse2[stage][col]);
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - sm.di[stage][col]);
      }
    // dV += p^T dO, dK += ds^T q over 16-query chunks
#pragma unroll
    for (int c = 0; c < kN / 16; ++c) {
      const uint32_t ap[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                              pack_bf16(s[2 * c][2], s[2 * c][3]),
                              pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                              pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
      const uint32_t ads[4] = {pack_bf16(dp[2 * c][0], dp[2 * c][1]),
                               pack_bf16(dp[2 * c][2], dp[2 * c][3]),
                               pack_bf16(dp[2 * c + 1][0], dp[2 * c + 1][1]),
                               pack_bf16(dp[2 * c + 1][2], dp[2 * c + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bo[4], bq[4];
        ldsm_x4_t(bo, frag_b_kn(tdo, S, c * 16, n * 8, lane));
        ldsm_x4_t(bq, frag_b_kn(tq, S, c * 16, n * 8, lane));
        mma(acc_dv[n], ap, bo[0], bo[1]);
        mma(acc_dv[n + 1], ap, bo[2], bo[3]);
        mma(acc_dk[n], ads, bq[0], bq[1]);
        mma(acc_dk[n + 1], ads, bq[2], bq[3]);
      }
    }
    __syncthreads();  // the stage is refilled next step
  }

  const int row0 = key0 + warp * 16;
  store_rows<D>(a.dk + b * a.o1_sb + h * a.o1_sh, a.o1_ss, acc_dk, a.scale, row0, a.skv, lane);
  store_rows<D>(a.dv + b * a.o2_sb + h * a.o2_sh, a.o2_ss, acc_dv, 1.f, row0, a.skv, lane);
}

// ---------------------------------------------------------------------------
// dQ: a block owns 64 queries and loops over the key tiles
// ---------------------------------------------------------------------------

template <int D, int kN>
struct DqSmem {
  static constexpr int kStride = D + kPad;
  __nv_bfloat16 q[kBlockM * kStride];
  __nv_bfloat16 dout[kBlockM * kStride];
  __nv_bfloat16 k[2][kN * kStride];
  __nv_bfloat16 v[2][kN * kStride];
};

template <int D, int kN>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Args a) {
  using Smem = DqSmem<D, kN>;
  constexpr int S = Smem::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int q0 = blockIdx.x * kBlockM;
  const int bh = blockIdx.y;
  const int b = bh / a.heads, h = bh % a.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const Rows q{a.q + b * a.q_sb + h * a.q_sh, a.q_ss};
  const Rows k{a.k + b * a.k_sb + h * a.k_sh, a.k_ss};
  const Rows v{a.v + b * a.v_sb + h * a.v_sh, a.v_ss};
  const Rows dout{a.dout + b * a.do_sb + h * a.do_sh, a.do_ss};

  // this thread's two query rows (g and g + 8 of the warp's 16)
  float lse2[2], dirow[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + warp * 16 + g + 8 * half;
    const long long at = static_cast<long long>(bh) * a.sq + row;
    lse2[half] = row < a.sq ? a.lse[at] * kLog2e : INFINITY;
    dirow[half] = row < a.sq ? a.di[at] : 0.f;
  }

  load_rows<kBlockM, D>(sm.q, q, q0, a.sq);
  load_rows<kBlockM, D>(sm.dout, dout, q0, a.sq);
  auto load_tile = [&](int tile, int stage) {
    load_rows<kN, D>(sm.k[stage], k, tile * kN, a.skv);
    load_rows<kN, D>(sm.v[stage], v, tile * kN, a.skv);
  };
  const int tiles = (a.skv + kN - 1) / kN;
  load_tile(0, 0);
  cp_async_commit();

  const float scale_log2 = a.scale * kLog2e;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < tiles) load_tile(j + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* tk = sm.k[stage];
    const __nv_bfloat16* tv = sm.v[stage];

    // s = q k^T and dp = dO v^T: the warp's 16 queries x kN keys
    float s[kN / 8][4], dp[kN / 8][4];
#pragma unroll
    for (int n = 0; n < kN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ao[4];
      ldsm_x4(aq, frag_a(sm.q, S, warp * 16, kk * 16, lane));
      ldsm_x4(ao, frag_a(sm.dout, S, warp * 16, kk * 16, lane));
#pragma unroll
      for (int n = 0; n < kN / 8; n += 2) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, frag_b_nk(tk, S, n * 8, kk * 16, lane));
        ldsm_x4(bv, frag_b_nk(tv, S, n * 8, kk * 16, lane));
        mma(s[n], aq, bk[0], bk[1]);
        mma(s[n + 1], aq, bk[2], bk[3]);
        mma(dp[n], ao, bv[0], bv[1]);
        mma(dp[n + 1], ao, bv[2], bv[3]);
      }
    }
    // p = exp(s scale - lse) (0 past Skv), ds = p (dp - di)
#pragma unroll
    for (int n = 0; n < kN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * kN + n * 8 + 2 * t + (e & 1);
        const float p = key < a.skv ? exp2f(s[n][e] * scale_log2 - lse2[e >> 1]) : 0.f;
        dp[n][e] = p * (dp[n][e] - dirow[e >> 1]);
      }
    // dQ += ds k over 16-key chunks
#pragma unroll
    for (int c = 0; c < kN / 16; ++c) {
      const uint32_t ads[4] = {pack_bf16(dp[2 * c][0], dp[2 * c][1]),
                               pack_bf16(dp[2 * c][2], dp[2 * c][3]),
                               pack_bf16(dp[2 * c + 1][0], dp[2 * c + 1][1]),
                               pack_bf16(dp[2 * c + 1][2], dp[2 * c + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bk[4];
        ldsm_x4_t(bk, frag_b_kn(tk, S, c * 16, n * 8, lane));
        mma(acc[n], ads, bk[0], bk[1]);
        mma(acc[n + 1], ads, bk[2], bk[3]);
      }
    }
    __syncthreads();  // the stage is refilled next step
  }

  store_rows<D>(a.dq + b * a.o1_sb + h * a.o1_sh, a.o1_ss, acc, a.scale, q0 + warp * 16, a.sq,
                lane);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t run(Kernel kernel, int smem, int rows, const Args& a, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + kBlockM - 1) / kBlockM, a.batch * a.heads);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// dK/dV at head dim 128 steps over 32 query rows: its two 64-register
// accumulators a thread leave room for no more score registers.
int launch_dkv(int device, const Args& a, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.head_dim == 64)
    return static_cast<int>(
        run(dkv_kernel<64, 64>, static_cast<int>(sizeof(DkvSmem<64, 64>)), a.skv, a, s));
  if (a.head_dim == 128)
    return static_cast<int>(
        run(dkv_kernel<128, 32>, static_cast<int>(sizeof(DkvSmem<128, 32>)), a.skv, a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_dq(int device, const Args& a, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.head_dim == 64)
    return static_cast<int>(
        run(dq_kernel<64, 64>, static_cast<int>(sizeof(DqSmem<64, 64>)), a.sq, a, s));
  if (a.head_dim == 128)
    return static_cast<int>(
        run(dq_kernel<128, 64>, static_cast<int>(sizeof(DqSmem<128, 64>)), a.sq, a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace flash_bwd

// Plain C entry points for ctypes (ops/kernels.py names every entry point
// `<name>_fwd`).  q, k, v, dout: (B, S, H, D) bf16 by (batch, sequence,
// head) strides in elements, the head dim dense; lse, di: fp32 (B * H, Sq).
// Each launches on `stream` of `device` and returns the cudaError_t of the
// launch (0 = success); none synchronises.
#define BWD_COMMON_ARGS                                                                     \
  int batch, int heads, int sq, int skv, int head_dim, long long q_sb, long long q_ss,      \
      long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,       \
      long long v_ss, long long v_sh, long long do_sb, long long do_ss, long long do_sh

extern "C" int flash_attention_bwd_dkv_fwd(int device, const void* q, const void* k,
                                           const void* v, const void* dout, const void* lse,
                                           const void* di, void* dk, void* dv, BWD_COMMON_ARGS,
                                           long long dk_sb, long long dk_ss, long long dk_sh,
                                           long long dv_sb, long long dv_ss, long long dv_sh,
                                           float scale, void* stream) {
  const flash_bwd::Args a{static_cast<const __nv_bfloat16*>(q),
                          static_cast<const __nv_bfloat16*>(k),
                          static_cast<const __nv_bfloat16*>(v),
                          static_cast<const __nv_bfloat16*>(dout),
                          static_cast<const float*>(lse),
                          static_cast<const float*>(di),
                          nullptr,
                          static_cast<__nv_bfloat16*>(dk),
                          static_cast<__nv_bfloat16*>(dv),
                          batch, heads, sq, skv, head_dim,
                          q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                          do_sb, do_ss, do_sh,
                          dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh,
                          scale};
  return flash_bwd::launch_dkv(device, a, stream);
}

extern "C" int flash_attention_bwd_dq_fwd(int device, const void* q, const void* k,
                                          const void* v, const void* dout, const void* lse,
                                          const void* di, void* dq, BWD_COMMON_ARGS,
                                          long long dq_sb, long long dq_ss, long long dq_sh,
                                          float scale, void* stream) {
  const flash_bwd::Args a{static_cast<const __nv_bfloat16*>(q),
                          static_cast<const __nv_bfloat16*>(k),
                          static_cast<const __nv_bfloat16*>(v),
                          static_cast<const __nv_bfloat16*>(dout),
                          static_cast<const float*>(lse),
                          static_cast<const float*>(di),
                          static_cast<__nv_bfloat16*>(dq),
                          nullptr,
                          nullptr,
                          batch, heads, sq, skv, head_dim,
                          q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                          do_sb, do_ss, do_sh,
                          dq_sb, dq_ss, dq_sh, 0, 0, 0,
                          scale};
  return flash_bwd::launch_dq(device, a, stream);
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
