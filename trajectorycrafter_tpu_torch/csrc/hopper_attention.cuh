// The Hopper (sm_90a) attention main loops: the bf16 loop shared by
// csrc/flash_attention.cu (K1, K4, K5, K1b) and csrc/flash_maxpass.cu (K4b),
// and at the end of this file the PV-int8 loop of csrc/flash_pv8.cu (K6) and
// csrc/int8_flash_attention.cu (K7), built from the same pieces (TMA maps,
// the ring, the QK product, the q scaling).  The backward kernels of
// csrc/flash_attention_bwd.cu (K4-dkv, K4-dq) build their two loops from
// the pieces too: `make_map`, `load_tile`, `issue_qk` (also at 64 rows, the
// m64n64k16 form), `issue_pv`, the turn barriers.
//
// What bounds it on the H100: at the DiT shape (2 x 48 heads x 13,330 tokens
// x 64) one call does ~4.4 TFLOP against ~0.3 GB of q/k/v, so it is bound by
// the tensor cores (4.42 ms at 989 TFLOP/s) and, at head dim 64, almost as
// much by the SFU's exp2 (one per score: 4.08 ms), not by device memory.  A
// kernel near that bound has to keep the tensor cores fed from shared memory
// without any thread spending time on copies, and has to run the softmax of
// one tile while the tensor cores multiply another.  The design:
//
// - TMA.  q, k and v are read straight from the (B, S, H, D) layout the
//   projections produce, by the caller's strides, through one 4-D tensor map
//   per operand over (D, H, S, B).  A box is (64 columns, 1 head, 128 or 192
//   rows, 1 batch) with the 128-byte swizzle, the layout `wgmma` reads
//   without bank conflicts; at head dim 128 a tile is two such boxes side by
//   side.  The Perceiver's k and v, strided views of one projection, go
//   through as they are.  Rows past the sequence are zero-filled by the TMA
//   unit.
// - A K/V ring.  Two stages of K and two of V in shared memory, each with an
//   mbarrier pair (full: the TMA unit has landed the tile; empty: every
//   consumer warp is done with it).  One producer warp issues every load and
//   gives its registers to the consumers (`setmaxnreg`).
// - Consumer warpgroups of 64 query rows: three at head dim 64 (a 192-row
//   query tile), two at 128 (`Tiles`).  QK^T
//   is `wgmma` m64n128k16 with q and k both read from shared memory; PV is
//   `wgmma` m64nDk16 with P as bf16 A fragments taken straight from the
//   score accumulators (the fp32 accumulator layout of two 8-key column
//   blocks is the A fragment of one 16-key chunk) and V read from shared
//   memory as an MN-major B operand.  The row max and row sum stay in fp32
//   registers.
// - Overlap of the exps and the products.  Each warpgroup issues the QK of
//   tile j together with the PV of tile j - 1, then runs the softmax of tile
//   j while that PV is still in flight; and the warpgroups take turns
//   issuing their products (named barriers), so one's softmax runs while
//   the tensor cores work on the others' products.
// - The ragged edge is masked in the kernel: keys past Skv score -inf (or
//   are left out of the exp2 modes' sums) in the last key tile only, and
//   query rows past Sq are not stored.  The output is bf16 (B, Sq, H, D),
//   written by strides.
//
// The modes (the function each computes is stated in the .cu that binds it):
//   kExact    online running max (K1, K4);
//   kLse      kExact, and the natural-log logsumexp of each row (K5);
//   kExp2     fixed bias, no running max, q rounded to bf16 after the scale,
//             bf16 weights in both sums, optional clamp and key mask (K1b);
//   kMaxPass  pass 1 the exact row max, pass 2 exp2 attention against it,
//             q rounded as in kExp2 (K4b).
//
// Host side: the tensor maps are built per call with cuTensorMapEncodeTiled,
// fetched through cudaGetDriverEntryPoint, so the library needs neither
// -lcuda nor PyTorch's headers.  The mbarrier, TMA and `wgmma` wrappers and
// the descriptor are hopper.cuh's, shared with the int8 GEMM main loop.

#pragma once

#include <math.h>

#include "hopper.cuh"

namespace hopper_attn {

using namespace hopper;

constexpr int kBlockN = 128;                 // keys per K/V tile (ops/kernels.py ATTENTION_KEY_TILE)
constexpr int kBoxCols = 64;                 // bf16 columns of a 128-byte swizzled row
constexpr int kProducerRegs = 24;
constexpr float kMasked = -1e30f;            // score of a key past the end (kMaxPass)
constexpr float kExp2Clamp = 110.f;          // exp2 argument cap of kExp2
constexpr float kLn2 = 0.6931471805599453f;

// The block's shape at head dim D: consumer warpgroups of 64 query rows, K
// and V tiles in flight, registers per consumer thread (the producer
// warpgroup keeps kProducerRegs: 128 x 24 + 384 x 160 and 128 x 24 + 256 x
// 240 both fit the SM's 65,536).  At d 64 a consumer holds 64 score, 32
// output and 32 P registers, so three fit in 160 registers and the third
// hides more of the softmax; at d 128 the 64 output registers need 240.
// Two stages keep each K and V tile in flight a whole step ahead of its use.
template <int D>
struct Tiles {
  static constexpr int kConsumers = D == 64 ? 3 : 2;
  static constexpr int kStages = 2;
  static constexpr int kBlockM = 64 * kConsumers;  // query rows per block
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kConsumerRegs = kConsumers == 2 ? 240 : 160;
};

enum Mode { kExact = 0, kLse = 1, kExp2 = 2, kMaxPass = 3 };

// Named barriers (0 is __syncthreads): the consumers' turns at the tensor
// cores, then each consumer's own 128-thread barrier.
constexpr int kTurnBarrier = 1;
constexpr int kGroupBarrier = 8;

struct Params {
  __nv_bfloat16* o;
  long long o_sb, o_ss, o_sh;  // output strides in elements (batch, sequence, head)
  float* lse;                  // kLse: (batch * heads, sq)
  const uint8_t* kv_valid;     // kExp2: (skv,) 1 = a real key, or null = all
  int heads, sq, skv;
  float scale_log2;  // softmax scale * log2(e): scores live in the exp2 domain
  float bias;        // kExp2: subtracted from every score (bf16-rounded)
  int clamp;         // kExp2: cap the exp2 argument at 110
};

// Shared memory of one block.  An operand tile of R rows is D / 64 column
// halves of R rows x 128 bytes, each 1024-byte aligned (the 128-byte swizzle
// repeats every 8 rows).
template <int D>
struct Smem {
  static constexpr int kStages = Tiles<D>::kStages;
  __nv_bfloat16 q[Tiles<D>::kBlockM * D];
  __nv_bfloat16 k[kStages][kBlockN * D];
  __nv_bfloat16 v[kStages][kBlockN * D];
  uint64_t q_full;
  uint64_t k_full[kStages], k_empty[kStages];
  uint64_t v_full[kStages], v_empty[kStages];
};

// ---------------------------------------------------------------------------
// The bf16 products
// ---------------------------------------------------------------------------

#define HA_D8(i)                                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),            \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HA_D32 HA_D8(0), HA_D8(8), HA_D8(16), HA_D8(24)
#define HA_D64 HA_D32, HA_D8(32), HA_D8(40), HA_D8(48), HA_D8(56)

// d (64 x 128, fp32) (+)= A (64 x 16, shared) B (16 x 128, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : HA_D64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) (+)= A (64 x 16, shared) B (16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : HA_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 registers) B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, bf16 registers) B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HA_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef HA_D64
#undef HA_D32
#undef HA_D8

// 2^x on the SFU, one instruction (exp2f adds a subnormal range fix-up);
// results below 2^-126 flush to 0, far below a softmax weight that counts.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// The two products of one warpgroup
// ---------------------------------------------------------------------------

// S (64 x kRows) = q (the warpgroup's 64 rows of a kBlockM-row query tile)
// k^T (one tile of kRows keys, read K-major).  The backward kernels
// (csrc/flash_attention_bwd.cu) take it for every score-shaped product:
// their A is any resident kBlockM-row tile, their B any streamed tile.
template <int D, int kBlockM = Tiles<D>::kBlockM, int kRows = kBlockN>
__device__ __forceinline__ void issue_qk(float (&s)[kRows / 2], const __nv_bfloat16* q_wg,
                                         const __nv_bfloat16* k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int half = kk / 4, col = (kk % 4) * 16;  // 16 columns = 32 bytes into the row
    const uint64_t da = make_desc(q_wg + half * kBlockM * kBoxCols + col, 16, 1024);
    const uint64_t db = make_desc(k_tile + half * kRows * kBoxCols + col, 16, 1024);
    wgmma_ss(s, da, db, kk > 0);
  }
}

// O (64 x D) += P (64 x kRows, bf16 registers) V (one tile of kRows keys,
// read MN-major: LBO the distance between its 64-column halves).
template <int D, int kRows = kBlockN>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[kRows / 16][4],
                                         const __nv_bfloat16* v_tile) {
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {  // 16 keys = two 8-key groups = 2048 bytes
    const uint64_t db = make_desc(v_tile + kk * 16 * kBoxCols, kRows * 128, 1024);
    wgmma_rs(o, p[kk], db);
  }
}

// q * scale_log2 rounded to bf16 in place over warpgroup `me`'s 64 rows of a
// kBlockM-row query tile (an elementwise pass, blind to the swizzle); the
// proxy fence makes the generic-proxy stores visible to `wgmma`, and the
// warpgroup's barrier waits for all of its threads' stores.
template <int D, int kBlockM>
__device__ __forceinline__ void scale_rows(__nv_bfloat16* q, int me, int tid, float scale_log2) {
  constexpr int kVecs = 64 * kBoxCols / 8;  // 16-byte vectors per half
#pragma unroll
  for (int half = 0; half < D / kBoxCols; ++half) {
    uint4* base = reinterpret_cast<uint4*>(q + half * kBlockM * kBoxCols + me * 64 * kBoxCols);
#pragma unroll
    for (int i = tid; i < kVecs; i += 128) {
      uint4 x = base[i];
      uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
        w[e] = pack_bf16(f.x * scale_log2, f.y * scale_log2);
      }
      base[i] = x;
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(kGroupBarrier + me, 128);
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// Per-thread view of a 64 x N accumulator: register i holds row
// r0 + 8 * ((i >> 1) & 1) and column 8 * (i / 4) + 2 * t + (i & 1), with
// r0 = 16 * warp + lane / 4 and t = lane % 4.
__device__ __forceinline__ int acc_row(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int acc_col(int i, int t) { return 8 * (i / 4) + 2 * t + (i & 1); }

template <int D, int kRows>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row, int h, int b) {
#pragma unroll
  for (int c = 0; c < D / kBoxCols; ++c) {
    tma_load_4d(dst + c * kRows * kBoxCols, map, bar, c * kBoxCols, h, row, b);
  }
}

// A consumer warpgroup's state and steps.
template <int D, int kMode>
struct Consumer {
  static constexpr int kConsumers = Tiles<D>::kConsumers;
  static constexpr int kStages = Tiles<D>::kStages;
  static constexpr int kBlockM = Tiles<D>::kBlockM;
  Smem<D>& sm;
  const Params& p;
  int me;          // 0 .. kConsumers - 1
  int lane, t;     // lane % 4
  int kc, vc;      // tiles of the K and V rings consumed so far
  const __nv_bfloat16* q_wg;
  float m[2], l[2];  // running max (or fixed offset) and this thread's row sums
  float o[D / 2];
  uint32_t pf[kBlockN / 16][4];

  __device__ __forceinline__ Consumer(Smem<D>& sm_, const Params& p_, int me_, int tid)
      : sm(sm_), p(p_), me(me_), lane(tid % 32), t(tid % 4), kc(0), vc(0),
        q_wg(sm_.q + me_ * 64 * kBoxCols) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    l[0] = l[1] = 0.f;
    m[0] = m[1] = (kMode == kExp2) ? p_.bias : -1e30f;  // finite: exp2(old - new) is 0, not NaN
  }

  __device__ __forceinline__ void wait_k() {
    mbar_wait(&sm.k_full[kc % kStages], (kc / kStages) & 1);
  }
  __device__ __forceinline__ void release_k() {
    if (lane == 0) mbar_arrive(&sm.k_empty[kc % kStages]);
    ++kc;
  }
  __device__ __forceinline__ void wait_v() {
    mbar_wait(&sm.v_full[vc % kStages], (vc / kStages) & 1);
  }
  __device__ __forceinline__ void release_v() {
    if (lane == 0) mbar_arrive(&sm.v_empty[vc % kStages]);
    ++vc;
  }
  __device__ __forceinline__ const __nv_bfloat16* k_tile() const { return sm.k[kc % kStages]; }
  __device__ __forceinline__ const __nv_bfloat16* v_tile() const { return sm.v[vc % kStages]; }

  // kExp2 and kMaxPass: q * scale * log2(e) rounded to bf16 in place.
  __device__ __forceinline__ void scale_q(int tid) {
    scale_rows<D, kBlockM>(sm.q, me, tid, p.scale_log2);
  }

  // Valid-key bits of the tile at n0 for kExp2's mask: word w, bit b is key
  // n0 + 32 w + b, read once per tile (each lane one byte of each word).
  __device__ __forceinline__ void key_bytes(int n0, uint32_t (&mask)[4]) const {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int key = n0 + 32 * w + lane;
      mask[w] = key < p.skv && (p.kv_valid == nullptr || p.kv_valid[key]);
    }
  }

  // The softmax of the scores in s for the key tile at n0, in place:
  // s becomes the weights (fp32, or bf16-rounded in the exp2 modes) and the
  // row sums take them in; returns the factor the accumulated output of the
  // earlier tiles must be multiplied by (1 in the fixed-offset modes).
  __device__ __forceinline__ void softmax(float (&s)[64], int n0, const uint32_t (&mask)[4],
                                          float (&corr)[2]) {
    const int limit = p.skv - n0;  // keys of this tile inside the sequence
    if (kMode == kExact || kMode == kLse) {
      // two partial maxima and sums per row shorten the dependent chains
      float part[2][2];
      if (limit < kBlockN) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          if (acc_col(i, t) >= limit) s[i] = -INFINITY;
        }
      }
      part[0][0] = part[0][1] = part[1][0] = part[1][1] = -INFINITY;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        float& x = part[acc_row(i)][(i / 4) & 1];
        x = fmaxf(x, s[i]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // the 4 lanes of a quad share a row
        float mx = fmaxf(part[r][0], part[r][1]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx * p.scale_log2);
        corr[r] = exp2_ftz(m[r] - m_new);
        m[r] = m_new;
      }
      part[0][0] = part[0][1] = part[1][0] = part[1][1] = 0.f;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        s[i] = exp2_ftz(fmaf(s[i], p.scale_log2, -m[acc_row(i)]));
        part[acc_row(i)][(i / 4) & 1] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], corr[r], part[r][0] + part[r][1]);
    } else {
      // fixed offset: kExp2's bias, kMaxPass's exact row max (all args <= 0).
      // Keys past the end, or marked invalid (kExp2), weigh 0; only a tile
      // that holds such keys pays for the per-key test.
      const bool check = kMode == kExp2 ? (p.kv_valid != nullptr || limit < kBlockN)
                                        : limit < kBlockN;
      uint32_t bits[4] = {~0u, ~0u, ~0u, ~0u};
      if (check) {
#pragma unroll
        for (int w = 0; w < 4; ++w) bits[w] = __ballot_sync(0xffffffffu, mask[w] != 0);
      }
      // the same ballots in every lane: the branch is uniform
      if ((bits[0] & bits[1] & bits[2] & bits[3]) == ~0u) {
        fixed_weights<false>(s, bits);
      } else {
        fixed_weights<true>(s, bits);
      }
      corr[0] = corr[1] = 1.f;
    }
  }

  // The weights of the fixed-offset modes in place, rounded to bf16 (the
  // row sums add the rounded weights, as the PV product takes them).  With
  // kMask, column acc_col(i, t) weighs 0 unless bit 8 (i / 4 % 4) + 2 t +
  // (i & 1) of bits[i / 16] is set.  exp2 on the SFU flushes weights below
  // 2^-126 to 0; they count only in a row whose every weight lies there.
  template <bool kMask>
  __device__ __forceinline__ void fixed_weights(float (&s)[64], const uint32_t (&bits)[4]) {
    float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int i = 0; i < 64; i += 2) {  // i, i + 1: one row, adjacent columns
      const int r = acc_row(i);
      float a0 = s[i] - m[r], a1 = s[i + 1] - m[r];
      if (kMode == kExp2 && p.clamp) {
        a0 = fminf(a0, kExp2Clamp);
        a1 = fminf(a1, kExp2Clamp);
      }
      float e0 = exp2_ftz(a0), e1 = exp2_ftz(a1);
      if (kMask) {
        const uint32_t w = bits[i / 16] >> (8 * (i / 4 % 4) + 2 * t);
        e0 = (w & 1u) ? e0 : 0.f;
        e1 = (w & 2u) ? e1 : 0.f;
      }
      const uint32_t pair = pack_bf16(e0, e1);
      s[i] = __uint_as_float(pair << 16);
      s[i + 1] = __uint_as_float(pair & 0xffff0000u);
      part[r][(i / 4) & 1] += s[i] + s[i + 1];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] += part[r][0] + part[r][1];
  }

  // P for the PV product: the accumulators of column blocks 2kk and 2kk + 1
  // are the A fragment of 16-key chunk kk.
  __device__ __forceinline__ void pack_p(const float (&s)[64]) {
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pf[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
    }
  }

  __device__ __forceinline__ void rescale(const float (&corr)[2]) {
    if (kMode == kExact || kMode == kLse) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[acc_row(i)];
    }
  }

  // kMaxPass pass 1: the row max of the scaled scores over the valid keys,
  // with the same products the second pass runs.
  __device__ __forceinline__ void row_max_pass(int n_tiles) {
    float mx[2] = {kMasked, kMasked};
    float s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    for (int j = 0; j < n_tiles; ++j) {
      const int limit = p.skv - j * kBlockN;
      wait_k();
      fence_regs(s);
      wgmma_fence();
      issue_qk<D>(s, q_wg, k_tile());
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      release_k();
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const float x = (limit < kBlockN && acc_col(i, t) >= limit) ? kMasked : s[i];
        mx[acc_row(i)] = fmaxf(mx[acc_row(i)], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      m[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
  }

  // One key tile of the main loop: the QK of tile j and (kWithPv) the PV of
  // tile j - 1 issued together in this warpgroup's turn, then the softmax of
  // tile j while the PV runs.  The register fences before `wgmma.fence`
  // finish every write to the operands first, so the compiler adds no fence
  // of its own.
  template <bool kWithPv>
  __device__ __forceinline__ void step(int j, int n_tiles, float (&s)[64]) {
    const int turn = kTurnBarrier + me, next = kTurnBarrier + (me + 1) % kConsumers;
    const int pair = 128 * 2;  // a turn barrier joins this warpgroup and the one before
    const int n0 = j * kBlockN;
    uint32_t mask[4] = {1u, 1u, 1u, 1u};
    float corr[2];
    if (kMode == kExp2 || kMode == kMaxPass) key_bytes(n0, mask);
    wait_k();
    if (kWithPv) wait_v();
    named_sync(turn, pair);
    fence_regs(s);
    fence_regs(o);
    fence_regs(pf);
    wgmma_fence();
    issue_qk<D>(s, q_wg, k_tile());
    wgmma_commit();
    if (kWithPv) issue_pv<D>(o, pf, v_tile());
    wgmma_commit();
    // hand the turn on; the last consumer's last turn has no successor
    if (!(me == kConsumers - 1 && j == n_tiles - 1)) named_arrive(next, pair);
    wgmma_wait<1>();
    fence_regs(s);
    release_k();
    softmax(s, n0, mask, corr);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pf);
    if (kWithPv) release_v();
    rescale(corr);
    pack_p(s);
  }

  __device__ __forceinline__ void attend(int n_tiles) {
    // the turns go round; the first consumer goes first
    if (me == kConsumers - 1) named_arrive(kTurnBarrier, 128 * 2);
    float s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    step<false>(0, n_tiles, s);
    for (int j = 1; j < n_tiles; ++j) step<true>(j, n_tiles, s);
    wait_v();
    fence_regs(o);
    fence_regs(pf);
    wgmma_fence();
    issue_pv<D>(o, pf, v_tile());
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pf);
    release_v();
  }

  // Full row sums over the quad, normalise, store bf16 pairs (and kLse's lse).
  __device__ __forceinline__ void store(int row0, int b, int h) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (kMode != kExact) l[r] = fmaxf(l[r], 1e-30f);
    }
    const int rows[2] = {row0, row0 + 8};
    if (kMode == kLse && t == 0) {
      float* lse = p.lse + static_cast<long long>(b * p.heads + h) * p.sq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] < p.sq) lse[rows[r]] = m[r] * kLn2 + logf(l[r]);
      }
    }
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    __nv_bfloat16* out = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= p.sq) continue;
      __nv_bfloat16* row = out + rows[r] * p.o_ss;
#pragma unroll
      for (int jd = 0; jd < D / 8; ++jd) {
        *reinterpret_cast<uint32_t*>(row + 8 * jd + 2 * t) =
            pack_bf16(o[4 * jd + 2 * r] * inv[r], o[4 * jd + 2 * r + 1] * inv[r]);
      }
    }
  }
};

template <int D, int kMode>
__global__ void __launch_bounds__(Tiles<D>::kThreads, 1)
attention_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, const __grid_constant__ Params p) {
  static_assert(D % kBoxCols == 0, "head dim must be a multiple of 64");
  constexpr int kConsumers = Tiles<D>::kConsumers;
  constexpr int kStages = Tiles<D>::kStages;
  constexpr int kBlockM = Tiles<D>::kBlockM;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern follows the address bits: align the tiles to 1024
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw + pad);

  // the warpgroup index through a shuffle, which the compiler knows to be
  // uniform across the warp: the role branches below then hold no divergence
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  const int tid = threadIdx.x % 128;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int m0 = blockIdx.x * kBlockM;
  const int n_tiles = (p.skv + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&sm.k_full[i], 1);
      mbar_init(&sm.v_full[i], 1);
      mbar_init(&sm.k_empty[i], 4 * kConsumers);  // one arrival per consumer warp
      mbar_init(&sm.v_empty[i], 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      constexpr uint32_t kTileBytes = kBlockN * D * sizeof(__nv_bfloat16);
      mbar_expect_tx(&sm.q_full, kBlockM * D * sizeof(__nv_bfloat16));
      load_tile<D, kBlockM>(sm.q, &q_map, &sm.q_full, m0, h, b);
      int kl = 0, vl = 0;  // tiles issued into each ring
      const int passes = kMode == kMaxPass ? 2 : 1;
      for (int pass = 0; pass < passes; ++pass) {
        const bool with_v = pass == passes - 1;
        for (int j = 0; j < n_tiles; ++j) {
          int st = kl % kStages;
          mbar_wait(&sm.k_empty[st], ((kl / kStages) & 1) ^ 1);
          mbar_expect_tx(&sm.k_full[st], kTileBytes);
          load_tile<D, kBlockN>(sm.k[st], &k_map, &sm.k_full[st], j * kBlockN, h, b);
          ++kl;
          if (with_v) {
            st = vl % kStages;
            mbar_wait(&sm.v_empty[st], ((vl / kStages) & 1) ^ 1);
            mbar_expect_tx(&sm.v_full[st], kTileBytes);
            load_tile<D, kBlockN>(sm.v[st], &v_map, &sm.v_full[st], j * kBlockN, h, b);
            ++vl;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Tiles<D>::kConsumerRegs));
    Consumer<D, kMode> c(sm, p, wg - 1, tid);
    mbar_wait(&sm.q_full, 0);
    if (kMode == kExp2 || kMode == kMaxPass) c.scale_q(tid);
    if (kMode == kMaxPass) c.row_max_pass(n_tiles);
    c.attend(n_tiles);
    c.store(m0 + (wg - 1) * 64 + 16 * (tid / 32) + (tid % 32) / 4, b, h);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The caller's arguments: bf16 (B, S, H, D) q, k, v and output, strides in
// elements over (batch, sequence, head), the head dim dense.
struct Args {
  const void *q, *k, *v;
  void* o;
  int batch, heads, sq, skv, head_dim;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  float scale;
  float* lse;
  const uint8_t* kv_valid;
  float bias;
  int clamp;
};

// A 4-D tiled map over (D, H, S, B) of a (B, S, H, D) tensor of Elem (bf16,
// or the int8 codes as bytes); a box is one swizzled row of the head dim
// (64 bf16 columns, or D bytes: 64 with the 64-byte swizzle, 128 with the
// 128-byte one) x 1 head x `rows` rows x 1 batch; rows past S read as zero.
template <typename Elem = __nv_bfloat16>
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int batch, int seq, int heads,
                            int d, long long sb, long long ss, long long sh, int rows) {
  constexpr int kBytes = sizeof(Elem);
  EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int box_bytes = d * kBytes < 128 ? d * kBytes : 128;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * kBytes,
                                 static_cast<cuuint64_t>(ss) * kBytes,
                                 static_cast<cuuint64_t>(sb) * kBytes};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_bytes / kBytes), 1u,
                             static_cast<cuuint32_t>(rows), 1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  const CUresult r = encode(
      map, kBytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
      const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, int kMode>
cudaError_t launch_d(const Args& a, cudaStream_t stream) {
  constexpr int kBlockM = Tiles<D>::kBlockM;
  CUtensorMap qm, km, vm;
  cudaError_t err = make_map(&qm, a.q, a.batch, a.sq, a.heads, D, a.q_sb, a.q_ss, a.q_sh, kBlockM);
  if (err == cudaSuccess)
    err = make_map(&km, a.k, a.batch, a.skv, a.heads, D, a.k_sb, a.k_ss, a.k_sh, kBlockN);
  if (err == cudaSuccess)
    err = make_map(&vm, a.v, a.batch, a.skv, a.heads, D, a.v_sb, a.v_ss, a.v_sh, kBlockN);
  if (err != cudaSuccess) return err;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(a.o);
  p.o_sb = a.o_sb;
  p.o_ss = a.o_ss;
  p.o_sh = a.o_sh;
  p.lse = a.lse;
  p.kv_valid = a.kv_valid;
  p.heads = a.heads;
  p.sq = a.sq;
  p.skv = a.skv;
  p.scale_log2 = a.scale * 1.4426950408889634f;
  p.bias = a.bias;
  p.clamp = a.clamp;
  const int smem = static_cast<int>(sizeof(Smem<D>)) + 1024;  // + the alignment pad
  err = cudaFuncSetAttribute(attention_kernel<D, kMode>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + kBlockM - 1) / kBlockM, a.batch * a.heads);
  attention_kernel<D, kMode><<<grid, Tiles<D>::kThreads, smem, stream>>>(qm, km, vm, p);
  return cudaGetLastError();
}

// Launch on `stream` of `device`; returns the cudaError_t (0 = success).
template <int kMode>
int launch(int device, const Args& a, void* stream) {
  // make the caller's device current for this runtime, as PyTorch has it
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.head_dim == 64) return static_cast<int>(launch_d<64, kMode>(a, s));
  if (a.head_dim == 128) return static_cast<int>(launch_d<128, kMode>(a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}


// ---------------------------------------------------------------------------
// The PV-int8 loop (K6, csrc/flash_pv8.cu; K7, csrc/int8_flash_attention.cu)
// ---------------------------------------------------------------------------
//
// The functions are stated in flash_pv8.cu and int8_flash_attention.cu.
// Their softmax weights are int8 codes quantized against the row max of
// their key block, so the block's max must be known before any of its
// codes: each block of `block_k` keys makes two passes over its 128-key
// tiles, the same QK `wgmma` sequence in both (bit-equal scores).  Pass 1
// keeps only the row max.  Pass 2 turns the scores into codes in registers,
// takes the block's row sums (K6: the exact int32 sum of the codes; K7: the
// fp32 sum of the weights before quantization), and runs PV as `wgmma`
// m64nDk32 s8 with the codes as the A operand from registers and the int8
// V^T tile (D rows x 128 keys, K-major) from shared memory.  After the
// block, its sums are folded into the fp32 output and denominator.
//
// The loop is templated on the kind of QK (`Qk`):
//   kBf16 (K6)  q' (bf16, scaled by scale * log2 e in shared memory) k^T,
//               `wgmma` m64n128k16 into fp32 scores of the exp2 domain;
//   kS8   (K7)  q8 k8^T, `wgmma` m64n128k32 s8 into int32 scores, both
//               operands read from shared memory (K-major).  A row of D
//               int8 columns is one TMA box: 64 bytes with the 64-byte
//               swizzle at d 64 (the descriptors say so: SBO 512, layout
//               kSwizzle64), 128 bytes with the 128-byte swizzle at d 128.
//               Pass 1 takes the row max on the int32 scores and converts it
//               once per row; pass 2 converts each score exactly by an add
//               of 1.5 x 2^23 (I2F would run at the SFU's rate beside the
//               exp), so each score costs one SFU operation, its exp.
//
// The codes' register layout.  The score accumulator gives a thread keys
// 8j + 2t + {0, 1} of each 8-key column block j; an s8 A fragment for k32
// wants keys 4t..4t+3 (a0, a1) and 16+4t..16+4t+3 (a2, a3) of its 32-key
// chunk.  Rather than permute bytes across the quad, the A fragment is built
// from the keys the thread holds, in the order 2t, 2t+1, 8+2t, 9+2t (and 16
// on for a2, a3), and V^T's keys are laid out in the same order inside each
// 32-key chunk by the caller (ops/attention_variants.py pv8_keys_last): the
// int32 sums are exact under any key order, so this costs nothing.
//
// Consumer warpgroups of 64 rows: three at head dim 64 (a 192-row query
// tile), two at 128.  Pass 2 holds 64 score, D / 2 int32 and 16 code
// registers; the fp32 output numerator is folded once per key block, so it
// stays in shared memory, and three warpgroups fit in 160 registers each at
// d 64, as the bf16 loop's do.  Each issues the QK of tile j with the PV of
// tile j - 1 and quantizes tile j while that PV runs, as the bf16 loop does,
// but without its turns: the warpgroups' products interleave as they come,
// and the ring (3 stages at d 64) lets one run ahead of another.  Measured
// on an H100 (tools/flash_pv8_ab.py): dropping the turns and a third stage
// ran K6 at the DiT shape 4.7% faster, a third warpgroup 8.4% more.

namespace pv8 {

// The block's shape at head dim D: consumer warpgroups of 64 rows, their
// registers (128 x 24 + 384 x 160 and 128 x 24 + 256 x 240 both fit the
// SM's 65,536), and the stages of the K / V^T ring.
template <int D>
struct Geometry {
  static constexpr int kConsumers = D == 64 ? 3 : 2;
  static constexpr int kBlockM = 64 * kConsumers;  // query rows per block
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 240;
  static constexpr int kStages = D == 64 ? 3 : 2;
};
constexpr int kChunks = kBlockN / 32;     // 32-key chunks of a key tile
constexpr float kClamp = 88.f;            // K6's exp2 argument cap: 2^88 x int32 sums < fp32 max
constexpr float kLog2_127 = 6.988684686772166f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kRound = 12582912.f;      // 1.5 x 2^23: x + kRound rounds x to an integer
constexpr int kRoundBits = 0x4B400000;    // the bits of kRound
constexpr int kMaskedInt = -(1 << 30);    // K7's int32 score of a key past the end

enum Qk { kBf16 = 0, kS8 = 1 };

// Per kind of QK: the operand element, the score accumulator, and the row
// sum pass 2 takes (K6: the count of codes; K7: the sum of the weights).
template <int kQk>
struct QkTypes;
template <>
struct QkTypes<kBf16> {
  using Elem = __nv_bfloat16;
  using Score = float;
  using Sum = int;
};
template <>
struct QkTypes<kS8> {
  using Elem = uint8_t;
  using Score = int;
  using Sum = float;
};

struct Params {
  __nv_bfloat16* o;
  long long o_sb, o_ss, o_sh;  // output strides in elements (batch, sequence, head)
  const float* vs;             // (batch * heads,) K6: the V scales; K7: vs / 127
  const float* logit;          // K7: (batch * heads,) qs * ks * softmax scale
  int heads, sq, skv;
  int block_tiles;             // 128-key tiles per quantization block
  float scale_log2;            // K6: softmax scale * log2 e
};

template <int D, int kQk>
struct Smem {
  using Elem = typename QkTypes<kQk>::Elem;
  static constexpr int kStages = Geometry<D>::kStages;
  Elem q[Geometry<D>::kBlockM * D];
  Elem k[kStages][kBlockN * D];
  uint8_t vt[kStages][D * kBlockN];  // D rows of 128 keys, 128-byte swizzled
  // each consumer thread's fp32 output numerator, register i of the
  // accumulator layout at [i][thread]: folded once per key block, so it
  // needs no registers
  float acc[Geometry<D>::kConsumers][D / 2][128];
  uint64_t q_full;
  uint64_t k_full[kStages], k_empty[kStages];
  uint64_t v_full[kStages], v_empty[kStages];
};

#define PV_D8(i)                                                                         \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),            \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define PV_D32 PV_D8(0), PV_D8(8), PV_D8(16), PV_D8(24)
#define PV_D64 PV_D32, PV_D8(32), PV_D8(40), PV_D8(48), PV_D8(56)

// d (64 x 64, int32) (+)= A (64 x 32, s8 registers) B (64 x 32, s8, shared, K-major)
__device__ __forceinline__ void wgmma_rs_s8(int (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : PV_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (64 x 128, int32) (+)= A (64 x 32, s8 registers) B (128 x 32, s8, shared, K-major)
__device__ __forceinline__ void wgmma_rs_s8(int (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : PV_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

#undef PV_D64
#undef PV_D32
#undef PV_D8

// S (64 x 128, int32) = q8 (the warpgroup's 64 rows) k8^T (one key tile):
// rows of D bytes, swizzled at 64 bytes (d 64) or 128 (d 128).
template <int D>
__device__ __forceinline__ void issue_qk_s8(int (&s)[64], const uint8_t* q_wg,
                                            const uint8_t* k_tile) {
  constexpr uint64_t kSwizzle = D == 64 ? kSwizzle64 : kSwizzle128;
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {  // 32 bytes of the row per k step
    wgmma_s8(s, make_desc(q_wg + 32 * kk, 16, 8 * D, kSwizzle),
             make_desc(k_tile + 32 * kk, 16, 8 * D, kSwizzle), kk > 0);
  }
}

// `rows` rows of q or k from row `row` of head h, batch b: K6's bf16 as
// 64-column boxes side by side, K7's D bytes as one box.
template <int D, int kQk, int kRows>
__device__ __forceinline__ void load_rows(typename QkTypes<kQk>::Elem* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row, int h, int b) {
  if constexpr (kQk == kS8) {
    tma_load_4d(dst, map, bar, 0, h, row, b);
  } else {
    load_tile<D, kRows>(dst, map, bar, row, h, b);
  }
}

// The score of a key past the end in pass 1, of each kind.
__device__ __forceinline__ constexpr float masked_score(float) { return kMasked; }
__device__ __forceinline__ constexpr int masked_score(int) { return kMaskedInt; }
__device__ __forceinline__ float larger(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int larger(int a, int b) { return max(a, b); }
__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t bits(int x) { return static_cast<uint32_t>(x); }

// Bytes 0 of four registers, in order, as one register.
__device__ __forceinline__ uint32_t low_bytes(uint32_t b0, uint32_t b1, uint32_t b2, uint32_t b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040), 0x5410);
}

// What pass 1 gives pass 2 and the fold, per row: the exp2 offset of the
// block's weights (K6: m_adj; K7: m_new log2 e, rounded up so that no weight
// exceeds 1) and K7's rescale of the earlier blocks' sums, exp(m - m_new).
struct BlockStat {
  float offset[2];
  float alpha[2];
};

template <int D, int kQk>
struct Consumer {
  using Elem = typename QkTypes<kQk>::Elem;
  using Score = typename QkTypes<kQk>::Score;
  using Sum = typename QkTypes<kQk>::Sum;
  static constexpr bool kInt8Qk = kQk == kS8;
  static constexpr int kBlockM = Geometry<D>::kBlockM;
  static constexpr int kStages = Geometry<D>::kStages;
  Smem<D, kQk>& sm;
  const Params& p;
  int me;          // 0 .. kConsumers - 1
  int lane, t;     // lane % 4
  int kc, vc;      // tiles of the K and V rings consumed so far
  const Elem* q_wg;
  float* acc;        // this thread's output numerator in shared memory, stride 128
  float den[2];      // this thread's two rows' denominators (full over the quad)
  float m[2];        // K7: the rows' running max
  float logit, l2;   // K7: qs * ks * scale, and it times log2 e
  float v127;        // K7: vs / 127
  int pv[D / 2];     // the int32 PV sums of the block in flight
  uint32_t pf[kChunks][4];  // the codes of one key tile as s8 A fragments

  // q_wg: the warpgroup's 64 rows (of each 64-column half for bf16)
  __device__ __forceinline__ Consumer(Smem<D, kQk>& sm_, const Params& p_, int me_, int tid, int bh)
      : sm(sm_), p(p_), me(me_), lane(tid % 32), t(tid % 4), kc(0), vc(0),
        q_wg(sm_.q + me_ * 64 * (kInt8Qk ? D : kBoxCols)), acc(&sm_.acc[me_][0][tid]) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      acc[128 * i] = 0.f;
      pv[i] = 0;
    }
    den[0] = den[1] = 0.f;
    m[0] = m[1] = -1e30f;  // finite: exp(m - m_new) of the first block is 0, not NaN
    if constexpr (kInt8Qk) {
      logit = p_.logit[bh];
      l2 = __fmul_rn(logit, kLog2e);
      v127 = p_.vs[bh];
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) pf[c][0] = pf[c][1] = pf[c][2] = pf[c][3] = 0u;
  }

  __device__ __forceinline__ void wait_k() {
    mbar_wait(&sm.k_full[kc % kStages], (kc / kStages) & 1);
  }
  __device__ __forceinline__ void release_k() {
    if (lane == 0) mbar_arrive(&sm.k_empty[kc % kStages]);
    ++kc;
  }
  __device__ __forceinline__ void wait_v() {
    mbar_wait(&sm.v_full[vc % kStages], (vc / kStages) & 1);
  }
  __device__ __forceinline__ void release_v() {
    if (lane == 0) mbar_arrive(&sm.v_empty[vc % kStages]);
    ++vc;
  }

  // s = the QK of the warpgroup's rows and the K tile in flight.
  __device__ __forceinline__ void qk(Score (&s)[64]) {
    if constexpr (kInt8Qk) {
      issue_qk_s8<D>(s, q_wg, sm.k[kc % kStages]);
    } else {
      issue_qk<D, kBlockM>(s, q_wg, sm.k[kc % kStages]);
    }
  }

  // pv (+)= the codes in pf x the V^T tile in flight.
  __device__ __forceinline__ void issue_pv(int accumulate) {
    const uint8_t* vt = sm.vt[vc % kStages];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      wgmma_rs_s8(pv, pf[c], make_desc(vt + 32 * c, 16, 1024), c > 0 || accumulate);
    }
  }

  // Pass 1 over tiles [t0, t1): the row max of the scores over the valid
  // keys, then the block's statistics.  K6: m_adj = max(min(max, 88) - log2
  // 127, -88).  K7: the int32 max x converted once (exact: |x| < 2^22), m_new
  // = max(m, x * logit) -- logit > 0, so this is the max of the rounded
  // products -- alpha = exp(m - m_new), and the offset max(x * l2 rounded
  // up, m * log2 e) >= every key's x * l2.
  __device__ __forceinline__ BlockStat row_max(int t0, int t1, Score (&s)[64]) {
    constexpr Score kNone = masked_score(Score());
    Score mx[2] = {kNone, kNone};
    for (int j = t0; j < t1; ++j) {
      const int limit = p.skv - j * kBlockN;
      wait_k();
      fence_regs(s);
      wgmma_fence();
      qk(s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      release_k();
      if (limit < kBlockN) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          if (acc_col(i, t) >= limit) s[i] = kNone;
        }
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) mx[acc_row(i)] = larger(mx[acc_row(i)], s[i]);
    }
    BlockStat st;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = larger(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = larger(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if constexpr (kInt8Qk) {
        const float x = __int2float_rn(mx[r]);
        const float m_new = fmaxf(m[r], __fmul_rn(x, logit));
        st.alpha[r] = expf(__fsub_rn(m[r], m_new));
        st.offset[r] = fmaxf(__fmul_ru(x, l2), __fmul_rn(m[r], kLog2e));
        m[r] = m_new;
      } else {
        st.offset[r] = fmaxf(__fsub_rn(fminf(mx[r], kClamp), kLog2_127), -kClamp);
        st.alpha[r] = 1.f;
      }
    }
    return st;
  }

  // K6: the codes rint(exp2(min(s, 88) - m_adj)) of the scores in s, in
  // place (as int bits), 0 past the end; their sums into psum.  rint is
  // taken by adding 1.5 x 2^23 (round half to even, as rintf; the codes are
  // < 2^22).
  __device__ __forceinline__ void codes(float (&s)[64], int limit, const float (&m_adj)[2],
                                        int (&psum)[2]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const float e = exp2_ftz(__fsub_rn(fminf(s[i], kClamp), m_adj[acc_row(i)]));
      s[i] = __int_as_float(__float_as_int(__fadd_rn(e, kRound)) - kRoundBits);
    }
    if (limit < kBlockN) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if (acc_col(i, t) >= limit) s[i] = __int_as_float(0);
      }
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) psum[acc_row(i)] += __float_as_int(s[i]);
  }

  // K7: the weights p = exp2(x * l2 - offset) of the int32 scores x in s
  // (x converted exactly: 1.5 x 2^23 + x has the bits kRoundBits + x for
  // |x| < 2^22), 0 past the end (kRagged); their fp32 sums into psum; the
  // codes rint(127 p) in place as the bits of 1.5 x 2^23 + code, whose byte
  // 0 is the code (one fused multiply-add: 127 p rounded once, half to even).
  template <bool kRagged>
  __device__ __forceinline__ void weights(int (&s)[64], int limit, const float (&offset)[2],
                                          float (&psum)[2]) {
    float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // two partial sums a row: shorter chains
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = acc_row(i);
      const float x = __fsub_rn(__int_as_float(s[i] + kRoundBits), kRound);
      float e = exp2_ftz(fmaf(x, l2, -offset[r]));
      if (kRagged && acc_col(i, t) >= limit) e = 0.f;
      part[r][(i / 4) & 1] += e;
      s[i] = __float_as_int(fmaf(e, 127.f, kRound));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) psum[r] += part[r][0] + part[r][1];
  }

  // The A fragments of the tile's codes: chunk c is column blocks 4c..4c+3;
  // a0 / a1 the thread's keys 2t, 2t+1, 8+2t, 9+2t of rows r0 / r0 + 8, a2 /
  // a3 the same 16 keys on.
  __device__ __forceinline__ void pack(const Score (&s)[64]) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const Score* x = s + 16 * c;
#pragma unroll
      for (int h = 0; h < 2; ++h) {      // keys 0..15 / 16..31 of the chunk
#pragma unroll
        for (int r = 0; r < 2; ++r) {    // row r0 / r0 + 8
          const Score* y = x + 8 * h + 2 * r;
          pf[c][2 * h + r] = low_bytes(bits(y[0]), bits(y[1]), bits(y[4]), bits(y[5]));
        }
      }
    }
  }

  // One tile j of pass 2: its QK issued (kWithPv: with the PV of tile j - 1,
  // which accumulates unless j - 1 starts the block), its codes taken while
  // the PV runs, then packed for its own PV.
  template <bool kWithPv>
  __device__ __forceinline__ void pv_step(int j, int accumulate, Score (&s)[64],
                                          const float (&offset)[2], Sum (&psum)[2]) {
    wait_k();
    if (kWithPv) wait_v();
    fence_regs(s);
    fence_regs(pv);
    fence_regs(pf);
    wgmma_fence();
    qk(s);
    wgmma_commit();
    if (kWithPv) issue_pv(accumulate);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
    release_k();
    const int limit = p.skv - j * kBlockN;
    if constexpr (kInt8Qk) {
      if (limit < kBlockN) {
        weights<true>(s, limit, offset, psum);
      } else {
        weights<false>(s, limit, offset, psum);
      }
    } else {
      codes(s, limit, offset, psum);
    }
    wgmma_wait<0>();
    fence_regs(pv);
    fence_regs(pf);
    if (kWithPv) release_v();
    pack(s);
  }

  // Pass 2 over tiles [t0, t1) and the block's fold, in the plain version's
  // order with each fp32 operation rounded on its own.  K6: acc += float(pv)
  // * exp2(m_adj), den += float(127 sum p8) * exp2(m_adj).  K7: acc = acc *
  // alpha + float(pv) * (vs / 127), den = den * alpha + sum p.
  __device__ __forceinline__ void block_pv(int t0, int t1, Score (&s)[64], const BlockStat& st) {
    Sum psum[2] = {0, 0};
    pv_step<false>(t0, 0, s, st.offset, psum);
    for (int j = t0 + 1; j < t1; ++j) pv_step<true>(j, j - 1 > t0, s, st.offset, psum);
    wait_v();
    fence_regs(pv);
    fence_regs(pf);
    wgmma_fence();
    issue_pv(t1 - 1 > t0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pv);
    fence_regs(pf);
    release_v();
    float w[2];  // the weight of this block's int32 sums
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      Sum n = psum[r];
      n += __shfl_xor_sync(0xffffffffu, n, 1);
      n += __shfl_xor_sync(0xffffffffu, n, 2);
      if constexpr (kInt8Qk) {
        w[r] = v127;
        den[r] = __fadd_rn(__fmul_rn(den[r], st.alpha[r]), n);
      } else {
        w[r] = exp2f(st.offset[r]);
        den[r] = __fadd_rn(den[r], __fmul_rn(__int2float_rn(127 * n), w[r]));
      }
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      const float add = __fmul_rn(__int2float_rn(pv[i]), w[acc_row(i)]);
      const float old = kInt8Qk ? __fmul_rn(acc[128 * i], st.alpha[acc_row(i)]) : acc[128 * i];
      acc[128 * i] = __fadd_rn(old, add);
    }
  }

  __device__ __forceinline__ void attend(int n_tiles) {
    Score s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0;
    for (int t0 = 0; t0 < n_tiles; t0 += p.block_tiles) {
      const int t1 = min(t0 + p.block_tiles, n_tiles);
      const BlockStat st = row_max(t0, t1, s);
      block_pv(t0, t1, s, st);
    }
  }

  // bf16 pairs of K6's acc / max(den, 1e-30) * (127 vs), or K7's acc /
  // max(den, 1e-20).
  __device__ __forceinline__ void store(int row0, int b, int h) {
    const float out_scale = kInt8Qk ? 1.f : __fmul_rn(127.f, p.vs[b * p.heads + h]);
    const int rows[2] = {row0, row0 + 8};
    __nv_bfloat16* out = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= p.sq) continue;
      const float d = fmaxf(den[r], kInt8Qk ? 1e-20f : 1e-30f);
      __nv_bfloat16* row = out + rows[r] * p.o_ss;
#pragma unroll
      for (int jd = 0; jd < D / 8; ++jd) {
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          y[e] = __fdiv_rn(acc[128 * (4 * jd + 2 * r + e)], d);
          if (!kInt8Qk) y[e] = __fmul_rn(y[e], out_scale);
        }
        *reinterpret_cast<uint32_t*>(row + 8 * jd + 2 * t) = pack_bf16(y[0], y[1]);
      }
    }
  }
};

template <int D, int kQk>
__global__ void __launch_bounds__(Geometry<D>::kThreads, 1)
pv8_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
           const __grid_constant__ CUtensorMap vt_map, const __grid_constant__ Params p) {
  static_assert(D % kBoxCols == 0, "head dim must be a multiple of 64");
  using Elem = typename QkTypes<kQk>::Elem;
  constexpr int kConsumers = Geometry<D>::kConsumers;
  constexpr int kBlockM = Geometry<D>::kBlockM;
  constexpr int kStages = Geometry<D>::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  Smem<D, kQk>& sm = *reinterpret_cast<Smem<D, kQk>*>(smem_raw + pad);

  // the warpgroup index through a shuffle: uniform, so no divergence around
  // the products
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  const int tid = threadIdx.x % 128;
  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const int m0 = blockIdx.x * kBlockM;
  const int n_tiles = (p.skv + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&sm.k_full[i], 1);
      mbar_init(&sm.v_full[i], 1);
      mbar_init(&sm.k_empty[i], 4 * kConsumers);  // one arrival per consumer warp
      mbar_init(&sm.v_empty[i], 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every TMA load, in the order the consumers
    // take them: per key block, its K tiles (pass 1), then K and V^T tile by
    // tile (pass 2)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      constexpr uint32_t kKBytes = kBlockN * D * sizeof(Elem);
      constexpr uint32_t kVBytes = D * kBlockN;
      mbar_expect_tx(&sm.q_full, kBlockM * D * sizeof(Elem));
      load_rows<D, kQk, kBlockM>(sm.q, &q_map, &sm.q_full, m0, h, b);
      int kl = 0, vl = 0;  // tiles issued into each ring
      const auto load_k = [&](int j) {
        const int st = kl % kStages;
        mbar_wait(&sm.k_empty[st], ((kl / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.k_full[st], kKBytes);
        load_rows<D, kQk, kBlockN>(sm.k[st], &k_map, &sm.k_full[st], j * kBlockN, h, b);
        ++kl;
      };
      for (int t0 = 0; t0 < n_tiles; t0 += p.block_tiles) {
        const int t1 = min(t0 + p.block_tiles, n_tiles);
        for (int j = t0; j < t1; ++j) load_k(j);
        for (int j = t0; j < t1; ++j) {
          load_k(j);
          const int st = vl % kStages;
          mbar_wait(&sm.v_empty[st], ((vl / kStages) & 1) ^ 1);
          mbar_expect_tx(&sm.v_full[st], kVBytes);
          tma_load_2d(sm.vt[st], &vt_map, &sm.v_full[st], j * kBlockN, bh * D);
          ++vl;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Geometry<D>::kConsumerRegs));
    Consumer<D, kQk> c(sm, p, wg - 1, tid, bh);
    mbar_wait(&sm.q_full, 0);
    if constexpr (kQk == kBf16) scale_rows<D, kBlockM>(sm.q, wg - 1, tid, p.scale_log2);
    c.attend(n_tiles);
    c.store(m0 + (wg - 1) * 64 + 16 * (tid / 32) + (tid % 32) / 4, b, h);
  }
}

// The caller's arguments: q (B, Sq, H, D) and k (B, Skv, H, D) by strides
// in elements over (batch, sequence, head), the head dim dense (K6: bf16;
// K7: int8 codes); vt the (B * H, D, vt_ld) int8 V^T in the key order stated
// above, vt_ld a multiple of 128; vs (B * H,) fp32 (K6: V's scales; K7: vs /
// 127); the output bf16 (B, Sq, H, D) by strides; K6's scale_log2 and K7's
// logit (B * H,) fp32, qs * ks * softmax scale.
struct Args {
  const void *q, *k, *vt, *vs;
  void* o;
  int batch, heads, sq, skv, head_dim, block_k;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, vt_ld, o_sb, o_ss, o_sh;
  float scale_log2;
  const void* logit;
};

template <int D, int kQk>
cudaError_t launch_d(const Args& a, cudaStream_t stream) {
  using Elem = typename QkTypes<kQk>::Elem;
  constexpr int kBlockM = Geometry<D>::kBlockM;
  CUtensorMap qm, km, vm;
  cudaError_t err =
      make_map<Elem>(&qm, a.q, a.batch, a.sq, a.heads, D, a.q_sb, a.q_ss, a.q_sh, kBlockM);
  if (err == cudaSuccess)
    err = make_map<Elem>(&km, a.k, a.batch, a.skv, a.heads, D, a.k_sb, a.k_ss, a.k_sh, kBlockN);
  if (err == cudaSuccess)
    err = make_map_u8(&vm, a.vt, a.batch * a.heads * D, static_cast<int>(a.vt_ld), a.vt_ld,
                      kBlockN, D, CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
  if (err != cudaSuccess) return err;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(a.o);
  p.o_sb = a.o_sb;
  p.o_ss = a.o_ss;
  p.o_sh = a.o_sh;
  p.vs = static_cast<const float*>(a.vs);
  p.logit = static_cast<const float*>(a.logit);
  p.heads = a.heads;
  p.sq = a.sq;
  p.skv = a.skv;
  p.block_tiles = a.block_k / kBlockN;
  p.scale_log2 = a.scale_log2;
  const int smem = static_cast<int>(sizeof(Smem<D, kQk>)) + 1024;  // + the alignment pad
  err = cudaFuncSetAttribute(pv8_kernel<D, kQk>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + kBlockM - 1) / kBlockM, a.batch * a.heads);
  pv8_kernel<D, kQk><<<grid, Geometry<D>::kThreads, smem, stream>>>(qm, km, vm, p);
  return cudaGetLastError();
}

// Launch on `stream` of `device`; returns the cudaError_t (0 = success).
template <int kQk>
int launch(int device, const Args& a, void* stream) {
  if (a.block_k <= 0 || a.block_k % kBlockN || a.vt_ld % kBlockN || a.vt_ld < a.skv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.head_dim == 64) return static_cast<int>(launch_d<64, kQk>(a, s));
  if (a.head_dim == 128) return static_cast<int>(launch_d<128, kQk>(a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace pv8

}  // namespace hopper_attn
