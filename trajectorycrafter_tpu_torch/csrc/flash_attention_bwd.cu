// The backward pass of non-causal softmax attention, o = softmax(q k^T *
// scale) v, for Hopper (sm_90a): two kernels, one for dK and dV and one for
// dQ, on `wgmma` bf16 products with fp32 accumulators, their operands
// brought by TMA through an mbarrier ring that one producer warp feeds.
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
// p and ds are rounded to bf16 for their products, as the forward kernel
// rounds p; the sums stay fp32 and each output is rounded to bf16 once.
// Each output row is written once, by one block, with no atomics: results
// are the same bit for bit from run to run.
//
// The TPU kernels pad the sequences to their blocks and mask the padding by
// segment ids; here the ragged ends are masked in the kernels: rows past the
// sequence are zero-filled by the TMA unit, a query row past Sq gets lse =
// +inf (so its p is 0 and it adds nothing to dK or dV), a key past Skv gets
// p = 0 in the dQ kernel's last key tile, and rows past the end are not
// stored.
//
// What bounds them on the H100: at the DiT's training shape (1 x 48 heads x
// 13,330 tokens x 64) dK/dV does 8 Sq Skv D H = 4.37 TFLOP (four products:
// s, dp, dV, dK) and dQ 6 Sq Skv D H = 3.28 TFLOP (s, dp, dQ) against ~0.3
// GB of operands: both are bound by the tensor cores (4.42 and 3.31 ms at
// 989 TFLOP/s), and next by the SFU's one exp per score (2.04 ms).  The
// design is the forward loop's (csrc/hopper_attention.cuh), built from its
// pieces: the 4-D TMA maps over (D, H, S, B) by the caller's strides, the
// 128-byte swizzled tiles, a producer warp that gives its registers away
// (`setmaxnreg`), and two consumer warpgroups of 64 rows that take turns at
// the tensor cores (`kTurnBarrier`), so that one's exps run while the
// other's products are in flight.
//
// - dQ: a block owns 128 queries (64 a warpgroup), q and dO resident; K and
//   V stream in 128-key tiles.  Per tile: S = q k^T and dP = dO v^T
//   (`issue_qk`, the V tile read K-major), p = exp2(s scale log2 e - lse
//   log2 e) (0 past Skv), ds = p (dp - di) packed into bf16 A fragments as
//   the forward packs P, and dQ += ds k (`issue_pv`, the K tile read
//   MN-major).  Each thread's lse and di are its two accumulator rows,
//   read once.
// - dK/dV: the same loop with the roles swapped.  A block owns 128 keys (64
//   a warpgroup), K and V resident; q and dO stream in 64-query tiles.  The
//   accumulators are keys x queries: S^T = k q^T and dP^T = v dO^T (the
//   m64n64k16 form of `issue_qk`), so p^T and ds^T are already the A
//   operands of dV += p^T dO and dK += ds^T q (`issue_pv`, the q and dO
//   tiles read MN-major: one swizzled tile is read in both major orders).
//   lse and di belong to the tile's columns: the producer warp loads them
//   into the stage with plain loads (+inf and 0 past Sq; a row of lse is
//   not 16-byte aligned in general, so no TMA), and the stage's full
//   barrier counts its 32 arrivals beside the TMA bytes.  q is not
//   pre-scaled (it is dK's B operand): scale log2 e goes into the exp2's
//   FFMA, and dK is multiplied by `scale` at the store.
// - Registers.  At head dim 64 a warpgroup issues tile j's score products
//   with tile j - 1's gradient products and runs tile j's exps while those
//   are in flight (dK/dV: 32 S^T + 32 dP^T + 16 + 16 fragment + 32 + 32
//   accumulator registers a thread; dQ: 64 + 64 + 32 + 32).  At head dim
//   128 the accumulators double and that overlap would not fit 240
//   registers, so a warpgroup waits for its own gradient products and only
//   the other warpgroup's turn covers its exps (`Shape::kOverlap`).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_bwd.so flash_attention_bwd.cu
// (trajectorycrafter_tpu_torch/ops/kernels.py does this at first use).

#include "hopper_attention.cuh"

namespace flash_bwd {

using namespace hopper_attn;

constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kConsumerRegs = 240;  // 128 x 24 + 256 x 240 fit the SM's 65,536
constexpr int kBlockM = 64 * kConsumers;  // rows a block owns: keys (dK/dV) or queries (dQ)
constexpr int kQueryTile = 64;  // queries a dK/dV tile (ops/kernels.py BWD_DKV_QUERY_TILE)
// dQ's key tile is the forward's kBlockN, 128 (ops/kernels.py BWD_DQ_KEY_TILE)
constexpr float kLog2e = 1.4426950408889634f;

// Per head dim: the overlap inside a warpgroup (see above) and the ring
// depths.  dK/dV holds a tile until its gradient products are done, one
// step later with the overlap, so four stages keep two tiles in flight
// ahead; dQ holds a K tile as long and a V tile only until dP is done.
template <int D>
struct Shape {
  static constexpr bool kOverlap = D == 64;
  static constexpr int kDkvStages = 4;
  static constexpr int kKStages = kOverlap ? 3 : 2;
  static constexpr int kVStages = 2;
};

struct Params {
  __nv_bfloat16 *o1, *o2;  // dK/dV: dk, dv; dQ: dq
  long long o1_sb, o1_ss, o1_sh, o2_sb, o2_ss, o2_sh;
  const float *lse, *di;  // (batch * heads, sq)
  int heads, sq, skv;
  float scale, scale_log2;
};

// The A fragments of an accumulator (64 x 2N fp32, N registers a thread),
// rounded to bf16: column blocks 2kk and 2kk + 1 are 16-deep chunk kk.
template <int N>
__device__ __forceinline__ void pack_frags(uint32_t (&f)[N / 8][4], const float (&x)[N]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) f[kk][e] = pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
  }
}

// This thread's two accumulator rows (row0, row0 + 8) of a 64 x D gradient,
// times `mul`, as bf16 pairs; rows at or past `len` are not stored.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long ss,
                                           const float (&acc)[D / 2], float mul, int row0,
                                           int len, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= len) continue;
    __nv_bfloat16* dst = out + row * ss;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      *reinterpret_cast<uint32_t*>(dst + 8 * jd + 2 * t) =
          pack_bf16(acc[4 * jd + 2 * r] * mul, acc[4 * jd + 2 * r + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// dK, dV: a block owns 128 keys and streams the query tiles
// ---------------------------------------------------------------------------

template <int D>
struct DkvSmem {
  static constexpr int kStages = Shape<D>::kDkvStages;
  __nv_bfloat16 k[kBlockM * D];
  __nv_bfloat16 v[kBlockM * D];
  __nv_bfloat16 q[kStages][kQueryTile * D];
  __nv_bfloat16 dout[kStages][kQueryTile * D];
  float lse2[kStages][kQueryTile];  // lse * log2 e; +inf past Sq
  float di[kStages][kQueryTile];    // 0 past Sq
  uint64_t kv_full;
  uint64_t full[kStages], empty[kStages];
};

template <int D>
struct DkvConsumer {
  static constexpr int kStages = Shape<D>::kDkvStages;
  static constexpr bool kOverlap = Shape<D>::kOverlap;
  static constexpr int kN = kQueryTile / 2;  // score registers a thread
  DkvSmem<D>& sm;
  const Params& p;
  int me, lane, t;
  int qc;  // query tiles taken from the ring so far
  const __nv_bfloat16 *k_wg, *v_wg;
  float dk[D / 2], dv[D / 2];
  uint32_t pf[kN / 8][4], dsf[kN / 8][4];  // p^T and ds^T of the tile in flight

  __device__ __forceinline__ DkvConsumer(DkvSmem<D>& sm_, const Params& p_, int me_, int tid)
      : sm(sm_), p(p_), me(me_), lane(tid % 32), t(tid % 4), qc(0),
        k_wg(sm_.k + me_ * 64 * kBoxCols), v_wg(sm_.v + me_ * 64 * kBoxCols) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  }

  __device__ __forceinline__ void release(int tile) {
    if (lane == 0) mbar_arrive(&sm.empty[tile % kStages]);
  }

  // p^T and ds^T in place; column 8 (i / 4) + 2t + (i & 1) of the
  // accumulators is that query of the tile, so lse and di come per column.
  __device__ __forceinline__ void grads(float (&st)[kN], float (&dpt)[kN], int stage) {
    const float* lse2 = sm.lse2[stage];
    const float* di = sm.di[stage];
#pragma unroll
    for (int cb = 0; cb < kN / 4; ++cb) {
      const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * cb + 2 * t);
      const float2 g = *reinterpret_cast<const float2*>(di + 8 * cb + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * cb + e;
        const float x = exp2_ftz(fmaf(st[i], p.scale_log2, -((e & 1) ? l.y : l.x)));
        st[i] = x;
        dpt[i] = x * (dpt[i] - ((e & 1) ? g.y : g.x));
      }
    }
  }

  // dV += p^T dO and dK += ds^T q of the tile in `stage`, waited for.
  __device__ __forceinline__ void products(int stage) {
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pf);
    fence_regs(dsf);
    wgmma_fence();
    issue_pv<D, kQueryTile>(dv, pf, sm.dout[stage]);
    issue_pv<D, kQueryTile>(dk, dsf, sm.q[stage]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pf);
    fence_regs(dsf);
  }

  // Query tile j: S^T and dP^T issued in this warpgroup's turn (with kOverlap
  // and kWithPrev, also tile j - 1's gradient products), the turn handed
  // on, p^T and ds^T while the products run, then packed.
  template <bool kWithPrev>
  __device__ __forceinline__ void step(int j, int n, float (&st)[kN], float (&dpt)[kN]) {
    const int turn = kTurnBarrier + me, next = kTurnBarrier + (me + 1) % kConsumers;
    const int stage = qc % kStages, prev = (qc + kStages - 1) % kStages;
    mbar_wait(&sm.full[stage], (qc / kStages) & 1);
    named_sync(turn, 256);
    fence_regs(st);
    fence_regs(dpt);
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pf);
    fence_regs(dsf);
    wgmma_fence();
    issue_qk<D, kBlockM, kQueryTile>(st, k_wg, sm.q[stage]);
    issue_qk<D, kBlockM, kQueryTile>(dpt, v_wg, sm.dout[stage]);
    wgmma_commit();
    if (kOverlap && kWithPrev) {
      issue_pv<D, kQueryTile>(dv, pf, sm.dout[prev]);
      issue_pv<D, kQueryTile>(dk, dsf, sm.q[prev]);
    }
    wgmma_commit();
    // the last consumer's last turn has no successor
    if (!(me == kConsumers - 1 && j == n - 1)) named_arrive(next, 256);
    wgmma_wait<1>();
    fence_regs(st);
    fence_regs(dpt);
    grads(st, dpt, stage);
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pf);
    fence_regs(dsf);
    if (kOverlap && kWithPrev) release(qc - 1);
    pack_frags(pf, st);
    pack_frags(dsf, dpt);
    if (!kOverlap) {
      products(stage);
      release(qc);
    }
    ++qc;
  }

  __device__ __forceinline__ void run(int n) {
    // the turns go round; the first consumer goes first
    if (me == kConsumers - 1) named_arrive(kTurnBarrier, 256);
    float st[kN], dpt[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) st[i] = dpt[i] = 0.f;
    step<false>(0, n, st, dpt);
    for (int j = 1; j < n; ++j) step<true>(j, n, st, dpt);
    if (kOverlap) {
      products((qc - 1) % kStages);
      release(qc - 1);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
           const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
           const __grid_constant__ Params p) {
  static_assert(D % kBoxCols == 0, "head dim must be a multiple of 64");
  using Smem = DkvSmem<D>;
  constexpr int kStages = Smem::kStages;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern follows the address bits: align the tiles to 1024
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);

  // the warpgroup index through a shuffle: uniform, so no divergence around
  // the products
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  const int tid = threadIdx.x % 128;
  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const int key0 = blockIdx.x * kBlockM;
  const int n = (p.sq + kQueryTile - 1) / kQueryTile;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&sm.full[i], 1 + 32);             // the TMA bytes' arrival + the warp's lse / di
      mbar_init(&sm.empty[i], 4 * kConsumers);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every TMA load, the warp loads lse and di
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid < 32) {
      const float* lse = p.lse + static_cast<long long>(bh) * p.sq;
      const float* di = p.di + static_cast<long long>(bh) * p.sq;
      if (tid == 0) {
        mbar_expect_tx(&sm.kv_full, 2 * kBlockM * D * sizeof(__nv_bfloat16));
        load_tile<D, kBlockM>(sm.k, &k_map, &sm.kv_full, key0, h, b);
        load_tile<D, kBlockM>(sm.v, &v_map, &sm.kv_full, key0, h, b);
      }
      for (int j = 0; j < n; ++j) {
        const int st = j % kStages;
        mbar_wait(&sm.empty[st], ((j / kStages) & 1) ^ 1);
        if (tid == 0) {
          mbar_expect_tx(&sm.full[st], 2 * kQueryTile * D * sizeof(__nv_bfloat16));
          load_tile<D, kQueryTile>(sm.q[st], &q_map, &sm.full[st], j * kQueryTile, h, b);
          load_tile<D, kQueryTile>(sm.dout[st], &do_map, &sm.full[st], j * kQueryTile, h, b);
        }
        for (int r = tid; r < kQueryTile; r += 32) {
          const int row = j * kQueryTile + r;
          const bool valid = row < p.sq;
          sm.lse2[st][r] = valid ? lse[row] * kLog2e : INFINITY;
          sm.di[st][r] = valid ? di[row] : 0.f;
        }
        mbar_arrive(&sm.full[st]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    DkvConsumer<D> c(sm, p, wg - 1, tid);
    mbar_wait(&sm.kv_full, 0);
    c.run(n);
    const int row0 = key0 + (wg - 1) * 64 + 16 * (tid / 32) + (tid % 32) / 4;
    store_rows<D>(p.o1 + b * p.o1_sb + h * p.o1_sh, p.o1_ss, c.dk, p.scale, row0, p.skv, c.t);
    store_rows<D>(p.o2 + b * p.o2_sb + h * p.o2_sh, p.o2_ss, c.dv, 1.f, row0, p.skv, c.t);
  }
}

// ---------------------------------------------------------------------------
// dQ: a block owns 128 queries and streams the key tiles
// ---------------------------------------------------------------------------

template <int D>
struct DqSmem {
  static constexpr int kKStages = Shape<D>::kKStages;
  static constexpr int kVStages = Shape<D>::kVStages;
  __nv_bfloat16 q[kBlockM * D];
  __nv_bfloat16 dout[kBlockM * D];
  __nv_bfloat16 k[kKStages][kBlockN * D];
  __nv_bfloat16 v[kVStages][kBlockN * D];
  uint64_t qdo_full;
  uint64_t k_full[kKStages], k_empty[kKStages];
  uint64_t v_full[kVStages], v_empty[kVStages];
};

template <int D>
struct DqConsumer {
  static constexpr int kKStages = Shape<D>::kKStages;
  static constexpr int kVStages = Shape<D>::kVStages;
  static constexpr bool kOverlap = Shape<D>::kOverlap;
  DqSmem<D>& sm;
  const Params& p;
  int me, lane, t;
  int kc, vc;  // tiles taken from the K and V rings so far
  const __nv_bfloat16 *q_wg, *do_wg;
  float lse2[2], di[2];  // this thread's two query rows
  float dq[D / 2];
  uint32_t dsf[kBlockN / 16][4];  // ds of the tile in flight

  __device__ __forceinline__ DqConsumer(DqSmem<D>& sm_, const Params& p_, int me_, int tid,
                                        int row0, int bh)
      : sm(sm_), p(p_), me(me_), lane(tid % 32), t(tid % 4), kc(0), vc(0),
        q_wg(sm_.q + me_ * 64 * kBoxCols), do_wg(sm_.dout + me_ * 64 * kBoxCols) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const long long at = static_cast<long long>(bh) * p_.sq + row;
      lse2[r] = row < p_.sq ? p_.lse[at] * kLog2e : INFINITY;
      di[r] = row < p_.sq ? p_.di[at] : 0.f;
    }
  }

  __device__ __forceinline__ void release_k(int tile) {
    if (lane == 0) mbar_arrive(&sm.k_empty[tile % kKStages]);
  }

  // ds = p (dp - di) in place of s, p 0 for keys past Skv (`limit`: the
  // keys of this tile inside the sequence).
  __device__ __forceinline__ void grads(float (&s)[64], const float (&dp)[64], int limit) {
    if (limit < kBlockN) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if (acc_col(i, t) >= limit) s[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = acc_row(i);
      const float x = exp2_ftz(fmaf(s[i], p.scale_log2, -lse2[r]));
      s[i] = x * (dp[i] - di[r]);
    }
  }

  // dQ += ds k of the K tile in `stage`, waited for.
  __device__ __forceinline__ void product(int stage) {
    fence_regs(dq);
    fence_regs(dsf);
    wgmma_fence();
    issue_pv<D>(dq, dsf, sm.k[stage]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(dsf);
  }

  // Key tile j: S and dP issued in this warpgroup's turn (with kOverlap and
  // kWithPrev, also tile j - 1's dQ product), the V tile released once dP
  // is done, ds while the dQ product runs, then packed.
  template <bool kWithPrev>
  __device__ __forceinline__ void step(int j, int n, float (&s)[64], float (&dp)[64]) {
    const int turn = kTurnBarrier + me, next = kTurnBarrier + (me + 1) % kConsumers;
    const int kst = kc % kKStages, vst = vc % kVStages;
    mbar_wait(&sm.k_full[kst], (kc / kKStages) & 1);
    mbar_wait(&sm.v_full[vst], (vc / kVStages) & 1);
    named_sync(turn, 256);
    fence_regs(s);
    fence_regs(dp);
    fence_regs(dq);
    fence_regs(dsf);
    wgmma_fence();
    issue_qk<D, kBlockM>(s, q_wg, sm.k[kst]);
    issue_qk<D, kBlockM>(dp, do_wg, sm.v[vst]);
    wgmma_commit();
    if (kOverlap && kWithPrev) issue_pv<D>(dq, dsf, sm.k[(kc + kKStages - 1) % kKStages]);
    wgmma_commit();
    if (!(me == kConsumers - 1 && j == n - 1)) named_arrive(next, 256);
    wgmma_wait<1>();
    fence_regs(s);
    fence_regs(dp);
    if (lane == 0) mbar_arrive(&sm.v_empty[vst]);
    ++vc;
    grads(s, dp, p.skv - j * kBlockN);
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(dsf);
    if (kOverlap && kWithPrev) release_k(kc - 1);
    pack_frags(dsf, s);
    if (!kOverlap) {
      product(kst);
      release_k(kc);
    }
    ++kc;
  }

  __device__ __forceinline__ void run(int n) {
    if (me == kConsumers - 1) named_arrive(kTurnBarrier, 256);
    float s[64], dp[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = dp[i] = 0.f;
    step<false>(0, n, s, dp);
    for (int j = 1; j < n; ++j) step<true>(j, n, s, dp);
    if (kOverlap) {
      product((kc - 1) % kKStages);
      release_k(kc - 1);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
          const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
          const __grid_constant__ Params p) {
  static_assert(D % kBoxCols == 0, "head dim must be a multiple of 64");
  using Smem = DqSmem<D>;
  constexpr int kKStages = Smem::kKStages, kVStages = Smem::kVStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  const int tid = threadIdx.x % 128;
  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const int m0 = blockIdx.x * kBlockM;
  const int n = (p.skv + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(&sm.qdo_full, 1);
#pragma unroll
    for (int i = 0; i < kKStages; ++i) {
      mbar_init(&sm.k_full[i], 1);
      mbar_init(&sm.k_empty[i], 4 * kConsumers);
    }
#pragma unroll
    for (int i = 0; i < kVStages; ++i) {
      mbar_init(&sm.v_full[i], 1);
      mbar_init(&sm.v_empty[i], 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      constexpr uint32_t kTileBytes = kBlockN * D * sizeof(__nv_bfloat16);
      mbar_expect_tx(&sm.qdo_full, 2 * kBlockM * D * sizeof(__nv_bfloat16));
      load_tile<D, kBlockM>(sm.q, &q_map, &sm.qdo_full, m0, h, b);
      load_tile<D, kBlockM>(sm.dout, &do_map, &sm.qdo_full, m0, h, b);
      for (int j = 0; j < n; ++j) {
        const int ks = j % kKStages, vs = j % kVStages;
        mbar_wait(&sm.k_empty[ks], ((j / kKStages) & 1) ^ 1);
        mbar_expect_tx(&sm.k_full[ks], kTileBytes);
        load_tile<D, kBlockN>(sm.k[ks], &k_map, &sm.k_full[ks], j * kBlockN, h, b);
        mbar_wait(&sm.v_empty[vs], ((j / kVStages) & 1) ^ 1);
        mbar_expect_tx(&sm.v_full[vs], kTileBytes);
        load_tile<D, kBlockN>(sm.v[vs], &v_map, &sm.v_full[vs], j * kBlockN, h, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int row0 = m0 + (wg - 1) * 64 + 16 * (tid / 32) + (tid % 32) / 4;
    DqConsumer<D> c(sm, p, wg - 1, tid, row0, bh);
    mbar_wait(&sm.qdo_full, 0);
    c.run(n);
    store_rows<D>(p.o1 + b * p.o1_sb + h * p.o1_sh, p.o1_ss, c.dq, p.scale, row0, p.sq, c.t);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The caller's arguments: bf16 (B, S, H, D) q, k, v, dout and outputs by
// strides in elements over (batch, sequence, head), the head dim dense.
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *di;
  void *o1, *o2;  // dk, dv; or dq, unused
  int batch, heads, sq, skv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh;
  long long o1_sb, o1_ss, o1_sh, o2_sb, o2_ss, o2_sh;
  float scale;
};

// The four operands' maps (q and dout by `q_rows`-row boxes, k and v by
// `kv_rows`) and the kernel's parameters.
inline cudaError_t prepare(const Args& a, int d, int q_rows, int kv_rows, CUtensorMap (&maps)[4],
                           Params& p) {
  cudaError_t err =
      make_map(&maps[0], a.q, a.batch, a.sq, a.heads, d, a.q_sb, a.q_ss, a.q_sh, q_rows);
  if (err == cudaSuccess)
    err = make_map(&maps[1], a.k, a.batch, a.skv, a.heads, d, a.k_sb, a.k_ss, a.k_sh, kv_rows);
  if (err == cudaSuccess)
    err = make_map(&maps[2], a.v, a.batch, a.skv, a.heads, d, a.v_sb, a.v_ss, a.v_sh, kv_rows);
  if (err == cudaSuccess)
    err = make_map(&maps[3], a.dout, a.batch, a.sq, a.heads, d, a.do_sb, a.do_ss, a.do_sh,
                   q_rows);
  p.o1 = static_cast<__nv_bfloat16*>(a.o1);
  p.o2 = static_cast<__nv_bfloat16*>(a.o2);
  p.o1_sb = a.o1_sb;
  p.o1_ss = a.o1_ss;
  p.o1_sh = a.o1_sh;
  p.o2_sb = a.o2_sb;
  p.o2_ss = a.o2_ss;
  p.o2_sh = a.o2_sh;
  p.lse = a.lse;
  p.di = a.di;
  p.heads = a.heads;
  p.sq = a.sq;
  p.skv = a.skv;
  p.scale = a.scale;
  p.scale_log2 = a.scale * kLog2e;
  return err;
}

template <typename Kernel>
cudaError_t run(Kernel kernel, int smem, int rows, const CUtensorMap (&m)[4], const Params& p,
                int bh, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + kBlockM - 1) / kBlockM, bh);
  kernel<<<grid, kThreads, smem, stream>>>(m[0], m[1], m[2], m[3], p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  CUtensorMap maps[4];
  Params p;
  cudaError_t err = prepare(a, D, kQueryTile, kBlockM, maps, p);
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(sizeof(DkvSmem<D>)) + 1024;  // + the alignment pad
  return run(dkv_kernel<D>, smem, a.skv, maps, p, a.batch * a.heads, stream);
}

template <int D>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  CUtensorMap maps[4];
  Params p;
  cudaError_t err = prepare(a, D, kBlockM, kBlockN, maps, p);
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(sizeof(DqSmem<D>)) + 1024;
  return run(dq_kernel<D>, smem, a.sq, maps, p, a.batch * a.heads, stream);
}

// Launch on `stream` of `device`; returns the cudaError_t (0 = success).
template <bool kDkv>
int launch(int device, int head_dim, const Args& a, void* stream) {
  // make the caller's device current for this runtime, as PyTorch has it
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return static_cast<int>(kDkv ? launch_dkv<64>(a, s) : launch_dq<64>(a, s));
  if (head_dim == 128)
    return static_cast<int>(kDkv ? launch_dkv<128>(a, s) : launch_dq<128>(a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace flash_bwd

// Plain C entry points for ctypes (ops/kernels.py names every entry point
// `<name>_fwd`).  q, k, v, dout: (B, S, H, D) bf16 by (batch, sequence,
// head) strides in elements, the head dim dense, 16-byte aligned rows;
// lse, di: fp32 (B * H, Sq).  Each launches on `stream` of `device` and
// returns the cudaError_t of the launch (0 = success); none synchronises.
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
  const flash_bwd::Args a{q, k, v, dout,
                          static_cast<const float*>(lse), static_cast<const float*>(di),
                          dk, dv,
                          batch, heads, sq, skv,
                          q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                          do_sb, do_ss, do_sh,
                          dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh,
                          scale};
  return flash_bwd::launch<true>(device, head_dim, a, stream);
}

extern "C" int flash_attention_bwd_dq_fwd(int device, const void* q, const void* k,
                                          const void* v, const void* dout, const void* lse,
                                          const void* di, void* dq, BWD_COMMON_ARGS,
                                          long long dq_sb, long long dq_ss, long long dq_sh,
                                          float scale, void* stream) {
  const flash_bwd::Args a{q, k, v, dout,
                          static_cast<const float*>(lse), static_cast<const float*>(di),
                          dq, nullptr,
                          batch, heads, sq, skv,
                          q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                          do_sb, do_ss, do_sh,
                          dq_sb, dq_ss, dq_sh, 0, 0, 0,
                          scale};
  return flash_bwd::launch<false>(device, head_dim, a, stream);
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
