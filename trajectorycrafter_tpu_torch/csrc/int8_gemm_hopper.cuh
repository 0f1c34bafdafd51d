// The Hopper (sm_90a) int8 GEMM main loop shared by int8_gemm.cu (K2b),
// int8_gemm_gscale.cu (K3b) and int8_gemm_gelu_quant.cu (K3a).
//
// C (M x N, int32) = A (M x K, int8) * W^T, with W (N x K, int8): torch's
// Linear layout.  Both operands are K-major, the only layout `wgmma` takes
// for 8-bit types, and each is read by its own row stride.
//
// What bounds it on the H100: at the DiT's shapes (M 26,660, K and N 2,048 to
// 12,288) the tensor cores (2.0 T int8 operations at the feed-forward's 3,072
// -> 12,288: 1.02 ms at 1,979 TOP/s); at the depth UNet's 320-channel layers
// device memory.  To run near the tensor cores' rate the products must be
// issued back to back from shared memory, with no thread spending time on
// copies or on address arithmetic.  The design:
//
// - TMA.  One 2-D tensor map per operand, over (K, rows) by the caller's row
//   stride; a box is 128 bytes of K x the tile's rows, 128-byte swizzled, the
//   layout `wgmma` reads without bank conflicts.  The TMA unit zero-fills
//   rows past M and N and bytes past K, so the ragged edges add nothing and
//   no operand is padded in device memory.
// - A ring of kStages shared-memory stages, each one K tile of A (128 rows)
//   and of W (BN rows), with a full / empty mbarrier pair.  One thread
//   of the producer warpgroup issues every load and runs up to kStages tiles
//   ahead of the products, across output tiles too; the producer warpgroup
//   gives its registers to the consumers (`setmaxnreg`).
// - Two consumer warpgroups, each 64 rows of the block tile, issue
//   `wgmma.mma_async.m64nNk32.s32.s8.s8` with A and W both read from shared
//   memory (4 per K tile).  The products of K tile j + 1 are in flight while
//   tile j's stage is released (`wgmma.wait_group 1`, then the empty
//   barrier).  The accumulators are fenced around every `wgmma` and the role
//   branch is warp-uniform, so ptxas serializes nothing (no C7520 note).
// - A hook after each group of K tiles (`after_group`): the grouped kernel
//   dequantizes its int32 sums there; the accumulators restart at the next
//   group's first product (`wgmma` with scale-d 0), so they need no reset.
// - A persistent grid, one block per SM, walking the output tiles in bands
//   of kBandTiles M tiles swept along N: the 132 tiles in flight share a few
//   A tiles and a band's A (kBandTiles x 128 rows) stays in L2 while W
//   streams past it (at the feed-forward, W is 37.7 MB and A 81.9 MB against
//   the 50 MB L2; bands of 16 ran FF1 faster than bands of 8 or 32).  A
//   block's next tile loads while it stores the last one.  With a cluster of
//   `cluster` blocks along N (K3a's), the grid walks units of one M tile x
//   `cluster` N tiles, each block of a cluster taking the N tile of its rank.
// - The epilogue.  The column scales and bias of a tile are loaded before
//   its products and staged in shared memory; then the kernel's epilogue
//   hook takes the accumulators in registers.  K2b's and K3b's
//   (`store_bf16`) turn them into bf16 64 columns at a time, through shared
//   memory, so that C is written in whole 128-byte rows, masked at the
//   ragged edges; K3a's quantizes them to int8 the same way.
//
// The kernels that include this header state what they compute in the hooks
// (`after_group`, the epilogue), which read the accumulators as `wgmma` lays
// them out: register i of a consumer thread holds row row0 + 8 ((i >> 1) & 1) and
// column col0 + 8 (i / 4) + (i & 1), with row0 = 64 (warpgroup) + 16 (warp) +
// lane / 4 and col0 = 2 (lane % 4) inside the block tile.

#pragma once

#include "hopper.cuh"

namespace int8_hopper {

using namespace hopper;

constexpr int kBlockM = 128;  // rows of C per block tile: two consumer warpgroups of 64
constexpr int kBlockK = 128;  // int8 elements (bytes) of K per stage: one swizzled row
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
// 128 x 40 + 256 x 232 = 384 x 168: the registers a block of 384 holds
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kBandTiles = 16;  // M tiles per band of the tile order
// named barriers (0 is __syncthreads): both consumers, then each consumer's own
constexpr int kColsBarrier = 1;
constexpr int kStoreBarrier = 2;
// The output tile goes to device memory through shared memory, 64 columns
// at a time per consumer: 64 rows of 128 bytes, each padded to 144 so that
// the 8 rows of a fragment's store fall in distinct banks.
constexpr int kChunkCols = 64;
constexpr int kChunkPitch = 2 * kChunkCols + 16;

struct Shape {
  int m, n;
  int tiles_m, tiles_n;
  int k_tiles;      // K tiles of 128 bytes (the last one zero-filled past K)
  int group_tiles;  // K tiles per call of the hook; k_tiles for one call at the end
  int cluster;      // blocks of a cluster along N (1: none); it divides tiles_n
};

// What the epilogue hook is told of the tile it stores.
struct Tile {
  int m0, n0;        // the tile's origin in C
  int local;         // tiles this block stored before this one
  int me, tid;       // the consumer warpgroup and the thread in it
  int row_in;        // the thread's first row in the tile (the second is 8 on)
  int col_in;        // the thread's first column in each 8-column block
  const float* cw;   // the tile's column scales and bias, staged in shared memory
  const float* cb;
  uint8_t* stage;    // this consumer's staging chunk: 64 rows x kChunkPitch bytes
};

// The dequantizing epilogue of the JAX package, in its operation order and
// with every fp32 operation rounded on its own (no fused multiply-add), so
// that the kernel computes exactly what the plain version computes:
// ((acc * xs) * ws) + bias.
__device__ __forceinline__ float dequant(int acc, float xs, float ws, float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws), bias);
}

// The main loop at a block tile of kBlockM x BN with a ring of kStages;
// kClustered: launched in clusters of sh.cluster blocks along N (else the
// schedule is fixed at compile time to single blocks).
template <int BN, int kStages, bool kClustered = false>
struct MainLoop {
  static constexpr int kAcc = BN / 2;  // int32 accumulators of a consumer thread
  static constexpr uint32_t kStageBytes = (kBlockM + BN) * kBlockK;

  // Each operand tile is 1024-byte aligned (the swizzle repeats every 8 rows
  // of 128 bytes).  `cols` holds the column scales and bias of the tile
  // being stored, two tiles deep.
  struct Smem {
    uint8_t a[kStages][kBlockM * kBlockK];
    uint8_t b[kStages][BN * kBlockK];
    float cols[2][2][BN];  // [tile parity][scale, bias][column of the tile]
    uint8_t c_stage[kConsumers][64 * kChunkPitch];  // a consumer's 64 x 64 bf16 output chunk
    uint64_t full[kStages], empty[kStages];
  };
  static constexpr int kSmemBytes = static_cast<int>(sizeof(Smem)) + 1024;  // + the pad

  // Blocks of a cluster: 1 unless kClustered.
  static __device__ __forceinline__ int cluster(const Shape& sh) {
    return kClustered ? sh.cluster : 1;
  }

  // The origin of the output tile of cluster rank `rank` in unit `unit`:
  // bands of kBandTiles M tiles, each swept along N before the next band
  // starts; a unit is one M tile x cluster(sh) N tiles.
  static __device__ __forceinline__ void tile_origin(const Shape& sh, int unit, int rank,
                                                     int& m0, int& n0) {
    const int band_size = kBandTiles * (sh.tiles_n / cluster(sh));
    const int band = unit / band_size;
    const int first = band * kBandTiles;
    const int rows = min(kBandTiles, sh.tiles_m - first);
    const int local = unit - band * band_size;
    m0 = (first + local % rows) * kBlockM;
    n0 = ((local / rows) * cluster(sh) + rank) * BN;
  }

  // Run the block's share of the output tiles of C = A W^T.  The epilogue
  // takes the column scales `ws` and the bias `bias` (or null: 0) of C's
  // columns.  The hooks, with row0 in C (the header comment gives the
  // accumulator layout):
  //   begin(row0)                     at a tile's start: loads of per-row
  //                                   scales issued here land during the
  //                                   products;
  //   after_group(acc, group, row0)   after every sh.group_tiles K tiles,
  //                                   with the products of those in acc;
  //   epilogue(acc, tile)             after the last, with the tile's column
  //                                   scales and bias staged (Tile); it may
  //                                   reuse acc.
  template <class Begin, class AfterGroup, class Epilogue>
  static __device__ __forceinline__ void run(uint8_t* smem_raw, const CUtensorMap* a_map,
                                             const CUtensorMap* b_map, const Shape& sh,
                                             const float* __restrict__ ws,
                                             const float* __restrict__ bias, Begin begin,
                                             AfterGroup after_group, Epilogue epilogue) {
    const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
    Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);
    const int n_units = sh.tiles_m * (sh.tiles_n / cluster(sh));
    const int rank = blockIdx.x % cluster(sh);  // the grid is 1-D, clusters along x
    const int first = blockIdx.x / cluster(sh), stride = gridDim.x / cluster(sh);
    // the warpgroup index through a shuffle, which the compiler knows to be
    // uniform across the warp: the role branch then holds no divergence
    const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
    const int tid = threadIdx.x % 128;

    if (threadIdx.x == 0) {
#pragma unroll
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&sm.full[s], 1);
        mbar_init(&sm.empty[s], 4 * kConsumers);  // one arrival per consumer warp
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();

    if (wg == 0) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
      if (tid == 0) {
        int it = 0;  // stages filled so far
        for (int unit = first; unit < n_units; unit += stride) {
          int m0, n0;
          tile_origin(sh, unit, rank, m0, n0);
          for (int kt = 0; kt < sh.k_tiles; ++kt, ++it) {
            const int s = it % kStages;
            mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
            // a box past the edges still lands whole (zero-filled)
            mbar_expect_tx(&sm.full[s], kStageBytes);
            tma_load_2d(sm.a[s], a_map, &sm.full[s], kt * kBlockK, m0);
            tma_load_2d(sm.b[s], b_map, &sm.full[s], kt * kBlockK, n0);
          }
        }
      }
    } else {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
      const int me = wg - 1;
      const int lane = tid % 32;
      const int row_in = 64 * me + 16 * (tid / 32) + lane / 4;
      const int col_in = 2 * (lane % 4);
      const int ct = 128 * me + tid;  // the column this thread stages, if < BN
      const auto release = [&](int s) {
        if (lane == 0) mbar_arrive(&sm.empty[s]);
      };
      int acc[kAcc];
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0;
      int it = 0;  // stages consumed so far
      int local = 0;
      for (int unit = first; unit < n_units; unit += stride, ++local) {
        const int parity = local & 1;
        int m0, n0;
        tile_origin(sh, unit, rank, m0, n0);
        // the tile's column scale and bias: loaded now, staged after the products
        float my_w = 0.f, my_b = 0.f;
        if (ct < BN && n0 + ct < sh.n) {
          my_w = __ldg(ws + n0 + ct);
          if (bias != nullptr) my_b = __ldg(bias + n0 + ct);
        }
        begin(m0 + row_in);
        int held = -1;  // the stage whose products may still be in flight
        for (int kt = 0; kt < sh.k_tiles; ++kt, ++it) {
          const int s = it % kStages;
          const int fresh = kt % sh.group_tiles == 0;  // the group's first tile
          mbar_wait(&sm.full[s], (it / kStages) & 1);
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBlockK / 32; ++kk) {  // 32 bytes of K per `wgmma`
            const uint64_t da = make_desc(sm.a[s] + 64 * me * kBlockK + 32 * kk, 16, 1024);
            const uint64_t db = make_desc(sm.b[s] + 32 * kk, 16, 1024);
            wgmma_s8(acc, da, db, kk > 0 || !fresh);
          }
          wgmma_commit();
          wgmma_wait<1>();  // the products of tile kt - 1 are done
          fence_regs(acc);
          if (held >= 0) release(held);
          held = s;
          if ((kt + 1) % sh.group_tiles == 0) {
            wgmma_wait<0>();
            fence_regs(acc);
            release(s);
            held = -1;
            after_group(acc, kt / sh.group_tiles, m0 + row_in);
          }
        }
        wgmma_wait<0>();  // drained at the last group's end: this only shows ptxas
        fence_regs(acc);
        if (ct < BN) {
          sm.cols[parity][0][ct] = my_w;
          sm.cols[parity][1][ct] = my_b;
        }
        // every column of this tile is staged, and no consumer still reads
        // the buffer of two tiles back (each passed this barrier since)
        named_sync(kColsBarrier, 128 * kConsumers);
        const Tile tile{m0,     n0,     local, me, tid, row_in, col_in,
                        sm.cols[parity][0], sm.cols[parity][1], sm.c_stage[me]};
        epilogue(acc, tile);
      }
    }
  }

  // The bf16 epilogue of K2b and K3b: value(acc, i, cw, cb) is the fp32
  // output of accumulator register i, whose column has scale cw and bias cb;
  // written to `out` (dense M x N) in whole 128-byte rows.
  template <class Value>
  static __device__ __forceinline__ void store_bf16(const int (&acc)[kAcc], const Tile& tl,
                                                    const Shape& sh,
                                                    __nv_bfloat16* __restrict__ out,
                                                    Value value) {
#pragma unroll  // constant register indices: acc stays in registers
    for (int chunk = 0; chunk < BN / kChunkCols; ++chunk) {
      const int c0 = tl.n0 + chunk * kChunkCols;
      if (c0 >= sh.n) break;  // the same for the whole block
      // this thread's bf16 pairs of the chunk into the stage ...
#pragma unroll
      for (int jj = 0; jj < kChunkCols / 8; ++jj) {
        const int i0 = 4 * (chunk * kChunkCols / 8 + jj);  // registers of column block j
        const int c = chunk * kChunkCols + 8 * jj + tl.col_in;  // column in the tile
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = i0 + 2 * h;
          *reinterpret_cast<uint32_t*>(tl.stage + (tl.row_in - 64 * tl.me + 8 * h) * kChunkPitch +
                                       2 * (8 * jj + tl.col_in)) =
              pack_bf16(value(acc, i, tl.cw[c], tl.cb[c]),
                        value(acc, i + 1, tl.cw[c + 1], tl.cb[c + 1]));
        }
      }
      named_sync(kStoreBarrier + tl.me, 128);
      // ... then whole 128-byte rows to C: 16 bytes a thread, 16 rows a pass
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = tl.tid / 8 + 16 * q;
        const int row = tl.m0 + 64 * tl.me + r, col = c0 + 8 * (tl.tid % 8);
        if (row < sh.m && col < sh.n) {  // N is a multiple of 16: a vector is in or out
          *reinterpret_cast<uint4*>(out + static_cast<long long>(row) * sh.n + col) =
              *reinterpret_cast<const uint4*>(tl.stage + r * kChunkPitch + 16 * (tl.tid % 8));
        }
      }
      named_sync(kStoreBarrier + tl.me, 128);  // the stage is read before it is rewritten
    }
  }

  // The tensor maps and the persistent grid of one launch: A (m x k) and W
  // (n x k) int8 by row strides lda and ldb (multiples of 16 bytes), the
  // hook every `group` of K (a multiple of kBlockK), or once at the end
  // when group is 0; clusters of `cluster` blocks along N (it divides the N
  // tiles), at most `max_clusters` of them in flight.
  struct Launch {
    CUtensorMap a_map, b_map;
    Shape shape;
    dim3 grid;
  };

  static cudaError_t prepare(int device, const void* a, const void* b, int m, int n, int k,
                             long long lda, long long ldb, int group, Launch& l,
                             int cluster = 1, int max_clusters = 0) {
    cudaError_t err = make_map_u8(&l.a_map, a, m, k, lda, kBlockK, kBlockM,
                                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
    if (err == cudaSuccess) {
      err = make_map_u8(&l.b_map, b, n, k, ldb, kBlockK, BN, CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
    }
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    Shape& sh = l.shape;
    sh.m = m;
    sh.n = n;
    sh.tiles_m = (m + kBlockM - 1) / kBlockM;
    sh.tiles_n = (n + BN - 1) / BN;
    sh.k_tiles = (k + kBlockK - 1) / kBlockK;
    sh.group_tiles = group > 0 ? group / kBlockK : sh.k_tiles;
    sh.cluster = cluster;
    const int units = sh.tiles_m * (sh.tiles_n / cluster);
    int clusters = sms / cluster;
    if (max_clusters > 0 && max_clusters < clusters) clusters = max_clusters;
    l.grid = dim3((units < clusters ? units : clusters) * cluster);
    return cudaSuccess;
  }
};

}  // namespace int8_hopper
