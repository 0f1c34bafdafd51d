// The `mma.sync` int8 GEMM main loop of int8_gemm_gelu_quant.cu (K3a), its
// only user: its cluster reduction of the group max is tied to this loop's
// 128-column block.  K2b and K3b run on the `wgmma` / TMA main loop of
// int8_gemm_hopper.cuh.  The quantized attention kernels (int8_attention.cuh)
// take `mma_s8_16832` and `lds32` from here.
//
// C (M x N, int32) = A (M x K, int8, row-major) * B, where B is given as the
// weight W (N x K, int8, row-major): torch's Linear layout, whose K-contiguous
// rows are exactly the column-major B operand of `mma.sync ... .row.col`.
//
// One thread block of 8 warps (2 along M x 4 along N) computes a 128 x 128
// tile of C with `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`; each warp
// holds a 64 x 32 tile of int32 accumulators in registers.  A loop over
// 64-deep K tiles takes the place of the TPU grid's sequential K axis; the
// tiles of A and W are staged in shared memory by `cp.async` through a ring
// of 3 stages, so the loads of tile k + 2 overlap the products of tile k.
// Rows of A past M, rows of W past N and columns past K load as zeros
// (`cp.async` with a source size of 0), so the ragged edges add nothing and
// no operand is padded in device memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace int8_gemm {

constexpr int kBlockM = 128;
constexpr int kBlockN = 128;
constexpr int kBlockK = 64;  // int8 elements (bytes) of K per shared-memory tile
constexpr int kStages = 3;
constexpr int kWarpsM = 2;
constexpr int kWarpsN = 4;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kWarpTileM = kBlockM / kWarpsM;  // 64
constexpr int kWarpTileN = kBlockN / kWarpsN;  // 32
constexpr int kMTiles = kWarpTileM / 16;       // m16 tiles per warp
constexpr int kNTiles = kWarpTileN / 8;        // n8 tiles per warp
// A shared row holds 64 bytes of K plus 16 of padding: a row stride of 80
// bytes (20 words) puts the 8 rows x 4 words one fragment load touches in
// 32 distinct banks.
constexpr int kRowBytes = kBlockK + 16;
constexpr int kStageBytes = (kBlockM + kBlockN) * kRowBytes;
constexpr int kSmemBytes = kStages * kStageBytes;  // dynamic shared memory per block

struct Operands {
  const int8_t* a;  // (M, K), row stride lda
  const int8_t* b;  // (N, K), row stride ldb
  int m, n, k;
  long long lda, ldb;
};

using Acc = int[kMTiles][kNTiles][4];

__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_size = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_size));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage the (kBlockM x kBlockK) tile of A and the (kBlockN x kBlockK) tile of W
// at (m0, n0, k0): 16-byte chunks, zeros past the edges.  K is a multiple of
// 16, so a chunk is wholly inside or wholly past it.
__device__ __forceinline__ void load_tile(uint8_t* stage, const Operands& op, int m0, int n0,
                                          int k0) {
  constexpr int kChunksPerRow = kBlockK / 16;
  uint8_t* a_s = stage;
  uint8_t* b_s = stage + kBlockM * kRowBytes;
#pragma unroll
  for (int i = 0; i < kBlockM * kChunksPerRow / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunksPerRow;
    const int c = (idx % kChunksPerRow) * 16;
    const bool valid = m0 + r < op.m && k0 + c < op.k;
    const int8_t* src = valid ? op.a + (long long)(m0 + r) * op.lda + k0 + c : op.a;
    cp_async_16(a_s + r * kRowBytes + c, src, valid);
  }
#pragma unroll
  for (int i = 0; i < kBlockN * kChunksPerRow / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunksPerRow;
    const int c = (idx % kChunksPerRow) * 16;
    const bool valid = n0 + r < op.n && k0 + c < op.k;
    const int8_t* src = valid ? op.b + (long long)(n0 + r) * op.ldb + k0 + c : op.b;
    cp_async_16(b_s + r * kRowBytes + c, src, valid);
  }
}

// acc += the products of the block's tile over all of K.  `after_tile(kt)` runs
// after the products of K tile kt (the grouped kernel dequantizes there).
//
// Fragment ownership of m16n8k32 (g = lane / 4, t = lane % 4):
//   a[0] = A[g][4t..4t+3]     a[1] = A[g+8][4t..4t+3]
//   a[2] = A[g][16+4t..+3]    a[3] = A[g+8][16+4t..+3]
//   b0 = B[4t..4t+3][g]       b1 = B[16+4t..+3][g]    (= W[g][...])
//   d[0..1] = C[g][2t..2t+1]  d[2..3] = C[g+8][2t..2t+1]
template <typename AfterTile>
__device__ __forceinline__ void gemm_mainloop(const Operands& op, int m0, int n0, uint8_t* smem,
                                              Acc& acc, AfterTile after_tile) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
  const int n_k = (op.k + kBlockK - 1) / kBlockK;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load_tile(smem + s * kStageBytes, op, m0, n0, s * kBlockK);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed (for this thread)
    __syncthreads();               // ... for every thread; tile kt - 1 is consumed
    const int next = kt + kStages - 1;
    if (next < n_k) load_tile(smem + (next % kStages) * kStageBytes, op, m0, n0, next * kBlockK);
    cp_async_commit();

    const uint8_t* a_s = smem + (kt % kStages) * kStageBytes;
    const uint8_t* b_s = a_s + kBlockM * kRowBytes;
#pragma unroll
    for (int kk = 0; kk < kBlockK / 32; ++kk) {
      const int col = kk * 32 + 4 * t;
      uint32_t a[kMTiles][4];
      uint32_t b[kNTiles][2];
#pragma unroll
      for (int mi = 0; mi < kMTiles; ++mi) {
        const uint8_t* row = a_s + (wm * kWarpTileM + mi * 16 + g) * kRowBytes + col;
        a[mi][0] = lds32(row);
        a[mi][1] = lds32(row + 8 * kRowBytes);
        a[mi][2] = lds32(row + 16);
        a[mi][3] = lds32(row + 8 * kRowBytes + 16);
      }
#pragma unroll
      for (int ni = 0; ni < kNTiles; ++ni) {
        const uint8_t* row = b_s + (wn * kWarpTileN + ni * 8 + g) * kRowBytes + col;
        b[ni][0] = lds32(row);
        b[ni][1] = lds32(row + 16);
      }
#pragma unroll
      for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
        for (int ni = 0; ni < kNTiles; ++ni) mma_s8_16832(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
      }
    }
    after_tile(kt);
  }
  cp_async_wait<0>();
}

// Where accumulator element acc[mi][ni][e] of this thread lies in the block tile.
__device__ __forceinline__ int acc_row(int mi, int e) {
  const int warp = threadIdx.x / 32;
  return (warp / kWarpsN) * kWarpTileM + mi * 16 + (threadIdx.x % 32) / 4 + (e >= 2 ? 8 : 0);
}

__device__ __forceinline__ int acc_col(int ni, int e) {
  const int warp = threadIdx.x / 32;
  return (warp % kWarpsN) * kWarpTileN + ni * 8 + 2 * (threadIdx.x % 4) + (e & 1);
}

// The dequantizing epilogue of the JAX package, in its operation order and
// with every fp32 operation rounded on its own (no fused multiply-add), so
// that the kernel computes exactly what the plain version computes:
// ((acc * xs) * ws) + bias.
__device__ __forceinline__ float dequant(int acc, float xs, float ws, float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws), bias);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low 16 bits)
  return *reinterpret_cast<uint32_t*>(&v);
}

// Symmetric int8 code of x at scale s: clip(round-half-even(x / s), -127, 127),
// with an IEEE division, as the plain version and the JAX package compute it.
__device__ __forceinline__ int quantize(float x, float s) {
  return static_cast<int>(fminf(fmaxf(rintf(x / s), -127.f), 127.f));
}

// Let the kernel use the dynamic shared memory of the ring (above 48 KB).
template <typename Kernel>
__host__ inline cudaError_t allow_ring_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
}

}  // namespace int8_gemm
