// The int8 probability x value product of int8_flash_attention.cu (K7), on
// `mma.sync` (K6, flash_pv8.cu, runs its own on `wgmma`: hopper_attention.cuh).
//
// The kernel holds a 16-row x 64-key tile of scores in the accumulator
// layout of `mma.sync` m16n8k{16,32} (thread g = lane / 4, t = lane % 4 owns
// keys 8j + 2t and 8j + 2t + 1 of rows g and g + 8, for j = 0..7), quantize
// the softmax weights of the tile to int8 codes p8 in [0, 127], and add
// p8 (16 x 64) * v8 (64 x D) on the tensor cores with
// `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32` into int32 accumulators.
//
// The A fragment of m16n8k32 wants keys 4t..4t+3 and 16+4t..16+4t+3 of each
// 32-key slice, which is not what a thread holds.  PV sums over keys, so any
// permutation of the keys that is applied to both operands leaves the
// product unchanged: the A fragment is built from the keys the thread holds,
// in the order (2t, 2t+1, 8+2t, 9+2t | 16+2t, 17+2t, 24+2t, 25+2t), and V's
// rows are permuted the same way as they are staged into shared memory.  The
// codes never leave the registers.
//
// V is staged transposed, v_s[d][key], from a (D, keys) int8 array per
// (batch, head) whose key axis is padded with zeros to a multiple of 64, so
// that a B fragment (four consecutive permuted keys of one column d) is one
// 32-bit shared load.  The row stride of 80 bytes (20 words) puts the 8 x 4
// words a warp loads for a fragment in 32 distinct banks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_gemm.cuh"

namespace int8_attn {

constexpr int kKeyTile = 64;          // keys per shared-memory tile
constexpr int kVtStride = 64 + 16;    // bytes per staged V^T row

// The staged position of key pair u (keys 2u, 2u+1) of a 32-key slice:
// u = 4a + t with a = key / 8, t = (key % 8) / 2 goes to pair 8 (a / 2) +
// 2t + (a % 2), so that logical keys 4t..4t+3 are physical keys 2t, 2t+1,
// 8+2t, 9+2t (and 16 further on for a = 2, 3).
__device__ __forceinline__ int staged_pair(int u) {
  const int a = u / 4, t = u % 4;
  return 8 * (a / 2) + 2 * t + (a % 2);
}

// Stage keys [n0, n0 + 64) of the (D, keys_padded) int8 V^T of one (batch,
// head) into v_s (D rows of kVtStride bytes), permuted as above.
template <int D, int kThreads>
__device__ __forceinline__ void stage_vt(const int8_t* vt, long long ld, int n0, uint8_t* v_s) {
  constexpr int kChunks = D * (kKeyTile / 16);  // 16-byte chunks of the tile
  for (int idx = threadIdx.x; idx < kChunks; idx += kThreads) {
    const int d = idx / (kKeyTile / 16);
    const int c = idx % (kKeyTile / 16);  // keys 16c..16c+15 of the tile
    const uint4 x = *reinterpret_cast<const uint4*>(vt + d * ld + n0 + 16 * c);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
    uint8_t* row = v_s + d * kVtStride + 32 * (c / 2);
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // pair i of the chunk is pair u of its slice
      const int u = 8 * (c % 2) + i;
      const uint16_t pair = static_cast<uint16_t>(w[i / 2] >> (16 * (i % 2)));
      *reinterpret_cast<uint16_t*>(row + 2 * staged_pair(u)) = pair;
    }
  }
}

__device__ __forceinline__ uint32_t pack4(int b0, int b1, int b2, int b3) {
  return static_cast<uint32_t>(b0) | (static_cast<uint32_t>(b1) << 8) |
         (static_cast<uint32_t>(b2) << 16) | (static_cast<uint32_t>(b3) << 24);
}

// acc (D / 8 n-tiles of int32 C fragments) += p8 (the thread's codes of one
// 64-key tile, in the score accumulator layout) * the staged V tile.
template <int D>
__device__ __forceinline__ void pv_tile(const int (&p8)[kKeyTile / 8][4], const uint8_t* v_s,
                                        int (&acc)[D / 8][4]) {
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  uint32_t a[2][4];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int j = 4 * c;
    a[c][0] = pack4(p8[j][0], p8[j][1], p8[j + 1][0], p8[j + 1][1]);
    a[c][1] = pack4(p8[j][2], p8[j][3], p8[j + 1][2], p8[j + 1][3]);
    a[c][2] = pack4(p8[j + 2][0], p8[j + 2][1], p8[j + 3][0], p8[j + 3][1]);
    a[c][3] = pack4(p8[j + 2][2], p8[j + 2][3], p8[j + 3][2], p8[j + 3][3]);
  }
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd) {
    const uint8_t* col = v_s + (8 * jd + g) * kVtStride + 4 * t;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      int8_gemm::mma_s8_16832(acc[jd], a[c], int8_gemm::lds32(col + 32 * c),
                              int8_gemm::lds32(col + 32 * c + 16));
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

template <typename T>
__device__ __forceinline__ T quad_sum(T x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace int8_attn
