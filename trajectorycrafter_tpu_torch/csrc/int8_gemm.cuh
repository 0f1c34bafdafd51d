// The `mma.sync` int8 pieces that int8_attention.cuh (K7,
// int8_flash_attention.cu) takes: the m16n8k32 s8 product and a 32-bit
// shared-memory load.  The int8 GEMMs (K2b, K3a, K3b) run on the `wgmma`
// main loop of int8_gemm_hopper.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace int8_gemm {

// d += a (16 x 32, s8, row-major) * b (32 x 8, s8, column-major); int32
// accumulate.  Fragment ownership (g = lane / 4, t = lane % 4):
//   a[0] = A[g][4t..4t+3]     a[1] = A[g+8][4t..4t+3]
//   a[2] = A[g][16+4t..+3]    a[3] = A[g+8][16+4t..+3]
//   b0 = B[4t..4t+3][g]       b1 = B[16+4t..+3][g]
//   d[0..1] = C[g][2t..2t+1]  d[2..3] = C[g+8][2t..2t+1]
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

}  // namespace int8_gemm
