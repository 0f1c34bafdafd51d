// bf16 tensor-core helpers shared by the attention kernels of this directory.
//
// `mma.sync` m16n8k16 (bf16 in, fp32 accumulate) and the packing of bf16
// pairs into the 32-bit registers its fragments are made of.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc_attn {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low 16 bits)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16x16, row-major) * b (16x8, column-major); bf16 in, fp32 accumulate.
// Fragment ownership (g = lane / 4, t = lane % 4):
//   a[0] = A[g][2t..2t+1]   a[1] = A[g+8][2t..2t+1]
//   a[2] = A[g][2t+8..+9]   a[3] = A[g+8][2t+8..+9]
//   b0   = B[2t..2t+1][g]   b1   = B[2t+8..2t+9][g]
//   d[0..1] = D[g][2t..2t+1]  d[2..3] = D[g+8][2t..2t+1]
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace tc_attn
