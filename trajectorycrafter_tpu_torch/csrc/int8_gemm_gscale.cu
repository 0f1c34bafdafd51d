// The second GEMM of the fused int8 feed-forward, for Hopper (sm_90a): an int8
// GEMM whose A operand carries one scale per (row, K group), as
// int8_gemm_gelu_quant.cu writes it:
// acc = sum_j float(hq[row, group j] @ wq[col, group j]) * hs[row, j]  (fp32, j in order),
// out (M x N, bf16) = acc * ws[col] + bias[col].
//
// Replaces the TPU kernel trajectorycrafter_tpu/ops/pallas/int8_matmul.py
// `int8_matmul_gscale` (body `_kernel_gscale`), whose K block is the group:
// each grid step's int32 partial product is dequantized into an fp32 VMEM
// accumulator.  Here the int32 accumulators of a group stay in registers over
// the group's 64-deep K tiles (int8_gemm.cuh); at the group's end each is
// converted, multiplied by the row's group scale and added into an fp32
// accumulator, also in registers, and reset.  The group must be a multiple of
// the 64-deep K tile, so a K tile never straddles two groups.
//
// What bounds it on the H100: tensor-core throughput (26,660 x 12,288 -> 3,072
// is 2.0 T int8 operations), plus the fp32 work of the 12 group flushes; the
// second set of accumulators doubles the registers a thread holds.
//
// The fp32 operations are rounded one by one in the JAX function's order (no
// fused multiply-add), so the kernel computes what the plain version computes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libint8_gemm_gscale.so int8_gemm_gscale.cu
// (trajectorycrafter_tpu_torch/ops/kernels.py does this at first use).

#include "int8_gemm.cuh"

namespace {

using namespace int8_gemm;

__global__ void __launch_bounds__(kThreads)
int8_gemm_gscale_kernel(const Operands op, const float* __restrict__ hs, int n_groups,
                        int tiles_per_group, const float* __restrict__ ws,
                        const float* __restrict__ bias, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int m0 = blockIdx.x * kBlockM;
  const int n0 = blockIdx.y * kBlockN;
  Acc acc;
  float facc[kMTiles][kNTiles][4];
#pragma unroll
  for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNTiles; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][ni][e] = 0;
        facc[mi][ni][e] = 0.f;
      }

  gemm_mainloop(op, m0, n0, smem, acc, [&](int kt) {
    if ((kt + 1) % tiles_per_group != 0) return;
    const int group = kt / tiles_per_group;
#pragma unroll
    for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + acc_row(mi, 2 * h);
        const float s = row < op.m ? hs[(long long)row * n_groups + group] : 0.f;
#pragma unroll
        for (int ni = 0; ni < kNTiles; ++ni) {
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            facc[mi][ni][e] = __fadd_rn(facc[mi][ni][e], __fmul_rn(__int2float_rn(acc[mi][ni][e]), s));
            acc[mi][ni][e] = 0;
          }
        }
      }
    }
  });

#pragma unroll
  for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + acc_row(mi, 2 * h);
      if (row >= op.m) continue;
#pragma unroll
      for (int ni = 0; ni < kNTiles; ++ni) {
        const int col = n0 + acc_col(ni, 0);  // even; N is a multiple of 16
        if (col >= op.n) continue;
        const float b0 = bias != nullptr ? bias[col] : 0.f;
        const float b1 = bias != nullptr ? bias[col + 1] : 0.f;
        const float y0 = __fadd_rn(__fmul_rn(facc[mi][ni][2 * h], ws[col]), b0);
        const float y1 = __fadd_rn(__fmul_rn(facc[mi][ni][2 * h + 1], ws[col + 1]), b1);
        *reinterpret_cast<uint32_t*>(out + (long long)row * op.n + col) = pack_bf16(y0, y1);
      }
    }
  }
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream` of `device` and returns
// the cudaError_t of the launch (0 = success); it does not synchronise.
// `bias` may be null.  hs: dense (M, K / group) fp32; out: dense (M, N) bf16.
// `group` is a multiple of 64 that divides K.
extern "C" int int8_gemm_gscale_fwd(int device, const void* hq, const void* wq, const void* hs,
                                    const void* ws, const void* bias, void* out, int m, int n, int k,
                                    long long lda, long long ldb, int group, void* stream) {
  if (group % kBlockK != 0 || k % group != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_ring_smem(int8_gemm_gscale_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Operands op{static_cast<const int8_t*>(hq), static_cast<const int8_t*>(wq), m, n, k, lda, ldb};
  const dim3 grid((m + kBlockM - 1) / kBlockM, (n + kBlockN - 1) / kBlockN);
  int8_gemm_gscale_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      op, static_cast<const float*>(hs), k / group, group / kBlockK,
      static_cast<const float*>(ws), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_gemm_gscale_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
