// int8 x int8 -> int32 GEMM with the dequantizing epilogue, for Hopper (sm_90a):
// out (M x N, bf16) = (xq @ wq^T) * xs[row] * ws[col] + bias[col].
//
// Replaces the TPU kernel trajectorycrafter_tpu/ops/pallas/int8_matmul.py
// `int8_matmul` (body `_kernel`): the GEMM of every int8 linear layer of the
// DiT (q/k/v/out of the 42 blocks, the unfused feed-forward, the Perceivers'
// q/kv/out) and of the depth UNet's transformers under `--quant_depth int8`.
// The TPU kernel keeps an int32 accumulator in VMEM across its sequential K
// grid axis and pads M to its 512-row block with rows of 1.0; here the
// accumulator lives in registers across the K loop of one thread block
// (int8_gemm.cuh), and the ragged M tail is masked in the kernel.
//
// What bounds it on the H100: at the DiT's feed-forward shape (26,660 x 3,072
// -> 12,288) one call is 2.0 T int8 operations against ~0.8 GB of operands
// and output, so it is bound by tensor-core throughput; at the depth UNet's
// narrow layers (451,584 x 320 -> 320) it moves ~0.4 GB for 0.09 T operations
// and is bound by device memory.  The design stages both operands through a
// cp.async ring so the tensor cores are fed from shared memory, and applies
// the scales and the bias to the int32 accumulators in registers: the int32
// product never reaches device memory.
//
// No overflow: |acc| <= K * 127^2 <= 12,288 * 16,129 < 2^31.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libint8_gemm.so int8_gemm.cu
// (trajectorycrafter_tpu_torch/ops/kernels.py does this at first use).

#include "int8_gemm.cuh"

namespace {

using namespace int8_gemm;

__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const Operands op, const float* __restrict__ xs, const float* __restrict__ ws,
                 const float* __restrict__ bias, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int m0 = blockIdx.x * kBlockM;
  const int n0 = blockIdx.y * kBlockN;
  Acc acc;
#pragma unroll
  for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNTiles; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;
  gemm_mainloop(op, m0, n0, smem, acc, [](int) {});

#pragma unroll
  for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + acc_row(mi, 2 * half);
      if (row >= op.m) continue;
      const float x_s = xs[row];
#pragma unroll
      for (int ni = 0; ni < kNTiles; ++ni) {
        const int col = n0 + acc_col(ni, 0);  // even; N is a multiple of 16
        if (col >= op.n) continue;
        const float b0 = bias != nullptr ? bias[col] : 0.f;
        const float b1 = bias != nullptr ? bias[col + 1] : 0.f;
        const float y0 = dequant(acc[mi][ni][2 * half], x_s, ws[col], b0);
        const float y1 = dequant(acc[mi][ni][2 * half + 1], x_s, ws[col + 1], b1);
        *reinterpret_cast<uint32_t*>(out + (long long)row * op.n + col) = pack_bf16(y0, y1);
      }
    }
  }
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream` of `device` and returns
// the cudaError_t of the launch (0 = success); it does not synchronise.
// `bias` may be null.  `out` is dense (M, N).
extern "C" int int8_gemm_fwd(int device, const void* xq, const void* wq, const void* xs,
                             const void* ws, const void* bias, void* out, int m, int n, int k,
                             long long lda, long long ldb, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_ring_smem(int8_gemm_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Operands op{static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq), m, n, k, lda, ldb};
  const dim3 grid((m + kBlockM - 1) / kBlockM, (n + kBlockN - 1) / kBlockN);
  int8_gemm_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      op, static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
