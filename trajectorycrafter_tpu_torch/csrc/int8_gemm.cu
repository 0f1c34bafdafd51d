// int8 x int8 -> int32 GEMM with the dequantizing epilogue, for Hopper (sm_90a):
// out (M x N, bf16) = (xq @ wq^T) * xs[row] * ws[col] + bias[col].
//
// Replaces the TPU kernel trajectorycrafter_tpu/ops/pallas/int8_matmul.py
// `int8_matmul` (body `_kernel`): the GEMM of every int8 linear layer of the
// DiT (q/k/v/out of the 42 blocks, the unfused feed-forward, the Perceivers'
// q/kv/out) and of the depth UNet's transformers under `--quant_depth int8`.
// The TPU kernel keeps an int32 accumulator in VMEM across its sequential K
// grid axis and pads M to its 512-row block with rows of 1.0; here the
// accumulator lives in registers across the K loop of one block tile, and
// the ragged M and N edges are zero-filled by the TMA unit and masked at the
// store.
//
// What bounds it on the H100: at the DiT's feed-forward shape (26,660 x 3,072
// -> 12,288) one call is 2.0 T int8 operations against ~0.8 GB of operands
// and output, so it is bound by tensor-core throughput; at the depth UNet's
// narrow layers (451,584 x 320 -> 320) it moves ~0.4 GB for 0.09 T operations
// and is bound by device memory.  The design is the main loop of
// int8_gemm_hopper.cuh (TMA, a 4-stage ring fed by a producer warp, `wgmma`
// m64n256k32 s8 from shared memory) on 128 x 256 block tiles, with the scales
// and the bias applied to the int32 accumulators in registers: the int32
// product never reaches device memory.
//
// No overflow: |acc| <= K * 127^2 <= 12,288 * 16,129 < 2^31.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libint8_gemm.so int8_gemm.cu
// (trajectorycrafter_tpu_torch/ops/kernels.py does this at first use).

#include "int8_gemm_hopper.cuh"

namespace {

using namespace int8_hopper;
using Loop = MainLoop<256, 4>;

struct Params {
  const float* __restrict__ xs;
  const float* __restrict__ ws;
  const float* __restrict__ bias;  // or null (a bias of 0 adds nothing)
  __nv_bfloat16* __restrict__ out;  // dense (M, N)
};

__global__ void __launch_bounds__(kThreads, 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap b_map, const __grid_constant__ Shape sh,
                 const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  float x_s[2];  // the row scales of this thread's two rows
  Loop::run(
      smem_raw, &a_map, &b_map, sh, p.ws, p.bias,
      [&](int row0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          x_s[h] = row0 + 8 * h < sh.m ? __ldg(p.xs + row0 + 8 * h) : 0.f;
        }
      },
      [](const int (&)[Loop::kAcc], int, int) {},
      [&](const int (&acc)[Loop::kAcc], const Tile& tile) {
        Loop::store_bf16(acc, tile, sh, p.out,
                         [&](const int (&a)[Loop::kAcc], int i, float cw, float cb) {
                           return dequant(a[i], x_s[(i >> 1) & 1], cw, cb);
                         });
      });
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream` of `device` and returns
// the cudaError_t of the launch (0 = success); it does not synchronise.
// `bias` may be null.  xq (M, K) and wq (N, K) by row strides lda and ldb
// (multiples of 16 bytes, 16-byte aligned); `out` is dense (M, N).
extern "C" int int8_gemm_fwd(int device, const void* xq, const void* wq, const void* xs,
                             const void* ws, const void* bias, void* out, int m, int n, int k,
                             long long lda, long long ldb, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Loop::Launch l;
  err = Loop::prepare(device, xq, wq, m, n, k, lda, ldb, 0, l);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(int8_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Loop::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{static_cast<const float*>(xs), static_cast<const float*>(ws),
                 static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out)};
  int8_gemm_kernel<<<l.grid, kThreads, Loop::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      l.a_map, l.b_map, l.shape, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
