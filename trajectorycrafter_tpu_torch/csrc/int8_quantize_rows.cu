// Per-row symmetric int8 quantization of bf16 activations, for Hopper (sm_90a):
// xs[row] = max(max_k |x[row, k]|, 1e-8) / 127,
// xq[row, k] = clip(round-half-even(x[row, k] / xs[row]), -127, 127).
//
// A second entry, `int8_quantize_rows_scaled`, takes xs and writes xq only:
// the row-parallel layers of a tensor-parallel DiT (ops/int8.py
// `Int8RowParallelLinear`) hold a slice of each row's columns and quantize it
// with the scale of the whole row, which they reduce across ranks first.
//
// Replaces the TPU kernel trajectorycrafter_tpu/ops/pallas/int8_matmul.py
// `quantize_rows_pallas` (body `_quant_kernel`), the dynamic activation
// quantization in front of every int8 GEMM.  The TPU kernel reads a block of
// rows into VMEM, sized to its 16 MB scoped-VMEM budget, and writes the scale
// broadcast over 128 lanes for the GEMM's tiling; neither carries over: one
// warp owns one row, and the scale is one float per row.
//
// What bounds it on the H100: device memory.  It does no arithmetic to speak
// of and moves 3 bytes per element (2 in, 1 out), so the design reads each
// row with 16-byte vector loads, neighbouring lanes on neighbouring
// addresses, reduces the row max with warp shuffles (no shared memory, no
// block barrier), and re-reads the row for the quantization pass, which the
// L1/L2 caches serve (a row is at most 24 KB).
//
// The arithmetic is the plain version's, bit for bit: the max is exact,
// the division is IEEE (this file is built without fast math) and
// `rintf` rounds half to even as `torch.round` and `jnp.round` do.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libint8_quantize_rows.so int8_quantize_rows.cu
// (trajectorycrafter_tpu_torch/ops/kernels.py does this at first use).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;  // one warp per row
constexpr int kVec = 8;           // bf16 values per 16-byte load

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__global__ void __launch_bounds__(32 * kRowsPerBlock)
quantize_rows_kernel(const __nv_bfloat16* __restrict__ x, long long ldx, int8_t* __restrict__ xq,
                     float* __restrict__ xs, int m, int k) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= m) return;
  const __nv_bfloat16* xr = x + (long long)row * ldx;

  float amax = 0.f;
  for (int c = lane * kVec; c < k; c += 32 * kVec) {
    float f[kVec];
    unpack(*reinterpret_cast<const uint4*>(xr + c), f);
#pragma unroll
    for (int i = 0; i < kVec; ++i) amax = fmaxf(amax, fabsf(f[i]));
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset /= 2) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, offset));
  }
  const float s = fmaxf(amax, 1e-8f) / 127.f;
  if (lane == 0) xs[row] = s;

  int8_t* qr = xq + (long long)row * k;
  for (int c = lane * kVec; c < k; c += 32 * kVec) {
    float f[kVec];
    unpack(*reinterpret_cast<const uint4*>(xr + c), f);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int q = static_cast<int>(fminf(fmaxf(rintf(f[i] / s), -127.f), 127.f));
      packed[i / 4] |= (static_cast<uint32_t>(q) & 0xffu) << (8 * (i % 4));
    }
    *reinterpret_cast<uint2*>(qr + c) = make_uint2(packed[0], packed[1]);
  }
}

// The same quantization pass with the row scales given: one warp per row.
__global__ void __launch_bounds__(32 * kRowsPerBlock)
quantize_rows_scaled_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                            const float* __restrict__ xs, int8_t* __restrict__ xq, int m, int k) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= m) return;
  const __nv_bfloat16* xr = x + (long long)row * ldx;
  const float s = __ldg(xs + row);
  int8_t* qr = xq + (long long)row * k;
  for (int c = lane * kVec; c < k; c += 32 * kVec) {
    float f[kVec];
    unpack(*reinterpret_cast<const uint4*>(xr + c), f);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int q = static_cast<int>(fminf(fmaxf(rintf(f[i] / s), -127.f), 127.f));
      packed[i / 4] |= (static_cast<uint32_t>(q) & 0xffu) << (8 * (i % 4));
    }
    *reinterpret_cast<uint2*>(qr + c) = make_uint2(packed[0], packed[1]);
  }
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream` of `device` and returns
// the cudaError_t of the launch (0 = success); it does not synchronise.
// x: (M, K) bf16 with row stride ldx; xq: dense (M, K) int8; xs: (M,) fp32.
extern "C" int int8_quantize_rows_fwd(int device, const void* x, void* xq, void* xs, int m, int k,
                                      long long ldx, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + kRowsPerBlock - 1) / kRowsPerBlock);
  quantize_rows_kernel<<<grid, 32 * kRowsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), ldx, static_cast<int8_t*>(xq),
      static_cast<float*>(xs), m, k);
  return static_cast<int>(cudaGetLastError());
}

// The scale-taking entry: xs (M,) fp32 is read, not written.
extern "C" int int8_quantize_rows_scaled_fwd(int device, const void* x, const void* xs, void* xq,
                                             int m, int k, long long ldx, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + kRowsPerBlock - 1) / kRowsPerBlock);
  quantize_rows_scaled_kernel<<<grid, 32 * kRowsPerBlock, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), ldx, static_cast<const float*>(xs),
      static_cast<int8_t*>(xq), m, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_quantize_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
