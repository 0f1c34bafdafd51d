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
// the group's 128-byte K tiles (the main loop of int8_gemm_hopper.cuh); after
// the group's last tile the products are waited for, each accumulator is
// converted, multiplied by the row's group scale and added into an fp32
// accumulator, also in registers, and the next group's first `wgmma`
// overwrites the int32 set.  The group must be a multiple of the 128-byte K
// tile, so a K tile never straddles two groups.
//
// What bounds it on the H100: tensor-core throughput (26,660 x 12,288 -> 3,072
// is 2.0 T int8 operations), plus the fp32 work and the drained product
// pipeline of the 12 group ends.  The fp32 set doubles the registers a
// thread holds, so the block tile is 128 x 128 (`wgmma` m64n128k32: 64 int32
// and 64 fp32 accumulators per consumer thread; m64n256 would need 256),
// with 6 stages of 32 KB in the ring.
//
// The fp32 operations are rounded one by one in the JAX function's order (no
// fused multiply-add), so the kernel computes what the plain version computes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libint8_gemm_gscale.so int8_gemm_gscale.cu
// (trajectorycrafter_tpu_torch/ops/kernels.py does this at first use).

#include "int8_gemm_hopper.cuh"

namespace {

using namespace int8_hopper;
using Loop = MainLoop<128, 6>;

struct Params {
  const float* __restrict__ hs;  // dense (M, n_groups)
  int n_groups;
  const float* __restrict__ ws;
  const float* __restrict__ bias;  // or null (a bias of 0 adds nothing)
  __nv_bfloat16* __restrict__ out;  // dense (M, N)
};

__global__ void __launch_bounds__(kThreads, 1)
int8_gemm_gscale_kernel(const __grid_constant__ CUtensorMap a_map,
                        const __grid_constant__ CUtensorMap b_map,
                        const __grid_constant__ Shape sh, const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  float facc[Loop::kAcc];
  float s_next[2];  // the group scales of this thread's two rows for the group in flight
  const auto load_scales = [&](int row0, int group) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      s_next[h] = row < sh.m && group < p.n_groups
                      ? __ldg(p.hs + static_cast<long long>(row) * p.n_groups + group)
                      : 0.f;
    }
  };
  Loop::run(
      smem_raw, &a_map, &b_map, sh, p.ws, p.bias,
      [&](int row0) { load_scales(row0, 0); },
      [&](const int (&acc)[Loop::kAcc], int group, int row0) {
        const float s[2] = {s_next[0], s_next[1]};
        load_scales(row0, group + 1);  // lands during the next group's products
        // 0 + x for the first group, as the plain version adds into zeros
#pragma unroll
        for (int i = 0; i < Loop::kAcc; ++i) {
          facc[i] = __fadd_rn(group == 0 ? 0.f : facc[i],
                              __fmul_rn(__int2float_rn(acc[i]), s[(i >> 1) & 1]));
        }
      },
      [&](const int (&acc)[Loop::kAcc], const Tile& tile) {
        Loop::store_bf16(acc, tile, sh, p.out, [&](const int (&)[Loop::kAcc], int i, float cw,
                                                   float cb) {
          return __fadd_rn(__fmul_rn(facc[i], cw), cb);
        });
      });
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream` of `device` and returns
// the cudaError_t of the launch (0 = success); it does not synchronise.
// `bias` may be null.  hq (M, K) and wq (N, K) by row strides lda and ldb
// (multiples of 16 bytes, 16-byte aligned); hs: dense (M, K / group) fp32;
// out: dense (M, N) bf16.  `group` is a multiple of 128 that divides K.
extern "C" int int8_gemm_gscale_fwd(int device, const void* hq, const void* wq, const void* hs,
                                    const void* ws, const void* bias, void* out, int m, int n, int k,
                                    long long lda, long long ldb, int group, void* stream) {
  if (group <= 0 || group % kBlockK != 0 || k % group != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Loop::Launch l;
  err = Loop::prepare(device, hq, wq, m, n, k, lda, ldb, group, l);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(int8_gemm_gscale_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Loop::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{static_cast<const float*>(hs), k / group, static_cast<const float*>(ws),
                 static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out)};
  int8_gemm_gscale_kernel<<<l.grid, kThreads, Loop::kSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(l.a_map, l.b_map, l.shape, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_gemm_gscale_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
