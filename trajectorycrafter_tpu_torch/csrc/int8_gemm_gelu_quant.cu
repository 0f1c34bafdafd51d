// The first GEMM of the fused int8 feed-forward, for Hopper (sm_90a): int8 GEMM,
// dequantize, bias, tanh-gelu, and a re-quantization to int8 with one scale per
// (row, group of `group` columns):
// y = gelu_tanh((xq @ wq^T) * xs[row] * ws[col] + bias[col]),
// hs[row, j] = max(max_{col in group j} |y[row, col]|, 1e-8) / 127,
// hq[row, col] = clip(round-half-even(y[row, col] / hs[row, j]), -127, 127).
//
// Replaces the TPU kernel trajectorycrafter_tpu/ops/pallas/int8_matmul.py
// `int8_matmul_gelu_quant` (body `_kernel_gelu_quant`).  There the group is a
// whole 1,024-column output block, which one TPU grid step holds in VMEM, so
// its row max is a plain reduction.  A Hopper block holds a 128 x 128 tile in
// registers; a group of 1,024 columns spans 8 such tiles.  So the 8 blocks of
// a group run as one thread block cluster (1 x group/128 blocks): each reduces
// its tile's row maxima into shared memory, the cluster synchronises, and
// each block reads the other blocks' maxima through distributed shared memory
// before it quantizes any value.  Quantizing per 128-column tile would compute
// a different function.
//
// What bounds it on the H100: tensor-core throughput (26,660 x 3,072 -> 12,288
// is 2.0 T int8 operations).  The fp32 intermediate (1.3 GB at that shape)
// never reaches device memory: the kernel writes 1 byte per element and one
// float per row and group.
//
// The arithmetic follows the JAX function: the dequantizing epilogue of
// int8_gemm.cuh, then 0.5 * y * (1 + tanh(c * (y + 0.044715 * y^3))) in that
// order with each fp32 operation rounded on its own and the accurate `tanhf`
// (the approximate tanh.approx.f32 moves the gelu by ~2^-11 relative and
// flips int8 codes), and the quantization of int8_quantize_rows.cu.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libint8_gemm_gelu_quant.so int8_gemm_gelu_quant.cu
// (trajectorycrafter_tpu_torch/ops/kernels.py does this at first use).

#include <cooperative_groups.h>

#include "int8_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace int8_gemm;

constexpr int kMaxCluster = 8;  // the portable cluster size: groups up to 1,024 columns

__device__ __forceinline__ float gelu_tanh(float y) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, y), y), y);
  const float inner = __fmul_rn(c, __fadd_rn(y, cube));
  return __fmul_rn(__fmul_rn(0.5f, y), __fadd_rn(1.f, tanhf(inner)));
}

__global__ void __launch_bounds__(kThreads)
int8_gemm_gelu_quant_kernel(const Operands op, const float* __restrict__ xs,
                            const float* __restrict__ ws, const float* __restrict__ bias,
                            int8_t* __restrict__ hq, float* __restrict__ hs, int n_groups) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float warp_max[kWarpsN][kBlockM];
  __shared__ float tile_max[kBlockM];  // read by the other blocks of the cluster
  __shared__ float group_max[kBlockM];
  cg::cluster_group cluster = cg::this_cluster();
  const int m0 = blockIdx.x * kBlockM;
  const int n0 = blockIdx.y * kBlockN;

  Acc acc;
#pragma unroll
  for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNTiles; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;
  gemm_mainloop(op, m0, n0, smem, acc, [](int) {});

  // y in registers, and this thread's |y| maxima of its rows (two per m16 tile)
  float y[kMTiles][kNTiles][4];
  float row_max[kMTiles][2];
#pragma unroll
  for (int mi = 0; mi < kMTiles; ++mi) {
    const float x_s0 = m0 + acc_row(mi, 0) < op.m ? xs[m0 + acc_row(mi, 0)] : 0.f;
    const float x_s1 = m0 + acc_row(mi, 2) < op.m ? xs[m0 + acc_row(mi, 2)] : 0.f;
    row_max[mi][0] = row_max[mi][1] = 0.f;
#pragma unroll
    for (int ni = 0; ni < kNTiles; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + acc_col(ni, e);  // N is a multiple of the group: in range
        const float b = bias != nullptr ? bias[col] : 0.f;
        const float v = gelu_tanh(dequant(acc[mi][ni][e], e < 2 ? x_s0 : x_s1, ws[col], b));
        y[mi][ni][e] = v;
        row_max[mi][e / 2] = fmaxf(row_max[mi][e / 2], fabsf(v));
      }
    }
  }

  // the tile's row maxima: over the quad (the 4 lanes of a row), then over the
  // warps along N
  const int warp = threadIdx.x / 32;
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = row_max[mi][h];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (t == 0) warp_max[warp % kWarpsN][acc_row(mi, 2 * h)] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < kBlockM) {
    float v = warp_max[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarpsN; ++w) v = fmaxf(v, warp_max[w][threadIdx.x]);
    tile_max[threadIdx.x] = v;
  }

  // the group's row maxima over the blocks of the cluster
  cluster.sync();  // every block's tile_max is written
  if (threadIdx.x < kBlockM) {
    float v = 0.f;
    for (unsigned r = 0; r < cluster.num_blocks(); ++r) {
      v = fmaxf(v, cluster.map_shared_rank(&tile_max[0], r)[threadIdx.x]);
    }
    group_max[threadIdx.x] = v;
  }
  cluster.sync();  // every remote read is done (blocks may exit), group_max is visible

  const int group = blockIdx.y / cluster.num_blocks();  // the cluster is 1 x group/128
  const bool writes_scales = cluster.block_rank() == 0 && warp % kWarpsN == 0 && t == 0;
#pragma unroll
  for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int local = acc_row(mi, 2 * h);
      const int row = m0 + local;
      if (row >= op.m) continue;
      const float s = fmaxf(group_max[local], 1e-8f) / 127.f;
      if (writes_scales) hs[(long long)row * n_groups + group] = s;
#pragma unroll
      for (int ni = 0; ni < kNTiles; ++ni) {
        const int col = n0 + acc_col(ni, 0);
        const int q0 = quantize(y[mi][ni][2 * h], s);
        const int q1 = quantize(y[mi][ni][2 * h + 1], s);
        *reinterpret_cast<uint16_t*>(hq + (long long)row * op.n + col) =
            static_cast<uint16_t>((q0 & 0xff) | ((q1 & 0xff) << 8));
      }
    }
  }
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream` of `device` and returns
// the cudaError_t of the launch (0 = success); it does not synchronise.
// `bias` may be null.  hq: dense (M, N) int8; hs: dense (M, N / group) fp32.
// `group` is a multiple of 128 up to 1,024 that divides N.
extern "C" int int8_gemm_gelu_quant_fwd(int device, const void* xq, const void* wq, const void* xs,
                                        const void* ws, const void* bias, void* hq, void* hs, int m,
                                        int n, int k, long long lda, long long ldb, int group,
                                        void* stream) {
  if (group % kBlockN != 0 || group / kBlockN > kMaxCluster || n % group != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_ring_smem(int8_gemm_gelu_quant_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Operands op{static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq), m, n, k, lda, ldb};

  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((m + kBlockM - 1) / kBlockM, n / kBlockN);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = kSmemBytes;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = group / kBlockN;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, int8_gemm_gelu_quant_kernel, op, static_cast<const float*>(xs),
                           static_cast<const float*>(ws), static_cast<const float*>(bias),
                           static_cast<int8_t*>(hq), static_cast<float*>(hs), n / group);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_gemm_gelu_quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
