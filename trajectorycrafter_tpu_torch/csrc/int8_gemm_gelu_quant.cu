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
// its row max is a plain reduction.  Here the products run on the `wgmma` s8
// main loop of int8_gemm_hopper.cuh (TMA, a producer-fed ring, two consumer
// warpgroups, a persistent grid) on 128 x 256 block tiles, so a group of
// 1,024 columns spans 4 blocks.  Those blocks run as one thread block
// cluster along N, and the clusters walk the (M tile, group) units.  The
// epilogue works in registers: each consumer dequantizes and applies the
// gelu in place of its int32 accumulators, takes its rows' |y| maxima (a
// `wgmma` row of 256 columns lies in the 4 lanes of a quad: two shuffles),
// stores them into every block of the cluster with `st.async` (counted on
// an mbarrier of the receiving block), waits for the cluster's, quantizes
// against the group max, and writes int8 through shared memory in whole
// 128-byte rows; the cluster's rank-0 block writes `hs`.  Quantizing per
// block tile would compute a different function.  A group that is not a
// multiple of 256 (128, 384, 640, 896) runs the same code on 128 x 128
// tiles, clusters of up to 7.
//
// What bounds it on the H100: tensor-core throughput (26,660 x 3,072 -> 12,288
// is 2.0 T int8 operations: 1.02 ms at 1,979 TOP/s).  The fp32 intermediate
// (1.3 GB at that shape) never reaches device memory: the kernel writes 1
// byte per element and one float per row and group.  The cost no product
// hides: the accurate tanh and the quantizing division on 327.5 M outputs
// are CUDA-core work while this block's tensor cores idle (the producer
// keeps loading the next tile meanwhile).
//
// The arithmetic follows the JAX function: the dequantizing epilogue of
// int8_gemm_hopper.cuh, then 0.5 * y * (1 + tanh(c * (y + 0.044715 * y^3))) in
// that order with each fp32 operation rounded on its own and the accurate
// `tanhf` (the approximate tanh.approx.f32 moves the gelu by ~2^-11 relative
// and flips int8 codes), and the quantization of int8_quantize_rows.cu.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libint8_gemm_gelu_quant.so int8_gemm_gelu_quant.cu
// (trajectorycrafter_tpu_torch/ops/kernels.py does this at first use).

#include "int8_gemm_hopper.cuh"

namespace {

using namespace int8_hopper;

constexpr int kMaxGroup = 1024;

__device__ __forceinline__ float gelu_tanh(float y) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, y), y), y);
  const float inner = __fmul_rn(c, __fadd_rn(y, cube));
  return __fmul_rn(__fmul_rn(0.5f, y), __fadd_rn(1.f, tanhf(inner)));
}

// Symmetric int8 code of x at scale s: clip(round-half-even(x / s), -127, 127),
// with an IEEE division, as the plain version and the JAX package compute it.
__device__ __forceinline__ int quantize(float x, float s) {
  return static_cast<int>(fminf(fmaxf(rintf(x / s), -127.f), 127.f));
}

struct Params {
  const float* __restrict__ xs;
  int8_t* __restrict__ hq;  // dense (M, N)
  float* __restrict__ hs;   // dense (M, N / group)
  int n_groups;
};

// BN: the block tile's columns; a cluster of kMaxCluster or fewer blocks
// along N covers one group.
template <int BN, int kStages, int kMaxCluster>
__global__ void __launch_bounds__(kThreads, 1)
gelu_quant_kernel(const __grid_constant__ CUtensorMap a_map,
                  const __grid_constant__ CUtensorMap b_map, const __grid_constant__ Shape sh,
                  const float* __restrict__ ws, const float* __restrict__ bias,
                  const __grid_constant__ Params p) {
  using Loop = MainLoop<BN, kStages, true>;
  extern __shared__ uint8_t smem_raw[];
  // the |y| maxima of each block of the cluster, by tile parity
  __shared__ float peer_max[2][kMaxCluster][kBlockM];
  __shared__ uint64_t peers_in[2];  // full once every block's maxima landed
  const int cluster = sh.cluster, rank = blockIdx.x % cluster;
  if (threadIdx.x == 0) {
    mbar_init(&peers_in[0], 1);
    mbar_init(&peers_in[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // no block stores into another before its barriers exist

  float x_s[2];  // the row scales of this thread's two rows
  Loop::run(
      smem_raw, &a_map, &b_map, sh, ws, bias,
      [&](int row0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          x_s[h] = row0 + 8 * h < sh.m ? __ldg(p.xs + row0 + 8 * h) : 0.f;
        }
      },
      [](const int (&)[Loop::kAcc], int, int) {},
      [&](int (&acc)[Loop::kAcc], const Tile& tl) {
        // 1-2. y in place of the accumulators, and this thread's |y| maxima
        float mx[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < Loop::kAcc; ++i) {
          const int c = tl.col_in + 8 * (i / 4) + (i & 1);  // column in the tile
          const float y = gelu_tanh(dequant(acc[i], x_s[(i >> 1) & 1], tl.cw[c], tl.cb[c]));
          acc[i] = __float_as_int(y);
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], fabsf(y));
        }
        // 3. the rows' maxima over the quad, into every block of the cluster
        const int t = tl.tid % 4, buf = tl.local & 1;
        if (tl.me == 0 && tl.tid == 0) {
          mbar_expect_tx(&peers_in[buf], cluster * kBlockM * sizeof(float));
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        }
        if (t == 0) {
          for (int r = 0; r < cluster; ++r) {
            const uint32_t bar = cluster_addr(&peers_in[buf], r);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              st_async(cluster_addr(&peer_max[buf][rank][tl.row_in + 8 * h], r), mx[h], bar);
            }
          }
        }
        mbar_wait<true>(&peers_in[buf], (tl.local >> 1) & 1);
        // 4. the group's scales
        float s[2];
        const int group = tl.n0 / (cluster * BN);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float g = 0.f;
          for (int r = 0; r < cluster; ++r) g = fmaxf(g, peer_max[buf][r][tl.row_in + 8 * h]);
          s[h] = fmaxf(g, 1e-8f) / 127.f;
          const int row = tl.m0 + tl.row_in + 8 * h;
          if (rank == 0 && t == 0 && row < sh.m) {
            p.hs[static_cast<long long>(row) * p.n_groups + group] = s[h];
          }
        }
        // 5-6. the codes, through shared memory, 128 columns at a time: whole
        // 128-byte rows to hq
        constexpr int kCodeCols = 128;
#pragma unroll
        for (int chunk = 0; chunk < BN / kCodeCols; ++chunk) {
#pragma unroll
          for (int jj = 0; jj < kCodeCols / 8; ++jj) {
            const int i0 = 4 * (chunk * kCodeCols / 8 + jj);  // registers of column block j
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int q0 = quantize(__int_as_float(acc[i0 + 2 * h]), s[h]);
              const int q1 = quantize(__int_as_float(acc[i0 + 2 * h + 1]), s[h]);
              *reinterpret_cast<uint16_t*>(tl.stage +
                                           (tl.row_in - 64 * tl.me + 8 * h) * kChunkPitch +
                                           8 * jj + tl.col_in) =
                  static_cast<uint16_t>((q0 & 0xff) | ((q1 & 0xff) << 8));
            }
          }
          named_sync(kStoreBarrier + tl.me, 128);
          const int c0 = tl.n0 + chunk * kCodeCols;
#pragma unroll
          for (int q = 0; q < 4; ++q) {  // 16 bytes a thread, 16 rows a pass
            const int r = tl.tid / 8 + 16 * q;
            const int row = tl.m0 + 64 * tl.me + r;
            if (row < sh.m) {  // N is a multiple of the group: every column is in
              *reinterpret_cast<uint4*>(p.hq + static_cast<long long>(row) * sh.n + c0 +
                                        16 * (tl.tid % 8)) =
                  *reinterpret_cast<const uint4*>(tl.stage + r * kChunkPitch + 16 * (tl.tid % 8));
            }
          }
          named_sync(kStoreBarrier + tl.me, 128);  // the stage is read before it is rewritten
        }
      });
  cluster_sync();  // no block leaves while another may still store into it
}

template <int BN, int kStages, int kMaxCluster>
cudaError_t launch(int device, const void* xq, const void* wq, const float* xs, const float* ws,
                   const float* bias, int8_t* hq, float* hs, int m, int n, int k, long long lda,
                   long long ldb, int group, cudaStream_t stream) {
  using Loop = MainLoop<BN, kStages, true>;
  const auto kernel = gelu_quant_kernel<BN, kStages, kMaxCluster>;
  const int cluster = group / BN;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Loop::kSmemBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = Loop::kSmemBytes;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  // the clusters the card holds at once at this shared-memory size: the
  // SMs of a cluster share a GPC, and 132 SMs need not hold 33 clusters of 4
  config.gridDim = dim3(cluster);
  int max_clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&max_clusters, kernel, &config);
  if (err != cudaSuccess) return err;
  if (max_clusters < 1) return cudaErrorInvalidConfiguration;
  typename Loop::Launch l;
  err = Loop::prepare(device, xq, wq, m, n, k, lda, ldb, 0, l, cluster, max_clusters);
  if (err != cudaSuccess) return err;
  config.gridDim = l.grid;
  const Params p{xs, hq, hs, n / group};
  err = cudaLaunchKernelEx(&config, kernel, l.a_map, l.b_map, l.shape, ws, bias, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream` of `device` and returns
// the cudaError_t of the launch (0 = success); it does not synchronise.
// `bias` may be null.  xq (M, K) and wq (N, K) by row strides lda and ldb
// (multiples of 16 bytes, 16-byte aligned); hq: dense (M, N) int8; hs: dense
// (M, N / group) fp32.  `group` is a multiple of 128 up to 1,024 that divides N.
extern "C" int int8_gemm_gelu_quant_fwd(int device, const void* xq, const void* wq, const void* xs,
                                        const void* ws, const void* bias, void* hq, void* hs, int m,
                                        int n, int k, long long lda, long long ldb, int group,
                                        void* stream) {
  if (group <= 0 || group % 128 != 0 || group > kMaxGroup || n % group != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto args = [&](auto launcher) {
    return launcher(device, xq, wq, static_cast<const float*>(xs), static_cast<const float*>(ws),
                    static_cast<const float*>(bias), static_cast<int8_t*>(hq),
                    static_cast<float*>(hs), m, n, k, lda, ldb, group,
                    static_cast<cudaStream_t>(stream));
  };
  // 128 x 256 tiles (K2b's) where the group is a whole number of them, else
  // 128 x 128 (K3b's ring), clusters of group / 256 or group / 128 blocks
  if (group % 256 == 0) return static_cast<int>(args(launch<256, 4, kMaxGroup / 256>));
  return static_cast<int>(args(launch<128, 6, kMaxGroup / 128 - 1>));
}

extern "C" const char* int8_gemm_gelu_quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
