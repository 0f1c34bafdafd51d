// Two-pass softmax attention with the exact row max, for Hopper (sm_90a), on
// the `wgmma` / TMA main loop of hopper_attention.cuh (its header comment
// states the design and what bounds it).
//
// Replaces the TPU kernel trajectorycrafter_tpu/ops/pallas/flash_max.py
// `flash_attention_maxpass` (bodies `_max_kernel` and `_attn_kernel`), the
// DepthCrafter UNet's opt-in spatial self-attention
// (TRAJCRAFTER_DEPTH_ATTN=flash_max): exact attention for unbounded scores,
// with the softmax's per-row constant taken from a first pass instead of a
// running max.
//
//   pass 1: m[row] = max over keys of (q * scale * log2 e) . k
//   pass 2: out[row] = sum_j exp2(s_j - m[row]) v_j / sum_j exp2(s_j - m[row])
//
// As in the TPU kernel, q is multiplied by scale * log2(e) in fp32 and
// rounded to bf16 before the product (in shared memory, once), keys past the
// end score -1e30 in both passes, the row sum adds the bf16-rounded weights
// that multiply v, and the denominator is floored at 1e-30.  Both passes
// compute the scores with the same `wgmma` sequence on the same shared
// layouts (`issue_qk`), so pass 2's scores equal pass 1's bit for bit and
// every exp2 argument is <= 0: no rescaling of the accumulator is needed.
//
// Both passes run in one launch per query tile: pass 1 streams the K
// tiles alone through the ring and keeps the row max in registers, then
// pass 2 streams K and V again.  No row-max buffer goes through device
// memory.  At the depth shape (49 frames x 5 heads x 9,216 tokens x 64)
// pass 2 does ~5.3 TFLOP and pass 1 another ~2.7: the extra QK product is
// the price of dropping the running-max rescale.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_maxpass.so flash_maxpass.cu
// (trajectorycrafter_tpu_torch/ops/kernels.py does this at first use).

#include "hopper_attention.cuh"

// Plain C entry point for ctypes.  Launches both passes on `stream` of
// `device` and returns the cudaError_t of the launch (0 = success); it does
// not synchronise.
extern "C" int flash_maxpass_fwd(int device, const void* q, const void* k, const void* v, void* o,
                                 int batch, int heads, int sq, int skv, int head_dim,
                                 long long q_sb, long long q_ss, long long q_sh,
                                 long long k_sb, long long k_ss, long long k_sh,
                                 long long v_sb, long long v_ss, long long v_sh,
                                 long long o_sb, long long o_ss, long long o_sh,
                                 float scale, void* stream) {
  const hopper_attn::Args a{q,    k,    v,    o,    batch, heads, sq,    skv,     head_dim,
                            q_sb, q_ss, q_sh, k_sb, k_ss,  k_sh,  v_sb,  v_ss,    v_sh,
                            o_sb, o_ss, o_sh, scale, nullptr, nullptr, 0.f, 0};
  return hopper_attn::launch<hopper_attn::kMaxPass>(device, a, stream);
}

extern "C" const char* flash_maxpass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
