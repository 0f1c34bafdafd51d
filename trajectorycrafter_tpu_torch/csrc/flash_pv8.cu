// PV-int8 attention for Hopper (sm_90a): bf16 q k^T, int8 probability x value.
//
// Replaces the TPU kernel trajectorycrafter_tpu/ops/pallas/flash_pv8.py
// `flash_attention_exp2_t_pv8` (body `_kernel`), which the JAX DiT runs for
// its joint self-attention (d 64) and its Perceiver (d 128) under
// `attention_impl="flash_pv8"`, and the depth UNet under
// TRAJCRAFTER_DEPTH_ATTN=flash_pv8.  It computes the TPU kernel's function,
// block by block of `block_k` keys counted from key 0 (the last block holds
// the valid keys only):
//
//   q'    = bf16(q * scale * log2 e)
//   s     = min(q' . k in fp32, 88)
//   m_adj = max(max over the block of s - log2 127, -88)
//   p8    = rint(exp2(s - m_adj))               in [0, 127]
//   acc  += float(sum p8 * v8, int32) * exp2(m_adj)
//   den  += float(127 * sum p8, int32) * exp2(m_adj)
//   out   = acc / max(den, 1e-30) * (127 * vs)
//
// with v8 = V quantized per (batch, head) outside the kernel (scale vs).  The
// TPU kernel carries the denominator as a 127-valued ones channel of V
// through its int8 matrix unit; here it is the exact int32 row sum of the
// codes.  Every fp32 operation of the block update is rounded on its own
// (no fused multiply-add), in the plain version's order.
//
// What bounds it on the H100: at the DiT shape (2 x 48 x 13,330 x 64) two
// bf16 QK passes of 2.2 TFLOP each (4.45 ms at 989 TFLOP/s) and one int8 PV
// of 2.2 T operations (1.1 ms at 1,979 TOP/s) against ~0.3 GB: tensor-core
// throughput, with one SFU exp2 per score in pass 2 close behind.  The
// design is the PV-int8 loop of hopper_attention.cuh (namespace pv8): TMA
// loads of q and k by strides and of the int8 V^T tile, a K / V^T ring fed
// by a producer warp, consumer warpgroups of 64 rows (three at d 64, two at
// d 128), `wgmma` QK in both passes of a key block and `wgmma` s8 PV with the
// codes taken from registers.  V^T's keys are laid out in the order of the
// codes' A fragments inside each 32-key chunk (that header states why), so
// the key blocks are multiples of its 128-key tile.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_pv8.so flash_pv8.cu
// (trajectorycrafter_tpu_torch/ops/kernels.py does this at first use).

#include "hopper_attention.cuh"

// Plain C entry point for ctypes.  Launches on `stream` of `device` and returns
// the cudaError_t of the launch (0 = success); it does not synchronise.
// `scale_log2` is the softmax scale times log2(e), rounded once to fp32 by the
// caller, as the plain version rounds it.  vt: (batch * heads, head_dim,
// vt_ld) int8 in the key order of ops/attention_variants.py pv8_keys_last,
// vt_ld and block_k multiples of 128.
extern "C" int flash_pv8_fwd(int device, const void* q, const void* k, const void* vt,
                             const void* vs, void* o, int batch, int heads, int sq, int skv,
                             int head_dim, int block_k, long long q_sb, long long q_ss,
                             long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                             long long vt_ld, long long o_sb, long long o_ss, long long o_sh,
                             float scale_log2, void* stream) {
  const hopper_attn::pv8::Args a{q,    k,    vt,   vs,   o,    batch, heads, sq,   skv,
                                 head_dim, block_k, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                                 vt_ld, o_sb, o_ss, o_sh, scale_log2, nullptr};
  return hopper_attn::pv8::launch<hopper_attn::pv8::kBf16>(device, a, stream);
}

extern "C" const char* flash_pv8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
