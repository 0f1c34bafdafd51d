// int8 flash attention for Hopper (sm_90a): int8 q k^T and int8 p v.
//
// Replaces the TPU kernel
// trajectorycrafter_tpu/ops/pallas/int8_flash_attention.py
// `int8_flash_attention` (body `_kernel`).  q, k and v are quantized per
// (batch, head) outside the kernel, symmetric int8 with scales qs, ks, vs;
// the kernel computes the TPU kernel's online softmax, key block by key block
// of `block_k` keys counted from key 0 (the last block holds the valid keys
// only):
//
//   s     = float(sum q8 * k8, int32) * logit,  logit = qs * ks * scale
//   m_new = max(m, max over the block of s);  alpha = exp(m - m_new)
//   p     = exp(s - m_new);  p8 = rint(p * 127)
//   acc   = acc * alpha + float(sum p8 * v8, int32) * (vs / 127)
//   l     = l * alpha + sum p                (the fp32 p, not p8)
//   out   = acc / max(l, 1e-20)
//
// The int32 q k^T is exact, and so are m_new and alpha (the block max is
// taken on the int32 scores and converted once; logit > 0, so that is the
// max of the rounded products).  The weights are taken as p = exp2(x * (logit
// log2 e) - m_new log2 e) of the exact float x of each int32 score, one
// fused multiply-add and one SFU ex2 each, with the offset rounded up so
// that no p exceeds 1: within a few fp32 ulps of the plain version's exp(s -
// m_new), so a code differs from it only where 127 p lies that close to a
// rounding boundary.  The fold is in the plain version's order, each fp32
// operation rounded on its own.
//
// What bounds it on the H100: at the DiT shape (2 x 48 x 13,330 x 64) it does
// 2 x 2.2 T int8 operations against ~0.1 GB of int8 q/k/v, so the tensor
// cores (2.2 ms at 1,979 TOP/s) and, above them, the one exp per score on
// the SFU (1.7 x 10^10 exps: 4.08 ms at 16 per clock per SM), not device
// memory.  The design is the PV-int8 loop of hopper_attention.cuh (namespace
// pv8, with the int8 QK): TMA loads of q8 and k8 by strides and of the int8
// V^T tile, a K / V^T ring fed by a producer warp, consumer warpgroups of 64
// rows (three at d 64, two at d 128), `wgmma` s8 QK in both passes of a key
// block and `wgmma` s8 PV with the codes taken from registers, so that the
// exps of one warpgroup run while the others' products do.  V^T's keys are
// laid out in the order of the codes' A fragments inside each 32-key chunk
// (that header states why), so the key blocks are multiples of its 128-key
// tile.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libint8_flash_attention.so int8_flash_attention.cu
// (trajectorycrafter_tpu_torch/ops/kernels.py does this at first use).

#include "hopper_attention.cuh"

// Plain C entry point for ctypes.  Launches on `stream` of `device` and returns
// the cudaError_t of the launch (0 = success); it does not synchronise.
// q (B, Sq, H, D), k (B, Skv, H, D) int8 by strides; vt: (batch * heads,
// head_dim, vt_ld) int8 in the key order of ops/attention_variants.py
// pv8_keys_last, vt_ld and block_k multiples of 128; logit and v127 (batch *
// heads,) fp32: qs * ks * scale and vs / 127.
extern "C" int int8_flash_attention_fwd(int device, const void* q, const void* k, const void* vt,
                                        const void* logit, const void* v127, void* o, int batch,
                                        int heads, int sq, int skv, int head_dim, int block_k,
                                        long long q_sb, long long q_ss, long long q_sh,
                                        long long k_sb, long long k_ss, long long k_sh,
                                        long long vt_ld, long long o_sb, long long o_ss,
                                        long long o_sh, void* stream) {
  const hopper_attn::pv8::Args a{q,    k,    vt,   v127, o,    batch, heads, sq,   skv,
                                 head_dim, block_k, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                                 vt_ld, o_sb, o_ss, o_sh, 0.f, logit};
  return hopper_attn::pv8::launch<hopper_attn::pv8::kS8>(device, a, stream);
}

extern "C" const char* int8_flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
