// Non-causal softmax attention, softmax(q k^T * scale) v, for Hopper (sm_90a),
// in three modes of one kernel body: the `wgmma` / TMA main loop of
// hopper_attention.cuh (its header comment states the design and what
// bounds it).
//
// Mode kExact (entry point flash_attention_fwd) replaces the TPU kernel
// trajectorycrafter_tpu/ops/pallas/flash_exp2.py `flash_attention_exp2_t`
// (body `_kernel_t`), which the DiT's joint self-attention (head dim 64) and
// the Perceiver cross-attention (head dim 128) run on.  The TPU kernel has no
// running max: it uses a fixed exp2 bias that is exact only for QK-normed
// scores, pads the sequences to its block multiple and corrects the
// denominator for the zero pad rows, and writes a (B, H, D, S) output to
// fill the 128-lane MXU.  None of that carries over.  This mode computes the
// function itself, with an online running max, so it is exact for the
// Perceiver's unnormalised scores too.
//
// It also replaces trajectorycrafter_tpu/ops/attention.py `_flash_attention`,
// JAX's library Pallas flash kernel (online running max, padded keys masked
// by segment ids), which carries the DepthCrafter UNet's large spatial
// self-attention (49 frames x 5 heads x 9,216 tokens x 64 and 49 x 10 x
// 2,304 x 64 at 576x1024): the same exact function, so the same kernel.
//
// Mode kLse (entry point flash_lse_fwd) replaces
// trajectorycrafter_tpu/ops/pallas/flash_lse.py `flash_attention_with_lse`:
// the same running-max attention, which also writes the natural-log
// logsumexp of each query row's scaled scores, lse = m + log(max(l, 1e-30)),
// fp32 (B, H, Sq).  The running max lives in the exp2 domain here, so the
// kernel converts: m = m2 * ln 2.  The TPU kernel masks nothing (callers pad
// to its block multiple and the zero keys count); this mode attends over
// exactly the keys it is given.
//
// Mode kExp2 (entry point flash_exp2_fwd) replaces
// trajectorycrafter_tpu/ops/pallas/flash_exp2.py `flash_attention_exp2`
// (body `_kernel`), the same attention as `_kernel_t` without the transposed
// output: no running max, q' = bf16(q * scale * log2 e) (rounded in shared
// memory before the product), s = q'.k - bias (the bias rounded to bf16, as
// its extra contraction lane is), clamped at 110 when asked, p =
// bf16(exp2(s)); the numerator sums p v and the denominator the same bf16 p,
// over the valid keys (an optional (Skv,) byte mask, the TPU kernel's
// validity column of V, read once per key tile).  exp2 runs on the SFU
// with weights below 2^-126 flushed to 0 (the plain version keeps them as
// subnormals: the two differ only in a row whose every weight lies below
// 2^-126), as exp2f's subnormal fix-up on every weight would add to the
// per-score work that bounds this mode at head dim 64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
// (trajectorycrafter_tpu_torch/ops/kernels.py does this at first use).

#include "hopper_attention.cuh"

using hopper_attn::Args;
using hopper_attn::launch;

// Plain C entry points for ctypes.  Each launches on `stream` of `device` and
// returns the cudaError_t of the launch (0 = success); none synchronises.
#define FLASH_COMMON_ARGS                                                             \
  int batch, int heads, int sq, int skv, int head_dim, long long q_sb, long long q_ss, \
      long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,  \
      long long v_ss, long long v_sh, long long o_sb, long long o_ss, long long o_sh,  \
      float scale
#define FLASH_COMMON_FIELDS                                                              \
  q, k, v, o, batch, heads, sq, skv, head_dim, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, \
      v_ss, v_sh, o_sb, o_ss, o_sh, scale

extern "C" int flash_attention_fwd(int device, const void* q, const void* k, const void* v, void* o,
                                   FLASH_COMMON_ARGS, void* stream) {
  const Args a{FLASH_COMMON_FIELDS, nullptr, nullptr, 0.f, 0};
  return launch<hopper_attn::kExact>(device, a, stream);
}

// `lse`: fp32 (batch * heads, sq), written as well as the output.
extern "C" int flash_lse_fwd(int device, const void* q, const void* k, const void* v, void* o,
                             void* lse, FLASH_COMMON_ARGS, void* stream) {
  const Args a{FLASH_COMMON_FIELDS, static_cast<float*>(lse), nullptr, 0.f, 0};
  return launch<hopper_attn::kLse>(device, a, stream);
}

// `kv_valid`: a (skv,) byte mask of the real keys, or null; `bias` already
// rounded to bf16; `clamp` nonzero caps the exp2 argument at 110.
extern "C" int flash_exp2_fwd(int device, const void* q, const void* k, const void* v, void* o,
                              const void* kv_valid, FLASH_COMMON_ARGS, float bias, int clamp,
                              void* stream) {
  const Args a{FLASH_COMMON_FIELDS, nullptr, static_cast<const uint8_t*>(kv_valid), bias, clamp};
  return launch<hopper_attn::kExp2>(device, a, stream);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
