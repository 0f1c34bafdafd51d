"""The attention variants of the JAX package: the hand-written CUDA kernels on
the card, their plain PyTorch versions on the CPU.

Counterparts of the JAX package's Pallas kernels
  * ops/pallas/flash_lse.py ``flash_attention_with_lse`` / ``flash_lse_inner``
    (K5): running-max attention that also returns the logsumexp;
  * ops/pallas/flash_exp2.py ``flash_attention_exp2`` (K1b): exp2 attention
    with a fixed bias, a clamp and a key-validity mask, no running max;
  * ops/pallas/flash_pv8.py ``flash_attention_exp2_t_pv8`` (K6): bf16 q k^T,
    int8 probabilities x int8 V, the DiT's and the depth UNet's
    ``flash_pv8`` route;
  * ops/pallas/int8_flash_attention.py ``int8_flash_attention`` (K7): int8
    q, k and v, online softmax.

Each port function keeps its JAX signature, (B, H, S, D) in and out (K6's
output is (B, H, Sq, D), not the TPU kernel's transposed (B, H, D, Sq)), and
attends over exactly the keys it is given: where the JAX function takes
zero-padded keys and a pad count, the port takes the valid keys only and
counts its key blocks from key 0, so the last block holds the valid keys.

Each dispatches as ops/attention.py does: a CUDA tensor launches the kernel
(ops/kernels.py), a CPU tensor takes the plain version, which is the same
function in the same operation order.  The quantization passes of K6 and K7
(V, or q, k and V, per (batch, head)) are plain PyTorch on both.

The plain versions' integer products are exact in fp32: every product and
partial sum of int8 codes is an integer below 2^24 (at most 1,024 keys x
127^2 per block, or 128 x 127^2 per score), so ``matmul`` of the codes as
fp32 returns the int32 result in any summation order.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from trajectorycrafter_tpu_torch.ops import kernels
from trajectorycrafter_tpu_torch.ops.int8_matmul import ieee_div

LOG2E = math.log2(math.e)
LOG2_127 = math.log2(127.0)
PV8_CLAMP = 88.0  # K6's exp2 argument cap: 2^88 x an int32 block sum stays below fp32 max
EXP2_CLAMP = 110.0  # K1b's exp2 argument cap: 2^110 x 30k keys stays below fp32 max
LSE_FLOOR = 1e-30  # K5's and K6's denominator floor
INT8_ATTN_FLOOR = 1e-20  # K7's denominator floor
# Query rows per step of the plain versions: bounds their fp32 score blocks.
CHUNK = 1024


def _bshd(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) <-> (B, S, H, D), a view."""
    return x.transpose(1, 2)


def pv8_block_k(sq: int) -> int:
    """K6's key block, as the JAX dispatch picks it (ops/attention.py:133-140):
    1,024 keys where the query length is at least 2,048, else 512."""
    return 1024 if sq >= 2048 else 512


def int8_block_k(s: int) -> int:
    """K7's key block (int8_flash_attention.py:128-129): block_k = min(1024,
    block_q) with block_q = min(1024, max(128, the next power of two >= s)),
    so block_q itself: a power of two from 128 to 1,024, whole 128-key tiles
    of the kernel."""
    return min(1024, max(128, 1 << (s - 1).bit_length()))


def quantize_per_head(x: torch.Tensor):
    """Symmetric int8 per (batch, head) of (B, S, H, D): scale max(|x|, 1e-8)
    / 127 (an IEEE division), codes rint(x / scale) in [-127, 127].  ->
    ((B, S, H, D) int8, (B, H) fp32)."""
    xf = x.float()
    scale = ieee_div(xf.abs().amax(dim=(1, 3)).clamp_min(1e-8), 127.0)
    codes = torch.clamp(torch.round(xf / scale[:, None, :, None]), -127, 127)
    return codes.to(torch.int8), scale


def pv8_key_order() -> torch.Tensor:
    """The key order of K6's and K7's V^T inside each 32-key chunk: position
    16 h + 4 t + e holds key 16 h + 8 (e // 2) + 2 t + e % 2 (h < 2, t < 4,
    e < 4).

    The int8 PV of the PV-int8 loop takes the codes of a 32-key chunk from
    the registers that hold the scores: thread t of a quad holds keys 8 j +
    2 t and 8 j + 2 t + 1 of each 8-key column j, and packs keys 2t, 2t+1,
    8+2t, 9+2t (then the same 16 on) where the s8 A fragment reads
    positions 4t..4t+3 (16 on).
    Its V^T is laid out in the same order, so each code meets its own key's
    values; the int32 sums over a chunk are exact in any order
    (csrc/hopper_attention.cuh, namespace pv8)."""
    pos = torch.arange(32)
    h, t, e = pos // 16, (pos % 16) // 4, pos % 4
    return 16 * h + 8 * (e // 2) + 2 * t + e % 2


def pv8_keys_last(v8: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) int8 -> (B * H, D, L) int8, K6's and K7's V layout: the
    keys on the last axis, zero-padded to L, a multiple of
    ``kernels.PV8_KEY_TILE``, and in ``pv8_key_order`` inside each 32-key
    chunk."""
    b, s, h, d = v8.shape
    tile = kernels.PV8_KEY_TILE
    out = torch.zeros((b * h, d, -(-s // tile) * tile), dtype=torch.int8, device=v8.device)
    out[:, :, :s] = v8.permute(0, 2, 3, 1).reshape(b * h, d, s)
    order = pv8_key_order().to(v8.device)
    return out.unflatten(-1, (-1, 32))[..., order].flatten(-2)


def scaled_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q * scale * log2(e) rounded to q's dtype, as the exp2 kernels take it."""
    return (q.float() * (scale * LOG2E)).to(q.dtype)


# ----------------------------------------------------------------------------
# K5: attention with its logsumexp
# ----------------------------------------------------------------------------


def lse_reference(q: torch.Tensor, k: torch.Tensor, scale: float,
                  chunk: int = CHUNK) -> torch.Tensor:
    """(B, Sq, H, D), (B, Skv, H, D) -> (B, H, Sq) fp32: logsumexp over the
    keys of q . k * scale, in fp32 (float64 for float64 inputs)."""
    acc = torch.promote_types(q.dtype, torch.float32)  # float64 stays float64
    qt, kt = _bshd(q), _bshd(k).to(acc).transpose(-1, -2)
    out = torch.empty(qt.shape[:3], dtype=acc, device=q.device)
    for i in range(0, qt.shape[2], chunk):
        out[:, :, i:i + chunk] = torch.logsumexp(qt[:, :, i:i + chunk].to(acc) @ kt * scale, -1)
    return out


def lse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """(B, S, H, D) in -> (out (B, Sq, H, D), lse (B, H, Sq) fp32): K5 on the
    card; on the CPU its plain version, ``attention_reference`` and
    ``lse_reference``."""
    if q.is_cuda:
        return kernels.flash_lse(q, k, v, scale)
    from trajectorycrafter_tpu_torch.ops.attention import attention_reference

    return attention_reference(q, k, v, scale), lse_reference(q, k, scale)


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             sm_scale: Optional[float] = None):
    """(B, H, S, D) -> (out (B, H, Sq, D), lse (B, H, Sq)), full non-causal
    attention over the keys given (the JAX function's callers pad and let the
    zero keys count; pass them to get its answer)."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    out, lse = lse_attention(_bshd(q), _bshd(k), _bshd(v), scale)
    return _bshd(out), lse


def flash_lse_inner(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """The ring attention's inner step: (out as fp32, lse)."""
    out, lse = flash_attention_with_lse(q, k, v, sm_scale=scale)
    return out.float(), lse


# ----------------------------------------------------------------------------
# K1b: exp2 attention with a fixed bias
# ----------------------------------------------------------------------------


def exp2_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                             kv_valid: Optional[torch.Tensor] = None, bias: float = 0.0,
                             clamp: bool = True, chunk: int = CHUNK) -> torch.Tensor:
    """The plain version of K1b, (B, S, H, D) in and out: q' = q * scale *
    log2(e) rounded to q's dtype, s = q'.k - bias (the bias rounded to q's
    dtype, as the TPU kernel's extra contraction lane is), capped at 110
    when ``clamp``, p = exp2(s) rounded to v's dtype; the numerator sums p v
    and the denominator p, over the keys ``kv_valid`` marks."""
    qt = _bshd(scaled_q(q, scale))
    kt = _bshd(k).float().transpose(-1, -2)
    vt = _bshd(v).float()
    bias_q = float(torch.tensor(bias, dtype=q.dtype))
    valid = None if kv_valid is None else (kv_valid != 0).float()
    out = torch.empty(qt.shape, dtype=q.dtype, device=q.device)
    for i in range(0, qt.shape[2], chunk):
        s = qt[:, :, i:i + chunk].float() @ kt - bias_q
        if clamp:
            s = s.clamp_max(EXP2_CLAMP)
        p = torch.exp2(s).to(v.dtype).float()
        if valid is not None:
            p = p * valid
        out[:, :, i:i + chunk] = (p @ vt / p.sum(-1, keepdim=True).clamp_min(LSE_FLOOR)).to(q.dtype)
    return _bshd(out)


def exp2_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                   kv_valid: Optional[torch.Tensor] = None, bias: float = 0.0,
                   clamp: bool = True) -> torch.Tensor:
    """(B, S, H, D): K1b on the card, its plain version on the CPU."""
    if q.is_cuda:
        return kernels.flash_exp2(q, k, v, scale, kv_valid, bias, clamp)
    return exp2_attention_reference(q, k, v, scale, kv_valid, bias, clamp)


def flash_attention_exp2(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_valid: Optional[torch.Tensor] = None,
                         sm_scale: Optional[float] = None, bias: float = 0.0,
                         clamp: bool = True) -> torch.Tensor:
    """(B, H, S, D) -> (B, H, Sq, D), the JAX function's signature without its
    block sizes (its answer does not depend on them)."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    return _bshd(exp2_attention(_bshd(q), _bshd(k), _bshd(v), scale, kv_valid, bias, clamp))


# ----------------------------------------------------------------------------
# K6: bf16 q k^T, int8 p v
# ----------------------------------------------------------------------------


def pv8_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                  block_k: int, chunk: int = CHUNK) -> torch.Tensor:
    """The plain version of K6, (B, S, H, D) in and out, in the JAX kernel's
    operation order: V quantized per (batch, head); per block of ``block_k``
    keys, s = min(q'.k, 88) with q' as ``scaled_q``, m_adj = max(block row
    max - log2 127, -88), p8 = rint(exp2(s - m_adj)); acc += (p8 v8) *
    exp2(m_adj), den += (127 sum p8) * exp2(m_adj); out = acc / max(den,
    1e-30) * (127 vs)."""
    v8, vs = quantize_per_head(v)
    qt = _bshd(scaled_q(q, scale))
    kt = _bshd(k).float().transpose(-1, -2)
    v8t = _bshd(v8).float()
    out_scale = (vs * 127.0)[:, :, None, None]
    skv = k.shape[1]
    out = torch.empty(qt.shape, dtype=q.dtype, device=q.device)
    for i in range(0, qt.shape[2], chunk):
        qc = qt[:, :, i:i + chunk].float()
        acc = torch.zeros((*qc.shape[:3], v.shape[-1]), device=q.device)
        den = torch.zeros((*qc.shape[:3], 1), device=q.device)
        for j in range(0, skv, block_k):
            s = (qc @ kt[..., j:j + block_k]).clamp_max(PV8_CLAMP)
            m_adj = (s.amax(-1, keepdim=True) - LOG2_127).clamp_min(-PV8_CLAMP)
            p8 = torch.round(torch.exp2(s - m_adj))
            w = torch.exp2(m_adj)
            acc = acc + (p8 @ v8t[:, :, j:j + block_k]) * w
            den = den + (p8.sum(-1, keepdim=True) * 127.0) * w
        out[:, :, i:i + chunk] = (acc / den.clamp_min(LSE_FLOOR) * out_scale).to(q.dtype)
    return _bshd(out)


def pv8_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                  block_k: int) -> torch.Tensor:
    """(B, S, H, D): K6 on the card (after quantizing V), its plain version on
    the CPU."""
    if not q.is_cuda:
        return pv8_reference(q, k, v, scale, block_k)
    kernels.refuse_grad("flash_pv8", q, k, v)  # v reaches the kernel quantized
    v8, vs = quantize_per_head(v)
    return kernels.flash_pv8(q, k, pv8_keys_last(v8), vs.reshape(-1), scale * LOG2E, block_k)


def flash_attention_exp2_t_pv8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               sm_scale: Optional[float] = None,
                               block_k: int = 1024) -> torch.Tensor:
    """(B, H, S, D) -> (B, H, Sq, D) over the keys given, key blocks of
    ``block_k`` counted from key 0."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    return _bshd(pv8_attention(_bshd(q), _bshd(k), _bshd(v), scale, block_k))


# ----------------------------------------------------------------------------
# K7: int8 q, k and v
# ----------------------------------------------------------------------------


def int8_operands(q, k, v, scale):
    """The per-(batch, head) quantization of K7, outside its kernel: (q8, k8,
    v8, logit scale qs * ks * scale (B * H,), v scale vs / 127 (B * H,))."""
    q8, qs = quantize_per_head(q)
    k8, ks = quantize_per_head(k)
    v8, vs = quantize_per_head(v)
    return q8, k8, v8, ((qs * ks) * scale).reshape(-1), ieee_div(vs, 127.0).reshape(-1)


def int8_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                             block_k: int, chunk: int = CHUNK) -> torch.Tensor:
    """The plain version of K7, (B, S, H, D) in and out, in the JAX kernel's
    operation order: s = (q8 k8) * (qs ks scale); per block of ``block_k``
    keys m_new = max(m, block row max), alpha = exp(m - m_new), p = exp(s -
    m_new), p8 = rint(p * 127), acc = acc * alpha + (p8 v8) * (vs / 127),
    l = l * alpha + sum p; out = acc / max(l, 1e-20)."""
    q8, k8, v8, logit, v127 = int8_operands(q, k, v, scale)
    b, _, h, d = q.shape
    logit, v127 = logit.reshape(b, h, 1, 1), v127.reshape(b, h, 1, 1)
    qt = _bshd(q8).float()
    kt = _bshd(k8).float().transpose(-1, -2)
    vt = _bshd(v8).float()
    skv = k.shape[1]
    out = torch.empty(qt.shape, dtype=q.dtype, device=q.device)
    for i in range(0, qt.shape[2], chunk):
        qc = qt[:, :, i:i + chunk]
        m = torch.full((*qc.shape[:3], 1), -1e30, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((*qc.shape[:3], d), device=q.device)
        for j in range(0, skv, block_k):
            s = (qc @ kt[..., j:j + block_k]) * logit
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            p8 = torch.round(p * 127.0)
            acc = acc * alpha + (p8 @ vt[:, :, j:j + block_k]) * v127
            l = l * alpha + p.sum(-1, keepdim=True)
            m = m_new
        out[:, :, i:i + chunk] = (acc / l.clamp_min(INT8_ATTN_FLOOR)).to(q.dtype)
    return _bshd(out)


def int8_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                   block_k: int) -> torch.Tensor:
    """(B, S, H, D): K7 on the card (after quantizing q, k and v), its plain
    version on the CPU."""
    if not q.is_cuda:
        return int8_attention_reference(q, k, v, scale, block_k)
    kernels.refuse_grad("int8_flash_attention", q, k, v)  # they reach it quantized
    q8, k8, v8, logit, v127 = int8_operands(q, k, v, scale)
    return kernels.int8_flash_attention(q8, k8, pv8_keys_last(v8), logit, v127, block_k)


def int8_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """(B, H, S, D) -> (B, H, S, D); key blocks as the JAX function picks them
    (``int8_block_k``) over the S keys."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    block_k = int8_block_k(q.shape[2])
    return _bshd(int8_attention(_bshd(q), _bshd(k), _bshd(v), scale, block_k))
