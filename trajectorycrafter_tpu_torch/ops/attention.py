"""Attention dispatch: the hand-written CUDA kernels on the card, their plain
PyTorch version on the CPU.

Counterpart of trajectorycrafter_tpu/ops/attention.py.  The DiT's joint
text+video self-attention runs over 13,330 tokens at 384x672 and the
Perceiver cross-attention over 13,104 x 3,024; the DepthCrafter UNet's
large spatial self-attention over 9,216 and 2,304 tokens per frame at
576x1024.  All go through ``multi_head_attention``, whose ``impl`` names
the JAX package's: ``"auto"`` (the DiT) and ``"flash_stock"`` launch the
running-max kernel (csrc/flash_attention.cu), ``"flash_max"`` the two-pass
kernel (csrc/flash_maxpass.cu), ``"flash_pv8"`` the PV-int8 kernel
(csrc/flash_pv8.cu, a quantized function of its own), for CUDA tensors and
whatever the size: there is no size threshold (the depth UNet routes by
size itself) and no fallback.  For a CPU tensor they take their plain
version: ``attention_reference`` for the first two, ``maxpass_reference``
(the attention of the rounded scaled q) for ``"flash_max"``,
``pv8_reference`` (ops/attention_variants.py) for ``"flash_pv8"``.  ``"xla"`` (the JAX name
of the plain einsum) and ``"reference"`` take ``attention_reference`` on any
device, ``"flash_pv8_reference"`` K6's plain version on any device, for
holding a whole model's kernel run against it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from trajectorycrafter_tpu_torch.ops import attention_variants as av
from trajectorycrafter_tpu_torch.ops.kernels import flash_attention, flash_maxpass

# Query rows per step of the plain version: bounds its fp32 score block to
# B * H * 1024 * Skv floats (5.2 GB at the DiT's 2 x 48 x 13,330).
REFERENCE_CHUNK = 1024


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, chunk: int = REFERENCE_CHUNK) -> torch.Tensor:
    """(B, Sq, H, D) x (B, Skv, H, D) -> (B, Sq, H, D) softmax attention.

    Same arithmetic as the JAX ``_xla_attention``: fp32 scores and softmax,
    weights cast to v's dtype for the PV product.  Chunked over queries so
    that it fits at the DiT's sequence length.
    """
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # (B, H, S, D)
    kf = kt.float().transpose(-1, -2)
    out = torch.empty_like(qt)
    for i in range(0, qt.shape[2], chunk):
        scores = torch.matmul(qt[:, :, i:i + chunk].float(), kf) * scale
        weights = torch.softmax(scores, dim=-1).to(v.dtype)
        out[:, :, i:i + chunk] = torch.matmul(weights, vt)
    return out.transpose(1, 2)


def maxpass_plain_inputs(q: torch.Tensor, scale: float):
    """(q', scale') that make ``attention_reference`` the plain version of the
    two-pass kernel: like the TPU kernel it replaces (flash_max.py), the
    kernel multiplies q by scale * log2(e) and rounds it to q's dtype (bf16)
    before the product, then takes the softmax in base 2, which is the
    natural-base softmax of the scores times ln 2.  The rounding moves
    peaked rows by up to ~2% against the unrounded attention, so the kernel
    is held against this, its own function, not the running-max kernel's."""
    return (q.float() * (scale * math.log2(math.e))).to(q.dtype), math.log(2.0)


def maxpass_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float, chunk: int = REFERENCE_CHUNK) -> torch.Tensor:
    """The plain version of the two-pass kernel: ``attention_reference`` on
    ``maxpass_plain_inputs(q, scale)``."""
    q, scale = maxpass_plain_inputs(q, scale)
    return attention_reference(q, k, v, scale, chunk)


# Tolerance of a bf16 attention kernel against ``attention_reference``:
#
# - per element, |out - ref| <= ELEM_TOL * (|ref| + P|v|), where P|v| is the
#   attention-weighted |v| of that element (the plain version run on |v|).
#   Each side rounds its softmax weights to bf16 (unit roundoff 2^-8) at its
#   own point -- the kernel before normalising, against its running max, the
#   plain version after -- and rounds its output to bf16, so the worst case
#   is 2^-7 (|ref| + P|v|); 2^-6 leaves room for fp32 summation order.
# - per output row (one query, one head, D values), the relative L2 error
#   ||out - ref|| / ||ref|| <= ROW_TOL.  The rounding errors above are
#   independent in sign, so a sound kernel reads about 2^-8 here whether the
#   softmax is flat or peaked; a fault that scales a row or drops some keys
#   shifts the whole row by a share of itself (a row sum off by 10% reads
#   0.09).  Where the softmax is flat (P|v| ~ E|v| while |ref| ~ E|v| /
#   sqrt(Skv)) this bound, not the per-element one, is the one that catches
#   such faults.
ATTN_ELEM_TOL = 2.0 ** -6
ATTN_ROW_TOL = 2.0 ** -6


def _readings(out: torch.Tensor, ref: torch.Tensor, weighted_v: torch.Tensor):
    """(|out - ref|, each error over its element's bound, the largest row's
    relative L2 error, whether out is finite and of ref's shape)."""
    ref, weighted_v = ref.float(), weighted_v.float()
    err = (out.float() - ref).abs()
    tiny = torch.finfo(torch.float32).tiny
    ratio = err / (ATTN_ELEM_TOL * (ref.abs() + weighted_v)).clamp_min(tiny)
    row_rel = (err.norm(dim=-1) / ref.norm(dim=-1).clamp_min(tiny)).max().item()
    sane = bool(torch.isfinite(out).all()) and out.shape == ref.shape
    return err, ratio, row_rel, sane


def output_error(out: torch.Tensor, ref: torch.Tensor, weighted_v: torch.Tensor) -> dict:
    """Hold ``out`` against ``ref``, the plain version's output on the same
    inputs, within the tolerance above; ``weighted_v`` is the plain version
    run on |v|.  Returns the readings and ``ok``: ``max_elem_ratio`` is the
    largest error as a share of its element's bound (at most 1 passes),
    ``max_row_rel_err`` the largest row error."""
    err, ratio, row_rel, sane = _readings(out, ref, weighted_v)
    elem_ratio = ratio.max().item()
    return {"max_abs_err": err.max().item(), "max_row_rel_err": row_rel,
            "max_elem_ratio": elem_ratio,
            "ok": sane and elem_ratio <= 1.0 and row_rel <= ATTN_ROW_TOL}


def attention_error(out: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> dict:
    """``output_error`` of ``out`` (B, Sq, H, D) against ``attention_reference``."""
    return output_error(out, attention_reference(q, k, v, scale),
                        attention_reference(q, k, v.abs(), scale))


def plain_refs(plain, v: torch.Tensor):
    """(plain(v), plain(|v|)): a kernel's plain version, with every input but
    v bound, and the weighted |v| of the same weights -- the two references
    ``output_error`` and ``quantized_error`` take.  For K6 and K7, quantizing
    |v| per head gives the codes' magnitudes, so plain(|v|) weighs them with
    the same codes."""
    return plain(v), plain(v.abs())


# Tolerance of the quantized kernels K6 and K7 against their plain versions.
# Their weights are integer codes p8 = rint(.) of scores that agree with the
# plain version's to fp32 rounding (K6: the bf16 products are summed in
# another order; K7's int32 scores agree bit for bit, its exp nearly so).
# Where a score sits on a code's rounding boundary the two sides' codes
# differ by 1, which moves that row by ||v_j|| / (the row's code sum): at a
# peaked row, whose code sum is near 127, by ~0.8% of the row, and the bound
# of ``output_error`` fails on the elements the key dominates.  Measured on
# an H100: rows of up to 1.2% at the depth and Perceiver shapes (peaked).
# So: per row a relative L2 error of at most 2^-5 (a row sum off by 10%
# reads 0.09, skipped or added keys far more), and at most 2^-10 of the
# elements outside ``output_error``'s per-element bound.
QUANT_ROW_TOL = 2.0 ** -5
QUANT_ELEM_SHARE = 2.0 ** -10


def quantized_error(out: torch.Tensor, ref: torch.Tensor, weighted_v: torch.Tensor) -> dict:
    """Hold a K6 or K7 output against ``ref``, its plain version's output on
    the same inputs, within the tolerance above (``weighted_v``: the plain
    version run on |v|, ``plain_refs``)."""
    err, ratio, row_rel, sane = _readings(out, ref, weighted_v)
    outside = (ratio > 1.0).float().mean().item()
    return {"max_abs_err": err.max().item(), "max_row_rel_err": row_rel,
            "share_outside_elem_bound": outside,
            "ok": sane and row_rel <= QUANT_ROW_TOL and outside <= QUANT_ELEM_SHARE}


# Tolerance of K5's logsumexp against ``lse_reference``: both sum the same
# fp32 exponentials in another order (~1e-6 relative) and the kernel carries
# its max in base 2 (one more rounding of m * ln 2), so |lse - ref| <=
# 2^-12 (1 + |ref|) holds with a wide margin; an lse in base 2 instead of
# natural is off by 44% of itself.
LSE_TOL = 2.0 ** -12


def lse_error(lse: torch.Tensor, q: torch.Tensor, k: torch.Tensor, scale: float) -> dict:
    """Hold K5's lse (B, H, Sq) against ``lse_reference`` on the same inputs."""
    ref = av.lse_reference(q, k, scale)
    err = (lse.float() - ref).abs()
    ratio = (err / (LSE_TOL * (1.0 + ref.abs()))).max().item()
    finite = bool(torch.isfinite(lse).all())
    return {"max_abs_err": err.max().item(), "max_lse_ratio": ratio,
            "ok": finite and lse.shape == ref.shape and ratio <= 1.0}


def kernel_error(kernel, out: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, scale: float) -> dict:
    """``output_error`` of ``kernel``'s output against the plain version of
    the kernel's own function: the two-pass kernel's rounds the scaled q
    first (``maxpass_reference``)."""
    plain = maxpass_reference if kernel is flash_maxpass else attention_reference
    return output_error(out, *plain_refs(lambda x: plain(q, k, x, scale), v))


def _pv8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """K6 with the JAX dispatch's key block (ops/attention.py:124-142)."""
    return av.pv8_attention(q, k, v, scale, av.pv8_block_k(q.shape[1]))


def _pv8_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    return av.pv8_reference(q, k, v, scale, av.pv8_block_k(q.shape[1]))


# impl -> (what it launches for CUDA tensors, or None; its plain version)
_IMPLS = {"auto": (flash_attention, attention_reference),
          "flash_stock": (flash_attention, attention_reference),
          "flash_max": (flash_maxpass, maxpass_reference),
          "flash_pv8": (_pv8, _pv8_plain),
          "flash_pv8_reference": (None, _pv8_plain),
          "reference": (None, attention_reference), "xla": (None, attention_reference)}


def multi_head_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S_kv, H, D)
    v: torch.Tensor,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Full (non-causal) MHA.  Returns (B, S, H*D).

    ``impl`` ``"auto"`` / ``"flash_stock"``, ``"flash_max"`` and
    ``"flash_pv8"`` launch their kernel for CUDA tensors and take their plain
    version for CPU tensors; ``"reference"`` / ``"xla"`` and
    ``"flash_pv8_reference"`` take a plain version on either.
    """
    b, s, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    if impl not in _IMPLS:
        raise ValueError(f"unknown attention impl {impl!r} (expected one of {sorted(_IMPLS)})")
    kernel, plain = _IMPLS[impl]
    if kernel is not None and q.is_cuda:
        out = kernel(q, k, v, scale)
    else:
        out = plain(q, k, v, scale)
    return out.reshape(b, s, h * d)
