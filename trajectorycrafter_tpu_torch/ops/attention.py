"""Attention dispatch: the hand-written CUDA kernel on the card, its plain
PyTorch version on the CPU.

Counterpart of trajectorycrafter_tpu/ops/attention.py.  The DiT's joint
text+video self-attention runs over 13,330 tokens at 384x672 and the
Perceiver cross-attention over 13,104 x 3,024; both go through
``multi_head_attention``.  For a CUDA tensor it launches the flash kernel
(ops/kernels.py, csrc/flash_attention.cu) whatever the size: there is no
size threshold and no fallback.  For a CPU tensor it takes
``attention_reference``, the plain version the tests and chip_smoke.py hold
the kernel against.
"""

from __future__ import annotations

from typing import Optional

import torch

from trajectorycrafter_tpu_torch.ops.kernels import flash_attention

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


def attention_error(out: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> dict:
    """Hold ``out`` (B, Sq, H, D) against ``attention_reference`` on the same
    inputs, within the tolerance above.  Returns the readings and ``ok``:
    ``max_elem_ratio`` is the largest error as a share of its element's
    bound (at most 1 passes), ``max_row_rel_err`` the largest row error."""
    ref = attention_reference(q, k, v, scale).float()
    weighted_v = attention_reference(q, k, v.abs(), scale).float()
    err = (out.float() - ref).abs()
    tiny = torch.finfo(torch.float32).tiny
    bound = ATTN_ELEM_TOL * (ref.abs() + weighted_v)
    elem_ratio = (err / bound.clamp_min(tiny)).max().item()
    row_rel = (err.norm(dim=-1) / ref.norm(dim=-1).clamp_min(tiny)).max().item()
    finite = bool(torch.isfinite(out).all())
    return {"max_abs_err": err.max().item(), "max_row_rel_err": row_rel,
            "max_elem_ratio": elem_ratio,
            "ok": finite and out.shape == ref.shape and elem_ratio <= 1.0
            and row_rel <= ATTN_ROW_TOL}


def multi_head_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S_kv, H, D)
    v: torch.Tensor,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Full (non-causal) MHA.  Returns (B, S, H*D).

    ``impl="auto"`` launches the kernel for CUDA tensors and takes the plain
    version for CPU tensors; ``impl="reference"`` takes the plain version on
    either, for holding a whole model's kernel run against it.
    """
    b, s, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    if impl == "auto":
        out = flash_attention(q, k, v, scale) if q.is_cuda else attention_reference(q, k, v, scale)
    elif impl == "reference":
        out = attention_reference(q, k, v, scale)
    else:
        raise ValueError(f"unknown attention impl {impl!r} (expected 'auto' or 'reference')")
    return out.reshape(b, s, h * d)
