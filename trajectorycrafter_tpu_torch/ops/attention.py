"""Attention dispatch: the hand-written CUDA kernels on the card, their plain
PyTorch version on the CPU.

Counterpart of trajectorycrafter_tpu/ops/attention.py.  The DiT's joint
text+video self-attention runs over 13,330 tokens at 384x672 and the
Perceiver cross-attention over 13,104 x 3,024; the DepthCrafter UNet's
large spatial self-attention over 9,216 and 2,304 tokens per frame at
576x1024.  All go through ``multi_head_attention``, whose ``impl`` names
the JAX package's: ``"auto"`` (the DiT), ``"flash"`` (the JAX name of the
same K1 route, which its benches build the DiT with) and ``"flash_stock"``
launch the running-max kernel (csrc/flash_attention.cu), ``"flash_max"`` the two-pass
kernel (csrc/flash_maxpass.cu), ``"flash_pv8"`` the PV-int8 kernel
(csrc/flash_pv8.cu, a quantized function of its own), for CUDA tensors and
whatever the size: there is no size threshold (the depth UNet routes by
size itself) and no fallback.  For a CPU tensor they take their plain
version: ``attention_reference`` for the first three, ``maxpass_reference``
(the attention of the rounded scaled q) for ``"flash_max"``,
``pv8_reference`` (ops/attention_variants.py) for ``"flash_pv8"``.  ``"xla"`` (the JAX name
of the plain einsum) and ``"reference"`` take ``attention_reference`` on any
device, ``"flash_pv8_reference"`` K6's plain version on any device, for
holding a whole model's kernel run against it.  Any other name raises
``ValueError``, where the JAX dispatch would send it to XLA without a word.

The gradient (LoRA training): ``FlashAttentionFunction`` is the port of the
``custom_vjp`` of JAX's library flash attention (``_flash_attention`` under
``impl="flash_stock"``): K5 forward, then the two backward kernels of
csrc/flash_attention_bwd.cu (dK/dV and dQ) with ``attention_backward_reference``
as their plain version.  Under autograd ``"flash_stock"`` takes it; every
other kernel route raises on the card, since its kernel has no backward.

Each ``multi_head_attention`` call, whatever its route, is one
``attention`` span of the tracer (utils/timing.py).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from trajectorycrafter_tpu_torch.ops import attention_variants as av
from trajectorycrafter_tpu_torch.ops import kernels
from trajectorycrafter_tpu_torch.utils.timing import span
from trajectorycrafter_tpu_torch.ops.kernels import (
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_lse,
    flash_maxpass,
)

# Query rows per step of the plain version: bounds its fp32 score block to
# B * H * 1024 * Skv floats (5.2 GB at the DiT's 2 x 48 x 13,330).
REFERENCE_CHUNK = 1024


def accumulate_dtype(x: torch.Tensor) -> torch.dtype:
    """The type the plain versions compute scores in: fp32, or float64 for
    float64 inputs (``torch.autograd.gradcheck`` runs them in float64)."""
    return torch.promote_types(x.dtype, torch.float32)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, chunk: int = REFERENCE_CHUNK) -> torch.Tensor:
    """(B, Sq, H, D) x (B, Skv, H, D) -> (B, Sq, H, D) softmax attention.

    Same arithmetic as the JAX ``_xla_attention``: fp32 scores and softmax
    (float64 for float64 inputs), weights cast to v's dtype for the PV
    product.  Chunked over queries so that it fits at the DiT's sequence
    length.
    """
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # (B, H, S, D)
    acc = accumulate_dtype(q)
    kf = kt.to(acc).transpose(-1, -2)
    out = torch.empty_like(qt)
    for i in range(0, qt.shape[2], chunk):
        scores = torch.matmul(qt[:, :, i:i + chunk].to(acc), kf) * scale
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


# ----------------------------------------------------------------------------
# The gradient: K5 forward, the backward kernels of csrc/flash_attention_bwd.cu
# ----------------------------------------------------------------------------


def _backward(q, k, v, out, lse, dout, scale, chunk, magnitudes):
    """The plain backward pass, chunked over queries: (dq, dk, dv), and with
    ``magnitudes`` also each one's sum of magnitudes, the same products over
    |.| with |ds| taken as p (|dout| |v|^T + |di|), which no cancellation
    shrinks (the bound of ``attention_backward_error``)."""
    acc = accumulate_dtype(q)
    qt, kt, vt, dot = (x.transpose(1, 2).to(acc) for x in (q, k, v, dout))  # (B, H, S, D)
    lse = lse.to(acc)
    di = (out.to(acc) * dout.to(acc)).sum(-1).transpose(1, 2)  # (B, H, Sq)
    fresh = lambda: [torch.empty_like(qt), torch.zeros_like(kt), torch.zeros_like(vt)]
    grads, mags = fresh(), fresh() if magnitudes else None
    kT, vT = kt.transpose(-1, -2), vt.transpose(-1, -2)
    for i in range(0, qt.shape[2], chunk):
        rows = slice(i, i + chunk)
        qc, doc, dic = qt[:, :, rows], dot[:, :, rows], di[:, :, rows, None]
        p = torch.exp(torch.matmul(qc, kT) * scale - lse[:, :, rows, None])
        ds = p * (torch.matmul(doc, vT) - dic)
        grads[0][:, :, rows] = torch.matmul(ds, kt) * scale
        grads[1] += torch.matmul(ds.transpose(-1, -2), qc) * scale
        grads[2] += torch.matmul(p.transpose(-1, -2), doc)
        if magnitudes:
            ds_mag = p * (torch.matmul(doc.abs(), vT.abs()) + dic.abs())
            mags[0][:, :, rows] = torch.matmul(ds_mag, kt.abs()) * scale
            mags[1] += torch.matmul(ds_mag.transpose(-1, -2), qc.abs()) * scale
            mags[2] += torch.matmul(p.transpose(-1, -2), doc.abs())
    grads = tuple(g.transpose(1, 2) for g in grads)
    return grads, None if mags is None else tuple(m.transpose(1, 2) for m in mags)


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                                 scale: float, chunk: int = REFERENCE_CHUNK):
    """The plain version of the attention backward: -> (dq, dk, dv), (B, S, H,
    D) in fp32 (float64 for float64 inputs).  q (B, Sq, H, D), k and v (B,
    Skv, H, D), out and dout (B, Sq, H, D), lse (B, H, Sq) the natural-log
    logsumexp of q k^T * scale.  With p = exp(q k^T * scale - lse), di =
    sum(out * dout) over the head dim and ds = p (dout v^T - di): dq = scale
    ds k, dk = scale ds^T q, dv = p^T dout, in fp32 scores like
    ``attention_reference`` and chunked over queries the same way.  The tests
    and chip_smoke.py use it; the port's gradient runs
    ``FlashAttentionFunction``."""
    return _backward(q, k, v, out, lse, dout, scale, chunk, magnitudes=False)[0]


# Tolerance of the backward kernels against ``attention_backward_reference``
# on the same inputs (the same lse and out):
#
# - per element, |g - ref| <= BWD_ELEM_TOL * (|ref| + mag), where mag is the
#   same sum over magnitudes (``_backward``).  The kernels round p (dV) and ds
#   (dK, dQ) to bf16 for their products (unit roundoff 2^-8 of each term) and
#   their outputs to bf16 once, and sum fp32 products in another order than
#   the plain version, so a sound answer is within 2^-8 (|ref| + mag) with room
#   for summation order under 2^-6.  mag takes |ds| as p (|dout| |v|^T +
#   |di|): where dout . v nearly equals di, fp32 summation order alone moves ds
#   by much of itself.
# - per (batch, head), the relative L2 error ||g - ref|| / ||ref|| over the
#   head's gradient <= BWD_HEAD_TOL.  The rounding errors above are
#   independent in sign, so a sound kernel reads about 2^-8 to 2^-9; a fault
#   that drops di, or the last quarter of the query tiles from dK/dV, moves
#   whole heads by a share of themselves (tens of percent where the rows are
#   peaked, as a trained model's are).  A head whose gradient cancels to
#   below BWD_NOISE_FLOOR of its sum of magnitudes (one key: p = 1 and out =
#   v, so ds = dout . v - di is 0 but for fp32 rounding) is measured against
#   that share of its magnitudes instead: there the reference itself is
#   rounding noise.
BWD_ELEM_TOL = 2.0 ** -6
BWD_HEAD_TOL = 2.0 ** -6
BWD_NOISE_FLOOR = 2.0 ** -10


def attention_backward_error(grads, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                             scale: float) -> dict:
    """Hold ``grads`` -- a dict with any of "dq", "dk", "dv", (B, S, H, D) --
    against the plain version on the same inputs within the tolerance
    above.  Returns per gradient the largest error over its element's bound
    (``<name>_max_elem_ratio``, at most 1 passes), the largest head's
    relative L2 error (``<name>_max_head_rel_err``) and its largest absolute
    error, and ``ok``."""
    (dq, dk, dv), (mq, mk, mv) = _backward(q, k, v, out, lse, dout, scale, REFERENCE_CHUNK,
                                           magnitudes=True)
    refs = {"dq": (dq, mq), "dk": (dk, mk), "dv": (dv, mv)}
    readings, ok = {}, True
    tiny = torch.finfo(torch.float32).tiny
    for name, g in grads.items():
        ref, mag = (x.float() for x in refs[name])
        err = (g.float() - ref).abs()
        ratio = (err / (BWD_ELEM_TOL * (ref.abs() + mag)).clamp_min(tiny)).max().item()
        # per (batch, head): sums over the sequence and the head dim
        norm = lambda x: x.square().sum((1, 3)).sqrt()
        scale = torch.maximum(norm(ref), BWD_NOISE_FLOOR * norm(mag)).clamp_min(tiny)
        head = (norm(err) / scale).max().item()
        sane = bool(torch.isfinite(g).all()) and g.shape == ref.shape
        readings.update({f"{name}_max_abs_err": err.max().item(),
                         f"{name}_max_elem_ratio": ratio, f"{name}_max_head_rel_err": head})
        ok = ok and sane and ratio <= 1.0 and head <= BWD_HEAD_TOL
    readings["ok"] = ok
    return readings


def attention_di(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """di = sum(out * dout) over the head dim, (B, S, H, D) -> (B, H, S)
    fp32 contiguous: one stock reduction before the backward kernels, as JAX
    computes it in XLA before its backward Pallas kernels."""
    return (out.float() * dout.float()).sum(-1).transpose(1, 2).contiguous()


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable attention, (B, S, H, D) q, k, v -> (B, Sq, H, D), the
    port of JAX's ``custom_vjp`` flash attention (K4 and its two backward
    Pallas kernels).  On the card the forward is K5 (``flash_lse``: the
    output and the natural-log logsumexp, JAX's m + log l), saving q, k, v,
    out and lse; the backward computes di (``attention_di``), then dK and dV
    (``flash_attention_bwd_dkv``) and dQ (``flash_attention_bwd_dq``).  On the
    CPU both take their plain versions (``attention_reference`` with
    ``lse_reference``; ``attention_backward_reference``), which keep float64
    inputs in float64."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if q.is_cuda:
            out, lse = flash_lse(q, k, v, scale)
        else:
            out, lse = attention_reference(q, k, v, scale), av.lse_reference(q, k, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if q.is_cuda:
            dout = dout.contiguous()
            di = attention_di(out, dout)
            dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, di, ctx.scale)
            dq = flash_attention_bwd_dq(q, k, v, dout, lse, di, ctx.scale)
        else:
            dq, dk, dv = attention_backward_reference(q, k, v, out, lse, dout, ctx.scale)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def _pv8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """K6 with the JAX dispatch's key block (ops/attention.py:124-142)."""
    return av.pv8_attention(q, k, v, scale, av.pv8_block_k(q.shape[1]))


def _pv8_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    return av.pv8_reference(q, k, v, scale, av.pv8_block_k(q.shape[1]))


# impl -> (what it launches for CUDA tensors, or None; its plain version)
_IMPLS = {"auto": (flash_attention, attention_reference),
          "flash": (flash_attention, attention_reference),
          "flash_stock": (flash_attention, attention_reference),
          "flash_max": (flash_maxpass, maxpass_reference),
          "flash_pv8": (_pv8, _pv8_plain),
          "flash_pv8_reference": (None, _pv8_plain),
          "reference": (None, attention_reference), "xla": (None, attention_reference)}
# the routes a token-sharded training forward takes through the differentiable ring
_RING_GRAD_IMPLS = ("auto", "flash", "flash_stock", "reference", "xla")


def multi_head_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S_kv, H, D)
    v: torch.Tensor,
    scale: Optional[float] = None,
    impl: str = "auto",
    ring=None,
) -> torch.Tensor:
    """Full (non-causal) MHA.  Returns (B, S, H*D).

    ``impl`` ``"auto"`` / ``"flash"`` / ``"flash_stock"`` (K1, the running-max
    kernel; ``"flash"`` is the name the JAX package gives its K1 route),
    ``"flash_max"`` and ``"flash_pv8"`` launch their kernel for CUDA tensors
    and take their plain version for CPU tensors; ``"reference"`` / ``"xla"``
    and ``"flash_pv8_reference"`` take a plain version on either.  Any other
    name raises ``ValueError`` (the JAX dispatch sends it to XLA).

    Where autograd needs a gradient through q, k or v, ``"flash_stock"`` runs
    ``FlashAttentionFunction`` (K5 forward, the backward kernels), and the
    other kernel routes raise ``RuntimeError`` on the card
    (``kernels.refuse_grad``): their kernels have no backward.  The plain
    routes are differentiated by autograd.  Under ``torch.no_grad()`` nothing
    changes.

    ``"ring"`` is sequence-parallel attention (ops/ring_attention.py): q, k
    and v are this rank's shards of a sequence sharded over the mesh's sp
    axis, which ``ring`` names (parallel/sharding.py ``JointShard``: the
    axis and every rank's token count; the JAX package finds its sp axis in
    the ambient mesh).  Without ``ring`` the route raises; it has no
    gradient.  With ``ring`` and another ``impl`` (training with the token
    stream on sp) the shards go through the differentiable ring,
    ``RingAttentionFunction``: ``"auto"`` / ``"flash"`` / ``"flash_stock"``
    on its kernels (K5, K4-dkv, K4-dq) for CUDA tensors, ``"reference"`` /
    ``"xla"`` on its plain versions on any device; any other name raises.
    """
    with span("attention", q):
        b, s, h, d = q.shape
        if scale is None:
            scale = d ** -0.5
        if impl == "ring" or ring is not None:
            if ring is None:
                raise ValueError("the ring route needs the sp axis of its mesh: shard the model "
                                 "with pipelines/trajcrafter.py with_mesh")
            from trajectorycrafter_tpu_torch.ops import ring_attention as ra

            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            if impl == "ring":
                kernels.refuse_grad("ring attention", q, k, v)
                out = ra.ring_attention(qt, kt, vt, ring.axis, sum(ring.sizes), scale)
            elif impl in _RING_GRAD_IMPLS:
                out = ra.RingAttentionFunction.apply(qt, kt, vt, ring.axis, sum(ring.sizes), scale,
                                                     _IMPLS[impl][0] is None)
            else:
                raise ValueError(f"no differentiable ring for attention impl {impl!r} (expected "
                                 f"one of {sorted(_RING_GRAD_IMPLS)})")
            return out.transpose(1, 2).reshape(b, s, h * d)
        if impl not in _IMPLS:
            raise ValueError(f"unknown attention impl {impl!r} (expected one of "
                             f"{sorted((*_IMPLS, 'ring'))})")
        kernel, plain = _IMPLS[impl]
        needs_grad = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
        if needs_grad and impl == "flash_stock":
            out = FlashAttentionFunction.apply(q, k, v, scale)
        elif kernel is not None and q.is_cuda:
            out = kernel(q, k, v, scale)  # under autograd the kernel's wrapper raises
        else:
            out = plain(q, k, v, scale)
        return out.reshape(b, s, h * d)
