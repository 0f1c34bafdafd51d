"""Ring attention: full (non-causal) attention with the sequence sharded
over the ``sp`` axis of the mesh.

Counterpart of trajectorycrafter_tpu/ops/ring_attention.py.  Each rank keeps
its shard of the queries; the K/V shards travel around the ring of sp ranks
(parallel/distributed.py ``Shift``), and each rank folds the attention
of its queries over every visiting shard into running online-softmax
statistics with ``_combine``.  The attention's heads x S^2 work divides by
sp.  As in JAX, the next hop is posted before the inner attention of the
current shard, so the transfer can run under the compute.

The inner per-shard attention returns (out as fp32, logsumexp): by default
``flash_lse_inner`` (ops/attention_variants.py), K5 on the card
(csrc/flash_attention.cu ``flash_lse``) and its plain version on the CPU;
``_attention_with_lse`` is JAX's einsum inner.

Uneven lengths: JAX pads S to a multiple of sp and masks the padded keys.
The port's shards hold only real tokens (parallel/sharding.py
``shard_sizes``: ceil(S / sp) a shard, the last shorter), and each rank
knows every shard's length from S, so each visiting shard's real keys are
passed as they are; a shard with no tokens is skipped.  Layout (B, H, S, D)
as JAX's.

The gradient (LoRA training with the token stream on sp):
``RingAttentionFunction``.  Its forward is the ring above, keeping the local q, k and v, the combined
output and the global logsumexp.  Its backward computes di = sum(out *
dout) over the local rows, then sends the K/V shards round the ring again
in the forward's hop order, each shard carrying an fp32 accumulator of its
dK and dV: at each hop the local queries' share is added to the visiting
shard's accumulator and to the local dQ.  With the global lse, p = exp(s -
lse) of one hop is already that hop's share of the whole softmax, so the
per-hop backward is the unsharded one on the visiting keys: on the card
the two backward kernels (K4-dkv and K4-dq, ``ops/kernels.py
flash_attention_bwd_dkv`` and ``flash_attention_bwd_dq``), elsewhere
``attention_backward_reference``.  After the last hop one more hop hands
each accumulator to its shard's owner.  Every rank issues the same hops in
the same order, also when ``remat`` recomputes a block's forward inside
the backward pass.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from trajectorycrafter_tpu_torch.ops.attention import attention_backward_reference, attention_di
from trajectorycrafter_tpu_torch.ops.attention_variants import flash_lse_inner
from trajectorycrafter_tpu_torch.ops.kernels import flash_attention_bwd_dkv, flash_attention_bwd_dq
from trajectorycrafter_tpu_torch.parallel.distributed import Axis, Shift
from trajectorycrafter_tpu_torch.parallel.sharding import shard_sizes


def _attention_with_lse(q, k, v, scale, key_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact attention returning (out fp32, lse); (B, H, S, D).  Padded keys
    (``key_mask`` False) score -1e30, as in JAX."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if key_mask is not None:
        s = torch.where(key_mask[None, None, None, :], s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v).float()
    lse = (m + torch.log(l))[..., 0]
    return out / l.clamp_min(1e-30), lse


def _combine(o1, lse1, o2, lse2):
    """Merge two attention partials with their logsumexps."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)[..., None]
    w2 = torch.exp(lse2 - m)[..., None]
    o = (o1 * w1 + o2 * w2) / (w1 + w2)
    lse = m + torch.log(torch.exp(lse1 - m) + torch.exp(lse2 - m))
    return o, lse


def _ring_forward(q_l, k_l, v_l, axis: Axis, s_true: int, scale: float, inner: Callable):
    """The ring's forward: this rank's (out as fp32, lse), or (None, None)
    where it holds no queries or no shard holds keys."""
    n, me = axis.size, axis.index
    sizes = shard_sizes(s_true, n)
    if q_l.shape[2] != sizes[me] or k_l.shape[2] != sizes[me] or v_l.shape[2] != sizes[me]:
        raise ValueError(f"rank {me} of {n} holds {sizes[me]} of {s_true} tokens; got q, k, v "
                         f"of {q_l.shape[2]}, {k_l.shape[2]}, {v_l.shape[2]}")
    o = lse = None
    k_cur, v_cur = k_l, v_l
    for t in range(n):
        hop = None
        if t < n - 1:
            # after t hops this rank holds shard (me - t) mod n; post the next hop first
            arriving = sizes[(me - t - 1) % n]
            shapes = [(*x.shape[:2], arriving, x.shape[3]) for x in (k_cur, v_cur)]
            hop = Shift([k_cur, v_cur], axis, shapes, q_l.device)
        if q_l.shape[2] and k_cur.shape[2]:
            o_i, lse_i = inner(q_l, k_cur, v_cur, scale)
            o, lse = (o_i, lse_i) if o is None else _combine(o, lse, o_i, lse_i)
        if hop is not None:
            k_cur, v_cur = hop.wait()
    return o, lse


def ring_attention(q_l: torch.Tensor, k_l: torch.Tensor, v_l: torch.Tensor, axis: Axis,
                   s_true: int, scale: Optional[float] = None,
                   inner: Callable = flash_lse_inner) -> torch.Tensor:
    """This rank's rows of full attention over a sequence of ``s_true``
    tokens sharded over ``axis`` (this rank's q, k and v shards, (B, H,
    S_local, D)) -> (B, H, S_local, D) in q's dtype."""
    if scale is None:
        scale = q_l.shape[-1] ** -0.5
    o, _ = _ring_forward(q_l, k_l, v_l, axis, s_true, scale, inner)
    if o is None:
        return torch.zeros_like(q_l)
    return o.to(q_l.dtype)


class RingAttentionFunction(torch.autograd.Function):
    """Differentiable ring attention: ``apply(q, k, v, axis, s_true, scale,
    plain)`` with ``ring_attention``'s arguments, -> this rank's rows in q's
    dtype.  ``plain`` takes the plain inner step (``_attention_with_lse``)
    and backward on any device; otherwise CUDA tensors launch K5 forward and
    K4-dkv / K4-dq backward, and CPU tensors take their plain versions.
    Backward as the module's doc says."""

    @staticmethod
    def forward(ctx, q, k, v, axis, s_true, scale, plain):
        kernels_on = q.is_cuda and not plain
        o, lse = _ring_forward(q, k, v, axis, s_true, scale,
                               flash_lse_inner if kernels_on else _attention_with_lse)
        out = torch.zeros_like(q) if o is None else o.to(q.dtype)
        if lse is None:
            lse = q.new_zeros(q.shape[:3], dtype=torch.float32)
        ctx.save_for_backward(q, k, v, out, lse.contiguous())
        ctx.axis, ctx.s_true, ctx.scale, ctx.kernels_on = axis, s_true, scale, kernels_on
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        axis, scale = ctx.axis, ctx.scale
        n, me = axis.size, axis.index
        sizes = shard_sizes(ctx.s_true, n)
        acc = torch.promote_types(q.dtype, torch.float32)
        # (B, S, H, D) views, the layout of the kernels and the plain backward
        bshd = lambda x: x.transpose(1, 2)
        qs, outs = bshd(q), bshd(out)
        douts = bshd(dout).contiguous()
        di = attention_di(outs, douts) if ctx.kernels_on else None
        dq = torch.zeros(q.shape, dtype=acc, device=q.device)
        k_cur, v_cur = k, v
        dk_cur, dv_cur = (torch.zeros(x.shape, dtype=acc, device=x.device) for x in (k, v))
        for t in range(n):
            # this rank holds shard (me - t) mod n and its accumulators, as in the forward
            arriving = sizes[(me - t - 1) % n]
            shape = lambda x: (*x.shape[:2], arriving, x.shape[3])
            hop = None
            if t < n - 1:
                hop = Shift([k_cur, v_cur], axis, [shape(k_cur), shape(v_cur)], q.device)
            if q.shape[2] and k_cur.shape[2]:
                ks, vs = bshd(k_cur), bshd(v_cur)
                if ctx.kernels_on:
                    dk_i, dv_i = flash_attention_bwd_dkv(qs, ks, vs, douts, lse, di, scale)
                    dq_i = flash_attention_bwd_dq(qs, ks, vs, douts, lse, di, scale)
                else:
                    dq_i, dk_i, dv_i = attention_backward_reference(qs, ks, vs, outs, lse,
                                                                    douts, scale)
                dq += bshd(dq_i)
                dk_cur += bshd(dk_i)
                dv_cur += bshd(dv_i)
            grads = Shift([dk_cur, dv_cur], axis, [shape(dk_cur), shape(dv_cur)], q.device,
                          name="ring_grad")
            if hop is not None:
                k_cur, v_cur = hop.wait()
            dk_cur, dv_cur = grads.wait()
        # n hops of the accumulators bring each home: shard me, dK and dV of every query
        return dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype), None, None, None, None

