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
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from trajectorycrafter_tpu_torch.ops.attention_variants import flash_lse_inner
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


def ring_attention(q_l: torch.Tensor, k_l: torch.Tensor, v_l: torch.Tensor, axis: Axis,
                   s_true: int, scale: Optional[float] = None,
                   inner: Callable = flash_lse_inner) -> torch.Tensor:
    """This rank's rows of full attention over a sequence of ``s_true``
    tokens sharded over ``axis`` (this rank's q, k and v shards, (B, H,
    S_local, D)) -> (B, H, S_local, D) in q's dtype."""
    if scale is None:
        scale = q_l.shape[-1] ** -0.5
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
    if o is None:
        return torch.zeros_like(q_l)
    return o.to(q_l.dtype)
