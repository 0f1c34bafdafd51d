"""Pipeline parallelism over the DiT's block stack: the GPipe schedule.

Counterpart of trajectorycrafter_tpu/parallel/pipeline.py, with its three
names.  The 42 CogVideoX blocks and the 21 Perceivers between them form 21
superblocks (block 2i, then Perceiver i added to the residual, then block
2i + 1; ``CrossTransformer3DModel.run_blocks`` runs them in that order),
split into contiguous stages over the mesh's ``pp`` axis; a stage's blocks
and Perceivers may also be tensor-parallel over ``tp``.  The batch is cut
into M microbatches, and at step t stage s runs microbatch t - s; its
output goes to stage s + 1 by one point-to-point hop
(``distributed.Shift``, filed as ``stage``), and the last stage's
outputs are broadcast to every stage at the end, as JAX's masked psum
hands them to every device.

Where JAX runs every stage at every step and discards the inactive
results, a stage here runs only its active steps, and a hop carries only a
microbatch a stage produced: the results are the same.  The bubble is (S -
1) / (M + S - 1) of the steps for S stages.  A rank keeps only its stage's
blocks and Perceivers (``stack_superblock_params`` moves the others to the
meta device), so its block weights are 1 / S of the stack's.

    stages = stack_superblock_params(model, mesh.pp.size, mesh.pp.index)
    stacked_param_sharding(model, stages, mesh)
    hidden, encoder = pipeline_dit_blocks(model, stages, hidden, encoder, temb,
                                          rope, cross_tokens, mesh)
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from trajectorycrafter_tpu_torch.parallel import distributed as D
from trajectorycrafter_tpu_torch.parallel.sharding import shard_unit_


def _superblock_units(model: nn.Module, i: int) -> list:
    """Superblock ``i``'s blocks 2i and 2i + 1 and its Perceiver i (none
    where the model has no reference branch)."""
    units = [model.transformer_blocks[2 * i], model.transformer_blocks[2 * i + 1]]
    if model.perceiver_cross_attention is not None:
        units.append(model.perceiver_cross_attention[i])
    return units


def stack_superblock_params(model: nn.Module, n_stages: int,
                            stage: Optional[int] = None) -> List[range]:
    """The superblocks of each of ``n_stages`` contiguous stages (stage s:
    [s n / S, (s + 1) n / S) of the n superblocks); ``n_stages`` must divide
    the superblock count (21 at the deployed 42 blocks: S in {3, 7, 21}).
    With ``stage``, every block and Perceiver outside that stage's
    superblocks moves to the meta device, freeing its memory."""
    if model.cross_attn_interval != 2:
        raise ValueError(f"the superblock layout needs cross_attn_interval 2, not "
                         f"{model.cross_attn_interval}")
    n_su = len(model.transformer_blocks) // 2
    if n_su % n_stages:
        raise ValueError(f"{n_stages} stages do not divide the {n_su} superblocks")
    per = n_su // n_stages
    stages = [range(s * per, (s + 1) * per) for s in range(n_stages)]
    if stage is not None:
        for i in range(n_su):
            if i not in stages[stage]:
                for unit in _superblock_units(model, i):
                    unit.to("meta")
    return stages


def stacked_param_sharding(model: nn.Module, stages: List[range], mesh) -> nn.Module:
    """This rank's stage's blocks and Perceivers over the mesh's tp axis
    (``sharding.shard_unit_``), in place."""
    for i in stages[mesh.pp.index]:
        for unit in _superblock_units(model, i):
            shard_unit_(unit, mesh.tp)
    return model


def pipeline_dit_blocks(
    model: nn.Module,  # CrossTransformer3DModel holding this rank's stage
    stages: List[range],  # stack_superblock_params
    hidden: torch.Tensor,  # (B, S_vid, D)
    encoder: torch.Tensor,  # (B, S_txt, D)
    temb: torch.Tensor,  # (B, time_embed_dim)
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]],  # the rotary tables, whole
    cross_tokens: Optional[torch.Tensor],  # (B, S_ref, D)
    mesh,
    n_microbatches: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole block stack pipelined over ``mesh.pp``: (hidden, encoder)
    as ``model.run_blocks`` gives them, on every rank of the pp axis.
    Every rank passes the whole inputs; ``temb`` and ``cross_tokens`` ride
    with their microbatch, ``rope`` is shared.  A batch that the
    microbatches do not divide raises."""
    pp = mesh.pp
    if pp is None:
        raise ValueError("this rank is outside the mesh: it runs no stage")
    if mesh.sp.size > 1:
        raise ValueError("the pipeline runs whole token sequences: sp must be 1")
    if len(stages) != pp.size:
        raise ValueError(f"{len(stages)} stages on a pp axis of {pp.size}")
    n_stages, s = pp.size, pp.index
    b, m = hidden.shape[0], n_microbatches
    if b % m:
        raise ValueError(f"a batch of {b} does not split into {m} microbatches")
    split = lambda x: [None] * m if x is None else list(x.split(b // m))
    h_in, e_in, t_in, c_in = map(split, (hidden, encoder, temb, cross_tokens))
    blocks = range(2 * stages[s].start, 2 * stages[s].stop)
    shapes = [h_in[0].shape, e_in[0].shape]
    outs, received = [], None
    for t in range(m + n_stages - 1):
        i = t - s  # this stage's microbatch at step t
        send = []
        if 0 <= i < m:
            h, e = (h_in[i], e_in[i]) if s == 0 else received
            h, e = model.run_blocks(h, e, t_in[i], rope, c_in[i], blocks=blocks)
            if s == n_stages - 1:
                outs.append((h, e))
            else:
                send = [h, e]
        # the previous stage runs microbatch i + 1 at step t: it is this
        # stage's input at step t + 1
        recv = shapes if s > 0 and 0 <= i + 1 < m else []
        if send or recv:
            received = D.Shift(send, pp, recv, hidden.device, [hidden.dtype] * len(recv),
                               name="stage").wait()
    if s == n_stages - 1:
        h, e = (torch.cat(x) for x in zip(*outs))
    else:
        h, e = torch.empty_like(hidden), torch.empty_like(encoder)
    return D.broadcast(h, pp, n_stages - 1), D.broadcast(e, pp, n_stages - 1)
