"""The dp x sp x tp x pp mesh of a sharded run.

Counterpart of trajectorycrafter_tpu/parallel/mesh.py ``make_mesh``.  Axes:
  * ``dp`` -- data: the batch, which in the denoise is the CFG pair;
  * ``sp`` -- sequence: the DiT's joint [text; video] tokens, attended
    across ranks by ring attention (ops/ring_attention.py);
  * ``tp`` -- tensor: the attention heads and the feed-forward's hidden
    width (parallel/sharding.py);
  * ``pp`` -- pipeline stages: the GPipe schedule of the DiT's block stack
    (parallel/pipeline.py), each stage's blocks over tp.

Ranks take coordinates in JAX's row-major ``reshape(dp, sp, tp, pp)`` order
of its devices, pp the fastest axis: rank r of the process group sits
where device r sits in the JAX mesh.  Each axis has one process group per
line of ranks along it, and so has the dp x sp ``plane`` (the ranks of one
tp and pp coordinate, dp-major), over which the CogVideoX VAE's GroupNorm
statistics are reduced (parallel/spatial.py).  The groups' collectives wait
``distributed.GROUP_TIMEOUT`` for a peer, well under the world's own.
``make_mesh`` raises and warns where JAX's does: a mesh larger than the
world raises, a smaller one warns and leaves the other ranks idle.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from trajectorycrafter_tpu_torch.parallel.distributed import GROUP_TIMEOUT, Axis

AXES = ("dp", "sp", "tp", "pp")


def mesh_ranks(dp: int = 1, sp: int = 1, tp: int = 1, pp: int = 1,
               world_size: int = 1) -> np.ndarray:
    """The (dp, sp, tp, pp) array of global ranks, with JAX's checks."""
    n = dp * sp * tp * pp
    if min(dp, sp, tp, pp) < 1:
        raise ValueError(f"mesh {dp}x{sp}x{tp}x{pp}: every axis needs at least one rank")
    if n > world_size:
        raise ValueError(f"mesh {dp}x{sp}x{tp}x{pp}={n} exceeds {world_size} ranks")
    if n < world_size:
        warnings.warn(f"mesh {dp}x{sp}x{tp}x{pp} uses {n} of {world_size} ranks; the rest "
                      "stay idle", stacklevel=3)
    return np.arange(n).reshape(dp, sp, tp, pp)


@dataclass
class Mesh:
    """This rank's view of the mesh: the rank array, its axes (None on an
    idle rank) and device."""

    ranks: np.ndarray
    rank: int
    axes: Dict[str, Axis]
    device: torch.device

    @property
    def member(self) -> bool:
        """False on a rank that a mesh smaller than the world leaves idle."""
        return self.axes["world"] is not None

    @property
    def leader(self) -> bool:
        """Rank 0: it runs the unsharded stages and writes the outputs."""
        return self.rank == 0

    @property
    def dp(self) -> Axis:
        return self.axes["dp"]

    @property
    def sp(self) -> Axis:
        return self.axes["sp"]

    @property
    def tp(self) -> Axis:
        return self.axes["tp"]

    @property
    def pp(self) -> Axis:
        return self.axes["pp"]

    @property
    def plane(self) -> Axis:
        """The dp x sp ranks at this rank's tp coordinate, as one axis
        (index dp * sp_size + sp)."""
        return self.axes["plane"]

    @property
    def world(self) -> Axis:
        """Every rank of the mesh, as one axis (the default process group)."""
        return self.axes["world"]


def _group(ranks) -> object:
    """A process group of ``ranks`` whose collectives wait ``GROUP_TIMEOUT``
    for a peer (parallel/distributed.py)."""
    return dist.new_group([int(r) for r in ranks], timeout=GROUP_TIMEOUT)


def make_mesh(dp: int = 1, sp: int = 1, tp: int = 1, pp: int = 1, device=None) -> Mesh:
    """The mesh over the started process group; every rank calls it (each
    axis group is made collectively).  ``device``: this rank's device (the
    process group's, by default the current CUDA device)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a started process group "
                           "(parallel/distributed.py init or init_from_env)")
    world, rank = dist.get_world_size(), dist.get_rank()
    ranks = mesh_ranks(dp, sp, tp, pp, world)
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    axes = {}
    here = np.argwhere(ranks == rank)  # empty on a rank the mesh leaves idle
    for i, name in enumerate(AXES):
        lines = np.moveaxis(ranks, i, -1).reshape(-1, ranks.shape[i])
        mine = None
        for line in lines:
            group = _group(line) if len(line) > 1 else None
            if rank in line:
                mine = Axis(name, len(line), int(np.flatnonzero(line == rank)[0]),
                            tuple(int(r) for r in line), group)
        axes[name] = mine
    axes["plane"] = None
    for line in np.moveaxis(ranks, (0, 1), (-2, -1)).reshape(-1, ranks.shape[0] * ranks.shape[1]):
        group = _group(line) if len(line) > 1 else None
        if rank in line:
            axes["plane"] = Axis("plane", len(line), int(np.flatnonzero(line == rank)[0]),
                                 tuple(int(r) for r in line), group)
    members = tuple(range(ranks.size))
    group = dist.group.WORLD if ranks.size == world else _group(members)
    axes["world"] = Axis("world", ranks.size, rank, members, group) if len(here) else None
    return Mesh(ranks, rank, axes, torch.device(device))
