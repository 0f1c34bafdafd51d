"""Spatial partitioning over the dp x sp plane: the CogVideoX VAE's slabs.

Counterpart of what GSPMD does behind the JAX package's
``constrain(x, None, None, "dp", "sp", None)``
(trajectorycrafter_tpu/pipelines/trajcrafter.py ``_spatial_sharded``,
``_decode_jit``): the VAE is causal in time, so its parallel axes are
spatial.  Rank (i, j) of the plane holds rows block i of dp and columns
block j of sp of every activation, the same slab on every tp rank (the JAX
spec replicates it over tp):

  * ``Plane.slab`` splits in whole latent rows and columns
    (``sharding.shard_sizes``: ceil(n / parts), the last ones shorter), the
    pixel slab 8x the latent one, so every stride-2 level of the encoder and
    decoder starts on an even row and column; a split that leaves a rank
    no latent row or column raises, as does a side that is no multiple of 8;
  * ``halo`` adds rows of the dp neighbours, then columns of the sp
    neighbours' row-extended slabs (so the corners come along), zeros at the
    global edges, which is what a convolution's zero padding sees there; the
    top and bottom (left and right) edges travel in one ``all_gather``;
  * ``group_norm`` is ``F.group_norm`` over the whole tensor: fp32, two
    passes, each an ``all_reduce`` over the plane of the slab's sums (the
    mean), then of its centred squares (the variance), with global element
    counts; equal to the one-device norm up to reassociation;
  * ``Plane.gather`` rebuilds the whole tensor from the slabs.

gloo runs ``all_gather`` and ``all_reduce`` on CUDA tensors itself (its
send / recv end the process there: tools/gloo_cuda_probe.py), so every
exchange is one of those two.  ``distributed.TRANSPORT`` files them under
``halo``, ``norm`` and ``slabs``.

``shard_spatially(module, plane)`` returns a twin of a module tree that
shares its parameters and carries ``plane`` on every submodule whose class
takes one (``plane = None`` class attributes of models/vae.py), so the
unsharded VAE stays as it is beside its sharded twin.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import List, Tuple

import torch
from torch import nn

from trajectorycrafter_tpu_torch.parallel import distributed as D
from trajectorycrafter_tpu_torch.parallel.sharding import shard_sizes

# pixels per latent row / column of the CogVideoX VAE
LATENT_SCALE = 8


@dataclass(frozen=True)
class Plane:
    """This rank's place in the dp x sp plane: ``rows`` (dp) splits H,
    ``cols`` (sp) splits W, ``both`` is the plane as one axis."""

    rows: D.Axis
    cols: D.Axis
    both: D.Axis

    @classmethod
    def of(cls, mesh) -> "Plane":
        return cls(mesh.dp, mesh.sp, mesh.plane)

    @property
    def size(self) -> int:
        return self.rows.size * self.cols.size

    def extents(self, h: int, w: int) -> Tuple[List[int], List[int]]:
        """Every rank's latent rows of ``h`` and columns of ``w``."""
        rows, cols = shard_sizes(h, self.rows.size), shard_sizes(w, self.cols.size)
        if min(rows) == 0 or min(cols) == 0:
            raise ValueError(f"{h} x {w} latents leave a rank of the dp {self.rows.size} x sp "
                             f"{self.cols.size} plane without rows or columns")
        return rows, cols

    def slab(self, x: torch.Tensor, scale: int) -> torch.Tensor:
        """This rank's slab of the whole ``x`` (..., H, W): whole latent rows
        and columns, ``scale`` pixels each (8 for pixels, 1 for latents)."""
        h, w = x.shape[-2:]
        if h % scale or w % scale:
            raise ValueError(f"a {h} x {w} tensor does not split in whole latent rows and "
                             f"columns of {scale} pixels")
        rows, cols = self.extents(h // scale, w // scale)
        r0 = sum(rows[:self.rows.index]) * scale
        c0 = sum(cols[:self.cols.index]) * scale
        return x[..., r0:r0 + rows[self.rows.index] * scale,
                 c0:c0 + cols[self.cols.index] * scale]

    def gather(self, x: torch.Tensor, h: int, w: int, scale: int) -> torch.Tensor:
        """The whole (..., h * scale, w * scale) tensor from every rank's
        slab ``x`` of ``h`` x ``w`` latents, on every rank of the plane."""
        rows, cols = self.extents(h, w)
        x = D.all_gather(x, self.cols, dim=-1, sizes=[c * scale for c in cols], name="slabs")
        return D.all_gather(x, self.rows, dim=-2, sizes=[r * scale for r in rows], name="slabs")


def exchange(x: torch.Tensor, axis: D.Axis, dim: int, before: int, after: int,
             name: str = "halo") -> torch.Tensor:
    """``x`` with the previous rank's last ``before`` and the next rank's
    first ``after`` rows along ``dim`` (negative) around it, zeros past the
    first and the last rank of ``axis``; ``name``: the exchange's name in
    ``distributed.TRANSPORT``."""
    if before == 0 and after == 0:
        return x
    n = x.shape[dim]
    zeros = lambda k: x.new_zeros(x.shape[:dim % x.dim()] + (k,) + x.shape[dim % x.dim() + 1:])
    if axis.size == 1:
        return torch.cat([zeros(before), x, zeros(after)], dim=dim)
    if n < max(before, after):
        raise ValueError(f"a slab of {n} along a split axis is thinner than its halo "
                         f"({before}, {after})")
    # one transfer for both edges: [first `after` rows | last `before` rows]
    edges = torch.cat([x.narrow(dim, 0, after), x.narrow(dim, n - before, before)], dim=dim)
    every = D.all_gather(edges.unsqueeze(0), axis, dim=0, name=name)
    i = axis.index
    top = every[i - 1].narrow(dim, after, before) if i > 0 else zeros(before)
    bottom = every[i + 1].narrow(dim, 0, after) if i < axis.size - 1 else zeros(after)
    return torch.cat([top, x, bottom], dim=dim)


def halo(x: torch.Tensor, plane: Plane, top: int, bottom: int, left: int,
         right: int) -> torch.Tensor:
    """The slab ``x`` (..., h, w) grown by ``top`` / ``bottom`` rows of its
    dp neighbours, then by ``left`` / ``right`` columns of its sp
    neighbours' row-grown slabs (the corners included); zeros at the
    global edges."""
    x = exchange(x, plane.rows, -2, top, bottom)
    return exchange(x, plane.cols, -1, left, right)


def group_norm(norm: nn.GroupNorm, x: torch.Tensor, plane: Plane) -> torch.Tensor:
    """``norm`` applied to the whole tensor of which ``x`` (N, C, ...) is
    this rank's slab, in fp32 whatever its dtype; the result in x's dtype.
    Two passes: the mean from the plane's sums, then the variance from its
    centred squares (the biased variance, as ``F.group_norm``); the sums
    travel in fp64 beside the element count.  The normalisation is one
    multiply-add per element (x * scale + shift per channel), so no more
    than one fp32 copy of the slab is alive at a time beside the result."""
    n, c = x.shape[:2]
    g = norm.num_groups
    xg = x.reshape(n, g, -1)
    local = torch.cat([xg.sum(dim=-1, dtype=torch.float32).double().reshape(-1),
                       torch.full((1,), xg.shape[-1], dtype=torch.float64, device=x.device)])
    total = D.all_reduce(local, plane.both, name="norm")
    count = total[-1]
    mean = (total[:-1] / count).float().reshape(n, g, 1)
    squares = torch.sub(xg, mean).square_().sum(dim=-1).double()
    var = (D.all_reduce(squares, plane.both, name="norm") / count).float().reshape(n, g, 1)
    scale = torch.rsqrt(var + norm.eps) * norm.weight.float().reshape(1, g, c // g)
    shift = norm.bias.float().reshape(1, g, c // g) - mean * scale
    y = torch.addcmul(shift.reshape(n, c, 1), x.reshape(n, c, -1), scale.reshape(n, c, 1))
    return y.reshape(x.shape).to(x.dtype)


def shard_spatially(module: nn.Module, plane: Plane) -> nn.Module:
    """A twin of ``module`` sharing its parameters and buffers, with
    ``plane`` set on every submodule whose class declares a ``plane``
    attribute; ``module`` itself is left unsharded."""
    twin = copy.copy(module)
    twin._modules = {name: None if sub is None else shard_spatially(sub, plane)
                     for name, sub in module._modules.items()}
    if hasattr(type(module), "plane"):
        twin.plane = plane
    return twin


def seam_band(n: int, sizes: List[int], scale: int, width: int) -> torch.Tensor:
    """A bool mask over ``n`` = sum(sizes) * ``scale`` rows: the rows within
    ``width`` of a seam between two slabs (the band a wrong halo
    reaches)."""
    rows = torch.arange(n)
    band = torch.zeros(n, dtype=torch.bool)
    for k in range(1, len(sizes)):
        seam = sum(sizes[:k]) * scale
        band |= (rows >= seam - width) & (rows < seam + width)
    return band

