"""The depth stage's partition: the DepthCrafter UNet's frames on dp and its
latent rows on sp; CLIP and the SVD VAE on whole frames over every rank.

Counterpart of what GSPMD does behind the JAX package's
``constrain(latents, "dp", "sp", None, None)``
(trajectorycrafter_tpu/pipelines/depth.py ``_denoise_window_jit`` with
``shard=True``) and ``_frame_sharded`` (models/svd_vae.py).  Rank (i, j, k)
of a dp x sp x tp mesh holds frames block i and latent-row block j of the
UNet's activations, the same slab on every tp rank (the JAX spec
replicates the UNet over tp):

  * ``FrameRows.row_extents`` splits the latent height in whole blocks of
    ``ROW_BLOCK`` = 8 rows (``sharding.shard_sizes`` over the blocks): the
    UNet halves its rows three times, so every seam then falls on the same
    global row at every level, down and up (an even 36 / 36 split of 72
    rows would leave the 9-row bottom level split 5 / 4 on an odd seam,
    where the nearest 2x upsample of 5 rows gives 10 against a skip of 9);
    a height that is no multiple of 8, fewer blocks than sp ranks and
    fewer frames than dp ranks raise;
  * ``Slab`` is one window's layout: every rank's frames and latent rows,
    this rank's offsets, every rank's rows at a level (``rows_at``);
  * ``row_halo`` / ``frame_halo`` grow a channel-last slab by its sp
    neighbours' rows (the 3x3 convolutions: one row each side; the stride-2
    downsampler, whose outputs on even seams read one row above the slab
    and none below: one row above) or its dp neighbours' frames (the
    temporal resnets' (3, 1, 1) convolutions: one frame each side), zeros
    past the global edges (``spatial.exchange``);
  * ``group_norm`` is the channel-last GroupNorm over the whole tensor:
    fp32, two passes, the sums in fp64, reduced over the axis the norm's
    statistics span (sp for a per-frame norm, the dp x sp plane for the
    temporal resnets' norms, which span the frames);
  * ``gather_kv`` joins a self-attention's keys and values (one tensor, k
    and v side by side): a frame's rows over sp in row order (spatial), a
    location's frames over dp in frame order (temporal);
  * ``deal`` / ``frame_share`` / ``gather_frames``: whole frames (the CLIP
    embed, the SVD encoder) or whole decode chunks dealt over every rank of
    the mesh, from the last rank back, so that the leader, which also
    reads, captions, makes the poses and encodes the prompt, gets the
    fewest; joined by one ``all_gather``.

``distributed.TRANSPORT`` files the exchanges under ``depth_halo``,
``depth_norm``, ``depth_kv``, ``depth_frames`` and ``depth_latents`` (a
window's latents joined over the plane).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch
from torch import nn

from trajectorycrafter_tpu_torch.parallel import distributed as D
from trajectorycrafter_tpu_torch.parallel.sharding import shard_sizes
from trajectorycrafter_tpu_torch.parallel.spatial import exchange

# latent rows of a block: the UNet's three stride-2 levels split a block evenly
ROW_BLOCK = 8


@dataclass(frozen=True)
class FrameRows:
    """This rank's place in the depth stage's partition: ``frames`` (dp)
    splits the frames, ``rows`` (sp) the latent rows, ``both`` is the dp x
    sp plane as one axis."""

    frames: D.Axis
    rows: D.Axis
    both: D.Axis

    @classmethod
    def of(cls, mesh) -> "FrameRows":
        return cls(mesh.dp, mesh.sp, mesh.plane)

    def frame_extents(self, f: int) -> List[int]:
        """Every dp rank's frames of ``f``."""
        sizes = shard_sizes(f, self.frames.size)
        if min(sizes) == 0:
            raise ValueError(f"{f} frames leave a rank of dp {self.frames.size} without frames")
        return sizes

    def row_extents(self, h: int) -> List[int]:
        """Every sp rank's latent rows of ``h``, in whole blocks of
        ``ROW_BLOCK``."""
        if h % ROW_BLOCK:
            raise ValueError(f"a latent height of {h} is no multiple of {ROW_BLOCK}: the UNet "
                             "halves it three times")
        blocks = shard_sizes(h // ROW_BLOCK, self.rows.size)
        if min(blocks) == 0:
            raise ValueError(f"{h // ROW_BLOCK} blocks of {ROW_BLOCK} latent rows leave a rank "
                             f"of sp {self.rows.size} without rows")
        return [b * ROW_BLOCK for b in blocks]

    def layout(self, f: int, h: int) -> "Slab":
        """The layout of ``f`` frames of ``h`` latent rows."""
        return Slab(self, tuple(self.frame_extents(f)), tuple(self.row_extents(h)))


@dataclass(frozen=True)
class Slab:
    """One window's layout: every dp rank's frames and every sp rank's
    latent rows (level 0), and this rank's share of them."""

    part: FrameRows
    frames: Tuple[int, ...]
    rows: Tuple[int, ...]

    @property
    def frame_start(self) -> int:
        return sum(self.frames[:self.part.frames.index])

    @property
    def num_frames(self) -> int:
        return self.frames[self.part.frames.index]

    @property
    def row_start(self) -> int:
        return sum(self.rows[:self.part.rows.index])

    @property
    def num_rows(self) -> int:
        return self.rows[self.part.rows.index]

    def rows_at(self, hh: int) -> List[int]:
        """Every sp rank's rows at the UNet level where this rank holds ``hh``."""
        factor = self.num_rows // hh
        if hh * factor != self.num_rows or any(r % factor for r in self.rows):
            raise ValueError(f"{hh} rows are no level of the slab's {self.num_rows}")
        return [r // factor for r in self.rows]

    def frame_ids(self, device) -> torch.Tensor:
        """The global indices of this rank's frames (the temporal
        transformers' positional embedding), fp32."""
        return torch.arange(self.frame_start, self.frame_start + self.num_frames,
                            dtype=torch.float32, device=device)

    def take(self, x: torch.Tensor, frame_dim: int, row_dim: int) -> torch.Tensor:
        """This rank's slab of the whole ``x``."""
        x = x.narrow(frame_dim, self.frame_start, self.num_frames)
        return x.narrow(row_dim, self.row_start, self.num_rows)

    def join(self, x: torch.Tensor, frame_dim: int, row_dim: int) -> torch.Tensor:
        """The whole tensor from every rank's slab ``x``, on every rank of
        the plane: the rows over sp, then the frames over dp."""
        x = D.all_gather(x, self.part.rows, dim=row_dim, sizes=self.rows, name="depth_latents")
        return D.all_gather(x, self.part.frames, dim=frame_dim, sizes=self.frames,
                            name="depth_latents")


def row_halo(x: torch.Tensor, slab: Slab, above: int, below: int) -> torch.Tensor:
    """The channel-last slab ``x`` (N, H, W, C) grown by ``above`` rows of
    the sp rank above and ``below`` of the one below; zeros past the
    picture's top and bottom."""
    return exchange(x, slab.part.rows, -3, above, below, name="depth_halo")


def frame_halo(x: torch.Tensor, slab: Slab, before: int, after: int) -> torch.Tensor:
    """The channel-last slab ``x`` (B, F, H, W, C) grown by ``before``
    frames of the dp rank before and ``after`` of the one after; zeros past
    the first and the last frame."""
    return exchange(x, slab.part.frames, -4, before, after, name="depth_halo")


def group_norm(norm: nn.GroupNorm, x: torch.Tensor, axis: D.Axis) -> torch.Tensor:
    """``norm`` over the whole tensor of which the channel-last ``x`` (N,
    ..., C) is this rank's slab along ``axis``, in fp32 whatever its dtype;
    the result in x's dtype.  Two passes: the mean from the axis' sums, then
    the biased variance from its centred squares, the sums in fp64 beside
    the element count (flax and ``group_norm_cl``: statistics over every
    non-batch axis of each channel group)."""
    n, c = x.shape[0], x.shape[-1]
    g = norm.num_groups
    y = x.to(torch.float32, copy=True).reshape(n, -1, g, c // g)
    local = torch.cat([y.sum(dim=(1, 3)).double().reshape(-1),
                       torch.full((1,), y.shape[1] * y.shape[3], dtype=torch.float64,
                                  device=x.device)])
    total = D.all_reduce(local, axis, name="depth_norm")
    count = total[-1]
    y.sub_((total[:-1] / count).float().reshape(n, 1, g, 1))
    squares = y.square().sum(dim=(1, 3)).double()
    var = (D.all_reduce(squares, axis, name="depth_norm") / count).float().reshape(n, 1, g, 1)
    y = y.mul_(torch.rsqrt(var + norm.eps)).reshape(x.shape)
    return y.mul_(norm.weight.float()).add_(norm.bias.float()).to(x.dtype)


def gather_kv(kv: torch.Tensor, axis: D.Axis, sizes: List[int]) -> torch.Tensor:
    """A self-attention's keys and values (B, S_local, 2 * inner) of every
    rank along ``axis`` joined in coordinate order along the sequence;
    ``sizes``: every rank's sequence length."""
    return D.all_gather(kv, axis, dim=1, sizes=sizes, name="depth_kv")


def deal(n: int, world: D.Axis) -> List[int]:
    """Every rank's count of ``n`` items dealt over ``world`` in contiguous
    runs, ``shard_sizes`` from the last rank back: the leader gets the
    fewest, and none when there are fewer items than ranks."""
    return shard_sizes(n, world.size)[::-1]


def frame_share(f: int, world: D.Axis) -> Tuple[int, int, List[int]]:
    """(start, count, every rank's count) of this rank's whole frames of
    ``f`` dealt over ``world`` (``deal``: a rank may get none)."""
    sizes = deal(f, world)
    return sum(sizes[:world.index]), sizes[world.index], sizes


def gather_frames(x: torch.Tensor, world: D.Axis, sizes: List[int], dim: int = 0) -> torch.Tensor:
    """Every rank's frames ``x`` joined along ``dim`` in rank order."""
    return D.all_gather(x, world, dim=dim, sizes=sizes, name="depth_frames")
