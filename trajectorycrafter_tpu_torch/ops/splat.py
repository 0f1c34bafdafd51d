"""Forward-splat warping with ``index_add_``.

Counterpart of trajectorycrafter_tpu/ops/splat.py: every frame of the clip is
warped at once, with ONE scatter-add over a padded accumulation grid per
clip -- the four bilinear corners and the value/weight channels fused into
one payload row per source pixel.  Everything is fp32.

Algorithm (the reference's maths):
  1. unproject the pixel grid with K1^-1 * depth, transform by T2 @ T1^-1,
     project with K2; points behind the camera (z <= 0.01) get depth 1000.
  2. flow = projected_xy / z - pixel_grid.
  3. bilinear splatting: each source pixel scatters into the 4 neighbouring
     target pixels with bilinear proximity weights divided by the soft
     z-buffer weight exp(log1p(d) / max(log1p(d)) * 50), max per frame.
  4. weight-normalise; mask = accumulated weight > 0.

On the card ``index_add_`` adds with float atomics, so sums land in an order
that changes from run to run: values agree with the JAX package to a
tolerance, not bit for bit.

Under a mesh (``forward_warp_batch(..., mesh=...)``, the JAX package's
frames over every mesh axis) the frames are independent: rank r of the
mesh warps ``shard_sizes(n, ranks)[r]`` contiguous frames, mask cleaning
included, and the four outputs travel in one ``all_gather`` (``warp`` in
``distributed.TRANSPORT``), joined in frame order on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch

from trajectorycrafter_tpu_torch.ops.morphology import clean_mask
from trajectorycrafter_tpu_torch.parallel import distributed as D
from trajectorycrafter_tpu_torch.parallel.sharding import shard_sizes

_BEHIND_EPS = 0.01
_BEHIND_FILL = 1000.0
_DEPTH_SAT = 1000.0
_ZWEIGHT_SCALE = 50.0


def _pixel_grid(h: int, w: int, device) -> torch.Tensor:
    """(h, w, 2) grid of (x, y) pixel coordinates, fp32."""
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([x, y], dim=-1)


def _apply3(m: torch.Tensor, v: torch.Tensor, t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-pixel (n, 3, 3) @ v (n, h, w, 3) [+ t (n, 3)] written as explicit
    multiply-adds: a matmul may reassociate the sum, and a 1-ulp coordinate
    change can flip a bilinear corner."""
    m = m[:, None, None]  # (n, 1, 1, 3, 3)
    out = [v[..., 0] * m[..., i, 0] + v[..., 1] * m[..., i, 1] + v[..., 2] * m[..., i, 2]
           for i in range(3)]
    if t is not None:
        out = [o + t[:, i, None, None] for i, o in enumerate(out)]
    return torch.stack(out, dim=-1)


def transform_points(depth, transformation1, transformation2, intrinsic1, intrinsic2):
    """(n, h, w) depths -> (n, h, w, 3) points in the target camera's K2 space."""
    n, h, w = depth.shape
    grid = _pixel_grid(h, w, depth.device)
    pix = torch.cat([grid, torch.ones_like(grid[..., :1])], dim=-1).expand(n, h, w, 3)
    transformation = transformation2 @ torch.linalg.inv(transformation1)
    rays = _apply3(torch.linalg.inv(intrinsic1), pix)
    world = _apply3(transformation[:, :3, :3], rays * depth[..., None], transformation[:, :3, 3])
    projected = _apply3(intrinsic2, world)
    behind = world[..., 2:3] <= _BEHIND_EPS
    return torch.where(behind, torch.full_like(projected, _BEHIND_FILL), projected)


def _splat_weights(trans_pos: torch.Tensor, h: int, w: int):
    """Floor-corner indices + per-slot proximity weights on the padded grid.

    As the reference, the ceil (not floor + 1) corner is used, so an integer
    landing position contributes through all four corners; when the ceil
    corner coincides with the floor one its weight folds into the floor slot
    (exact, as the weights are separable).
    """
    pos = trans_pos + 1.0  # shift into the padded grid
    floor, ceil = torch.floor(pos), torch.ceil(pos)
    pos_x = pos[..., 0].clamp(0.0, w + 1.0)
    pos_y = pos[..., 1].clamp(0.0, h + 1.0)
    fx = floor[..., 0].clamp(0.0, w + 1.0)
    fy = floor[..., 1].clamp(0.0, h + 1.0)
    cx = ceil[..., 0].clamp(0.0, w + 1.0)
    cy = ceil[..., 1].clamp(0.0, h + 1.0)

    px_f, px_c = 1.0 - (pos_x - fx), 1.0 - (cx - pos_x)
    py_f, py_c = 1.0 - (pos_y - fy), 1.0 - (cy - pos_y)
    fxi, fyi = fx.long(), fy.long()
    deg_x, deg_y = cx.long() == fxi, cy.long() == fyi
    zero = torch.zeros_like(px_c)
    px0 = px_f + torch.where(deg_x, px_c, zero)
    px1 = torch.where(deg_x, zero, px_c)
    py0 = py_f + torch.where(deg_y, py_c, zero)
    py1 = torch.where(deg_y, zero, py_c)
    # slot (dy, dx) contributes to target cell (fy + dy, fx + dx)
    return fyi, fxi, (py0 * px0, py0 * px1, py1 * px0, py1 * px1)


def bilinear_splat(values: torch.Tensor, depth: torch.Tensor, flow: torch.Tensor,
                   mask: Optional[torch.Tensor] = None):
    """Softly z-buffered bilinear forward splat of (n, h, w, c) values by
    (n, h, w, 2) flow -> (weight-normalised values with 0 in holes, mask).
    ``mask`` (n, h, w), 1 = known, weights the source pixels."""
    n, h, w, c = values.shape
    trans_pos = flow + _pixel_grid(h, w, values.device)
    fyi, fxi, slots = _splat_weights(trans_pos, h, w)

    log_depth = torch.log1p(depth.clamp(0.0, _DEPTH_SAT))
    log_max = log_depth.flatten(1).amax(dim=1)[:, None, None]
    base_w = (1.0 if mask is None else mask) / torch.exp(log_depth / log_max * _ZWEIGHT_SCALE)

    # one payload row per source pixel: 4 slots x [values | 1]
    payload = torch.cat([values, torch.ones_like(values[..., :1])], dim=-1)
    slot_w = torch.stack([s * base_w for s in slots], dim=-1)  # (n, h, w, 4)
    rows = (payload[..., None, :] * slot_w[..., None]).reshape(n * h * w, 4 * (c + 1))

    # padded grid (h+3, w+3) per frame: fyi/fxi reach h+1/w+1, slots add one
    cells = (h + 3) * (w + 3)
    frame = torch.arange(n, device=values.device)[:, None, None]
    flat = (frame * cells + fyi * (w + 3) + fxi).reshape(-1)
    acc = torch.zeros((n * cells, 4 * (c + 1)), dtype=values.dtype, device=values.device)
    acc.index_add_(0, flat, rows)

    acc = acc.reshape(n, h + 3, w + 3, 4, c + 1)
    # out[y, x] = slot0[y, x] + slot1[y, x-1] + slot2[y-1, x] + slot3[y-1, x-1]
    acc = (acc[:, 1:h + 1, 1:w + 1, 0] + acc[:, 1:h + 1, 0:w, 1]
           + acc[:, 0:h, 1:w + 1, 2] + acc[:, 0:h, 0:w, 3])
    warped, weights = acc[..., :c], acc[..., c:]
    known = weights > 0
    out = torch.where(known, warped / torch.where(known, weights, torch.ones_like(weights)),
                      torch.zeros_like(warped))
    return out, known[..., 0].to(values.dtype)


@torch.no_grad()
def forward_warp_batch(
    frames: torch.Tensor,  # (n, h, w, 3) in [-1, 1]
    depths: torch.Tensor,  # (n, h, w)
    pose_s: torch.Tensor,  # (n, 4, 4)
    pose_t: torch.Tensor,  # (n, 4, 4)
    intrinsics1: torch.Tensor,  # (n, 3, 3)
    intrinsics2: Optional[torch.Tensor] = None,  # (n, 3, 3)
    use_mask_clean: bool = False,
    mesh=None,
):
    """Warp every frame of a clip -> (warped (n,h,w,3), mask (n,h,w),
    warped depth (n,h,w), flow (n,h,w,2)).  All inputs on one device, fp32.
    ``use_mask_clean`` (``--mask``): the holes of each frame are dilated and
    blanked after the splat (ops/morphology.py ``clean_mask``).  ``mesh``
    (parallel/mesh.py): every rank passes the whole clip, warps its share of
    the frames and gets every frame's outputs back."""
    if intrinsics2 is None:
        intrinsics2 = intrinsics1
    if mesh is not None:
        return _sharded_warp(mesh.world, frames, depths, pose_s, pose_t, intrinsics1,
                             intrinsics2, use_mask_clean)
    n, h, w = depths.shape
    pts = transform_points(depths, pose_s, pose_t, intrinsics1, intrinsics2)
    coords = pts[..., :2] / pts[..., 2:3]
    trans_depth = pts[..., 2]
    flow = coords - _pixel_grid(h, w, depths.device)

    # one splat for [frame | depth]: the two share indices and weights
    both, mask = bilinear_splat(torch.cat([frames, trans_depth[..., None]], dim=-1),
                                trans_depth, flow)
    known = mask[..., None] > 0
    warped = torch.where(known, both[..., :3].clamp(-1.0, 1.0), torch.full_like(both[..., :3], -1.0))
    if use_mask_clean:
        warped, mask = clean_mask(warped, mask)
    return warped, mask, both[..., 3], flow


def _sharded_warp(axis: D.Axis, frames, depths, pose_s, pose_t, intrinsics1, intrinsics2,
                  use_mask_clean):
    """This rank's contiguous share of the frames along ``axis``, warped,
    then every rank's outputs joined in frame order."""
    n, h, w = depths.shape
    sizes = shard_sizes(n, axis.size)
    lo = sum(sizes[:axis.index])
    mine = slice(lo, lo + sizes[axis.index])
    if sizes[axis.index]:
        outs = forward_warp_batch(frames[mine], depths[mine], pose_s[mine], pose_t[mine],
                                  intrinsics1[mine], intrinsics2[mine], use_mask_clean)
        packed = torch.cat([outs[0], outs[1][..., None], outs[2][..., None], outs[3]], dim=-1)
    else:  # more ranks than frames
        packed = frames.new_zeros((0, h, w, 7))
    every = D.all_gather(packed, axis, dim=0, sizes=sizes, name="warp")
    return every[..., :3], every[..., 3], every[..., 4], every[..., 5:]
