"""Global point cloud: lifting, merging, downsampling and z-buffer rendering.

Counterpart of trajectorycrafter_tpu/geometry/pointcloud.py (the reference's
``warper_point_cloud.py``): every pixel of a clip is unprojected into one
world-space coloured cloud, and a view is rendered from it by a z-buffer
over linearised pixel bins -- ``scatter_reduce("amin")`` of the depths, with
a dump slot at ``npix`` for culled points, then the colour of each pixel's
winner gathered.  The clouds stay on their device (the card in the
autoregressive v2 path: 28.9 M points a 49-frame clip at 576x1024).

The products are written as explicit fp32 multiply-adds, as ops/splat.py
writes its own, so no TF32 matmul can enter (the JAX package runs them at
"highest" precision).  They may still differ from XLA's by an ulp, so a
point on a rounding boundary or a frame border can land one pixel off
(tests/test_torch_pointcloud.py bounds that as the warp's parity is).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from trajectorycrafter_tpu_torch.ops.splat import _pixel_grid

_FAR = 1e10
_NEAR_CULL = 0.01  # points at z <= 0.01 are culled


def _affine(points: torch.Tensor, m: torch.Tensor, t: Optional[torch.Tensor] = None):
    """(..., 3) points -> points @ m.T (+ t), as explicit fp32 multiply-adds."""
    out = [points[..., 0] * m[i, 0] + points[..., 1] * m[i, 1] + points[..., 2] * m[i, 2]
           for i in range(3)]
    if t is not None:
        out = [o + t[i] for i, o in enumerate(out)]
    return torch.stack(out, dim=-1)


def lift_to_pointcloud(frame: torch.Tensor, depth: torch.Tensor, intrinsic: torch.Tensor,
                       c2w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """frame (h, w, 3) colours, depth (h, w), intrinsic (3, 3), c2w (4, 4)
    camera-to-world -> every pixel unprojected to world space: (points
    (h*w, 3), colours (h*w, 3))."""
    h, w = depth.shape
    grid = _pixel_grid(h, w, depth.device)
    pix = torch.cat([grid, torch.ones_like(grid[..., :1])], dim=-1)
    rays = _affine(pix, torch.linalg.inv(intrinsic))
    world = _affine(rays * depth[..., None], c2w[:3, :3], c2w[:3, 3])
    return world.reshape(-1, 3), frame.reshape(-1, 3)


def lift_video_to_pointcloud(frames: torch.Tensor, depths: torch.Tensor,
                             intrinsics: torch.Tensor, c2ws: torch.Tensor):
    """frames (f, h, w, 3), depths (f, h, w), intrinsics (f, 3, 3), c2ws
    (f, 4, 4) -> one cloud of the whole clip, frame by frame in order."""
    parts = [lift_to_pointcloud(*args) for args in zip(frames, depths, intrinsics, c2ws)]
    return torch.cat([p for p, _ in parts]), torch.cat([c for _, c in parts])


def merge_pointclouds(points_list: Sequence[torch.Tensor], colors_list: Sequence[torch.Tensor]):
    return torch.cat(list(points_list)), torch.cat(list(colors_list))


def downsample_pointcloud(points: torch.Tensor, colors: torch.Tensor, num_samples: int,
                          generator: torch.Generator, weights: Optional[torch.Tensor] = None):
    """``num_samples`` rows of the cloud, drawn from ``generator`` (on the
    cloud's device): without replacement unless ``num_samples`` exceeds the
    cloud, as the JAX ``jax.random.choice`` draws; with ``weights``, each row
    in proportion to its weight (``multinomial``).  The draw is torch's, so
    it cannot reproduce JAX's rows from a seed."""
    n = points.shape[0]
    replace = num_samples > n
    if weights is not None:
        idx = torch.multinomial(weights / weights.sum(), num_samples, replacement=replace,
                                generator=generator)
    elif replace:
        idx = torch.randint(n, (num_samples,), generator=generator, device=points.device)
    else:
        idx = torch.randperm(n, generator=generator, device=points.device)[:num_samples]
    return points[idx], colors[idx]


@torch.no_grad()
def render_zbuffer(points: torch.Tensor, colors: torch.Tensor, intrinsic: torch.Tensor,
                   w2c: torch.Tensor, height: int, width: int, point_size: int = 1,
                   background: float = 0.0):
    """Z-buffered point rendering -> (image (h, w, 3), depth (h, w), mask
    (h, w)), fp32, on the points' device.

    A point is valid when z > 0.01 and its unrounded projection lies in the
    frame.  With ``point_size`` 1 it lands on its rounded (half to even)
    pixel, clamped into the frame; with a larger size it covers the (2r+1)^2
    pixels round(x + dx), round(y + dy), |dx|, |dy| <= r = point_size // 2,
    that lie in the frame.  Each pixel keeps the least z of the points on
    it; the points whose z is that least z are its winners.

    Ties: a pixel whose winners share one z takes the colour of the last
    winner in the order (offset, point index) -- the offsets in row-major
    order of (dy, dx), then the highest point index -- made explicit as a
    ``scatter_reduce("amax")`` of offset * n + index and a gather, so the
    card renders the same pixels on every run.  The JAX package's
    ``.at[].set`` keeps the last update of each pixel on the CPU, which is
    the same rule.  The mask is depth < 1e10; the depth is 0 off the mask.
    """
    device = points.device
    n = points.shape[0]
    intrinsic = intrinsic.to(device, torch.float32)
    w2c = w2c.to(device, torch.float32)
    proj = _affine(_affine(points, w2c[:3, :3], w2c[:3, 3]), intrinsic)
    z = proj[:, 2]
    x = proj[:, 0] / z
    y = proj[:, 1] / z
    npix = height * width
    valid = (z > _NEAR_CULL) & (x >= 0) & (x < width) & (y >= 0) & (y < height)

    if point_size == 1:
        offsets = [(0, 0)]
    else:
        r = point_size // 2
        offsets = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
    bins = []
    for dy, dx in offsets:
        if point_size == 1:
            xo = torch.round(x).clamp(0, width - 1).long()
            yo = torch.round(y).clamp(0, height - 1).long()
            ok = valid
        else:
            xo = torch.round(x + dx).long()
            yo = torch.round(y + dy).long()
            ok = valid & (xo >= 0) & (xo < width) & (yo >= 0) & (yo < height)
        bins.append(torch.where(ok, yo * width + xo, torch.full_like(xo, npix)))

    zbuf = torch.full((npix + 1,), _FAR, dtype=torch.float32, device=device)
    for idx in bins:
        zbuf.scatter_reduce_(0, idx, z, "amin")

    # the last winner of each pixel in (offset, point index) order
    order = torch.arange(n, device=device)
    last = torch.full((npix + 1,), -1, dtype=torch.int64, device=device)
    for o, idx in enumerate(bins):
        key = torch.where(z <= zbuf[idx], o * n + order, torch.full_like(order, -1))
        last.scatter_reduce_(0, idx, key, "amax")
    last = last[:npix]
    hit = last >= 0
    img = torch.full((npix, 3), background, dtype=torch.float32, device=device)
    img[hit] = colors[last[hit] % n].to(torch.float32)

    depth_map = zbuf[:npix].reshape(height, width)
    mask = (depth_map < _FAR).to(torch.float32)
    depth_map = torch.where(mask > 0, depth_map, torch.zeros_like(depth_map))
    return img.reshape(height, width, 3), depth_map, mask


class GlobalPointCloudWarper:
    """The reference class's facade (warper_point_cloud.py)."""

    def lift_to_3d_pointcloud(self, frame, depth, intrinsic, c2w):
        return lift_to_pointcloud(frame, depth, intrinsic, c2w)

    def merge_pointclouds(self, points_list, colors_list):
        return merge_pointclouds(points_list, colors_list)

    def downsample_pointcloud(self, points, colors, num_samples, generator, weights=None):
        return downsample_pointcloud(points, colors, num_samples, generator, weights)

    def render_from_camera(self, points, colors, intrinsic, w2c, height, width,
                           point_size: int = 1):
        return render_zbuffer(points, colors, intrinsic, w2c, height, width,
                              point_size=point_size)
