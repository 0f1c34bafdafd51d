"""The reference-compatible ``Warper`` facade over the port's splat.

Counterpart of trajectorycrafter_tpu/geometry/warper.py: the reference's
``Warper.forward_warp`` signature and semantics with NCHW batches in and
out, so code written against the reference ports directly.  Inside, the
batch is channel-last and every frame is warped at once on its device
(ops/splat.py); ``mask=True`` blanks the dilated holes (ops/morphology.py
``clean_mask``), ``twice=True`` warps forward and back again.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from trajectorycrafter_tpu_torch.ops.morphology import clean_mask
from trajectorycrafter_tpu_torch.ops.splat import _pixel_grid, bilinear_splat, transform_points


def _image_splat(values, mask, depth, flow):
    """A splat of image values: clipped to [-1, 1], -1 in the holes."""
    out, known = bilinear_splat(values, depth, flow, mask)
    return torch.where(known[..., None] > 0, out.clamp(-1.0, 1.0), -1.0), known


@torch.no_grad()
def forward_warp(
    frame1: torch.Tensor,  # (b, 3, h, w) in [-1, 1]
    mask1: Optional[torch.Tensor],  # (b, 1, h, w) or None
    depth1: torch.Tensor,  # (b, 1, h, w)
    transformation1: torch.Tensor,  # (b, 4, 4)
    transformation2: torch.Tensor,  # (b, 4, 4)
    intrinsic1: torch.Tensor,  # (b, 3, 3)
    intrinsic2: Optional[torch.Tensor] = None,  # (b, 3, 3)
    mask: bool = False,
    twice: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """-> (warped frame (b, 3, h, w), mask (b, 1, h, w), warped depth
    (b, 1, h, w), flow (b, 2, h, w), or None with ``twice``)."""
    frames = frame1.float().permute(0, 2, 3, 1)
    depths = depth1.float()[:, 0]
    masks = None if mask1 is None else mask1.float()[:, 0]
    if intrinsic2 is None:
        intrinsic2 = intrinsic1
    h, w = depths.shape[-2:]
    pts = transform_points(depths, transformation1.float(), transformation2.float(),
                           intrinsic1.float(), intrinsic2.float())
    trans_depth = pts[..., 2]
    flow = pts[..., :2] / pts[..., 2:3] - _pixel_grid(h, w, depths.device)

    warped, mask2 = _image_splat(frames, masks, trans_depth, flow)
    warped_depth, _ = bilinear_splat(trans_depth[..., None], trans_depth, flow, masks)
    if mask:
        warped, mask2 = clean_mask(warped, mask2)
    if twice:
        if mask:
            warped_depth, _ = clean_mask(warped_depth, mask2)
        warped_flow, _ = bilinear_splat(flow, trans_depth, flow, masks)
        back = (warped_depth[..., 0], -warped_flow)
        warped_depth, _ = bilinear_splat(warped_depth, *back, mask2)
        warped, mask2 = _image_splat(warped, mask2, *back)
        if mask:
            warped, mask2 = clean_mask(warped, mask2)
            warped_depth, _ = clean_mask(warped_depth, mask2)
    return (warped.permute(0, 3, 1, 2), mask2[:, None], warped_depth.permute(0, 3, 1, 2),
            None if twice else flow.permute(0, 3, 1, 2))


class Warper:
    """Drop-in replacement for the reference ``Warper``."""

    def __init__(self, resolution: Optional[tuple] = None):
        self.resolution = resolution

    def forward_warp(self, frame1, mask1, depth1, transformation1, transformation2,
                     intrinsic1, intrinsic2=None, mask=False, twice=False):
        if self.resolution is not None:
            assert tuple(frame1.shape[2:4]) == tuple(self.resolution)
        return forward_warp(frame1, mask1, depth1, transformation1, transformation2,
                            intrinsic1, intrinsic2, mask=mask, twice=twice)

    @staticmethod
    def create_grid(b: int, h: int, w: int, device=None) -> torch.Tensor:
        """(b, 2, h, w) grid of (x, y) pixel coordinates."""
        return _pixel_grid(h, w, device).permute(2, 0, 1).expand(b, 2, h, w)
