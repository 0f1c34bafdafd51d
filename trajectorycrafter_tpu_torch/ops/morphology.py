"""Mask morphology on the device: dilation, erosion and the ``--mask`` clean-up.

Counterpart of trajectorycrafter_tpu/ops/morphology.py.  For a binary mask,
dilation with an all-ones size x size kernel is a size x size max filter,
here ``F.max_pool2d`` over a border padded with -inf; erosion is the min
filter -max(-x).  Every function takes masks with any leading dimensions
over the last two (h, w), so one call cleans every frame of a clip.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _max_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """size x size max filter over the last two dims, -inf outside."""
    pad = size // 2
    h, w = x.shape[-2:]
    planes = F.pad(x.reshape(-1, 1, h, w), (pad, pad, pad, pad), value=float("-inf"))
    return F.max_pool2d(planes, size, stride=1).reshape(x.shape)


def dilate(mask: torch.Tensor, size: int = 5, iterations: int = 1) -> torch.Tensor:
    """Binary dilation of (..., h, w) masks with an all-ones size x size kernel."""
    for _ in range(iterations):
        mask = _max_filter(mask, size)
    return mask


def erode(mask: torch.Tensor, size: int = 5, iterations: int = 1) -> torch.Tensor:
    """Binary erosion: the min filter -max(-x)."""
    for _ in range(iterations):
        mask = -_max_filter(-mask, size)
    return mask


def mask_open(mask: torch.Tensor, size: int = 9, n_erosion: int = 1,
              n_dilation: int = 1) -> torch.Tensor:
    """Morphological opening of a soft mask: binarise at 0.5, erode, dilate."""
    binary = (mask > 0.5).float()
    binary = erode(binary, size=size, iterations=n_erosion)
    return dilate(binary, size=size, iterations=n_dilation)


def clean_mask(
    warped: torch.Tensor,  # (..., h, w, c) in [-1, 1]
    mask: torch.Tensor,  # (..., h, w) 1 = known
    size: int = 5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dilate the disocclusion holes and blank them in the warped frame.

    holes = binarised (1 - mask) dilated by a size x size kernel; the warped
    frame, mapped to [0, 1], is zeroed inside the holes and mapped back to
    [-1, 1]; the returned mask is 1 - holes.
    """
    holes = torch.where(1.0 - mask >= 0.5, 1.0, 0.0)
    holes = dilate(holes, size=size)
    holes = torch.where(holes >= 0.5, 1.0, 0.0)
    frame01 = (warped + 1.0) / 2.0
    frame01 = frame01 * (1.0 - holes)[..., None]
    return frame01 * 2.0 - 1.0, 1.0 - holes
