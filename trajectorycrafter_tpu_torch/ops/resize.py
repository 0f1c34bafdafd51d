"""Linear resize with torch ``F.interpolate`` semantics.

Counterpart of trajectorycrafter_tpu/ops/resize.py ``resize_linear``.  The
JAX package gathers each axis by hand with half-pixel centres (its
``_gather_axis_linear_hp``: source coordinate (i + 0.5) * in/out - 0.5,
clamped to the input) because ``jax.image.resize`` differs at the edges;
``F.interpolate(..., antialias=False)`` computes exactly that, so the port
calls it (tests/test_torch_depth.py holds the two against each other).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

_MODES = {1: "linear", 2: "bilinear", 3: "trilinear"}


def resize_linear(x: torch.Tensor, out_spatial: Sequence[int],
                  align_corners: bool = False) -> torch.Tensor:
    """Linear resize of the trailing ``len(out_spatial)`` axes of (N, C, ...)."""
    return F.interpolate(x, size=tuple(out_spatial), mode=_MODES[len(out_spatial)],
                         align_corners=align_corners, antialias=False)
