"""Linear and nearest resizes with torch ``F.interpolate`` semantics.

Counterpart of trajectorycrafter_tpu/ops/resize.py ``resize_linear`` and
``resize_nearest``.  The JAX package gathers each axis by hand with
half-pixel centres (its ``_gather_axis_linear_hp``: source coordinate
(i + 0.5) * in/out - 0.5, clamped to the input) because ``jax.image.resize``
differs at the edges; ``F.interpolate(..., antialias=False)`` computes
exactly that, so the port calls it (tests/test_torch_depth.py holds the two
against each other).  ``resize_nearest`` is torch's ``nearest`` (the source
index floor(i * in / out), clamped), not ``nearest-exact``.
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


def resize_nearest(x: torch.Tensor, out_spatial: Sequence[int]) -> torch.Tensor:
    """Nearest resize of the trailing ``len(out_spatial)`` axes of ``x``: along
    each, output i reads input floor(i * in / out) (the product in fp32, as
    the JAX gather takes it), clamped to the input; an axis already at its
    size is left as it is."""
    out = x
    for i, size in enumerate(out_spatial):
        axis = x.ndim - len(out_spatial) + i
        n = out.shape[axis]
        if n == size:
            continue
        idx = (torch.arange(size, dtype=torch.float32, device=x.device) * (n / size)).long()
        out = out.index_select(axis, idx.clamp(0, n - 1))
    return out
