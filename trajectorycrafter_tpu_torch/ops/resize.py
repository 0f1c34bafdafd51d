"""Linear and nearest resizes with torch ``F.interpolate`` semantics.

Counterpart of trajectorycrafter_tpu/ops/resize.py ``resize_linear`` and
``resize_nearest``.  The JAX package gathers each axis by hand with
half-pixel centres (its ``_gather_axis_linear_hp``: source coordinate
(i + 0.5) * in/out - 0.5, clamped to the input) because ``jax.image.resize``
differs at the edges; ``F.interpolate(..., antialias=False)`` computes
exactly that, so the port calls it (tests/test_torch_depth.py holds the two
against each other).  ``resize_nearest`` is torch's ``nearest`` (the source
index floor(i * in / out), clamped), not ``nearest-exact``.

``resize_bicubic_jax`` is ``jax.image.resize(..., "bicubic")``, which the
JAX VDA uses to resize its position table; it is not torch's bicubic (Keys
a = -0.5 where torch takes -0.75, the kernel widened by in / out and the
weights renormalised when an axis shrinks, zero weight for a sample outside
the input): each axis is one product with the weight matrix of
``jax.image.scale_and_translate``, computed here in fp32 as JAX computes it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

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


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys cubic kernel with a = -0.5 at |x| (fp32, JAX's arithmetic)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def bicubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) fp32 weights of one axis of ``jax.image.resize``'s
    bicubic (``compute_weight_mat`` with translation 0, antialiased)."""
    one, half = np.float32(1.0), np.float32(0.5)
    inv_scale = one / np.float32(out_size / in_size)
    kernel_scale = max(inv_scale, one)
    sample = (np.arange(out_size, dtype=np.float32) + half) * inv_scale - half
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = _keys_cubic(x.astype(np.float32))
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, one), 0.0)
    inside = (sample >= -half) & (sample <= np.float32(in_size) - half)
    return np.where(inside[None, :], w, 0.0).astype(np.float32).T


def resize_bicubic_jax(x: torch.Tensor, out_spatial: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(x, ..., "bicubic")`` of the trailing
    ``len(out_spatial)`` axes of ``x`` (any leading axes), in fp32; an axis
    already at its size is left as it is, as JAX skips it."""
    out = x
    for i, size in enumerate(out_spatial):
        axis = x.ndim - len(out_spatial) + i
        n = out.shape[axis]
        if n == size:
            continue
        w = torch.from_numpy(bicubic_weights(n, size)).to(x.device, x.dtype)
        out = torch.tensordot(out.movedim(axis, -1), w.T, dims=1).movedim(-1, axis)
    return out
