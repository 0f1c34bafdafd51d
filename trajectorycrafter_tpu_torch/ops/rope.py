"""3D rotary position embeddings (CogVideoX flavour).

Counterpart of trajectorycrafter_tpu/ops/rope.py: head channels split
t : h : w = 1/4 : 3/8 : 3/8, interleaved-pair rotation, cos/sin tables
repeat-interleaved to the full head dim.  The tables are built on the host
in numpy once per (grid, frames) and moved to the device by the caller.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


def get_resize_crop_region_for_grid(src, tgt_width, tgt_height):
    """Aspect-preserving crop of the base grid."""
    h, w = src
    r = h / w
    if r > (tgt_height / tgt_width):
        resize_height = tgt_height
        resize_width = int(round(tgt_height / h * w))
    else:
        resize_width = tgt_width
        resize_height = int(round(tgt_width / w * h))
    crop_top = int(round((tgt_height - resize_height) / 2.0))
    crop_left = int(round((tgt_width - resize_width) / 2.0))
    return (crop_top, crop_left), (crop_top + resize_height, crop_left + resize_width)


def _rotary_1d(dim: int, pos: np.ndarray, theta: float = 10000.0):
    """-> (cos, sin) each (len(pos), dim), pairs repeat-interleaved."""
    freqs = 1.0 / theta ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim)
    out = np.outer(pos, freqs)
    return np.repeat(np.cos(out), 2, axis=1), np.repeat(np.sin(out), 2, axis=1)


@lru_cache(maxsize=16)
def get_3d_rotary_pos_embed(
    embed_dim: int,
    crops_coords: Tuple[Tuple[int, int], Tuple[int, int]],
    grid_size: Tuple[int, int],  # (h, w)
    temporal_size: int,
    theta: float = 10000.0,
):
    """-> (cos, sin) numpy arrays, each (T*H*W, embed_dim) float32."""
    start, stop = crops_coords
    grid_h_n, grid_w_n = grid_size
    grid_h = np.linspace(start[0], stop[0], grid_h_n, endpoint=False, dtype=np.float32)
    grid_w = np.linspace(start[1], stop[1], grid_w_n, endpoint=False, dtype=np.float32)
    grid_t = np.arange(temporal_size, dtype=np.float32)

    dim_t = embed_dim // 4
    dim_h = embed_dim // 8 * 3
    dim_w = embed_dim // 8 * 3
    t_cos, t_sin = _rotary_1d(dim_t, grid_t, theta)
    h_cos, h_sin = _rotary_1d(dim_h, grid_h, theta)
    w_cos, w_sin = _rotary_1d(dim_w, grid_w, theta)

    def combine(ft, fh, fw):
        shape = (temporal_size, grid_h_n, grid_w_n)
        ft = np.broadcast_to(ft[:, None, None, :], shape + (dim_t,))
        fh = np.broadcast_to(fh[None, :, None, :], shape + (dim_h,))
        fw = np.broadcast_to(fw[None, None, :, :], shape + (dim_w,))
        return np.concatenate([ft, fh, fw], axis=-1).reshape(-1, embed_dim)

    return (combine(t_cos, h_cos, w_cos).astype(np.float32),
            combine(t_sin, h_sin, w_sin).astype(np.float32))


def apply_rotary_emb(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs (x0, x1) -> (x0 cos - x1 sin, x1 cos + x0 sin).

    cos/sin broadcast against x; the arithmetic stays in x's dtype, as in
    the JAX package (an fp32 upcast would materialise GB-sized temporaries
    at 13k tokens x 48 heads).
    """
    pairs = x.unflatten(-1, (-1, 2))
    x_rot = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    return x * cos.to(x.dtype) + x_rot * sin.to(x.dtype)


def rope_for_sample(
    attention_head_dim: int,
    height: int,  # pixel height
    width: int,
    num_latent_frames: int,
    vae_scale_factor_spatial: int = 8,
    patch_size: int = 2,
    base_height: int = 480,
    base_width: int = 720,
):
    """RoPE tables (numpy cos, sin) for a sample resolution."""
    grid_h = height // (vae_scale_factor_spatial * patch_size)
    grid_w = width // (vae_scale_factor_spatial * patch_size)
    base_h = base_height // (vae_scale_factor_spatial * patch_size)
    base_w = base_width // (vae_scale_factor_spatial * patch_size)
    crops = get_resize_crop_region_for_grid((grid_h, grid_w), base_w, base_h)
    return get_3d_rotary_pos_embed(attention_head_dim, crops, (grid_h, grid_w),
                                   num_latent_frames)
