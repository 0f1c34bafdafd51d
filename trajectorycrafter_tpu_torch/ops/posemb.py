"""3D sinusoidal positional embeddings and timestep embeddings.

Counterpart of trajectorycrafter_tpu/ops/posemb.py.  The sincos table is
used only by checkpoints without RoPE (the deployed one has RoPE); it is
built on the host and resized to the runtime latent grid with trilinear
``F.interpolate`` (align_corners=False), once per shape.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """(M,) positions -> (M, embed_dim): [sin(w*p), cos(w*p)] halves."""
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_3d_sincos_pos_embed(
    embed_dim: int,
    spatial_size,  # (width, height)
    temporal_size: int,
    spatial_interpolation_scale: float = 1.875,
    temporal_interpolation_scale: float = 1.0,
) -> np.ndarray:
    """-> (T, H*W, embed_dim); channel layout [temporal dim/4 | spatial 3dim/4]."""
    w, h = spatial_size
    dim_spatial = 3 * embed_dim // 4
    dim_temporal = embed_dim // 4

    grid_h = np.arange(h, dtype=np.float32) / spatial_interpolation_scale
    grid_w = np.arange(w, dtype=np.float32) / spatial_interpolation_scale
    gw, gh = np.meshgrid(grid_w, grid_h)
    emb_w = _sincos_1d(dim_spatial // 2, gw)
    emb_h = _sincos_1d(dim_spatial // 2, gh)
    pos_spatial = np.concatenate([emb_w, emb_h], axis=1)  # (h*w, ds)

    grid_t = np.arange(temporal_size, dtype=np.float32) / temporal_interpolation_scale
    pos_temporal = _sincos_1d(dim_temporal, grid_t)  # (t, dt)

    pos_temporal = np.repeat(pos_temporal[:, np.newaxis, :], h * w, axis=1)
    pos_spatial = np.repeat(pos_spatial[np.newaxis, :, :], temporal_size, axis=0)
    return np.concatenate([pos_temporal, pos_spatial], axis=-1)


@lru_cache(maxsize=16)
def resized_pos_embedding(
    embed_dim: int,
    base_frames: int,
    base_height: int,  # post-patch grid of the trained table
    base_width: int,
    frames: int,
    height: int,  # post-patch grid at runtime
    width: int,
    spatial_interpolation_scale: float = 1.875,
    temporal_interpolation_scale: float = 1.0,
) -> np.ndarray:
    """Trained-table pos-emb trilinearly resized to the runtime grid.

    Returns (frames*height*width, embed_dim) float32, cached per shape.
    """
    table = get_3d_sincos_pos_embed(
        embed_dim, (base_width, base_height), base_frames,
        spatial_interpolation_scale, temporal_interpolation_scale,
    ).astype(np.float32)
    table = table.reshape(base_frames, base_height, base_width, embed_dim)
    if (frames, height, width) != (base_frames, base_height, base_width):
        t = torch.from_numpy(table).permute(3, 0, 1, 2)[None]  # (1, d, f, h, w)
        t = F.interpolate(t, size=(frames, height, width), mode="trilinear",
                          align_corners=False)
        table = t[0].permute(1, 2, 3, 0).numpy()
    return np.ascontiguousarray(table).reshape(frames * height * width, embed_dim)


def timestep_embedding(
    timesteps: torch.Tensor,  # (B,)
    dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal timestep features (diffusers Timesteps semantics), fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                  device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb
