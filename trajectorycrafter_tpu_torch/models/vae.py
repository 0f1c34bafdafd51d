"""CogVideoX / MAGVIT-style 3D causal video VAE in PyTorch.

Counterpart of trajectorycrafter_tpu/models/vae.py: 4x temporal + 8x8
spatial compression, 16 latent channels, scaling factor 1.15258426.
Modules work channels-first (N, C, T, H, W), as ``F.conv3d`` wants; the
public ``vae_encode`` / ``vae_decode`` keep the JAX package's channel-last
(B, T, H, W, C).

Each causal conv takes its streaming cache explicitly: ``forward(x, cache)``
returns ``(y, new_cache)``, with nested dicts mirroring the module tree, so
the chunked encode/decode carries the cache across chunks in a plain Python
loop.  Chunk boundaries are the reference's (encode: first chunk 4 + T mod 4
frames, then 4; decode: first chunk 2 + T mod 2 latent frames, then 2),
which bit-comparable outputs need because the causal caches see them.

Module and parameter names are the reference checkpoint's
(``utils/convert.py expected_vae_keys``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Cache = Optional[Dict[str, Any]]

VAE_SCALING_FACTOR = 1.15258426


def _sub(cache: Cache, name: str) -> Cache:
    return None if cache is None else cache.get(name)


def group_norm_f32(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """Apply ``norm`` in fp32 whatever its parameter dtype; result in x's dtype."""
    return F.group_norm(x.float(), norm.num_groups, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(x.dtype)


def _nearest(x: torch.Tensor, size) -> torch.Tensor:
    return F.interpolate(x, size=tuple(size), mode="nearest")


class CausalConv3d(nn.Module):
    """Temporally causal conv3d with an explicit streaming cache.

    The cache holds the last (kt-1) input frames; with no cache the clip's
    first frame is replicated.  Spatial padding is zero, ``kh//2, kw//2``.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int, int] = (3, 3, 3), stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        kt, kh, kw = kernel_size
        self.kt, self.stride, self.dilation = kt, stride, dilation
        self.conv = nn.Conv3d(in_channels, out_channels, kernel_size,
                              stride=(stride, 1, 1), dilation=(dilation, 1, 1),
                              padding=(0, kh // 2, kw // 2))

    def forward(self, x: torch.Tensor, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        new_cache = None
        if self.kt > 1:
            ncache = self.dilation * (self.kt - 1) + (1 - self.stride)
            if cache is None:
                pad = x[:, :, :1].expand(-1, -1, ncache, -1, -1)
            else:
                pad = cache["conv"].to(x.dtype)
            x = torch.cat([pad, x], dim=2)
            # clone: a view would pin the whole chunk's activation
            new_cache = {"conv": x[:, :, x.shape[2] - ncache:].clone()}
        return self.conv(x), new_cache


class SpatialNorm3D(nn.Module):
    """Spatially conditioned GroupNorm (MoVQ): zq is nearest-resized onto f's
    grid, the first frame alone when T is odd."""

    def __init__(self, f_channels: int, zq_channels: int, groups: int = 32):
        super().__init__()
        self.norm_layer = nn.GroupNorm(groups, f_channels, eps=1e-6)
        self.conv_y = CausalConv3d(zq_channels, f_channels, (1, 1, 1))
        self.conv_b = CausalConv3d(zq_channels, f_channels, (1, 1, 1))

    def forward(self, f: torch.Tensor, zq: torch.Tensor) -> torch.Tensor:
        ft, fh, fw = f.shape[2:]
        if ft > 1 and ft % 2 == 1:
            zq = torch.cat([_nearest(zq[:, :, :1], (1, fh, fw)),
                            _nearest(zq[:, :, 1:], (ft - 1, fh, fw))], dim=2)
        else:
            zq = _nearest(zq, (ft, fh, fw))
        y, _ = self.conv_y(zq, None)
        b, _ = self.conv_b(zq, None)
        return group_norm_f32(self.norm_layer, f) * y + b


class ResnetBlock3D(nn.Module):
    """Causal 3D resnet block; SpatialNorm3D conditioned on zq in the decoder."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 32,
                 zq_channels: Optional[int] = None):
        super().__init__()
        self.spatial_norm = zq_channels is not None
        if self.spatial_norm:
            self.norm1 = SpatialNorm3D(in_channels, zq_channels, groups)
            self.norm2 = SpatialNorm3D(out_channels, zq_channels, groups)
        else:
            self.norm1 = nn.GroupNorm(groups, in_channels, eps=1e-6)
            self.norm2 = nn.GroupNorm(groups, out_channels, eps=1e-6)
        self.conv1 = CausalConv3d(in_channels, out_channels)
        self.conv2 = CausalConv3d(out_channels, out_channels)
        self.conv_shortcut = (nn.Conv3d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def _norm(self, norm, x, zq):
        return norm(x, zq) if self.spatial_norm else group_norm_f32(norm, x)

    def forward(self, x, zq, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        h = F.silu(self._norm(self.norm1, x, zq))
        h, c1 = self.conv1(h, _sub(cache, "conv1"))
        h = F.silu(self._norm(self.norm2, h, zq))
        h, c2 = self.conv2(h, _sub(cache, "conv2"))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h, {"conv1": c1, "conv2": c2}


class Downsample3D(nn.Module):
    """Optional 2x time average (odd-T first frame kept), then a spatially
    strided 3x3 conv per frame with asymmetric (0, 1, 0, 1) zero pad."""

    def __init__(self, channels: int, compress_time: bool = False):
        super().__init__()
        self.compress_time = compress_time
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        n, c, t, h, w = x.shape
        if self.compress_time and t > 1:
            if t % 2 == 1:
                rest = x[:, :, 1:].unflatten(2, ((t - 1) // 2, 2)).mean(dim=3)
                x = torch.cat([x[:, :, :1], rest], dim=2)
            else:
                x = x.unflatten(2, (t // 2, 2)).mean(dim=3)
        t2 = x.shape[2]
        frames = F.pad(x.transpose(1, 2).reshape(n * t2, c, h, w), (0, 1, 0, 1))
        y = self.conv(frames)
        return y.reshape(n, t2, c, *y.shape[2:]).transpose(1, 2)


class Upsample3D(nn.Module):
    """Nearest 2x (time doubled too when compressing, the odd-T first frame
    spatially only), then a 3x3 conv per frame."""

    def __init__(self, channels: int, compress_time: bool = False):
        super().__init__()
        self.compress_time = compress_time
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        t = x.shape[2]
        up2d = lambda y: y.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
        if self.compress_time and t > 1 and t % 2 == 1:
            x = torch.cat([up2d(x[:, :, :1]),
                           up2d(x[:, :, 1:].repeat_interleave(2, dim=2))], dim=2)
        elif self.compress_time and t > 1:
            x = up2d(x.repeat_interleave(2, dim=2))
        else:
            x = up2d(x)
        n, c, t2, h2, w2 = x.shape
        y = self.conv(x.transpose(1, 2).reshape(n * t2, c, h2, w2))
        return y.reshape(n, t2, c, h2, w2).transpose(1, 2)


class DownBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int = 3,
                 add_downsample: bool = True, compress_time: bool = False, groups: int = 32):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock3D(in_channels if i == 0 else out_channels, out_channels, groups)
            for i in range(num_layers)
        ])
        self.downsamplers = (nn.ModuleList([Downsample3D(out_channels, compress_time)])
                             if add_downsample else None)

    def forward(self, x, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        new_cache = {}
        for i, resnet in enumerate(self.resnets):
            name = f"resnets_{i}"
            x, new_cache[name] = resnet(x, None, _sub(cache, name))
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x, new_cache


class MidBlock3D(nn.Module):
    def __init__(self, channels: int, num_layers: int = 2, groups: int = 32,
                 zq_channels: Optional[int] = None):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock3D(channels, channels, groups, zq_channels) for _ in range(num_layers)
        ])

    def forward(self, x, zq, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        new_cache = {}
        for i, resnet in enumerate(self.resnets):
            name = f"resnets_{i}"
            x, new_cache[name] = resnet(x, zq, _sub(cache, name))
        return x, new_cache


class UpBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, zq_channels: int,
                 num_layers: int = 4, add_upsample: bool = True,
                 compress_time: bool = False, groups: int = 32):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock3D(in_channels if i == 0 else out_channels, out_channels, groups,
                          zq_channels)
            for i in range(num_layers)
        ])
        self.upsamplers = (nn.ModuleList([Upsample3D(out_channels, compress_time)])
                           if add_upsample else None)

    def forward(self, x, zq, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        new_cache = {}
        for i, resnet in enumerate(self.resnets):
            name = f"resnets_{i}"
            x, new_cache[name] = resnet(x, zq, _sub(cache, name))
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x, new_cache


class Encoder3D(nn.Module):
    """(N, 3, T, H, W) -> (N, 2*latent, T', H/8, W/8) moments."""

    def __init__(self, latent_channels: int = 16,
                 block_out_channels: Sequence[int] = (128, 256, 256, 512),
                 layers_per_block: int = 3, temporal_compress_level: int = 2,
                 norm_num_groups: int = 32):
        super().__init__()
        boc = list(block_out_channels)
        n = len(boc)
        self.conv_in = CausalConv3d(3, boc[0])
        self.down_blocks = nn.ModuleList([
            DownBlock3D(boc[max(i - 1, 0)], boc[i], layers_per_block,
                        add_downsample=i < n - 1,
                        compress_time=i < temporal_compress_level, groups=norm_num_groups)
            for i in range(n)
        ])
        self.mid_block = MidBlock3D(boc[-1], 2, norm_num_groups)
        self.norm_out = nn.GroupNorm(norm_num_groups, boc[-1], eps=1e-6)
        self.conv_out = CausalConv3d(boc[-1], 2 * latent_channels)

    def forward(self, x, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        new_cache = {}
        x, new_cache["conv_in"] = self.conv_in(x, _sub(cache, "conv_in"))
        for i, block in enumerate(self.down_blocks):
            name = f"down_blocks_{i}"
            x, new_cache[name] = block(x, _sub(cache, name))
        x, new_cache["mid_block"] = self.mid_block(x, None, _sub(cache, "mid_block"))
        x = F.silu(group_norm_f32(self.norm_out, x))
        x, new_cache["conv_out"] = self.conv_out(x, _sub(cache, "conv_out"))
        return x, new_cache


class Decoder3D(nn.Module):
    """(N, latent, T', h, w) -> (N, 3, T, 8h, 8w)."""

    def __init__(self, latent_channels: int = 16, out_channels: int = 3,
                 block_out_channels: Sequence[int] = (128, 256, 256, 512),
                 layers_per_block: int = 3, temporal_compress_level: int = 2,
                 norm_num_groups: int = 32):
        super().__init__()
        rev = list(reversed(block_out_channels))
        n = len(rev)
        self.conv_in = CausalConv3d(latent_channels, rev[0])
        self.mid_block = MidBlock3D(rev[0], 2, norm_num_groups, zq_channels=latent_channels)
        self.up_blocks = nn.ModuleList([
            UpBlock3D(rev[max(i - 1, 0)], rev[i], latent_channels, layers_per_block + 1,
                      add_upsample=i < n - 1, compress_time=i < temporal_compress_level,
                      groups=norm_num_groups)
            for i in range(n)
        ])
        self.norm_out = SpatialNorm3D(rev[-1], latent_channels, norm_num_groups)
        self.conv_out = CausalConv3d(rev[-1], out_channels)

    def forward(self, z, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        new_cache = {}
        x, new_cache["conv_in"] = self.conv_in(z, _sub(cache, "conv_in"))
        x, new_cache["mid_block"] = self.mid_block(x, z, _sub(cache, "mid_block"))
        for i, block in enumerate(self.up_blocks):
            name = f"up_blocks_{i}"
            x, new_cache[name] = block(x, z, _sub(cache, name))
        x = F.silu(self.norm_out(x, z))
        x, new_cache["conv_out"] = self.conv_out(x, _sub(cache, "conv_out"))
        return x, new_cache


class AutoencoderKLCogVideoX(nn.Module):
    def __init__(self, latent_channels: int = 16,
                 block_out_channels: Sequence[int] = (128, 256, 256, 512),
                 layers_per_block: int = 3, norm_num_groups: int = 32,
                 scaling_factor: float = VAE_SCALING_FACTOR):
        super().__init__()
        self.latent_channels = latent_channels
        self.scaling_factor = scaling_factor
        self.encoder = Encoder3D(latent_channels, block_out_channels, layers_per_block,
                                 norm_num_groups=norm_num_groups)
        self.decoder = Decoder3D(latent_channels, 3, block_out_channels, layers_per_block,
                                 norm_num_groups=norm_num_groups)


def _chunked(fn, x: torch.Tensor, first: int, step: int) -> torch.Tensor:
    """Run ``fn(chunk, cache)`` over (N, C, T, H, W) time chunks: the first
    ``first`` frames, then ``step`` at a time, carrying the cache."""
    t = x.shape[2]
    bounds = [0, first] + list(range(first + step, t + 1, step))
    outs, cache = [], None
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        y, cache = fn(x[:, :, lo:hi], cache)
        outs.append(y)
    return torch.cat(outs, dim=2)


@torch.no_grad()
def vae_encode(vae: AutoencoderKLCogVideoX, video: torch.Tensor) -> torch.Tensor:
    """video (B, T, H, W, 3) -> latent moments (B, T_lat, H/8, W/8, 2C).

    The first chunk takes 4 + (T mod 4) frames, every later chunk 4.
    """
    x = video.permute(0, 4, 1, 2, 3)
    t = x.shape[2]
    first = t if t <= 4 else 4 + t % 4
    return _chunked(vae.encoder, x, first, 4).permute(0, 2, 3, 4, 1)


@torch.no_grad()
def vae_decode(vae: AutoencoderKLCogVideoX, latents: torch.Tensor) -> torch.Tensor:
    """latents (B, T_lat, h, w, C) -> video (B, T, 8h, 8w, 3).

    The first chunk takes 2 + (T_lat mod 2) latent frames, every later one 2.
    """
    z = latents.permute(0, 4, 1, 2, 3)
    t = z.shape[2]
    first = t if t <= 2 else 2 + t % 2
    return _chunked(vae.decoder, z, first, 2).permute(0, 2, 3, 4, 1)


def sample_posterior(moments: torch.Tensor, latent_channels: int,
                     noise: torch.Tensor) -> torch.Tensor:
    """DiagonalGaussian sample from concatenated (mean, logvar) moments, with
    the caller's standard-normal ``noise`` shaped like the mean."""
    mean = moments[..., :latent_channels]
    logvar = moments[..., latent_channels:].clamp(-30.0, 20.0)
    std = torch.exp(0.5 * logvar)
    return mean + std * noise.to(mean.dtype)


def posterior_mode(moments: torch.Tensor, latent_channels: int = 16) -> torch.Tensor:
    return moments[..., :latent_channels]
