"""CogVideoX / MAGVIT-style 3D causal video VAE in PyTorch.

Counterpart of trajectorycrafter_tpu/models/vae.py: 4x temporal + 8x8
spatial compression, 16 latent channels, scaling factor 1.15258426.
Modules work channels-first (N, C, T, H, W), as ``F.conv3d`` wants; the
public ``vae_encode`` / ``vae_decode`` / ``vae_decode_tiled`` /
``vae_decode_auto`` keep the JAX package's channel-last (B, T, H, W, C).

Each causal conv takes its streaming cache explicitly: ``forward(x, cache)``
returns ``(y, new_cache)``, with nested dicts mirroring the module tree, so
the chunked encode/decode carries the cache across chunks in a plain Python
loop.  Chunk boundaries are the reference's (encode: first chunk 4 + T mod 4
frames, then 4; decode: first chunk 2 + T mod 2 latent frames, then 2),
which bit-comparable outputs need because the causal caches see them.

Module and parameter names are the reference checkpoint's
(``utils/convert.py expected_vae_keys``).

Spatial sharding (the JAX package's H-on-dp, W-on-sp VAE under a mesh):
``parallel/spatial.py shard_spatially(vae, plane)`` gives a twin of the
VAE, sharing its weights, whose modules carry the dp x sp ``plane``: its
convolutions take their spatial padding from the neighbours' halos (zeros
at the global edges), its GroupNorms reduce their statistics over the
plane, and ``vae_encode`` / ``vae_decode`` / ``vae_decode_auto`` on it take
the whole tensor, run this rank's slab and return the whole result,
gathered over the plane.  Time is not sharded: the chunking over time and
the causal caches are as on one device (each rank caches its slab's
frames).  The nearest resizes (SpatialNorm3D's zq, the 2x upsample) and the
time pooling are local on slabs split in whole latent rows and columns.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from trajectorycrafter_tpu_torch.parallel import spatial

Cache = Optional[Dict[str, Any]]

VAE_SCALING_FACTOR = 1.15258426


def _sub(cache: Cache, name: str) -> Cache:
    return None if cache is None else cache.get(name)


def group_norm_f32(norm: nn.GroupNorm, x: torch.Tensor, plane=None) -> torch.Tensor:
    """Apply ``norm`` in fp32 whatever its parameter dtype; result in x's
    dtype.  Under ``plane`` x is a slab and the statistics are the whole
    tensor's (``spatial.group_norm``)."""
    if plane is not None:
        return spatial.group_norm(norm, x, plane)
    return F.group_norm(x.float(), norm.num_groups, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(x.dtype)


def _nearest(x: torch.Tensor, size) -> torch.Tensor:
    return F.interpolate(x, size=tuple(size), mode="nearest")


class CausalConv3d(nn.Module):
    """Temporally causal conv3d with an explicit streaming cache.

    The cache holds the last (kt-1) input frames; with no cache the clip's
    first frame is replicated.  Spatial padding is zero, ``kh//2, kw//2``;
    under a ``plane`` it is the neighbours' halo, exchanged after the time
    padding, so that the cached frames carry theirs too.
    """

    plane = None

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
        ph, pw = self.conv.padding[1:]
        if self.plane is None or ph == pw == 0:
            return self.conv(x), new_cache
        x = spatial.halo(x, self.plane, ph, ph, pw, pw)
        return F.conv3d(x, self.conv.weight, self.conv.bias, self.conv.stride, 0,
                        self.conv.dilation), new_cache


class SpatialNorm3D(nn.Module):
    """Spatially conditioned GroupNorm (MoVQ): zq is nearest-resized onto f's
    grid, the first frame alone when T is odd.  Under a ``plane`` the
    resize is local: f's slab is zq's slab scaled by a power of 2."""

    plane = None

    def __init__(self, f_channels: int, zq_channels: int, groups: int = 32):
        super().__init__()
        self.norm_layer = nn.GroupNorm(groups, f_channels, eps=1e-6)
        self.conv_y = CausalConv3d(zq_channels, f_channels, (1, 1, 1))
        self.conv_b = CausalConv3d(zq_channels, f_channels, (1, 1, 1))

    def forward(self, f: torch.Tensor, zq: torch.Tensor) -> torch.Tensor:
        ft, fh, fw = f.shape[2:]
        if self.plane is not None and (fh % zq.shape[3] or fw % zq.shape[4]):
            raise ValueError(f"a {fh} x {fw} slab is no multiple of its {tuple(zq.shape[3:])} "
                             "zq slab")
        if ft > 1 and ft % 2 == 1:
            zq = torch.cat([_nearest(zq[:, :, :1], (1, fh, fw)),
                            _nearest(zq[:, :, 1:], (ft - 1, fh, fw))], dim=2)
        else:
            zq = _nearest(zq, (ft, fh, fw))
        y, _ = self.conv_y(zq, None)
        b, _ = self.conv_b(zq, None)
        return group_norm_f32(self.norm_layer, f, self.plane) * y + b


class ResnetBlock3D(nn.Module):
    """Causal 3D resnet block; SpatialNorm3D conditioned on zq in the decoder."""

    plane = None

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
        return norm(x, zq) if self.spatial_norm else group_norm_f32(norm, x, self.plane)

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
    strided 3x3 conv per frame with asymmetric (0, 1, 0, 1) zero pad; under
    a ``plane`` the pad is one row of the dp neighbour below and one column
    of the sp neighbour to the right (zeros at the global bottom and right
    edges), so a slab must start on an even row and column and hold an even
    number of each."""

    plane = None

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
        frames = x.transpose(1, 2).reshape(n * t2, c, h, w)
        if self.plane is None:
            frames = F.pad(frames, (0, 1, 0, 1))
        elif h % 2 or w % 2:
            raise ValueError(f"a {h} x {w} slab at a stride-2 level: slabs split in whole "
                             "latent rows and columns stay even")
        else:
            frames = spatial.halo(frames, self.plane, 0, 1, 0, 1)
        y = self.conv(frames)
        return y.reshape(n, t2, c, *y.shape[2:]).transpose(1, 2)


class Upsample3D(nn.Module):
    """Nearest 2x (time doubled too when compressing, the odd-T first frame
    spatially only), then a 3x3 conv per frame (under a ``plane``, padded
    by the neighbours' halo)."""

    plane = None

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
        frames = x.transpose(1, 2).reshape(n * t2, c, h2, w2)
        if self.plane is None:
            y = self.conv(frames)
        else:
            y = F.conv2d(spatial.halo(frames, self.plane, 1, 1, 1, 1), self.conv.weight,
                         self.conv.bias)
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

    plane = None

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
        x = F.silu(group_norm_f32(self.norm_out, x, self.plane))
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
    plane = None  # set on a spatially sharded twin (parallel/spatial.py)

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

    The first chunk takes 4 + (T mod 4) frames, every later chunk 4.  On a
    spatially sharded twin each rank encodes its slab of ``video`` and the
    moments are gathered over the plane.
    """
    x = video.permute(0, 4, 1, 2, 3)
    h, w = x.shape[3:]
    if vae.plane is not None:
        x = vae.plane.slab(x, spatial.LATENT_SCALE)
    t = x.shape[2]
    first = t if t <= 4 else 4 + t % 4
    y = _chunked(vae.encoder, x, first, 4)
    if vae.plane is not None:
        scale = spatial.LATENT_SCALE
        y = vae.plane.gather(y, h // scale, w // scale, 1)
    return y.permute(0, 2, 3, 4, 1)


@torch.no_grad()
def vae_decode(vae: AutoencoderKLCogVideoX, latents: torch.Tensor) -> torch.Tensor:
    """latents (B, T_lat, h, w, C) -> video (B, T, 8h, 8w, 3).

    The first chunk takes 2 + (T_lat mod 2) latent frames, every later one 2.
    On a spatially sharded twin each rank decodes its slab of ``latents``
    and the frames are gathered over the plane.
    """
    z = latents.permute(0, 4, 1, 2, 3)
    h, w = z.shape[3:]
    if vae.plane is not None:
        z = vae.plane.slab(z, 1)
    t = z.shape[2]
    first = t if t <= 2 else 2 + t % 2
    y = _chunked(vae.decoder, z, first, 2)
    if vae.plane is not None:
        y = vae.plane.gather(y, h, w, spatial.LATENT_SCALE)
    return y.permute(0, 2, 3, 4, 1)


def _blend(a: torch.Tensor, b: torch.Tensor, extent: int, dim: int) -> torch.Tensor:
    """``b`` with its first ``extent`` rows along ``dim`` ramped linearly in
    from the last ``extent`` rows of ``a`` (weights arange(extent) / extent);
    an extent of 0 leaves ``b`` as it is."""
    extent = min(a.shape[dim], b.shape[dim], extent)
    if extent == 0:
        return b
    shape = [1] * a.ndim
    shape[dim] = extent
    ramp = (torch.arange(extent, device=a.device) / extent).reshape(shape)
    mixed = a.narrow(dim, a.shape[dim] - extent, extent) * (1 - ramp) + \
        b.narrow(dim, 0, extent) * ramp
    return torch.cat([mixed, b.narrow(dim, extent, b.shape[dim] - extent)], dim=dim)


@torch.no_grad()
def vae_decode_tiled(vae: AutoencoderKLCogVideoX, latents: torch.Tensor,
                     tile_latent_height: int = 30, tile_latent_width: int = 45,
                     overlap_factor_h: float = 1.0 / 6.0,
                     overlap_factor_w: float = 1.0 / 5.0) -> torch.Tensor:
    """latents (B, T_lat, h, w, C) -> fp32 video (B, T, 8h, 8w, 3), decoded
    tile by tile (each tile through ``vae_decode``, its causal chunks
    included) and blended over the overlaps with linear ramps.

    The arithmetic is the JAX package's (``vae_decode_tiled``, after the
    reference's ``tiled_decode``): tiles start every int(tile * (1 -
    overlap)) latent rows / columns, blend over int(8 * tile * overlap)
    pixels with the tile above and the tile to the left, keep their first
    8 tile - blend pixels, and the mosaic is cropped to 8h x 8w.  The tiles
    are taken in fp32 before blending, as JAX promotes a bf16 tile mixed with
    its fp32 ramp.

    On a spatially sharded twin each tile is decoded on the plane, H on dp
    and W on sp (``vae_decode``: this rank's slab, the tile gathered over
    the plane), and every rank blends the whole tiles as the unsharded
    decode does.  A tile that would leave a rank of the plane without a
    latent row or column raises before anything runs.
    """
    b, t, h, w, c = latents.shape
    stride_h = int(tile_latent_height * (1 - overlap_factor_h))
    stride_w = int(tile_latent_width * (1 - overlap_factor_w))
    blend_h_px = int(8 * tile_latent_height * overlap_factor_h)
    blend_w_px = int(8 * tile_latent_width * overlap_factor_w)
    row_limit_h = tile_latent_height * 8 - blend_h_px
    row_limit_w = tile_latent_width * 8 - blend_w_px
    tops, lefts = range(0, h, stride_h), range(0, w, stride_w)
    if vae.plane is not None:
        for i in tops:
            for j in lefts:
                vae.plane.extents(min(tile_latent_height, h - i), min(tile_latent_width, w - j))

    rows = [[vae_decode(vae, latents[:, :, i:i + tile_latent_height,
                                     j:j + tile_latent_width]).float()
             for j in lefts] for i in tops]
    out_rows = []
    for i, row in enumerate(rows):
        out_row = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = _blend(rows[i - 1][j], tile, blend_h_px, 2)
            if j > 0:
                tile = _blend(row[j - 1], tile, blend_w_px, 3)
            out_row.append(tile[:, :, :row_limit_h, :row_limit_w])
        out_rows.append(torch.cat(out_row, dim=3))
    return torch.cat(out_rows, dim=2)[:, :, :h * 8, :w * 8]


# Peak-memory model of the one-shot decoder (the JAX package's): the last
# up-block holds ~3 copies of the (T_px, H, W, 128) bf16 activation plus
# caches and the output, ~3.5 times that tensor; the one-shot decode runs
# while the estimate stays under 0.60 of the device's memory.
_DECODE_PEAK_FACTOR = 128 * 2 * 3.5
_DECODE_MEMORY_FRACTION = 0.60


def decode_memory_bytes(device) -> int:
    """The memory ``vae_decode_auto`` plans against on ``device``: the card's
    total memory, or on the CPU the host's physical memory."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def decode_is_tiled(latent_shape: Sequence[int], memory_bytes: int,
                    peak_divisor: int = 1) -> bool:
    """Whether ``vae_decode_auto`` decodes latents of ``latent_shape`` (B,
    T_lat, h, w, C) in strips: the one-shot decoder's estimated peak, B x
    T_px x 8h x 8w x ``_DECODE_PEAK_FACTOR`` bytes over ``peak_divisor``
    (the ranks whose slabs share the activations), is above 0.60 of
    ``memory_bytes``."""
    b, t_lat, h, w = latent_shape[:4]
    est_peak = b * ((t_lat - 1) * 4 + 1) * (8 * h) * (8 * w) * _DECODE_PEAK_FACTOR
    return est_peak / peak_divisor > _DECODE_MEMORY_FRACTION * memory_bytes


def decode_peak_divisor(vae: AutoencoderKLCogVideoX) -> int:
    """How many ranks share the decode's activations: dp x sp on a
    spatially sharded twin, 1 otherwise.  The JAX package divides by the
    whole mesh (``pipelines/trajcrafter.py:556``, ``mesh.size``), which
    counts the tp ranks too, though they hold the same slab: with tp > 1 it
    underestimates a rank's peak (``ADVICE.md`` rates it high)."""
    return 1 if vae.plane is None else vae.plane.size


@torch.no_grad()
def vae_decode_auto(vae: AutoencoderKLCogVideoX, latents: torch.Tensor, memory_bytes: int,
                    strip_height: int = 24) -> torch.Tensor:
    """Decode in one shot, or, when ``decode_is_tiled`` says the one-shot peak
    would not fit ``memory_bytes``, in full-width strips of ``strip_height``
    latent rows blended over 1/7 of a strip (the JAX ``vae_decode_auto``'s
    rule, chosen before anything runs; the caller passes the memory, e.g.
    ``decode_memory_bytes(device)``).  On a spatially sharded twin the
    estimate is a rank's (``decode_peak_divisor``), and the one-shot decode
    or each strip runs on the plane (``vae_decode_tiled``), as JAX's
    ``_decode_jit`` dispatches its strips on latents laid out H on dp and W
    on sp."""
    if not decode_is_tiled(latents.shape, memory_bytes, decode_peak_divisor(vae)):
        return vae_decode(vae, latents)
    return vae_decode_tiled(vae, latents, tile_latent_height=strip_height,
                            tile_latent_width=latents.shape[3],
                            overlap_factor_h=1.0 / 7.0, overlap_factor_w=0.0)


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
