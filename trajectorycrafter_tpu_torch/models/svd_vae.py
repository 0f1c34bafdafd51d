"""SVD AutoencoderKL with the temporal decoder (DepthCrafter's VAE), in PyTorch.

Counterpart of trajectorycrafter_tpu/models/svd_vae.py: a per-frame 2D KL
encoder and a decoder whose resnets blend a (3, 1, 1) temporal conv branch
and which ends in a conv3d over time.  Channel-last at the public
functions, (B, F, H, W, 3) pixels in [-1, 1] and (B, F, H/8, W/8, C)
latents, as in the JAX package.  The mid blocks' single-head attention over
all H/8 x W/8 tokens (9,216 at 576x1024, 512 channels) is a plain matmul /
fp32 softmax in the module, as the JAX package runs it.

Parameter names are diffusers' ``AutoencoderKLTemporalDecoder``
(``utils/convert.py convert_svd_vae``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from trajectorycrafter_tpu_torch.models.depthcrafter import (
    Level,
    Resampler,
    ResnetBlock2D,
    SpatioTemporalResBlock,
    conv_cl,
    group_norm_cl,
    upsample_nearest_2x,
)

SVD_VAE_SCALING = 0.18215


class AttnBlock2D(nn.Module):
    """Single-head spatial self-attention over a frame's H x W tokens."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(32, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        n, h, w, c = x.shape
        t = group_norm_cl(self.group_norm, x).reshape(n, h * w, c)
        q, k, v = self.to_q(t), self.to_k(t), self.to_v(t)
        scores = torch.matmul(q.float(), k.float().transpose(1, 2)) * c ** -0.5
        out = torch.matmul(torch.softmax(scores, dim=-1).to(v.dtype), v)
        return x + self.to_out[0](out).reshape(n, h, w, c)


def _mid_block(resnets, channels: int) -> Level:
    mid = Level()
    mid.resnets.extend(resnets)
    mid.attentions.append(AttnBlock2D(channels))
    return mid


class Encoder2D(nn.Module):
    """Per-frame KL encoder: (N, H, W, 3) -> (N, H/8, W/8, 2 * latent)."""

    def __init__(self, latent_channels: int = 4,
                 block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2):
        super().__init__()
        self.conv_in = nn.Conv2d(3, block_out_channels[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        ch_in = block_out_channels[0]
        for i, ch in enumerate(block_out_channels):
            level = Level()
            for _ in range(layers_per_block):
                level.resnets.append(ResnetBlock2D(ch_in, ch, eps=1e-6))
                ch_in = ch
            if i < len(block_out_channels) - 1:
                level.downsamplers = nn.ModuleList([Resampler(ch, 2, padding=0)])
            self.down_blocks.append(level)
        self.mid_block = _mid_block([ResnetBlock2D(ch_in, ch_in, eps=1e-6) for _ in range(2)],
                                    ch_in)
        self.conv_norm_out = nn.GroupNorm(32, ch_in, eps=1e-6)
        self.conv_out = nn.Conv2d(ch_in, 2 * latent_channels, 3, padding=1)

    def forward(self, x):
        x = conv_cl(self.conv_in, x)
        for level in self.down_blocks:
            for res in level.resnets:
                x = res(x, None)
            if hasattr(level, "downsamplers"):
                # asymmetric pad (bottom / right only), then a stride-2 conv
                x = conv_cl(level.downsamplers[0].conv, F.pad(x, (0, 0, 0, 1, 0, 1)))
        x = self.mid_block.resnets[0](x, None)
        x = self.mid_block.attentions[0](x)
        x = self.mid_block.resnets[1](x, None)
        return conv_cl(self.conv_out, F.silu(group_norm_cl(self.conv_norm_out, x)))


def _decoder_res(in_channels: int, out_channels: int) -> SpatioTemporalResBlock:
    # diffusers Mid/UpBlockTemporalDecoder: spatial eps 1e-6, temporal eps
    # 1e-5, merge factor 0, the sigmoid weight on the temporal branch
    return SpatioTemporalResBlock(in_channels, out_channels, eps=1e-6, temporal_eps=1e-5,
                                  switch=True, mix_init=0.0)


class TemporalDecoder(nn.Module):
    """(B, F, h, w, latent) -> (B, F, 8h, 8w, 3)."""

    def __init__(self, latent_channels: int = 4, out_channels: int = 3,
                 block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 3):
        super().__init__()
        rev = list(reversed(block_out_channels))
        self.conv_in = nn.Conv2d(latent_channels, rev[0], 3, padding=1)
        self.mid_block = _mid_block([_decoder_res(rev[0], rev[0]) for _ in range(2)], rev[0])
        self.up_blocks = nn.ModuleList()
        ch_in = rev[0]
        for i, ch in enumerate(rev):
            level = Level()
            for _ in range(layers_per_block):
                level.resnets.append(_decoder_res(ch_in, ch))
                ch_in = ch
            if i < len(rev) - 1:
                level.upsamplers = nn.ModuleList([Resampler(ch, 1)])
            self.up_blocks.append(level)
        self.conv_norm_out = nn.GroupNorm(32, ch_in, eps=1e-6)
        self.conv_out = nn.Conv2d(ch_in, out_channels, 3, padding=1)
        self.time_conv_out = nn.Conv3d(out_channels, out_channels, (3, 1, 1), padding=(1, 0, 0))

    def forward(self, z):
        b, f, hh, ww, c = z.shape
        x = conv_cl(self.conv_in, z.reshape(b * f, hh, ww, c).to(self.conv_in.weight.dtype))
        x = self.mid_block.resnets[0](x, None, f)
        x = self.mid_block.attentions[0](x)
        x = self.mid_block.resnets[1](x, None, f)
        for level in self.up_blocks:
            for res in level.resnets:
                x = res(x, None, f)
            if hasattr(level, "upsamplers"):
                x = conv_cl(level.upsamplers[0].conv, upsample_nearest_2x(x))
        x = conv_cl(self.conv_out, F.silu(group_norm_cl(self.conv_norm_out, x)))
        # conv3d smoothing over time
        return conv_cl(self.time_conv_out, x.reshape(b, f, *x.shape[1:]))


class AutoencoderKLTemporalDecoder(nn.Module):
    def __init__(self, latent_channels: int = 4,
                 block_out_channels: Sequence[int] = (128, 256, 512, 512)):
        super().__init__()
        self.latent_channels = latent_channels
        self.scaling_factor = SVD_VAE_SCALING
        self.encoder = Encoder2D(latent_channels, block_out_channels)
        self.quant_conv = nn.Conv2d(2 * latent_channels, 2 * latent_channels, 1)
        self.decoder = TemporalDecoder(latent_channels, 3, block_out_channels)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, F, H, W, 3) -> per-frame moments (B, F, H/8, W/8, 2 * latent)."""
        b, f = frames.shape[:2]
        m = conv_cl(self.quant_conv, self.encoder(frames.reshape(b * f, *frames.shape[2:])))
        return m.reshape(b, f, *m.shape[1:])

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)


@torch.no_grad()
def svd_encode_chunked(vae: AutoencoderKLTemporalDecoder, frames: torch.Tensor,
                       chunk: int = 8) -> torch.Tensor:
    """(B, F, H, W, 3) -> (B, F, H/8, W/8, 2 * latent), ``chunk`` frames at a
    time.  The encoder is per-frame, so this is exact; it only bounds the
    activation memory.  (The JAX package replicate-pads the last chunk for
    one static shape; eager PyTorch runs it at its own length.)"""
    return torch.cat([vae.encode(frames[:, i:i + chunk])
                      for i in range(0, frames.shape[1], chunk)], dim=1)


def decode_chunk(h: int, w: int) -> int:
    """The frames of a decode chunk at ``h`` x ``w`` latents (the JAX
    package's rule): ``min(8, max(1, 4*72*128 // (h*w)))``, 4 at 576x1024."""
    return int(min(8, max(1, (4 * 72 * 128) // (h * w))))


@torch.no_grad()
def svd_decode_chunked(vae: AutoencoderKLTemporalDecoder, z: torch.Tensor,
                       chunk: Optional[int] = None) -> torch.Tensor:
    """(B, F, h, w, latent) -> (B, F, 8h, 8w, 3), ``chunk`` frames at a time
    (``decode_chunk`` by default).

    The chunking is semantics, not memory: the temporal decoder mixes time
    only within a chunk (the published ``decode_chunk_size`` behaviour), so
    the JAX package's rule is kept and the last partial chunk is decoded at
    its true length."""
    f = z.shape[1]
    if chunk is None:
        chunk = decode_chunk(z.shape[2], z.shape[3])
    return torch.cat([vae.decode(z[:, i:i + chunk]) for i in range(0, f, chunk)], dim=1)
