"""DepthCrafter video-depth UNet (the SVD spatio-temporal architecture) in PyTorch.

Counterpart of trajectorycrafter_tpu/models/depthcrafter.py, bf16 branch
(``quant="none"``; ``quant="int8"`` is this model after ``ops/int8.py
quantize_depth_unet_``, which swaps the transformers' linear layers for
``Int8Linear`` ones):
  * 8-channel input (4 noisy latents + 4 per-frame conditioning latents);
  * blocks (320, 640, 1280, 1280), 2 layers per block, heads (5, 10, 20, 20)
    of 64, cross-attention to one 1024-d CLIP embedding per frame;
  * every layer is a spatial resnet and a temporal resnet blended by a
    learned alpha, then a spatial transformer and a temporal transformer
    blended likewise;
  * time embedding 320 -> 1280 plus the three added time ids (fps, motion
    bucket, noise aug) embedded 256 x 3 -> 1280.

Layout, as in the JAX package: channel-last (B*F, H, W, C) with the frames
on the batch axis; temporal blocks see (B, F, H, W, C) or (B*HW, F, C).
Convolutions run on the channel-last tensor viewed as NCHW (a channels-last
view, which cuDNN takes as it is); group and layer norms run in fp32.

Attention routing mirrors the JAX ``CrossAttention``: on the card a
self-attention with at least 2^20 scores per (frame, head) goes to a
hand-written kernel, chosen by ``TRAJCRAFTER_DEPTH_ATTN`` (``flash_stock``,
the default, ``flash_max`` or ``flash_pv8``) or by a module's
``attention_impl``; every
other attention (the 576- and 144-token levels, all temporal attention over
the frames, all cross-attention to the single CLIP token) is the plain
matmul / fp32 softmax.

Under a dp x sp x tp mesh (pipelines/depth.py ``with_mesh``) the UNet's
twin (parallel/spatial.py ``shard_spatially``, sharing its weights) carries
the partition (parallel/frames.py ``FrameRows``) as ``plane`` and takes this
rank's slab of the window: its frames (dp) and latent rows (sp), the whole
latent height and every frame's CLIP embedding.  The 3x3 convolutions read
one halo row of their sp neighbours, the stride-2 downsamplers one row
above, the temporal resnets' convolutions one halo frame of their dp
neighbours; the GroupNorms take the whole tensor's statistics (per frame
over sp, the temporal resnets' over the plane); the spatial self-attention
runs a rank's query rows against the whole frame's keys and values
(gathered over sp), the temporal one its frames against every frame's
(over dp), each routed on the whole frame's ``s * s_kv`` as unsharded; the
temporal transformers embed the global frame indices and take global frame
0's CLIP embedding as their context.  The unsharded UNet is unchanged.

Parameter names are diffusers' ``UNetSpatioTemporalConditionModel``
(``utils/convert.py convert_svd_unet``).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from trajectorycrafter_tpu_torch.models.dit import layer_norm_f32
from trajectorycrafter_tpu_torch.ops.attention import multi_head_attention
from trajectorycrafter_tpu_torch.ops.posemb import timestep_embedding
from trajectorycrafter_tpu_torch.parallel import frames as FR

# a self-attention launches a kernel at s * s_kv >= 2^20 scores (the JAX
# routing threshold); at 576x1024 that is the 9,216- and 2,304-token levels
DEPTH_KERNEL_MIN_SCORES = 1024 * 1024
DEPTH_ATTN_ENV = "TRAJCRAFTER_DEPTH_ATTN"
DEPTH_ATTN_IMPLS = ("flash_stock", "flash_max", "flash_pv8", "reference", "xla")


def depth_attention_impl(s: int, s_kv: int, on_card: bool, impl: str = "auto") -> str:
    """The ``multi_head_attention`` impl of one depth-UNet attention.

    ``impl`` is the module's ``attention_impl``: ``"auto"`` reads
    ``TRAJCRAFTER_DEPTH_ATTN`` (default ``flash_stock``, the K4 kernel;
    ``flash_max`` is the two-pass K4b kernel, ``flash_pv8`` the PV-int8 K6
    kernel, as the JAX UNet passes any value on); ``"reference"`` and
    ``"xla"`` (the JAX einsum's name) take the plain version.  That choice
    applies on the card at ``s * s_kv >= 2^20``; everything else is
    ``"xla"``, the plain matmul / softmax.  Any other name raises
    ``ValueError``.
    """
    if impl == "auto":
        impl = os.environ.get(DEPTH_ATTN_ENV, "flash_stock")
    if impl not in DEPTH_ATTN_IMPLS:
        raise ValueError(f"depth attention impl {impl!r} is not one of {DEPTH_ATTN_IMPLS} "
                         f"(set by attention_impl or ${DEPTH_ATTN_ENV})")
    return impl if on_card and s * s_kv >= DEPTH_KERNEL_MIN_SCORES else "xla"


# ----------------------------------------------------------------------------
# channel-last helpers
# ----------------------------------------------------------------------------


def conv_cl(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A Conv2d on (N, H, W, C) or a Conv3d on (N, T, H, W, C), channel-last
    in and out."""
    return conv(x.movedim(-1, 1)).movedim(1, -1)


def group_norm_cl(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm of channel-last ``x`` (N, ..., C) in fp32, statistics over
    every non-batch axis of each channel group (flax ``GroupNorm``); result
    in x's dtype.  The normalisation runs in place on one fp32 copy of x
    (the SVD decoder's full-resolution norms hold 2.25 GiB a copy)."""
    n, c = x.shape[0], x.shape[-1]
    y = x.to(torch.float32, copy=True).reshape(n, -1, norm.num_groups, c // norm.num_groups)
    var, mean = torch.var_mean(y, dim=(1, 3), unbiased=False, keepdim=True)
    y.sub_(mean).mul_(torch.rsqrt(var + norm.eps))
    y = y.reshape(x.shape).mul_(norm.weight.float()).add_(norm.bias.float())
    return y.to(x.dtype)


def norm_cl(norm: nn.GroupNorm, x: torch.Tensor, slab=None, temporal: bool = False):
    """``group_norm_cl``, over the whole tensor where ``x`` is a ``slab``
    (parallel/frames.py): a per-frame norm's statistics span the sp ranks'
    rows, a temporal one's (``temporal``) the plane's frames and rows."""
    if slab is None:
        return group_norm_cl(norm, x)
    axis = slab.part.both if temporal else slab.part.rows
    return group_norm_cl(norm, x) if axis.size == 1 else FR.group_norm(norm, x, axis)


def conv_rows_cl(conv: nn.Conv2d, x: torch.Tensor, slab=None) -> torch.Tensor:
    """``conv_cl`` of a 3x3 Conv2d (padding 1) on channel-last (N, H, W, C),
    on this rank's rows where ``x`` is a ``slab``: one halo row of each sp
    neighbour, zeros past the picture's edges; a stride-2 conv reads one row
    above and none below (its outputs on an even seam read no row past the
    slab)."""
    if slab is None or slab.part.rows.size == 1:
        return conv_cl(conv, x)
    x = FR.row_halo(x, slab, 1, 0 if conv.stride[0] == 2 else 1)
    y = F.conv2d(x.movedim(-1, 1), conv.weight, conv.bias, conv.stride, (0, conv.padding[1]))
    return y.movedim(1, -1)


def conv_frames_cl(conv: nn.Conv3d, x: torch.Tensor, slab=None) -> torch.Tensor:
    """``conv_cl`` of a (3, 1, 1) Conv3d (time padding 1) on channel-last
    (B, F, H, W, C), on this rank's frames where ``x`` is a ``slab``: one
    halo frame of each dp neighbour, zeros past the first and last frame."""
    if slab is None or slab.part.frames.size == 1:
        return conv_cl(conv, x)
    x = FR.frame_halo(x, slab, 1, 1)
    return F.conv3d(x.movedim(-1, 1), conv.weight, conv.bias).movedim(1, -1)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, 2H, 2W, C), each pixel repeated."""
    return F.interpolate(x.movedim(-1, 1), scale_factor=2, mode="nearest").movedim(1, -1)


# ----------------------------------------------------------------------------
# blocks shared with the SVD VAE
# ----------------------------------------------------------------------------


class AlphaBlender(nn.Module):
    """Learned scalar blend of a spatial and a temporal branch.  ``switch``
    puts the sigmoid weight on the temporal branch (the SVD VAE's decoder
    blocks); the UNet keeps it on the spatial one."""

    def __init__(self, switch: bool = False, init: float = 0.5):
        super().__init__()
        self.switch = switch
        self.mix_factor = nn.Parameter(torch.full((1,), init))

    def forward(self, spatial, temporal):
        alpha = torch.sigmoid(self.mix_factor.float()).to(spatial.dtype)
        if self.switch:
            alpha = 1.0 - alpha
        return alpha * spatial + (1.0 - alpha) * temporal


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, eps: float = 1e-5,
                 groups: int = 32, temb_channels: Optional[int] = None):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (nn.Linear(temb_channels, out_channels)
                              if temb_channels is not None else None)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, temb, slab=None):
        # x: (N, H, W, C); temb: (N, T) or None; slab: x's layout under a mesh
        h = conv_rows_cl(self.conv1, F.silu(norm_cl(self.norm1, x, slab)), slab)
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = conv_rows_cl(self.conv2, F.silu(norm_cl(self.norm2, h, slab)), slab)
        if self.conv_shortcut is not None:
            x = conv_cl(self.conv_shortcut, x)
        return x + h


class TemporalResnetBlock(nn.Module):
    """Resnet over the time axis of (B, F, H, W, C): conv3d kernels (3, 1, 1)."""

    def __init__(self, in_channels: int, out_channels: int, eps: float = 1e-6,
                 groups: int = 32, temb_channels: Optional[int] = None):
        super().__init__()
        conv = lambda i, o: nn.Conv3d(i, o, (3, 1, 1), padding=(1, 0, 0))
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = conv(in_channels, out_channels)
        self.time_emb_proj = (nn.Linear(temb_channels, out_channels)
                              if temb_channels is not None else None)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = conv(out_channels, out_channels)
        self.conv_shortcut = (nn.Conv3d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, temb, slab=None):
        # x: (B, F, H, W, C); temb: (B, F, T) or None; slab: x's layout under a mesh
        h = conv_frames_cl(self.conv1, F.silu(norm_cl(self.norm1, x, slab, True)), slab)
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None, :]
        h = conv_frames_cl(self.conv2, F.silu(norm_cl(self.norm2, h, slab, True)), slab)
        if self.conv_shortcut is not None:
            x = conv_cl(self.conv_shortcut, x)
        return x + h


class SpatioTemporalResBlock(nn.Module):
    """Spatial resnet per frame, temporal resnet over the frames, blended.

    The UNet's blocks share one eps and keep the blend on the spatial
    branch; the SVD VAE decoder's use spatial eps 1e-6, temporal 1e-5 and
    ``switch`` (mix factor initialised to 0)."""

    def __init__(self, in_channels: int, out_channels: int, eps: float = 1e-5,
                 groups: int = 32, temb_channels: Optional[int] = None,
                 temporal_eps: Optional[float] = None, switch: bool = False,
                 mix_init: float = 0.5):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(in_channels, out_channels, eps, groups,
                                               temb_channels)
        self.temporal_res_block = TemporalResnetBlock(
            out_channels, out_channels, eps if temporal_eps is None else temporal_eps,
            groups, temb_channels)
        self.time_mixer = AlphaBlender(switch, mix_init)

    def forward(self, x, temb, num_frames: int, slab=None):
        # x: (B*F, H, W, C); temb: (B*F, T) or None; under a mesh F and H are
        # the rank's, ``slab`` their layout
        h = self.spatial_res_block(x, temb, slab)
        bf, hh, ww, c = h.shape
        h5 = h.reshape(bf // num_frames, num_frames, hh, ww, c)
        t5 = self.temporal_res_block(
            h5, None if temb is None else temb.reshape(bf // num_frames, num_frames, -1), slab)
        return self.time_mixer(h5, t5).reshape(bf, hh, ww, c)


# ----------------------------------------------------------------------------
# transformers
# ----------------------------------------------------------------------------


class CrossAttention(nn.Module):
    """Self-attention (``context=None``) or cross-attention to ``context``;
    no biases in q/k/v, no QK-norm, so the scores are unbounded."""

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None, attention_impl: str = "auto"):
        super().__init__()
        inner = heads * head_dim
        context_dim = query_dim if context_dim is None else context_dim
        self.heads, self.head_dim, self.attention_impl = heads, head_dim, attention_impl
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x, context=None, gather=None):
        """``gather``: under a mesh, joins this rank's self-attention keys
        and values (B, S_local, 2 * inner) into the whole sequence's
        (parallel/frames.py ``gather_kv``); the queries stay the rank's.
        The route is chosen on the whole sequence's ``s * s_kv``."""
        ctx = x if context is None else context
        heads = (self.heads, self.head_dim)
        # (B, S, H, D) views of the projections: the kernel reads them in place
        q = self.to_q(x).unflatten(-1, heads)
        if gather is None:
            k = self.to_k(ctx).unflatten(-1, heads)
            v = self.to_v(ctx).unflatten(-1, heads)
            s = q.shape[1]
        else:
            kv = gather(torch.cat([self.to_k(ctx), self.to_v(ctx)], dim=-1))
            k, v = (t.unflatten(-1, heads) for t in kv.chunk(2, dim=-1))
            s = k.shape[1]
        impl = depth_attention_impl(s, k.shape[1], q.is_cuda, self.attention_impl)
        return self.to_out[0](multi_head_attention(q, k, v, self.head_dim ** -0.5, impl))


class _GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, 2 * dim_out)

    def forward(self, x):
        a, g = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(g)


class GEGLUFeedForward(nn.Module):
    """Named as diffusers' ``net.0.proj`` / ``net.2`` (``net.1`` is dropout)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([_GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class BasicTransformerBlock(nn.Module):
    """Spatial block over a frame's tokens: self-attn, cross-attn to CLIP, GEGLU FF."""

    def __init__(self, dim: int, heads: int, context_dim: int, attention_impl: str = "auto"):
        super().__init__()
        hd = dim // heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, heads, hd, attention_impl=attention_impl)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, heads, hd, context_dim, attention_impl)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x, context, gather=None):
        x = x + self.attn1(layer_norm_f32(self.norm1, x), gather=gather)
        x = x + self.attn2(layer_norm_f32(self.norm2, x), context)
        return x + self.ff(layer_norm_f32(self.norm3, x))


class TemporalBasicTransformerBlock(nn.Module):
    """Temporal block over one location's frames: (B*HW, F, C)."""

    def __init__(self, dim: int, heads: int, context_dim: int, attention_impl: str = "auto"):
        super().__init__()
        hd = dim // heads
        self.norm_in = nn.LayerNorm(dim, eps=1e-5)
        self.ff_in = GEGLUFeedForward(dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, heads, hd, attention_impl=attention_impl)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, heads, hd, context_dim, attention_impl)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x, context, gather=None):
        x = x + self.ff_in(layer_norm_f32(self.norm_in, x))
        x = x + self.attn1(layer_norm_f32(self.norm1, x), gather=gather)
        x = x + self.attn2(layer_norm_f32(self.norm2, x), context)
        return x + self.ff(layer_norm_f32(self.norm3, x))


class _TimePosEmbed(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.linear_1 = nn.Linear(channels, 4 * channels)
        self.linear_2 = nn.Linear(4 * channels, channels)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class TransformerSpatioTemporal(nn.Module):
    def __init__(self, channels: int, heads: int, context_dim: int, groups: int = 32,
                 attention_impl: str = "auto"):
        super().__init__()
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, heads, context_dim, attention_impl)])
        self.temporal_transformer_blocks = nn.ModuleList([
            TemporalBasicTransformerBlock(channels, heads, context_dim, attention_impl)])
        self.time_pos_embed = _TimePosEmbed(channels)
        self.time_mixer = AlphaBlender()
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x, context, num_frames: int, slab=None):
        # x: (B*F, H, W, C); context: (B*F, 1, Dc), one CLIP embedding per
        # frame.  Under a mesh x is the rank's frames and rows (``slab``) and
        # context every frame's, of which the rank takes its own
        bf, hh, ww, c = x.shape
        b, hw = bf // num_frames, hh * ww
        h = self.proj_in(norm_cl(self.norm, x, slab).reshape(bf, hw, c))
        frames = context.reshape(b, -1, *context.shape[1:])
        spatial_kv = temporal_kv = None
        if slab is None:
            frame_ids = torch.arange(num_frames, dtype=torch.float32, device=x.device)
        else:
            frame_ids = slab.frame_ids(x.device)
            context = frames[:, slab.frame_start:slab.frame_start + num_frames].flatten(0, 1)
            rows, frames_axis = slab.part.rows, slab.part.frames
            if rows.size > 1:
                sizes = [r * ww for r in slab.rows_at(hh)]
                spatial_kv = lambda kv: FR.gather_kv(kv, rows, sizes)
            if frames_axis.size > 1:
                temporal_kv = lambda kv: FR.gather_kv(kv, frames_axis, list(slab.frames))
        # temporal context: each batch's (global) first-frame embedding, at
        # every location
        time_context = frames[:, 0].repeat_interleave(hw, dim=0)  # (B*HW, 1, Dc)
        # per-frame positional embedding (the sinusoid of the frame index)
        femb = self.time_pos_embed(
            timestep_embedding(frame_ids.repeat(b), c).to(h.dtype))[:, None]
        for block, temporal in zip(self.transformer_blocks, self.temporal_transformer_blocks):
            h = block(h, context, spatial_kv)
            # (B*F, HW, C) -> (B*HW, F, C) and back
            ht = (h + femb).reshape(b, num_frames, hw, c).transpose(1, 2)
            ht = temporal(ht.reshape(b * hw, num_frames, c), time_context, temporal_kv)
            ht = ht.reshape(b, hw, num_frames, c).transpose(1, 2).reshape(bf, hw, c)
            h = self.time_mixer(h, ht)
        return x + self.proj_out(h).reshape(bf, hh, ww, c)


# ----------------------------------------------------------------------------
# the UNet
# ----------------------------------------------------------------------------


class Level(nn.Module):
    """One resolution level (of the UNet or the SVD VAE): ``resnets``,
    ``attentions`` (empty where the level has none) and a ``downsamplers`` /
    ``upsamplers`` list holding one ``Resampler``, as the checkpoints name
    them."""

    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()


class Resampler(nn.Module):
    """The 3x3 conv of a down- (stride 2) or upsampler, as ``.conv``."""

    def __init__(self, channels: int, stride: int, padding: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=stride, padding=padding)


class _Embedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class UNetSpatioTemporalConditionModel(nn.Module):
    """SVD UNet: (B, F, h, w, 8) + t + per-frame CLIP context -> (B, F, h, w, 4)."""

    plane = None  # parallel/frames.py FrameRows, set on a sharded twin

    def __init__(
        self,
        in_channels: int = 8,
        out_channels: int = 4,
        block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
        layers_per_block: int = 2,
        num_attention_heads: Sequence[int] = (5, 10, 20, 20),
        cross_attention_dim: int = 1024,
        addition_time_embed_dim: int = 256,
        projection_class_embeddings_input_dim: int = 768,
        norm_num_groups: int = 32,
        attention_impl: str = "auto",
    ):
        super().__init__()
        ch0 = block_out_channels[0]
        tdim = 4 * ch0
        groups, n = norm_num_groups, len(block_out_channels)
        self.addition_time_embed_dim = addition_time_embed_dim
        st_res = lambda i, o, eps: SpatioTemporalResBlock(i, o, eps, groups, tdim)
        st_attn = lambda ch, heads: TransformerSpatioTemporal(
            ch, heads, cross_attention_dim, groups, attention_impl)

        self.conv_in = nn.Conv2d(in_channels, ch0, 3, padding=1)
        self.time_embedding = _Embedding(ch0, tdim)
        self.add_embedding = _Embedding(projection_class_embeddings_input_dim, tdim)

        # down: every level's outputs are skips for the up path
        skips, ch_in = [ch0], ch0
        self.down_blocks = nn.ModuleList()
        for i, ch in enumerate(block_out_channels):
            level, has_attn = Level(), i < n - 1
            # diffusers quirk: the cross-attention levels build their resnets
            # with eps 1e-6, the plain level and the mid block with 1e-5
            eps = 1e-6 if has_attn else 1e-5
            for _ in range(layers_per_block):
                level.resnets.append(st_res(ch_in, ch, eps))
                if has_attn:
                    level.attentions.append(st_attn(ch, num_attention_heads[i]))
                skips.append(ch)
                ch_in = ch
            if i < n - 1:
                level.downsamplers = nn.ModuleList([Resampler(ch, 2)])
                skips.append(ch)
            self.down_blocks.append(level)

        self.mid_block = Level()
        self.mid_block.resnets.extend([st_res(ch_in, ch_in, 1e-5), st_res(ch_in, ch_in, 1e-5)])
        self.mid_block.attentions.append(st_attn(ch_in, num_attention_heads[-1]))

        self.up_blocks = nn.ModuleList()
        for i, ch in enumerate(reversed(block_out_channels)):
            level, has_attn = Level(), i > 0  # the deepest level has none
            eps = 1e-6 if has_attn else 1e-5  # the same quirk
            for _ in range(layers_per_block + 1):
                level.resnets.append(st_res(ch_in + skips.pop(), ch, eps))
                if has_attn:
                    level.attentions.append(st_attn(ch, num_attention_heads[n - 1 - i]))
                ch_in = ch
            if i < n - 1:
                level.upsamplers = nn.ModuleList([Resampler(ch, 1)])
            self.up_blocks.append(level)

        self.conv_norm_out = nn.GroupNorm(groups, ch0, eps=1e-5)
        self.conv_out = nn.Conv2d(ch0, out_channels, 3, padding=1)

    def forward(
        self,
        sample: torch.Tensor,  # (B, F, h, w, 8)
        timestep: torch.Tensor,  # (B,), continuous 0.25 log sigma
        encoder_hidden_states: torch.Tensor,  # (B, F, 1, 1024) per-frame CLIP
        added_time_ids: torch.Tensor,  # (B, 3)
        height: Optional[int] = None,
    ) -> torch.Tensor:
        """On a sharded twin (``plane`` set) ``sample`` is this rank's slab
        of the whole (B, F, ``height``, w, 8), ``encoder_hidden_states``
        every frame's, and the output is the rank's slab."""
        b, f, hh, ww, _ = sample.shape
        slab = None
        if self.plane is not None:
            if height is None:
                raise ValueError("a sharded UNet takes the whole latent height beside its slab")
            slab = self.plane.layout(encoder_hidden_states.shape[1], height)
            if (f, hh) != (slab.num_frames, slab.num_rows):
                raise ValueError(f"a slab of {f} frames x {hh} rows is not this rank's "
                                 f"{slab.num_frames} x {slab.num_rows} of {slab.frames} frames "
                                 f"x {slab.rows} rows")
        dtype = self.conv_in.weight.dtype
        temb = self.time_embedding(
            timestep_embedding(timestep, self.conv_in.out_channels).to(dtype))
        add_freq = timestep_embedding(added_time_ids.reshape(-1), self.addition_time_embed_dim)
        temb = temb + self.add_embedding(add_freq.reshape(b, -1).to(dtype))
        temb = temb.repeat_interleave(f, dim=0)  # (B*F, tdim)
        ctx = encoder_hidden_states.flatten(0, 1).to(dtype)

        x = conv_rows_cl(self.conv_in, sample.reshape(b * f, hh, ww, -1).to(dtype), slab)
        skips = [x]
        for level in self.down_blocks:
            for j, res in enumerate(level.resnets):
                x = res(x, temb, f, slab)
                if len(level.attentions):
                    x = level.attentions[j](x, ctx, f, slab)
                skips.append(x)
            if hasattr(level, "downsamplers"):
                x = conv_rows_cl(level.downsamplers[0].conv, x, slab)
                skips.append(x)

        x = self.mid_block.resnets[0](x, temb, f, slab)
        x = self.mid_block.attentions[0](x, ctx, f, slab)
        x = self.mid_block.resnets[1](x, temb, f, slab)

        for level in self.up_blocks:
            for j, res in enumerate(level.resnets):
                x = res(torch.cat([x, skips.pop()], dim=-1), temb, f, slab)
                if len(level.attentions):
                    x = level.attentions[j](x, ctx, f, slab)
            if hasattr(level, "upsamplers"):
                x = conv_rows_cl(level.upsamplers[0].conv, upsample_nearest_2x(x), slab)

        x = conv_rows_cl(self.conv_out, F.silu(norm_cl(self.conv_norm_out, x, slab)), slab)
        return x.reshape(b, f, hh, ww, -1)
