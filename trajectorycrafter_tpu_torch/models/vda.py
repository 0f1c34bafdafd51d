"""Video-Depth-Anything (VDA), the consistent-depth estimator, in PyTorch.

Counterpart of trajectorycrafter_tpu/models/vda.py: a DINOv2 ViT backbone
(patch 14, CLS token, LayerScale, the position table resized bicubically as
``jax.image.resize`` resizes it), the DPT neck and relative-depth head
(reassemble -> fusion -> three convolutions), and four AnimateDiff motion
modules at the official places (two on the reassembled layer_3 / layer_4
maps, two after the two deepest fusion stages).  ``num_temporal_blocks``
gates how many of the four run.

The modules carry the official checkpoint's names
(``video_depth_anything_*.pth``; ``utils/checkpoints.py
expected_vda_official_keys``): ``pretrained.blocks.{i}.attn.qkv`` fused,
``ls1.gamma``, ``head.projects.{i}``, ``head.scratch.refinenet{n}``,
``head.motion_modules.{i}.temporal_transformer`` and so on, so
``load_state_dict(strict=True)`` takes the file's tensors once the loader
has dropped ``pretrained.mask_token`` (unused) and each motion module's
``pos_encoder.pe`` buffer (the fixed table ``sinusoidal_frame_encoding``
recomputes for any frame count).

Layout: frames (B, T, 3, H, W), H and W multiples of 14; the backbone and
the head run the B*T frames as one batch, the motion modules as (B*h*w, T,
C) token streams.  fp32 throughout, as the JAX entry point builds it.
Attention is stock PyTorch with fp32 scores and softmax (the JAX VDA uses
no flash kernel), taken in chunks of the (batch x head) axis of about
``ATTENTION_CHUNK_BYTES`` of scores each: the same function in less memory
(a 32-frame window at 588x1036 has 3,109 tokens a frame).  With
``model.checkpoint`` set and gradients on, each backbone layer, motion
module, fusion stage and the output head is recomputed in the backward pass
(``torch.utils.checkpoint``): the same operations, so no value changes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint as _recompute

from trajectorycrafter_tpu_torch.depth_alignment import compute_scale_and_shift
from trajectorycrafter_tpu_torch.ops.resize import resize_bicubic_jax
from trajectorycrafter_tpu_torch.pipelines.depth import window_starts

# ImageNet statistics of the VDA / Depth Anything preprocessor
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# scores per attention chunk, bytes (fp32)
ATTENTION_CHUNK_BYTES = 2 * 2**30


class VDAConfig:
    """Architecture hyper-parameters; the presets are the official
    ``model_configs``: vits (features 64, out (48, 96, 192, 384)), vitb (128,
    (96, 192, 384, 768)), vitl (256, (256, 512, 1024, 1024))."""

    def __init__(
        self,
        hidden_size: int = 1024,
        num_hidden_layers: int = 24,
        num_attention_heads: int = 16,
        mlp_ratio: float = 4.0,
        patch_size: int = 14,
        image_size: int = 518,
        layerscale_value: float = 1.0,
        layer_norm_eps: float = 1e-6,
        out_indices: Sequence[int] = (5, 12, 18, 24),
        features: int = 256,
        out_channels: Sequence[int] = (256, 512, 1024, 1024),
        reassemble_factors: Sequence[float] = (4.0, 2.0, 1.0, 0.5),
        head_hidden_size: int = 32,
        num_temporal_blocks: int = 4,
        temporal_heads: int = 8,
    ):
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.mlp_ratio = mlp_ratio
        self.patch_size = patch_size
        self.image_size = image_size
        self.layerscale_value = layerscale_value
        self.layer_norm_eps = layer_norm_eps
        # indices into [embeddings, layer1, ..., layerN]: i = after layer i
        self.out_indices = tuple(out_indices)
        self.features = features
        self.out_channels = tuple(out_channels)
        self.reassemble_factors = tuple(reassemble_factors)
        self.head_hidden_size = head_hidden_size
        self.num_temporal_blocks = num_temporal_blocks
        self.temporal_heads = temporal_heads


def vda_vits_config(**kw) -> VDAConfig:
    kw.setdefault("hidden_size", 384)
    kw.setdefault("num_hidden_layers", 12)
    kw.setdefault("num_attention_heads", 6)
    kw.setdefault("out_indices", (3, 6, 9, 12))
    kw.setdefault("features", 64)
    kw.setdefault("out_channels", (48, 96, 192, 384))
    return VDAConfig(**kw)


def vda_vitb_config(**kw) -> VDAConfig:
    kw.setdefault("hidden_size", 768)
    kw.setdefault("num_hidden_layers", 12)
    kw.setdefault("num_attention_heads", 12)
    kw.setdefault("out_indices", (3, 6, 9, 12))
    kw.setdefault("features", 128)
    kw.setdefault("out_channels", (96, 192, 384, 768))
    return VDAConfig(**kw)


def vda_vitl_config(**kw) -> VDAConfig:
    return VDAConfig(**kw)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (N, S, D) streams, fp32 scores, in
    chunks of N of about ``ATTENTION_CHUNK_BYTES`` of scores."""
    n, s, d = q.shape
    step = max(1, ATTENTION_CHUNK_BYTES // (s * k.shape[1] * 4))
    out = []
    for i in range(0, n, step):
        scores = torch.matmul(q[i:i + step], k[i:i + step].transpose(-1, -2)) * d**-0.5
        out.append(torch.matmul(scores.softmax(-1), v[i:i + step]))
    return out[0] if len(out) == 1 else torch.cat(out)


def _maybe_recompute(model_checkpoint: bool, fn, *args):
    if model_checkpoint and torch.is_grad_enabled():
        return _recompute(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# DINOv2 backbone (``pretrained``)
# ---------------------------------------------------------------------------


class Dinov2MLP(nn.Module):
    def __init__(self, cfg: VDAConfig):
        super().__init__()
        hidden = int(cfg.hidden_size * cfg.mlp_ratio)
        self.fc1 = nn.Linear(cfg.hidden_size, hidden)
        self.fc2 = nn.Linear(hidden, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Dinov2Attention(nn.Module):
    """Fused q/k/v (``attn.qkv``) and the output projection (``attn.proj``)."""

    def __init__(self, cfg: VDAConfig):
        super().__init__()
        self.heads = cfg.num_attention_heads
        self.qkv = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size)
        self.proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x):
        b, s, c = x.shape
        h = self.heads
        qkv = self.qkv(x).reshape(b, s, 3, h, c // h).permute(2, 0, 3, 1, 4)
        q, k, v = (t.reshape(b * h, s, c // h) for t in qkv)
        out = attention(q, k, v).reshape(b, h, s, c // h).transpose(1, 2)
        return self.proj(out.reshape(b, s, c))


class LayerScale(nn.Module):
    def __init__(self, dim: int, value: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(value)))

    def forward(self, x):
        return x * self.gamma


class Dinov2Layer(nn.Module):
    """Pre-norm ViT block with LayerScale (torchhub DINOv2 ``Block``)."""

    def __init__(self, cfg: VDAConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.attn = Dinov2Attention(cfg)
        self.ls1 = LayerScale(cfg.hidden_size, cfg.layerscale_value)
        self.norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = Dinov2MLP(cfg)
        self.ls2 = LayerScale(cfg.hidden_size, cfg.layerscale_value)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: VDAConfig):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Conv2d(3, cfg.hidden_size, kernel_size=p, stride=p)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


def interpolate_pos_encoding(pos: torch.Tensor, grid: int, ph: int, pw: int) -> torch.Tensor:
    """The (1, grid*grid+1, C) table at a (ph, pw) patch grid: the patch part
    resized by ``jax.image.resize``'s bicubic (``resize_bicubic_jax``)."""
    if ph == grid and pw == grid:
        return pos
    c = pos.shape[-1]
    patch = pos[0, 1:].reshape(grid, grid, c).permute(2, 0, 1)
    patch = resize_bicubic_jax(patch, (ph, pw)).permute(1, 2, 0).reshape(1, ph * pw, c)
    return torch.cat([pos[:, :1], patch], dim=1)


class Dinov2Backbone(nn.Module):
    """(N, 3, H, W) -> the (N, 1+hw, C) hidden states after each of
    ``out_indices``, each through the final LayerNorm (``norm``)."""

    def __init__(self, cfg: VDAConfig):
        super().__init__()
        self.cfg = cfg
        grid = cfg.image_size // cfg.patch_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, cfg.hidden_size))
        self.patch_embed = PatchEmbed(cfg)
        self.blocks = nn.ModuleList(Dinov2Layer(cfg) for _ in range(cfg.num_hidden_layers))
        self.norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.checkpoint = False

    def forward(self, pixels: torch.Tensor):
        c = self.cfg
        n, _, h, w = pixels.shape
        ph, pw = h // c.patch_size, w // c.patch_size
        x = torch.cat([self.cls_token.expand(n, 1, -1), self.patch_embed(pixels)], dim=1)
        x = x + interpolate_pos_encoding(self.pos_embed, c.image_size // c.patch_size, ph, pw)
        want = set(c.out_indices)
        stash = {0: x} if 0 in want else {}
        for i, block in enumerate(self.blocks):
            x = _maybe_recompute(self.checkpoint, block, x)
            if i + 1 in want:
                stash[i + 1] = x
        return [self.norm(stash[i]) for i in c.out_indices], (ph, pw)


# ---------------------------------------------------------------------------
# motion modules (``head.motion_modules.{i}``)
# ---------------------------------------------------------------------------


def sinusoidal_frame_encoding(t: int, c: int, device=None) -> torch.Tensor:
    """(t, c) interleaved table, pe[:, 0::2] = sin, pe[:, 1::2] = cos (the
    AnimateDiff ``PositionalEncoding`` buffer, here for any t)."""
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    # the exponent's factor in fp32, as the JAX table takes it
    factor = -torch.log(torch.tensor(10000.0, device=device)) / c
    div = torch.exp(torch.arange(0, c, 2, dtype=torch.float32, device=device) * factor)
    pe = torch.zeros((t, c), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div[: (c - 1) // 2 + 1])
    return pe


class TemporalAttention(nn.Module):
    """Self-attention over the frames of one site, the frame table added to
    the tokens before q/k/v (AnimateDiff ``VersatileAttention``)."""

    def __init__(self, channels: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(channels, channels, bias=False)
        self.to_k = nn.Linear(channels, channels, bias=False)
        self.to_v = nn.Linear(channels, channels, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels), nn.Identity()])

    def forward(self, tok):  # (N, T, C)
        n, t, c = tok.shape
        h = self.heads
        tok = tok + sinusoidal_frame_encoding(t, c, tok.device)[None]
        split = lambda x: x.reshape(n, t, h, c // h).transpose(1, 2).reshape(n * h, t, c // h)
        out = attention(split(self.to_q(tok)), split(self.to_k(tok)), split(self.to_v(tok)))
        return self.to_out[0](out.reshape(n, h, t, c // h).transpose(1, 2).reshape(n, t, c))


class GEGLU(nn.Module):
    def __init__(self, channels: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(channels, 2 * inner)

    def forward(self, x):
        val, gate = self.proj(x).chunk(2, dim=-1)
        return val * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(channels, 4 * channels), nn.Identity(),
                                  nn.Linear(4 * channels, channels)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class TemporalTransformerBlock(nn.Module):
    """Two pre-norm temporal self-attentions, then a pre-norm GEGLU
    feed-forward."""

    def __init__(self, channels: int, heads: int = 8, num_attention_blocks: int = 2):
        super().__init__()
        self.attention_blocks = nn.ModuleList(
            TemporalAttention(channels, heads) for _ in range(num_attention_blocks))
        self.norms = nn.ModuleList(nn.LayerNorm(channels) for _ in range(num_attention_blocks))
        self.ff = FeedForward(channels)
        self.ff_norm = nn.LayerNorm(channels)

    def forward(self, tok):
        for norm, attn in zip(self.norms, self.attention_blocks):
            tok = tok + attn(norm(tok))
        return tok + self.ff(self.ff_norm(tok))


class FastVarianceGroupNorm(nn.GroupNorm):
    """GroupNorm with flax's arithmetic: the variance E[x^2] - E[x]^2 clamped
    at 0 (``use_fast_variance``), then (x - mean) * (rsqrt(var + eps) *
    weight) + bias.  torch's two-pass variance differs where a group's mean
    dwarfs its spread (one channel a group at small widths): 5e-5 of the
    output over 32 frames in tests/test_torch_vda.py."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        g = x.reshape(n, self.num_groups, -1)
        mean = g.mean(-1, keepdim=True)
        var = ((g * g).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        shape = (1, c) + (1,) * (x.dim() - 2)
        y = (g - mean) * torch.rsqrt(var + self.eps)
        return y.reshape(x.shape) * self.weight.reshape(shape) + self.bias.reshape(shape)


class TemporalTransformer3DModel(nn.Module):
    def __init__(self, channels: int, heads: int = 8, num_attention_blocks: int = 2):
        super().__init__()
        self.norm = FastVarianceGroupNorm(min(32, channels), channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            [TemporalTransformerBlock(channels, heads, num_attention_blocks)])
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor, t: int) -> torch.Tensor:  # (B*T, C, H, W)
        bt, c, h, w = x.shape
        b = bt // t
        tok = self.norm(x).reshape(b, t, c, h, w).permute(0, 3, 4, 1, 2).reshape(b * h * w, t, c)
        tok = self.proj_out(self.transformer_blocks[0](self.proj_in(tok)))
        return tok.reshape(b, h, w, t, c).permute(0, 3, 4, 1, 2).reshape(bt, c, h, w) + x


class TemporalModule(nn.Module):
    """VDA's motion module: GroupNorm(min(32, C)) -> proj_in -> one
    temporal transformer block -> proj_out, plus the input (proj_out starts
    at zero in the official initialisation)."""

    def __init__(self, channels: int, heads: int = 8, num_attention_blocks: int = 2):
        super().__init__()
        self.temporal_transformer = TemporalTransformer3DModel(channels, heads,
                                                               num_attention_blocks)

    def forward(self, x: torch.Tensor, t: int) -> torch.Tensor:
        return self.temporal_transformer(x, t)


# ---------------------------------------------------------------------------
# DPT neck and head (``head``)
# ---------------------------------------------------------------------------


def _interp_bilinear(x: torch.Tensor, hw, align_corners: bool) -> torch.Tensor:
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=align_corners)


class PreActResidual(nn.Module):
    """relu-conv3x3-relu-conv3x3 + input (``resConfUnit``)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionLayer(nn.Module):
    """Merge a skip map into the running state, upsample, project
    (``refinenet``): the skip map resized bilinearly (align_corners False)
    when its size differs, the state resized to ``size`` (2x without one)
    with align_corners True."""

    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = PreActResidual(features)
        self.resConfUnit2 = PreActResidual(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, residual: Optional[torch.Tensor] = None, size=None):
        if residual is not None:
            if x.shape[-2:] != residual.shape[-2:]:
                residual = _interp_bilinear(residual, x.shape[-2:], align_corners=False)
            x = x + self.resConfUnit1(residual)
        x = self.resConfUnit2(x)
        out_hw = size if size is not None else (x.shape[-2] * 2, x.shape[-1] * 2)
        return self.out_conv(_interp_bilinear(x, out_hw, align_corners=True))


class Scratch(nn.Module):
    def __init__(self, cfg: VDAConfig):
        super().__init__()
        f = cfg.features
        for i, ch in enumerate(cfg.out_channels):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(ch, f, 3, padding=1, bias=False))
        for n in range(1, len(cfg.out_channels) + 1):
            setattr(self, f"refinenet{n}", FeatureFusionLayer(f))
        self.output_conv1 = nn.Conv2d(f, f // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(f // 2, cfg.head_hidden_size, 3, padding=1), nn.ReLU(),
            nn.Conv2d(cfg.head_hidden_size, 1, 1), nn.ReLU())


def _resize_layer(ch: int, factor: float) -> nn.Module:
    if factor > 1:
        k = int(factor)
        return nn.ConvTranspose2d(ch, ch, k, stride=k)
    if factor < 1:
        return nn.Conv2d(ch, ch, 3, stride=int(1.0 / factor), padding=1)
    return nn.Identity()


class DPTTemporalHead(nn.Module):
    """Reassemble, fusion and depth head with the official motion-module
    places: modules 0 / 1 on the reassembled layer_3 / layer_4 maps (before
    the ``layerX_rn`` convolutions), 2 / 3 after the two deepest fusion
    stages."""

    def __init__(self, cfg: VDAConfig):
        super().__init__()
        self.cfg = cfg
        self.projects = nn.ModuleList(nn.Conv2d(cfg.hidden_size, ch, 1)
                                      for ch in cfg.out_channels)
        self.resize_layers = nn.ModuleList(_resize_layer(ch, f) for ch, f in
                                           zip(cfg.out_channels, cfg.reassemble_factors))
        self.scratch = Scratch(cfg)
        temporal = [cfg.out_channels[2], cfg.out_channels[3], cfg.features, cfg.features]
        self.motion_modules = nn.ModuleList(
            TemporalModule(temporal[i], cfg.temporal_heads)
            for i in range(cfg.num_temporal_blocks))
        self.checkpoint = False

    def _run(self, fn, *args):
        return _maybe_recompute(self.checkpoint, fn, *args)

    def _output(self, fused: torch.Tensor, hw) -> torch.Tensor:
        s = self.scratch
        x = _interp_bilinear(s.output_conv1(fused), hw, align_corners=True)
        return s.output_conv2(x)[:, 0]

    def forward(self, feats: List[torch.Tensor], t: int, ph: int, pw: int) -> torch.Tensor:
        c = self.cfg
        temporal = lambda i, x: self._run(self.motion_modules[i], x, t)
        pre = []
        for f, project, resize in zip(feats, self.projects, self.resize_layers):
            m = f[:, 1:].transpose(1, 2).reshape(f.shape[0], -1, ph, pw)
            pre.append(resize(project(m)))
        if c.num_temporal_blocks > 0:
            pre[2] = temporal(0, pre[2])
        if c.num_temporal_blocks > 1:
            pre[3] = temporal(1, pre[3])
        maps = [getattr(self.scratch, f"layer{i + 1}_rn")(m) for i, m in enumerate(pre)]

        # fusion, deepest first: stage i is refinenet{n - i}
        rev = maps[::-1]
        n = len(rev)
        fused = None
        for i, m in enumerate(rev):
            size = tuple(rev[i + 1].shape[-2:]) if i + 1 < n else None
            layer = getattr(self.scratch, f"refinenet{n - i}")
            if fused is None:
                fused = self._run(lambda x, layer=layer, size=size: layer(x, None, size), m)
            else:
                fused = self._run(lambda x, r, layer=layer, size=size: layer(x, r, size),
                                  fused, m)
            if i == 0 and c.num_temporal_blocks > 2:
                fused = temporal(2, fused)
            if i == 1 and c.num_temporal_blocks > 3:
                fused = temporal(3, fused)
        return self._run(lambda x: self._output(x, (ph * c.patch_size, pw * c.patch_size)),
                         fused)


class VideoDepthAnything(nn.Module):
    """(B, T, 3, H, W) ImageNet-normalised frames -> (B, T, H, W) inverse
    (relative) depth; H and W multiples of ``cfg.patch_size``."""

    def __init__(self, cfg: VDAConfig):
        super().__init__()
        self.cfg = cfg
        self.pretrained = Dinov2Backbone(cfg)
        self.head = DPTTemporalHead(cfg)

    @property
    def checkpoint(self) -> bool:
        return self.pretrained.checkpoint

    @checkpoint.setter
    def checkpoint(self, on: bool) -> None:
        self.pretrained.checkpoint = self.head.checkpoint = on

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        b, t, _, h, w = frames.shape
        feats, (ph, pw) = self.pretrained(frames.reshape(b * t, 3, h, w))
        return self.head(feats, t, ph, pw).reshape(b, t, h, w)


@torch.no_grad()
def infer_video_depth(model: VideoDepthAnything, frames_im: torch.Tensor, window: int = 32,
                      overlap: int = 10) -> torch.Tensor:
    """Inverse depth (F, H, W) of a clip of any length, ``frames_im`` (F, 3,
    H, W) ImageNet-normalised: windows of ``window`` frames stepping
    ``window - overlap``, the last moved back to end at the last frame; each
    later window is fitted to the running result on the frames they share
    (closed-form scale and shift) and ramp-blended into it."""
    f = frames_im.shape[0]
    window = min(window, f)
    out = torch.zeros((f, *frames_im.shape[2:]), dtype=torch.float32, device=frames_im.device)
    prev_start = None
    for s in window_starts(f, window, overlap):
        d = model(frames_im[s:s + window][None])[0].float()
        ov = 0 if prev_start is None else min(max(prev_start + window - s, 0), window)
        if ov > 0:
            scale, shift = compute_scale_and_shift(
                d[:ov].reshape(1, -1), out[s:s + ov].reshape(1, -1),
                torch.ones((1, d[:ov].numel()), device=d.device))
            d = d * scale[0] + shift[0]
            w = torch.linspace(0.0, 1.0, ov, device=d.device)[:, None, None]
            d[:ov] = d[:ov] * w + out[s:s + ov] * (1.0 - w)
        out[s:s + window] = d
        prev_start = s
    return out


def normalize_imagenet(frames01: torch.Tensor) -> torch.Tensor:
    """[0, 1] RGB (..., 3, H, W) -> ImageNet-normalised."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=frames01.dtype, device=frames01.device)
    std = torch.tensor(IMAGENET_STD, dtype=frames01.dtype, device=frames01.device)
    return (frames01 - mean[:, None, None]) / std[:, None, None]


def denormalize_imagenet(frames_im: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`normalize_imagenet`."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=frames_im.dtype, device=frames_im.device)
    std = torch.tensor(IMAGENET_STD, dtype=frames_im.dtype, device=frames_im.device)
    return frames_im * std[:, None, None] + mean[:, None, None]


def vda_config(encoder: str) -> VDAConfig:
    """The preset of ``--vda_encoder`` (vits, vitb or vitl)."""
    presets = {"vits": vda_vits_config, "vitb": vda_vitb_config, "vitl": vda_vitl_config}
    if encoder not in presets:
        raise ValueError(f"unknown VDA encoder {encoder!r}; expected one of {sorted(presets)}")
    return presets[encoder]()
