"""CrossTransformer3D: the dual-stream CogVideoX DiT with reference-view
Perceiver cross-attention, in PyTorch.

Counterpart of trajectorycrafter_tpu/models/dit.py, in bf16 (the JAX
package's ``quant="none"`` branch):
  * 42 CogVideoX blocks (AdaLN-Zero, joint text+video self-attention with
    per-head QK layernorm and 3D RoPE on the video tokens, gated tanh-gelu
    FF), with a Perceiver cross-attention over reference-view tokens after
    every ``cross_attn_interval``-th block;
  * patch embedding of the 33-channel latent input and the text projection;
  * channel-last (B, F, H, W, C) latents at the public interface;
  * linear layers stay ``nn.Linear`` (plain matrix products); layer norms
    and softmax run in fp32; attention goes through ops/attention.py, which
    launches the hand-written flash kernel for CUDA tensors.

Module and parameter names are the reference checkpoint's
(``utils/convert.py expected_dit_keys``), so ``load_state_dict(strict=True)``
checks a converted tree.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from trajectorycrafter_tpu_torch.ops.attention import multi_head_attention
from trajectorycrafter_tpu_torch.ops.posemb import resized_pos_embedding, timestep_embedding
from trajectorycrafter_tpu_torch.ops.rope import apply_rotary_emb


def layer_norm_f32(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """Apply ``norm`` in fp32 whatever its parameter dtype; result in x's dtype."""
    weight = norm.weight.float() if norm.weight is not None else None
    bias = norm.bias.float() if norm.bias is not None else None
    return F.layer_norm(x.float(), norm.normalized_shape, weight, bias, norm.eps).to(x.dtype)


class _GELUProj(nn.Module):
    """diffusers GELU(approximate="tanh"): projection, then tanh-gelu."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out)

    def forward(self, x):
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    """Linear -> tanh-gelu -> Linear, named as diffusers' ``net.0.proj`` /
    ``net.2`` (``net.1`` is the reference's parameter-free dropout)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([_GELUProj(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class LayerNormZero(nn.Module):
    """CogVideoX AdaLN-Zero: temb -> 6 modulation vectors; one shared LN
    modulates both streams."""

    def __init__(self, conditioning_dim: int, dim: int):
        super().__init__()
        self.linear = nn.Linear(conditioning_dim, 6 * dim)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, hidden, encoder, temb):
        mod = self.linear(F.silu(temb))
        shift, scale, gate, enc_shift, enc_scale, enc_gate = mod.chunk(6, dim=-1)
        h = layer_norm_f32(self.norm, hidden)
        e = layer_norm_f32(self.norm, encoder)
        h = h * (1 + scale[:, None]) + shift[:, None]
        e = e * (1 + enc_scale[:, None]) + enc_shift[:, None]
        return h, e, gate[:, None], enc_gate[:, None]


class JointAttention(nn.Module):
    """Self-attention over [text ; video] tokens with QK layernorm and RoPE
    on the video part only."""

    def __init__(self, dim: int, heads: int, head_dim: int, attention_impl: str = "auto"):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim, self.attention_impl = heads, head_dim, attention_impl
        self.to_q = nn.Linear(dim, inner)
        self.to_k = nn.Linear(dim, inner)
        self.to_v = nn.Linear(dim, inner)
        self.norm_q = nn.LayerNorm(head_dim, eps=1e-6)
        self.norm_k = nn.LayerNorm(head_dim, eps=1e-6)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim)])

    def forward(self, hidden, encoder, rope: Optional[Tuple[torch.Tensor, torch.Tensor]]):
        text_len = encoder.shape[1]
        x = torch.cat([encoder, hidden], dim=1)
        heads = (self.heads, self.head_dim)
        q = layer_norm_f32(self.norm_q, self.to_q(x).unflatten(-1, heads))
        k = layer_norm_f32(self.norm_k, self.to_k(x).unflatten(-1, heads))
        v = self.to_v(x).unflatten(-1, heads)
        if rope is not None:
            # rotate the video tokens in (B, S, H, D): cos/sin (S_vid, 1, D)
            cos, sin = rope[0][:, None], rope[1][:, None]
            q = torch.cat([q[:, :text_len], apply_rotary_emb(q[:, text_len:], cos, sin)], dim=1)
            k = torch.cat([k[:, :text_len], apply_rotary_emb(k[:, text_len:], cos, sin)], dim=1)
        out = self.to_out[0](multi_head_attention(q, k, v, impl=self.attention_impl))
        return out[:, text_len:], out[:, :text_len]


class CogVideoXBlock(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, time_embed_dim: int,
                 attention_impl: str = "auto"):
        super().__init__()
        self.norm1 = LayerNormZero(time_embed_dim, dim)
        self.attn1 = JointAttention(dim, heads, head_dim, attention_impl)
        self.norm2 = LayerNormZero(time_embed_dim, dim)
        self.ff = FeedForward(dim)

    def forward(self, hidden, encoder, temb, rope):
        h, e, gate, enc_gate = self.norm1(hidden, encoder, temb)
        attn_h, attn_e = self.attn1(h, e, rope)
        hidden = hidden + gate * attn_h
        encoder = encoder + enc_gate * attn_e

        h, e, gate_ff, enc_gate_ff = self.norm2(hidden, encoder, temb)
        ff_out = self.ff(torch.cat([e, h], dim=1))
        text_len = encoder.shape[1]
        hidden = hidden + gate_ff * ff_out[:, text_len:]
        encoder = encoder + enc_gate_ff * ff_out[:, :text_len]
        return hidden, encoder


class PerceiverCrossAttention(nn.Module):
    """Video tokens query reference-view tokens; fp32 softmax at scale
    head_dim^-1/2.  No QK-norm, so the scores are unbounded."""

    def __init__(self, dim: int = 3072, head_dim: int = 128, heads: int = 16,
                 attention_impl: str = "auto"):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim, self.attention_impl = heads, head_dim, attention_impl
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, 2 * inner, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x, latents):
        # x: (B, S_ref, dim) reference tokens; latents: (B, S_vid, dim)
        x = layer_norm_f32(self.norm1, x)
        lat = layer_norm_f32(self.norm2, latents)
        heads = (self.heads, self.head_dim)
        q = self.to_q(lat).unflatten(-1, heads)
        # k and v stay strided views of the kv projection: the kernel reads
        # them in place
        k, v = (t.unflatten(-1, heads) for t in self.to_kv(x).chunk(2, dim=-1))
        out = multi_head_attention(q, k, v, scale=self.head_dim ** -0.5,
                                   impl=self.attention_impl)
        return self.to_out(out)


class _PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int, text_dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, dim, patch, stride=patch)
        self.text_proj = nn.Linear(text_dim, dim)


class _RefPatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, dim, patch, stride=patch)


class _TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class _AdaNormOut(nn.Module):
    def __init__(self, time_embed_dim: int, dim: int):
        super().__init__()
        self.linear = nn.Linear(time_embed_dim, 2 * dim)
        self.norm = nn.LayerNorm(dim, eps=1e-5)


def _patchify(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """(B, F, H, W, C) -> (B, F * H/p * W/p, dim) tokens."""
    b, f, h, w, c = x.shape
    y = conv(x.reshape(b * f, h, w, c).permute(0, 3, 1, 2))  # (B*F, dim, H/p, W/p)
    return y.flatten(2).transpose(1, 2).reshape(b, -1, y.shape[1])


class CrossTransformer3DModel(nn.Module):
    """Deployed TrajectoryCrafter scale by default: 42 blocks, dim 3072."""

    def __init__(
        self,
        num_attention_heads: int = 48,
        attention_head_dim: int = 64,
        in_channels: int = 33,
        out_channels: int = 16,
        time_embed_dim: int = 512,
        text_embed_dim: int = 4096,
        num_layers: int = 42,
        sample_width: int = 90,
        sample_height: int = 60,
        sample_frames: int = 49,
        patch_size: int = 2,
        temporal_compression_ratio: int = 4,
        max_text_seq_length: int = 226,
        spatial_interpolation_scale: float = 1.875,
        temporal_interpolation_scale: float = 1.0,
        use_rotary_positional_embeddings: bool = True,
        add_noise_in_inpaint_model: bool = True,
        is_train_cross: bool = True,
        cross_attn_interval: int = 2,
        cross_attn_dim_head: int = 128,
        cross_attn_num_heads: int = 16,
        attention_impl: str = "auto",
    ):
        super().__init__()
        dim = num_attention_heads * attention_head_dim
        self.inner_dim = dim
        self.attention_head_dim = attention_head_dim
        self.out_channels = out_channels
        self.patch_size = patch_size
        self.sample_width, self.sample_height = sample_width, sample_height
        self.sample_frames = sample_frames
        self.temporal_compression_ratio = temporal_compression_ratio
        self.spatial_interpolation_scale = spatial_interpolation_scale
        self.temporal_interpolation_scale = temporal_interpolation_scale
        self.use_rotary_positional_embeddings = use_rotary_positional_embeddings
        self.add_noise_in_inpaint_model = add_noise_in_inpaint_model
        self.cross_attn_interval = cross_attn_interval

        self.patch_embed = _PatchEmbed(in_channels, dim, text_embed_dim, patch_size)
        if is_train_cross:
            self.ref_patch_embed = _RefPatchEmbed(out_channels, dim, patch_size)
        self.time_embedding = _TimestepEmbedding(dim, time_embed_dim)
        self.transformer_blocks = nn.ModuleList([
            CogVideoXBlock(dim, num_attention_heads, attention_head_dim, time_embed_dim,
                           attention_impl)
            for _ in range(num_layers)
        ])
        # one Perceiver after blocks 0, interval, 2 * interval, ...
        self.perceiver_cross_attention = nn.ModuleList([
            PerceiverCrossAttention(dim, cross_attn_dim_head, cross_attn_num_heads,
                                    attention_impl)
            for _ in range(0, num_layers, cross_attn_interval)
        ]) if is_train_cross else None
        self.norm_final = nn.LayerNorm(dim, eps=1e-5)
        self.norm_out = _AdaNormOut(time_embed_dim, dim)
        self.proj_out = nn.Linear(dim, patch_size * patch_size * out_channels)

    def forward(
        self,
        hidden_states: torch.Tensor,  # (B, F, H, W, 16) noisy latents
        encoder_hidden_states: torch.Tensor,  # (B, 226, 4096) text
        timestep: torch.Tensor,  # (B,)
        inpaint_latents: Optional[torch.Tensor] = None,  # (B, F, H, W, 17)
        cross_latents: Optional[torch.Tensor] = None,  # (B, F_ref, H, W, 16)
        image_rotary_emb: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> torch.Tensor:
        b, f, h, w, _ = hidden_states.shape
        p = self.patch_size
        dim = self.inner_dim
        dtype = self.proj_out.weight.dtype

        # 1. time embedding (fp32 sinusoid -> MLP in the model dtype)
        temb = self.time_embedding(timestep_embedding(timestep, dim).to(dtype))

        # 2. patch embedding of [noise ; inpaint] and the text projection
        if inpaint_latents is not None:
            hidden_states = torch.cat([hidden_states, inpaint_latents], dim=-1)
        video_tokens = _patchify(self.patch_embed.proj, hidden_states)
        text_tokens = self.patch_embed.text_proj(encoder_hidden_states)

        cross_tokens = None
        if self.perceiver_cross_attention is not None and cross_latents is not None:
            cross_tokens = _patchify(self.ref_patch_embed.proj, cross_latents)

        # 3. positional embedding (non-RoPE checkpoints only)
        text_len = text_tokens.shape[1]
        if not self.use_rotary_positional_embeddings:
            table = resized_pos_embedding(
                dim,
                (self.sample_frames - 1) // self.temporal_compression_ratio + 1,
                self.sample_height // p, self.sample_width // p,
                f, h // p, w // p,
                self.spatial_interpolation_scale, self.temporal_interpolation_scale,
            )
            video_tokens = video_tokens + torch.as_tensor(
                table, dtype=dtype, device=video_tokens.device)[None]

        # 4. transformer blocks with interleaved Perceiver cross-attention
        hidden, encoder = video_tokens, text_tokens
        for i, block in enumerate(self.transformer_blocks):
            hidden, encoder = block(hidden, encoder, temb, image_rotary_emb)
            if cross_tokens is not None and i % self.cross_attn_interval == 0:
                perceiver = self.perceiver_cross_attention[i // self.cross_attn_interval]
                hidden = hidden + perceiver(cross_tokens, hidden)

        # 5. final norm on the joint text+video stream (the deployed RoPE
        #    checkpoint's order), then AdaLN and the projection
        joint = layer_norm_f32(self.norm_final, torch.cat([encoder, hidden], dim=1))
        hidden = joint[:, text_len:]
        shift, scale = self.norm_out.linear(F.silu(temb)).chunk(2, dim=-1)
        hidden = layer_norm_f32(self.norm_out.norm, hidden)
        hidden = hidden * (1 + scale[:, None]) + shift[:, None]
        out = self.proj_out(hidden)

        # 6. unpatchify -> (B, F, H, W, C) in the reference's [c][i][j] order
        out = out.reshape(b, f, h // p, w // p, self.out_channels, p, p)
        out = out.permute(0, 1, 2, 5, 3, 6, 4)  # (b, f, h/p, p, w/p, p, c)
        return out.reshape(b, f, h, w, self.out_channels)
