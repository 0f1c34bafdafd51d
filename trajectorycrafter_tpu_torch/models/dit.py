"""CrossTransformer3D: the dual-stream CogVideoX DiT with reference-view
Perceiver cross-attention, in PyTorch.

Counterpart of trajectorycrafter_tpu/models/dit.py, in bf16:
  * 42 CogVideoX blocks (AdaLN-Zero, joint text+video self-attention with
    per-head QK layernorm and 3D RoPE on the video tokens, gated tanh-gelu
    FF), with a Perceiver cross-attention over reference-view tokens after
    every ``cross_attn_interval``-th block;
  * patch embedding of the 33-channel latent input and the text projection;
  * channel-last (B, F, H, W, C) latents at the public interface;
  * linear layers are ``ops/linear.py Linear`` (``nn.Linear``, each call a
    ``linear`` span); layer norms and softmax run in fp32; attention goes
    through ops/attention.py, which launches the hand-written flash kernel
    for CUDA tensors.  The model's
    ``attention_impl`` reaches both the joint self-attention and the
    Perceivers, as in the JAX model: ``"flash_pv8"`` runs both on the
    PV-int8 kernel.

``remat`` is the JAX model's field: with gradients on, each
``CogVideoXBlock`` keeps only its inputs and is recomputed in the backward
pass (``torch.utils.checkpoint``), as JAX's ``nn.remat`` wraps the blocks
only; the Perceivers keep their activations.  The same operations run, so
no value changes.

The JAX ``quant="int8"`` branch is this model after ``ops/int8.py
quantize_dit_``, which swaps the blocks' and the Perceivers' linear layers
for ``Int8Linear`` ones: on the card their GEMMs run in the hand-written
int8 kernels (ops/int8_matmul.py).

Module and parameter names are the reference checkpoint's
(``utils/convert.py expected_dit_keys``), so ``load_state_dict(strict=True)``
checks a converted tree.

Under a mesh (``mesh``, set by parallel/sharding.py ``shard_dit_`` through
the pipeline's ``with_mesh``; the JAX model's ``shard_activations``) each
rank holds its tensor-parallel shard of the blocks and Perceivers (48 / tp
heads in the joint attention, 16 / tp in the Perceivers, 12,288 / tp of
the feed-forward), takes its dp share of the batch and its sp shard of the
joint [text; video] tokens (``JointShard``; RoPE tables sliced to its video
tokens), runs the joint self-attention on the ring, and gathers the output
over sp and dp before the unpatchify, so every rank returns the whole
output.  Layer norms and the modulation run at full width on every rank.
Training shards the blocks and Perceivers over tp alone (parallel/
sharding.py ``shard_units_``; ``mesh`` stays None and the step shards the
batch), and with grad enabled their tp collectives are autograd Functions
(``distributed.tp_input`` / ``tp_output``).  With the forward's ``sp`` (an
sp axis; training/step.py passes the mesh's) each rank keeps its
``JointShard`` of the joint tokens as above, the joint self-attention runs
on the differentiable ring (ops/ring_attention.py
``RingAttentionFunction``: the blocks keep their ``attention_impl``), the
Perceivers' queries are the rank's video tokens against the whole
reference tokens, and the output is gathered over sp with a backward that
takes the rank's slice.  JAX's ``shard_activations`` puts only the video
tokens on sp and keeps the text whole; the port shards the joint sequence:
the same function.

The forward is ``embed`` (steps 1-3: time, patch and text embeddings, the
reference tokens), ``run_blocks`` (step 4, the block stack: block 2i, then
Perceiver i added to the residual, then block 2i + 1, as the JAX pipeline's
superblocks; a GPipe stage runs its share, parallel/pipeline.py) and the
output head.

Spans (utils/timing.py; traced only under a profiler): ``dit.forward``,
``dit.embed``, ``dit.block``, ``dit.joint_attn``, ``dit.perceiver`` and
``dit.ff`` at the modules' forwards; ``dit.norm`` at the fp32 layer norms
with their modulation (each ``LayerNormZero``, a Perceiver's two norms, the
head's two); ``linear`` at every linear layer, ``attention`` at
ops/attention.py ``multi_head_attention``.  Per CFG step at 42 layers: 1, 1,
42, 42, 21, 42, 106, 404 and 63 calls.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint as _recompute

from trajectorycrafter_tpu_torch.ops.attention import multi_head_attention
from trajectorycrafter_tpu_torch.ops.int8 import Int8Linear, Int8RowParallelLinear
from trajectorycrafter_tpu_torch.ops.int8_matmul import FF_GROUP, fit_block, int8_ff_apply
from trajectorycrafter_tpu_torch.ops.linear import Linear
from trajectorycrafter_tpu_torch.parallel import distributed as D
from trajectorycrafter_tpu_torch.parallel.sharding import JointShard, batch_shard
from trajectorycrafter_tpu_torch.ops.posemb import resized_pos_embedding, timestep_embedding
from trajectorycrafter_tpu_torch.ops.rope import apply_rotary_emb
from trajectorycrafter_tpu_torch.utils.timing import span


def layer_norm_f32(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """Apply ``norm`` in fp32 whatever its parameter dtype; result in x's dtype."""
    weight = norm.weight.float() if norm.weight is not None else None
    bias = norm.bias.float() if norm.bias is not None else None
    return F.layer_norm(x.float(), norm.normalized_shape, weight, bias, norm.eps).to(x.dtype)


class _GELUProj(nn.Module):
    """diffusers GELU(approximate="tanh"): projection, then tanh-gelu."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim_in, dim_out)

    def forward(self, x):
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    """Linear -> tanh-gelu -> Linear, named as diffusers' ``net.0.proj`` /
    ``net.2`` (``net.1`` is the reference's parameter-free dropout).

    Quantized (``ops/int8.py quantize_dit_``), ``fuse`` picks the int8 path
    as the JAX module's field does: None (the default) or False runs the two
    ``Int8Linear`` layers with the tanh-gelu between them, each quantizing
    its input per row; True runs the fused chain (``int8_ff_apply``), whose
    first GEMM applies bias and gelu and re-quantizes per (row, 1,024
    columns) in its epilogue, so the (tokens, 4 x dim) intermediate stays
    int8."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.fuse: Optional[bool] = None
        self.tp_axis = None  # set by parallel/sharding.py shard_unit_
        self.net = nn.ModuleList([_GELUProj(dim, dim * mult), nn.Identity(),
                                  Linear(dim * mult, dim)])

    def forward(self, x):
        with span("dit.ff", x):
            proj_in, proj_out = self.net[0].proj, self.net[2]
            if self.fuse and isinstance(proj_in, Int8Linear):
                with span("linear", x):  # the fused chain is one linear layer's span
                    return self._fused(x, proj_in, proj_out)
            x = D.tp_input(x, self.tp_axis)
            for layer in self.net:
                x = layer(x)
            return x

    @staticmethod
    def _fused(x, proj_in, proj_out):
        if not isinstance(proj_out, Int8RowParallelLinear):
            return int8_ff_apply(x, proj_in.weight_q, proj_in.weight_scale, proj_in.bias,
                                 proj_out.weight_q, proj_out.weight_scale, proj_out.bias,
                                 impl=proj_in.int8_impl)
        # tensor-parallel: this rank's columns of the first GEMM and its K of
        # the second, whose groups must stay the unsharded ones
        width = proj_in.out_features * proj_out.tp_axis.size
        group = fit_block(FF_GROUP, width)
        if proj_in.out_features % group:
            raise ValueError(f"the fused int8 FF runs under tp only where {width} / tp is a "
                             f"multiple of its {group}-column group; tp="
                             f"{proj_out.tp_axis.size} leaves {proj_in.out_features}")
        return D.sum_partials(int8_ff_apply(
            x, proj_in.weight_q, proj_in.weight_scale, proj_in.bias, proj_out.weight_q,
            proj_out.weight_scale, None, group=group, impl=proj_in.int8_impl),
            proj_out.tp_axis, proj_out.bias)


class LayerNormZero(nn.Module):
    """CogVideoX AdaLN-Zero: temb -> 6 modulation vectors; one shared LN
    modulates both streams."""

    def __init__(self, conditioning_dim: int, dim: int):
        super().__init__()
        self.linear = Linear(conditioning_dim, 6 * dim)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, hidden, encoder, temb):
        with span("dit.norm", hidden):
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
        self.tp_axis = None  # set by parallel/sharding.py shard_unit_
        self.to_q = Linear(dim, inner)
        self.to_k = Linear(dim, inner)
        self.to_v = Linear(dim, inner)
        self.norm_q = nn.LayerNorm(head_dim, eps=1e-6)
        self.norm_k = nn.LayerNorm(head_dim, eps=1e-6)
        self.to_out = nn.ModuleList([Linear(inner, dim)])

    def forward(self, hidden, encoder, rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
                seq: Optional[JointShard] = None):
        if seq is None and self.attention_impl == "ring":
            raise ValueError("token shards take a ring route and the ring needs token "
                             "shards: shard the model with the pipeline's with_mesh, or give "
                             "the training forward its sp axis")
        with span("dit.joint_attn", hidden):
            text_len = encoder.shape[1]
            x = D.tp_input(torch.cat([encoder, hidden], dim=1), self.tp_axis)
            heads = (self.heads, self.head_dim)
            q = layer_norm_f32(self.norm_q, self.to_q(x).unflatten(-1, heads))
            k = layer_norm_f32(self.norm_k, self.to_k(x).unflatten(-1, heads))
            v = self.to_v(x).unflatten(-1, heads)
            if rope is not None:
                # rotate the video tokens in (B, S, H, D): cos/sin (S_vid, 1, D)
                cos, sin = rope[0][:, None], rope[1][:, None]
                q = torch.cat([q[:, :text_len], apply_rotary_emb(q[:, text_len:], cos, sin)],
                              dim=1)
                k = torch.cat([k[:, :text_len], apply_rotary_emb(k[:, text_len:], cos, sin)],
                              dim=1)
            out = self.to_out[0](multi_head_attention(q, k, v, impl=self.attention_impl,
                                                      ring=seq))
            return out[:, text_len:], out[:, :text_len]


class CogVideoXBlock(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, time_embed_dim: int,
                 attention_impl: str = "auto"):
        super().__init__()
        self.norm1 = LayerNormZero(time_embed_dim, dim)
        self.attn1 = JointAttention(dim, heads, head_dim, attention_impl)
        self.norm2 = LayerNormZero(time_embed_dim, dim)
        self.ff = FeedForward(dim)

    def forward(self, hidden, encoder, temb, rope, seq: Optional[JointShard] = None):
        with span("dit.block", hidden):
            h, e, gate, enc_gate = self.norm1(hidden, encoder, temb)
            attn_h, attn_e = self.attn1(h, e, rope, seq)
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
        self.tp_axis = None  # set by parallel/sharding.py shard_unit_
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.to_q = Linear(dim, inner, bias=False)
        self.to_kv = Linear(dim, 2 * inner, bias=False)
        self.to_out = Linear(inner, dim, bias=False)

    def forward(self, x, latents):
        with span("dit.perceiver", x):
            # x: (B, S_ref, dim) reference tokens; latents: (B, S_vid, dim)
            with span("dit.norm", x):
                x = layer_norm_f32(self.norm1, x)
                lat = layer_norm_f32(self.norm2, latents)
            x = D.tp_input(x, self.tp_axis)
            lat = D.tp_input(lat, self.tp_axis)
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
        self.text_proj = Linear(text_dim, dim)


class _RefPatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, dim, patch, stride=patch)


class _TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = Linear(in_dim, time_embed_dim)
        self.linear_2 = Linear(time_embed_dim, time_embed_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class _AdaNormOut(nn.Module):
    def __init__(self, time_embed_dim: int, dim: int):
        super().__init__()
        self.linear = Linear(time_embed_dim, 2 * dim)
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
        remat: bool = False,
    ):
        super().__init__()
        dim = num_attention_heads * attention_head_dim
        self.remat = remat
        self.mesh = None  # parallel/mesh.py Mesh, set by parallel/sharding.py shard_dit_
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
        self.proj_out = Linear(dim, patch_size * patch_size * out_channels)

    def embed(self, hidden_states, encoder_hidden_states, timestep, inpaint_latents=None,
              cross_latents=None):
        """Steps 1-3 of the forward: (video tokens (B, S_vid, D), text tokens
        (B, S_txt, D), temb (B, time_embed_dim), reference tokens (B, S_ref,
        D) or None), the block stack's inputs."""
        with span("dit.embed", hidden_states):
            f, h, w = hidden_states.shape[1:4]
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
            return video_tokens, text_tokens, temb, cross_tokens

    def run_blocks(self, hidden, encoder, temb, rope, cross_tokens,
                   seq: Optional[JointShard] = None, blocks: Optional[range] = None):
        """Step 4: the blocks ``blocks`` (all by default) with the Perceiver
        after every ``cross_attn_interval``-th block added to the residual
        (none without ``cross_tokens``); each block recomputed in the
        backward pass under ``remat`` with grad enabled.  Returns (hidden,
        encoder)."""
        for i in blocks if blocks is not None else range(len(self.transformer_blocks)):
            block = self.transformer_blocks[i]
            if self.remat and torch.is_grad_enabled():
                hidden, encoder = _recompute(block, hidden, encoder, temb, rope, seq,
                                             use_reentrant=False)
            else:
                hidden, encoder = block(hidden, encoder, temb, rope, seq)
            if cross_tokens is not None and i % self.cross_attn_interval == 0:
                perceiver = self.perceiver_cross_attention[i // self.cross_attn_interval]
                hidden = hidden + perceiver(cross_tokens, hidden)
        return hidden, encoder

    def forward(
        self,
        hidden_states: torch.Tensor,  # (B, F, H, W, 16) noisy latents
        encoder_hidden_states: torch.Tensor,  # (B, 226, 4096) text
        timestep: torch.Tensor,  # (B,)
        inpaint_latents: Optional[torch.Tensor] = None,  # (B, F, H, W, 17)
        cross_latents: Optional[torch.Tensor] = None,  # (B, F_ref, H, W, 16)
        image_rotary_emb: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        sp: Optional[D.Axis] = None,  # training: the joint tokens' sp axis
    ) -> torch.Tensor:
        if self.mesh is not None and sp is not None:
            raise ValueError("the forward's sp axis is training's; a sharded model has its mesh")
        with span("dit.forward", hidden_states):
            b, f, h, w, _ = hidden_states.shape
            p = self.patch_size
            mesh = self.mesh
            if mesh is not None:  # this dp rank's share of the batch (the CFG pair)
                hidden_states, encoder_hidden_states, timestep, inpaint_latents, cross_latents = (
                    batch_shard(x, mesh.dp) for x in (hidden_states, encoder_hidden_states,
                                                      timestep, inpaint_latents, cross_latents))

            video_tokens, text_tokens, temb, cross_tokens = self.embed(
                hidden_states, encoder_hidden_states, timestep, inpaint_latents, cross_latents)
            text_len = text_tokens.shape[1]

            # 4. transformer blocks with interleaved Perceiver cross-attention;
            #    under sp each rank keeps its shard of the joint token sequence
            seq = None
            sp = mesh.sp if mesh is not None else sp
            if sp is not None and sp.size > 1:
                seq = JointShard(sp, text_len, video_tokens.shape[1])
                text_tokens, video_tokens = seq.split(text_tokens, video_tokens)
                if image_rotary_emb is not None:
                    image_rotary_emb = tuple(t[seq.video] for t in image_rotary_emb)
                text_len = text_tokens.shape[1]
            hidden, encoder = self.run_blocks(video_tokens, text_tokens, temb, image_rotary_emb,
                                              cross_tokens, seq)

            # 5. final norm on the joint text+video stream (the deployed RoPE
            #    checkpoint's order), then AdaLN and the projection
            joint = torch.cat([encoder, hidden], dim=1)
            with span("dit.norm", joint):
                hidden = layer_norm_f32(self.norm_final, joint)[:, text_len:]
                shift, scale = self.norm_out.linear(F.silu(temb)).chunk(2, dim=-1)
                hidden = layer_norm_f32(self.norm_out.norm, hidden)
                hidden = hidden * (1 + scale[:, None]) + shift[:, None]
            out = self.proj_out(hidden)
            if seq is not None:
                out = seq.gather_video(out)
            if mesh is not None:
                out = D.all_gather(out, mesh.dp, dim=0)

            # 6. unpatchify -> (B, F, H, W, C) in the reference's [c][i][j] order
            out = out.reshape(b, f, h // p, w // p, self.out_channels, p, p)
            out = out.permute(0, 1, 2, 5, 3, 6, 4)  # (b, f, h/p, p, w/p, p, c)
            return out.reshape(b, f, h, w, self.out_channels)
