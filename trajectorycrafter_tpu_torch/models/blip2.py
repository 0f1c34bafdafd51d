"""BLIP-2 captioner (EVA ViT-g vision encoder + Q-Former + OPT decoder), in PyTorch.

Counterpart of trajectorycrafter_tpu/models/blip2.py.  The pipeline
captions the middle frame once per video when no ``--prompt`` is given:

  * ``Blip2VisionModel``: EVA-CLIP ViT-g/14, fused-qkv attention (one
    ``qkv`` linear whose bias is the checkpoint's merged [q ; 0 ; v] bias),
    pre-LN blocks, learned class / position embeddings, post-layernorm;
  * ``Blip2QFormer``: the learned query tokens through a BERT-style post-LN
    stack, cross-attending to the image features every
    ``cross_attention_frequency`` layers, with the query-path FFN;
  * ``OPTDecoder``: a pre-LN causal LM (learned positions with OPT's +2
    offset, ReLU FFN) over the projected query tokens as a soft prefix; the
    language-model head is the token embedding (tied);
  * ``generate_caption_ids``: greedy decoding over one fixed buffer of
    prefix + ``max_new_tokens`` slots, the unfilled slots masked out.

Module and parameter names are transformers' ``Blip2ForConditionalGeneration``
checkpoint's, so its safetensors load with ``strict=True`` (its tied
``language_model.lm_head.weight`` is skipped, ``utils/checkpoints.py``).
Layer norms, attention scores and softmax run in fp32, the linear layers in
the parameters' dtype; the attention is a plain matmul softmax, as in the
JAX module (a 257-token image and a ~52-token text buffer, once per video).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# image preprocessing constants (transformers Blip2Processor / CLIP stats)
BLIP_IMAGE_SIZE = 224
BLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
BLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class Blip2Config:
    # vision (EVA ViT-g/14)
    vision_hidden: int = 1408
    vision_intermediate: int = 6144
    vision_layers: int = 39
    vision_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    # Q-Former
    num_query_tokens: int = 32
    qformer_hidden: int = 768
    qformer_layers: int = 12
    qformer_heads: int = 12
    qformer_intermediate: int = 3072
    cross_attention_frequency: int = 2
    # OPT decoder (opt-2.7b)
    vocab_size: int = 50272
    opt_hidden: int = 2560
    opt_layers: int = 32
    opt_heads: int = 32
    opt_ffn: int = 10240
    max_positions: int = 2048
    bos_token_id: int = 2
    eos_token_id: int = 50118  # "\n": blip2-opt's generation stopper


def blip2_config_from_hf(cfg: dict) -> Blip2Config:
    """HF Blip2Config dict (the checkpoint's config.json) -> Blip2Config."""
    v = cfg.get("vision_config", {})
    q = cfg.get("qformer_config", {})
    t = cfg.get("text_config", {})
    d = Blip2Config()
    return Blip2Config(
        vision_hidden=v.get("hidden_size", d.vision_hidden),
        vision_intermediate=v.get("intermediate_size", d.vision_intermediate),
        vision_layers=v.get("num_hidden_layers", d.vision_layers),
        vision_heads=v.get("num_attention_heads", d.vision_heads),
        image_size=v.get("image_size", d.image_size),
        patch_size=v.get("patch_size", d.patch_size),
        num_query_tokens=cfg.get("num_query_tokens", d.num_query_tokens),
        qformer_hidden=q.get("hidden_size", d.qformer_hidden),
        qformer_layers=q.get("num_hidden_layers", d.qformer_layers),
        qformer_heads=q.get("num_attention_heads", d.qformer_heads),
        qformer_intermediate=q.get("intermediate_size", d.qformer_intermediate),
        cross_attention_frequency=q.get("cross_attention_frequency",
                                        d.cross_attention_frequency),
        vocab_size=t.get("vocab_size", d.vocab_size),
        opt_hidden=t.get("hidden_size", d.opt_hidden),
        opt_layers=t.get("num_hidden_layers", d.opt_layers),
        opt_heads=t.get("num_attention_heads", d.opt_heads),
        opt_ffn=t.get("ffn_dim", d.opt_ffn),
        max_positions=t.get("max_position_embeddings", d.max_positions),
        bos_token_id=t.get("bos_token_id", d.bos_token_id),
        # the published blip2-opt generation config stops at "\n" (50118), not
        # at text_config's eos; generation_config.json may override it
        eos_token_id=d.eos_token_id,
    )


def _ln(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``norm`` applied in fp32; the result in x's dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(x.dtype)


def _attend(q, k, v, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, S, H, D) q, (B, T, H, D) k, v -> (B, S, H * D): fp32 scores and
    softmax (``mask`` added to the scores), the weights in v's dtype."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    if mask is not None:
        scores = scores + mask
    w = scores.softmax(dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v)
    return out.reshape(*out.shape[:2], -1)


# ---------------------------------------------------------------------------
# vision encoder
# ---------------------------------------------------------------------------


class Blip2VisionAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.projection = nn.Linear(dim, dim)

    def forward(self, x):
        b, s, d = x.shape
        q, k, v = self.qkv(x).reshape(b, s, 3, self.heads, d // self.heads).unbind(dim=2)
        return self.projection(_attend(q, k, v))


class _VisionMLP(nn.Module):
    def __init__(self, dim: int, intermediate: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, intermediate)
        self.fc2 = nn.Linear(intermediate, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class _VisionLayer(nn.Module):
    def __init__(self, cfg: Blip2Config):
        super().__init__()
        d = cfg.vision_hidden
        self.self_attn = Blip2VisionAttention(d, cfg.vision_heads)
        self.layer_norm1 = nn.LayerNorm(d, eps=1e-6)
        self.mlp = _VisionMLP(d, cfg.vision_intermediate)
        self.layer_norm2 = nn.LayerNorm(d, eps=1e-6)

    def forward(self, x):
        x = x + self.self_attn(_ln(self.layer_norm1, x))
        return x + self.mlp(_ln(self.layer_norm2, x))


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: Blip2Config):
        super().__init__()
        d, grid = cfg.vision_hidden, cfg.image_size // cfg.patch_size
        self.class_embedding = nn.Parameter(torch.zeros(1, 1, d))
        self.patch_embedding = nn.Conv2d(3, d, cfg.patch_size, stride=cfg.patch_size)
        self.position_embedding = nn.Parameter(torch.zeros(1, grid * grid + 1, d))

    def forward(self, pixels):
        patches = self.patch_embedding(pixels.to(self.patch_embedding.weight.dtype))
        patches = patches.flatten(2).transpose(1, 2)  # (B, grid^2, d)
        cls = self.class_embedding.expand(pixels.shape[0], -1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embedding


class _VisionEncoder(nn.Module):
    def __init__(self, cfg: Blip2Config):
        super().__init__()
        self.layers = nn.ModuleList([_VisionLayer(cfg) for _ in range(cfg.vision_layers)])


class Blip2VisionModel(nn.Module):
    """(B, 3, S, S) CLIP-normalised pixels -> (B, 1 + (S/14)^2, vision_hidden)."""

    def __init__(self, cfg: Blip2Config):
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg)
        self.encoder = _VisionEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.vision_hidden, eps=1e-6)

    def forward(self, pixels):
        x = self.embeddings(pixels)
        for layer in self.encoder.layers:
            x = layer(x)
        return _ln(self.post_layernorm, x)


# ---------------------------------------------------------------------------
# Q-Former
# ---------------------------------------------------------------------------


class _QKV(nn.Module):
    def __init__(self, dim: int, kv_dim: int):
        super().__init__()
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(kv_dim, dim)
        self.value = nn.Linear(kv_dim, dim)


class _Dense(nn.Module):
    def __init__(self, dim_in: int, dim: int):
        super().__init__()
        self.dense = nn.Linear(dim_in, dim)


class _DenseNorm(nn.Module):
    def __init__(self, dim_in: int, dim: int):
        super().__init__()
        self.dense = nn.Linear(dim_in, dim)
        self.LayerNorm = nn.LayerNorm(dim, eps=1e-12)

    def forward(self, h, residual):
        return _ln(self.LayerNorm, self.dense(h) + residual)


class QFormerAttention(nn.Module):
    """BERT-style attention with its post-LN output block (``attention.query
    / key / value``, ``output.dense`` + ``output.LayerNorm``)."""

    def __init__(self, dim: int, kv_dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.attention = _QKV(dim, kv_dim)
        self.output = _DenseNorm(dim, dim)

    def forward(self, x, kv):
        b, s, d = x.shape
        split = lambda t: t.reshape(b, t.shape[1], self.heads, d // self.heads)
        a = self.attention
        ctx = _attend(split(a.query(x)), split(a.key(kv)), split(a.value(kv)))
        return self.output(ctx, x)


class _QFormerLayer(nn.Module):
    def __init__(self, cfg: Blip2Config, cross: bool):
        super().__init__()
        d = cfg.qformer_hidden
        self.attention = QFormerAttention(d, d, cfg.qformer_heads)
        if cross:
            self.crossattention = QFormerAttention(d, cfg.vision_hidden, cfg.qformer_heads)
        self.intermediate_query = _Dense(d, cfg.qformer_intermediate)
        self.output_query = _DenseNorm(cfg.qformer_intermediate, d)

    def forward(self, x, image_embeds):
        x = self.attention(x, x)
        if hasattr(self, "crossattention"):
            x = self.crossattention(x, image_embeds)
        return self.output_query(F.gelu(self.intermediate_query.dense(x)), x)


class _QFormerEncoder(nn.Module):
    def __init__(self, cfg: Blip2Config):
        super().__init__()
        self.layer = nn.ModuleList([_QFormerLayer(cfg, i % cfg.cross_attention_frequency == 0)
                                    for i in range(cfg.qformer_layers)])


class Blip2QFormer(nn.Module):
    """Query tokens (B, Q, qformer_hidden) attending to the image features
    -> (B, Q, qformer_hidden)."""

    def __init__(self, cfg: Blip2Config):
        super().__init__()
        self.layernorm = nn.LayerNorm(cfg.qformer_hidden, eps=1e-12)
        self.encoder = _QFormerEncoder(cfg)

    def forward(self, query, image_embeds):
        x = _ln(self.layernorm, query)
        for layer in self.encoder.layer:
            x = layer(x, image_embeds)
        return x


# ---------------------------------------------------------------------------
# OPT decoder
# ---------------------------------------------------------------------------


class _OPTAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x, mask):
        b, s, d = x.shape
        split = lambda t: t.reshape(b, s, self.heads, d // self.heads)
        return self.out_proj(_attend(split(self.q_proj(x)), split(self.k_proj(x)),
                                     split(self.v_proj(x)), mask))


class _OPTLayer(nn.Module):
    def __init__(self, cfg: Blip2Config):
        super().__init__()
        d = cfg.opt_hidden
        self.self_attn = _OPTAttention(d, cfg.opt_heads)
        self.self_attn_layer_norm = nn.LayerNorm(d)
        self.fc1 = nn.Linear(d, cfg.opt_ffn)
        self.fc2 = nn.Linear(cfg.opt_ffn, d)
        self.final_layer_norm = nn.LayerNorm(d)

    def forward(self, x, mask):
        x = x + self.self_attn(_ln(self.self_attn_layer_norm, x), mask)
        return x + self.fc2(F.relu(self.fc1(_ln(self.final_layer_norm, x))))


class OPTDecoder(nn.Module):
    """Pre-LN OPT causal LM over a fixed-length embedding buffer:
    ``forward(embeds, valid_len)`` -> hidden states (B, L, opt_hidden), the
    slots at and past ``valid_len`` masked out of every attention (-1e9)."""

    def __init__(self, cfg: Blip2Config):
        super().__init__()
        d = cfg.opt_hidden
        self.embed_tokens = nn.Embedding(cfg.vocab_size, d)
        # OPT's learned positions carry a historical +2 offset
        self.embed_positions = nn.Embedding(cfg.max_positions + 2, d)
        self.layers = nn.ModuleList([_OPTLayer(cfg) for _ in range(cfg.opt_layers)])
        self.final_layer_norm = nn.LayerNorm(d)

    def forward(self, embeds, valid_len: int):
        b, l, _ = embeds.shape
        x = embeds + self.embed_positions.weight[2:l + 2][None]
        idx = torch.arange(l, device=embeds.device)
        keep = (idx[None, :] <= idx[:, None]) & (idx[None, :] < valid_len)
        mask = torch.where(keep, 0.0, -1e9).to(torch.float32)
        for layer in self.layers:
            x = layer(x, mask)
        return _ln(self.final_layer_norm, x)


class _OPTModel(nn.Module):
    def __init__(self, cfg: Blip2Config):
        super().__init__()
        self.decoder = OPTDecoder(cfg)


class _OPTForCausalLM(nn.Module):
    def __init__(self, cfg: Blip2Config):
        super().__init__()
        self.model = _OPTModel(cfg)


class Blip2Captioner(nn.Module):
    """vision -> Q-Former -> language projection -> OPT, with the pieces the
    generation loop needs."""

    def __init__(self, cfg: Blip2Config):
        super().__init__()
        self.cfg = cfg
        self.vision_model = Blip2VisionModel(cfg)
        self.query_tokens = nn.Parameter(torch.zeros(1, cfg.num_query_tokens, cfg.qformer_hidden))
        self.qformer = Blip2QFormer(cfg)
        self.language_projection = nn.Linear(cfg.qformer_hidden, cfg.opt_hidden)
        self.language_model = _OPTForCausalLM(cfg)

    @property
    def decoder(self) -> OPTDecoder:
        return self.language_model.model.decoder

    def query_output(self, pixels):
        """(B, 3, S, S) -> the Q-Former's output (B, Q, qformer_hidden)."""
        image_embeds = self.vision_model(pixels)
        query = self.query_tokens.expand(pixels.shape[0], -1, -1)
        return self.qformer(query, image_embeds)

    def prefix_embeds(self, pixels):
        """(B, 3, S, S) -> (B, Q + 1, opt_hidden): the projected query
        outputs and the BOS embedding (the generation prompt)."""
        proj = self.language_projection(self.query_output(pixels))
        bos = torch.full((pixels.shape[0], 1), self.cfg.bos_token_id, device=pixels.device)
        return torch.cat([proj, self.embed_tokens(bos)], dim=1)

    def embed_tokens(self, ids):
        return self.decoder.embed_tokens(ids)

    def logits(self, hidden):
        """The tied head, in fp32: hidden @ embed_tokens^T."""
        return hidden.float() @ self.decoder.embed_tokens.weight.float().T

    def decode_step(self, embeds, valid_len: int):
        """Logits (B, L, vocab) of the buffer ``embeds`` with ``valid_len`` slots filled."""
        return self.logits(self.decoder(embeds, valid_len))


@torch.no_grad()
def generate_caption_ids(model: Blip2Captioner, pixels: torch.Tensor,
                         max_new_tokens: int = 20,
                         eos_token_id: Optional[int] = None) -> torch.Tensor:
    """Greedy caption ids (B, max_new_tokens).  Each step runs the decoder
    over the whole buffer of prefix + ``max_new_tokens`` slots with the
    filled ones valid, and takes the argmax at the last filled slot; once a
    row emits ``eos`` its later slots repeat it.  ``eos_token_id``
    overrides the config's (-1: never stop)."""
    eos = model.cfg.eos_token_id if eos_token_id is None else eos_token_id
    prefix = model.prefix_embeds(pixels)
    b, p, d = prefix.shape
    buf = prefix.new_zeros((b, p + max_new_tokens, d))
    buf[:, :p] = prefix
    ids = torch.zeros((b, max_new_tokens), dtype=torch.long, device=pixels.device)
    done = torch.zeros((b,), dtype=torch.bool, device=pixels.device)
    for i in range(max_new_tokens):
        hidden = model.decoder(buf, p + i)
        nxt = model.logits(hidden[:, p + i - 1]).argmax(dim=-1)
        nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
        done = done | (nxt == eos)
        buf[:, p + i] = model.embed_tokens(nxt)
        ids[:, i] = nxt
    return ids


def preprocess_frame(frame01: np.ndarray, image_size: int = BLIP_IMAGE_SIZE,
                     device="cpu") -> torch.Tensor:
    """[0, 1] RGB (H, W, 3) -> (1, 3, S, S) CLIP-normalised fp32 on
    ``device``: the antialiased bicubic resize (Keys a = -0.5, the kernel
    widened when downsampling), which is ``jax.image.resize``'s bicubic."""
    x = torch.as_tensor(np.asarray(frame01, np.float32), device=device).permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(image_size, image_size), mode="bicubic", align_corners=False,
                      antialias=True)
    mean = torch.tensor(BLIP_IMAGE_MEAN, device=device)[None, :, None, None]
    std = torch.tensor(BLIP_IMAGE_STD, device=device)[None, :, None, None]
    return (x - mean) / std
