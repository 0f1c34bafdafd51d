"""T5 v1.1 text encoder (the CogVideoX prompt encoder), in PyTorch.

Counterpart of trajectorycrafter_tpu/models/t5.py: RMS layer norms in fp32,
a relative position bias built by the first block and shared by all, no
1/sqrt(d) scale on the scores, no biases, gated-gelu feed-forward.  At XXL
scale : d_model 4096, 24 layers, 64 heads of 64, d_ff
10240, 4.8B parameters.  The attention is a plain matmul / fp32 softmax in
the module, as in the JAX package: its scores carry the position bias and
the padding mask, and 226 tokens is far below where a kernel pays.  The
constructor's defaults are the XXL widths.

Parameter names are transformers' ``T5EncoderModel``
(``utils/convert.py convert_t5_encoder``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def relative_position_bucket(relative_position: np.ndarray, num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """Bidirectional T5 bucket of each relative position (half the buckets
    for each sign, exact below num_buckets / 4, log-spaced above)."""
    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int64) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    large = max_exact + (np.log(np.maximum(n, 1) / max_exact) / np.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).astype(np.int64)
    large = np.minimum(large, num_buckets - 1)
    return ret + np.where(n < max_exact, n, large)


class T5LayerNorm(nn.Module):
    """RMS norm without mean or bias, computed in fp32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (xf * self.weight.float()).to(x.dtype)


class T5Attention(nn.Module):
    def __init__(self, d_model: int, d_kv: int, heads: int, has_relative_bias: bool,
                 num_buckets: int = 32, max_distance: int = 128):
        super().__init__()
        inner = heads * d_kv
        self.heads, self.d_kv = heads, d_kv
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.q = nn.Linear(d_model, inner, bias=False)
        self.k = nn.Linear(d_model, inner, bias=False)
        self.v = nn.Linear(d_model, inner, bias=False)
        self.o = nn.Linear(inner, d_model, bias=False)
        self.relative_attention_bias = (nn.Embedding(num_buckets, heads)
                                        if has_relative_bias else None)

    def position_bias(self, s: int, device) -> torch.Tensor:
        """(1, heads, s, s) bias of key j for query i, fp32."""
        pos = np.arange(s)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None], self.num_buckets,
                                           self.max_distance)
        bias = self.relative_attention_bias(torch.from_numpy(buckets).to(device))
        return bias.permute(2, 0, 1)[None].float()

    def forward(self, x, mask_bias, position_bias):
        b, s, _ = x.shape
        split = lambda t: t.unflatten(-1, (self.heads, self.d_kv)).transpose(1, 2)
        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        if self.relative_attention_bias is not None:
            position_bias = self.position_bias(s, x.device)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) + position_bias
        if mask_bias is not None:
            scores = scores + mask_bias
        out = torch.matmul(torch.softmax(scores, dim=-1).to(v.dtype), v)
        return self.o(out.transpose(1, 2).reshape(b, s, -1)), position_bias


class _SelfAttentionLayer(nn.Module):
    def __init__(self, d_model: int, d_kv: int, heads: int, has_relative_bias: bool,
                 eps: float):
        super().__init__()
        self.SelfAttention = T5Attention(d_model, d_kv, heads, has_relative_bias)
        self.layer_norm = T5LayerNorm(d_model, eps)


class _GatedGelu(nn.Module):
    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.wi_0 = nn.Linear(d_model, d_ff, bias=False)
        self.wi_1 = nn.Linear(d_model, d_ff, bias=False)
        self.wo = nn.Linear(d_ff, d_model, bias=False)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class _FeedForwardLayer(nn.Module):
    def __init__(self, d_model: int, d_ff: int, eps: float):
        super().__init__()
        self.DenseReluDense = _GatedGelu(d_model, d_ff)
        self.layer_norm = T5LayerNorm(d_model, eps)


class T5Block(nn.Module):
    def __init__(self, d_model, d_kv, d_ff, heads, has_relative_bias, eps):
        super().__init__()
        self.layer = nn.ModuleList([
            _SelfAttentionLayer(d_model, d_kv, heads, has_relative_bias, eps),
            _FeedForwardLayer(d_model, d_ff, eps)])

    def forward(self, x, mask_bias, position_bias):
        attn, ff = self.layer
        out, position_bias = attn.SelfAttention(attn.layer_norm(x), mask_bias, position_bias)
        x = x + out
        return x + ff.DenseReluDense(ff.layer_norm(x)), position_bias


class _Stack(nn.Module):
    def __init__(self, num_layers, d_model, d_kv, d_ff, heads, eps):
        super().__init__()
        self.block = nn.ModuleList([T5Block(d_model, d_kv, d_ff, heads, i == 0, eps)
                                    for i in range(num_layers)])
        self.final_layer_norm = T5LayerNorm(d_model, eps)


class T5EncoderModel(nn.Module):
    """(B, L) token ids [+ (B, L) bool mask] -> (B, L, d_model) hidden states."""

    def __init__(self, vocab_size: int = 32128, d_model: int = 4096, d_kv: int = 64,
                 d_ff: int = 10240, num_layers: int = 24, num_heads: int = 64,
                 layer_norm_epsilon: float = 1e-6):
        super().__init__()
        self.shared = nn.Embedding(vocab_size, d_model)
        self.encoder = _Stack(num_layers, d_model, d_kv, d_ff, num_heads, layer_norm_epsilon)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.shared(input_ids)
        mask_bias = None
        if attention_mask is not None:
            mask_bias = torch.where(attention_mask.bool(), 0.0, -1e9)[:, None, None, :].to(
                device=x.device, dtype=torch.float32)
        position_bias = None
        for block in self.encoder.block:
            x, position_bias = block(x, mask_bias, position_bias)
        return self.encoder.final_layer_norm(x)
