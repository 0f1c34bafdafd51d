"""CLIP vision encoder with projection, in PyTorch.

Counterpart of trajectorycrafter_tpu/models/clip.py: the SVD shell's image
encoder, CLIP ViT-H/14 (1280 wide, 32 layers, 16 heads of 80, 257 tokens
at 224x224, projection 1024), which conditions the DepthCrafter UNet on
one embedding per frame.  Pixels enter channel-last (B, H, W, 3), already
normalised with the OpenAI statistics.  Layer norms run in fp32; the
attention is a plain matmul / fp32 softmax in the module, as in the JAX
package: head dim 80 is not one the flash kernel takes, and 257 tokens is
far below where a kernel pays.

Parameter names are transformers' ``CLIPVisionModelWithProjection``
(``utils/convert.py convert_clip_vision``).
"""

from __future__ import annotations

import torch
from torch import nn

from trajectorycrafter_tpu_torch.models.dit import layer_norm_f32

# image normalisation of the CLIP processor (OpenAI statistics)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


class CLIPAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads, self.head_dim = heads, hidden // heads
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x):
        b, s, c = x.shape
        split = lambda t: t.unflatten(-1, (self.heads, self.head_dim)).transpose(1, 2)
        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * self.head_dim ** -0.5
        out = torch.matmul(torch.softmax(scores, dim=-1).to(v.dtype), v)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, c))


class CLIPMLP(nn.Module):
    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden, intermediate)
        self.fc2 = nn.Linear(intermediate, hidden)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(torch.sigmoid(1.702 * h) * h)  # quick-gelu


class CLIPEncoderLayer(nn.Module):
    def __init__(self, hidden: int, intermediate: int, heads: int, eps: float):
        super().__init__()
        self.self_attn = CLIPAttention(hidden, heads)
        self.layer_norm1 = nn.LayerNorm(hidden, eps=eps)
        self.mlp = CLIPMLP(hidden, intermediate)
        self.layer_norm2 = nn.LayerNorm(hidden, eps=eps)

    def forward(self, x):
        x = x + self.self_attn(layer_norm_f32(self.layer_norm1, x))
        return x + self.mlp(layer_norm_f32(self.layer_norm2, x))


class _Embeddings(nn.Module):
    def __init__(self, hidden: int, image_size: int, patch_size: int):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.empty(hidden))
        self.patch_embedding = nn.Conv2d(3, hidden, patch_size, stride=patch_size, bias=False)
        self.position_embedding = nn.Embedding((image_size // patch_size) ** 2 + 1, hidden)


class _Encoder(nn.Module):
    def __init__(self, num_layers: int, *layer_args):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(*layer_args) for _ in range(num_layers)])


class _VisionTransformer(nn.Module):
    def __init__(self, hidden, intermediate, num_layers, heads, image_size, patch_size, eps):
        super().__init__()
        self.embeddings = _Embeddings(hidden, image_size, patch_size)
        self.pre_layrnorm = nn.LayerNorm(hidden, eps=eps)  # sic: the checkpoint's name
        self.encoder = _Encoder(num_layers, hidden, intermediate, heads, eps)
        self.post_layernorm = nn.LayerNorm(hidden, eps=eps)


class CLIPVisionModelWithProjection(nn.Module):
    """(B, H, W, 3) normalised pixels -> image embeddings (B, projection_dim)."""

    def __init__(self, hidden_size: int = 1280, intermediate_size: int = 5120,
                 num_hidden_layers: int = 32, num_attention_heads: int = 16,
                 image_size: int = 224, patch_size: int = 14, projection_dim: int = 1024,
                 layer_norm_eps: float = 1e-5):
        super().__init__()
        self.image_size = image_size
        self.vision_model = _VisionTransformer(hidden_size, intermediate_size,
                                               num_hidden_layers, num_attention_heads,
                                               image_size, patch_size, layer_norm_eps)
        self.visual_projection = nn.Linear(hidden_size, projection_dim, bias=False)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        vm = self.vision_model
        emb = vm.embeddings
        patches = emb.patch_embedding(pixels.permute(0, 3, 1, 2))  # (B, hidden, h, w)
        patches = patches.flatten(2).transpose(1, 2)
        cls = emb.class_embedding.expand(patches.shape[0], 1, -1)
        x = torch.cat([cls, patches], dim=1) + emb.position_embedding.weight[None]
        x = layer_norm_f32(vm.pre_layrnorm, x)
        for layer in vm.encoder.layers:
            x = layer(x)
        pooled = layer_norm_f32(vm.post_layernorm, x[:, 0])
        return self.visual_projection(pooled)
