"""The DiT's weights, made by the benchmark from ``--seed``.

Each unit of the model (the embeddings, each block, each Perceiver, the
output head) is one bf16 draw of N(0, std^2) on the device, from a generator
seeded by the run's seed and the unit's name, split into the unit's
parameters in the order of ``unit_specs``.  Layer-norm scales are 1 plus
that draw.  The program is handed these tensors as if loaded from a
checkpoint, and the reference draws the same ones again, one unit at a time,
after the window.  Names are the reference checkpoint's state-dict keys.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import torch


def subseed(seed: int, *tags) -> int:
    """A 63-bit seed for ``tags`` under the run's ``seed``."""
    text = ":".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") & (2 ** 63 - 1)


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, *tags))


def _linear(prefix: str, n: int, k: int, bias: bool = True) -> List[Tuple[str, tuple]]:
    return [(f"{prefix}.weight", (n, k))] + ([(f"{prefix}.bias", (n,))] if bias else [])


def _norm(prefix: str, dim: int) -> List[Tuple[str, tuple]]:
    return [(f"{prefix}.weight", (dim,)), (f"{prefix}.bias", (dim,))]


def unit_specs(cfg: dict) -> Dict[str, List[Tuple[str, tuple]]]:
    """{unit name: [(parameter name, shape)]} of the whole DiT, in order."""
    dim = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    hd, temb, p = cfg["attention_head_dim"], cfg["time_embed_dim"], cfg["patch_size"]
    ff = dim * cfg["ff_mult"]
    cross = cfg["cross_attn_num_heads"] * cfg["cross_attn_dim_head"]
    out = cfg["out_channels"]
    units = {
        "patch_embed": [("proj.weight", (dim, cfg["in_channels"], p, p)), ("proj.bias", (dim,)),
                        *_linear("text_proj", dim, cfg["text_embed_dim"])],
        "ref_patch_embed": [("proj.weight", (dim, out, p, p)), ("proj.bias", (dim,))],
        "time_embedding": [*_linear("linear_1", temb, dim), *_linear("linear_2", temb, temb)],
    }
    for i in range(cfg["num_layers"]):
        units[f"transformer_blocks.{i}"] = [
            *_linear("norm1.linear", 6 * dim, temb), *_norm("norm1.norm", dim),
            *_linear("attn1.to_q", dim, dim), *_linear("attn1.to_k", dim, dim),
            *_linear("attn1.to_v", dim, dim), *_norm("attn1.norm_q", hd),
            *_norm("attn1.norm_k", hd), *_linear("attn1.to_out.0", dim, dim),
            *_linear("norm2.linear", 6 * dim, temb), *_norm("norm2.norm", dim),
            *_linear("ff.net.0.proj", ff, dim), *_linear("ff.net.2", dim, ff),
        ]
    for j in range(len(range(0, cfg["num_layers"], cfg["cross_attn_interval"]))):
        units[f"perceiver_cross_attention.{j}"] = [
            *_norm("norm1", dim), *_norm("norm2", dim), *_linear("to_q", cross, dim, False),
            *_linear("to_kv", 2 * cross, dim, False), *_linear("to_out", dim, cross, False),
        ]
    units["norm_final"] = _norm("", dim)
    units["norm_out"] = [*_linear("linear", 2 * dim, temb), *_norm("norm", dim)]
    units["proj_out"] = _linear("", p * p * out, dim)
    return {unit: [(name.lstrip("."), shape) for name, shape in params]
            for unit, params in units.items()}


def _is_ln_scale(unit: str, name: str) -> bool:
    if unit.startswith("transformer_blocks."):
        return name in ("norm1.norm.weight", "norm2.norm.weight", "attn1.norm_q.weight",
                        "attn1.norm_k.weight")
    if unit.startswith("perceiver_cross_attention."):
        return name in ("norm1.weight", "norm2.weight")
    return (unit, name) in (("norm_final", "weight"), ("norm_out", "norm.weight"))


@torch.no_grad()
def draw_unit(cfg: dict, unit: str, seed: int, device) -> Dict[str, torch.Tensor]:
    """The bf16 parameters of ``unit``: one draw of N(0, std^2), layer-norm
    scales shifted to 1 + the draw."""
    params = unit_specs(cfg)[unit]
    sizes = [int(torch.Size(shape).numel()) for _, shape in params]
    flat = torch.randn(sum(sizes), generator=generator(device, seed, "weights", unit),
                       device=device, dtype=torch.bfloat16).mul_(cfg["weight_std"])
    out = {}
    for (name, shape), chunk in zip(params, flat.split(sizes)):
        t = chunk.view(shape)
        out[name] = t.add_(1.0) if _is_ln_scale(unit, name) else t
    return out
