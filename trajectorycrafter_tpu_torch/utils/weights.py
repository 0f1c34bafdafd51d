"""JAX parameter tree -> PyTorch state_dict, for the DiT and the VAE.

The inverse of trajectorycrafter_tpu/utils/convert.py ``convert_dit`` and
``convert_vae``: given the flax tree (numpy arrays), return a state_dict
under the reference checkpoint's names, which the port's modules keep, so
``module.load_state_dict(sd, strict=True)`` loads it and
``convert_dit(dit_from_jax(p)) == p``.  This module needs neither jax nor
flax: the tree is plain nested dicts of arrays.

Layout rules (the converter's, reversed):
  flax Dense kernel (in, out)            -> Linear weight (out, in)
  flax Conv kernel (kh, kw, I, O)        -> Conv2d weight (O, I, kh, kw)
  flax Conv kernel (kt, kh, kw, I, O)    -> Conv3d weight (O, I, kt, kh, kw)
  flax LayerNorm / GroupNorm scale, bias -> weight, bias
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

Tree = Mapping[str, Any]
StateDict = Dict[str, torch.Tensor]

_KERNEL_PERM = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a writable copy


def _put(sd: StateDict, prefix: str, leaf: Tree) -> None:
    """One Dense / Conv / norm leaf dict -> ``prefix.weight`` (+ ``.bias``)."""
    if "kernel" in leaf:
        kernel = np.asarray(leaf["kernel"])
        sd[prefix + ".weight"] = _tensor(np.transpose(kernel, _KERNEL_PERM[kernel.ndim]))
    if "scale" in leaf:
        sd[prefix + ".weight"] = _tensor(leaf["scale"])
    if "bias" in leaf:
        sd[prefix + ".bias"] = _tensor(leaf["bias"])


def _indexed(tree: Tree, stem: str):
    """Sorted (i, subtree) of the ``{stem}_{i}`` entries."""
    items = [(int(k[len(stem) + 1:]), v) for k, v in tree.items()
             if k.startswith(stem + "_") and k[len(stem) + 1:].isdigit()]
    return sorted(items, key=lambda kv: kv[0])


def dit_from_jax(params: Tree) -> StateDict:
    """CrossTransformer3D flax tree -> torch state_dict (reference names)."""
    sd: StateDict = {}
    top = {
        "patch_embed_proj": "patch_embed.proj",
        "patch_embed_text_proj": "patch_embed.text_proj",
        "ref_patch_embed_proj": "ref_patch_embed.proj",
        "time_embedding_linear_1": "time_embedding.linear_1",
        "time_embedding_linear_2": "time_embedding.linear_2",
        "norm_final": "norm_final",
        "norm_out_linear": "norm_out.linear",
        "norm_out_norm": "norm_out.norm",
        "proj_out": "proj_out",
    }
    for name, prefix in top.items():
        if name in params:
            _put(sd, prefix, params[name])
    for i, blk in _indexed(params, "blocks"):
        p = f"transformer_blocks.{i}"
        for norm in ("norm1", "norm2"):
            _put(sd, f"{p}.{norm}.linear", blk[norm]["linear"])
            _put(sd, f"{p}.{norm}.norm", blk[norm]["norm"])
        attn = blk["attn1"]
        for proj in ("to_q", "to_k", "to_v", "norm_q", "norm_k"):
            _put(sd, f"{p}.attn1.{proj}", attn[proj])
        _put(sd, f"{p}.attn1.to_out.0", attn["to_out"])
        _put(sd, f"{p}.ff.net.0.proj", blk["ff"]["proj_in"])
        _put(sd, f"{p}.ff.net.2", blk["ff"]["proj_out"])
    for i, pca in _indexed(params, "perceiver_cross_attention"):
        for name in ("norm1", "norm2", "to_q", "to_kv", "to_out"):
            _put(sd, f"perceiver_cross_attention.{i}.{name}", pca[name])
    return sd


def _causal_conv(sd: StateDict, prefix: str, tree: Tree) -> None:
    _put(sd, prefix + ".conv", tree["conv"])


def _resnet(sd: StateDict, prefix: str, tree: Tree) -> None:
    for conv in ("conv1", "conv2"):
        _causal_conv(sd, f"{prefix}.{conv}", tree[conv])
    for norm in ("norm1", "norm2"):
        sub = tree[norm]
        if "norm_layer" in sub:  # SpatialNorm3D (decoder)
            _put(sd, f"{prefix}.{norm}.norm_layer", sub["norm_layer"])
            _causal_conv(sd, f"{prefix}.{norm}.conv_y", sub["conv_y"])
            _causal_conv(sd, f"{prefix}.{norm}.conv_b", sub["conv_b"])
        else:
            _put(sd, f"{prefix}.{norm}", sub)
    if "conv_shortcut" in tree:
        _put(sd, prefix + ".conv_shortcut", tree["conv_shortcut"])


def vae_from_jax(params: Tree) -> StateDict:
    """AutoencoderKLCogVideoX flax tree -> torch state_dict (reference names)."""
    sd: StateDict = {}
    enc, dec = params["encoder"], params["decoder"]
    _causal_conv(sd, "encoder.conv_in", enc["conv_in"])
    for i, blk in _indexed(enc, "down_blocks"):
        for j, res in _indexed(blk, "resnets"):
            _resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}", res)
        if "downsamplers_0" in blk:
            _put(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv",
                 blk["downsamplers_0"]["conv"])
    for j, res in _indexed(enc["mid_block"], "resnets"):
        _resnet(sd, f"encoder.mid_block.resnets.{j}", res)
    _put(sd, "encoder.norm_out", enc["norm_out"])
    _causal_conv(sd, "encoder.conv_out", enc["conv_out"])

    _causal_conv(sd, "decoder.conv_in", dec["conv_in"])
    for j, res in _indexed(dec["mid_block"], "resnets"):
        _resnet(sd, f"decoder.mid_block.resnets.{j}", res)
    for i, blk in _indexed(dec, "up_blocks"):
        for j, res in _indexed(blk, "resnets"):
            _resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}", res)
        if "upsamplers_0" in blk:
            _put(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv", blk["upsamplers_0"]["conv"])
    norm_out = dec["norm_out"]
    _put(sd, "decoder.norm_out.norm_layer", norm_out["norm_layer"])
    _causal_conv(sd, "decoder.norm_out.conv_y", norm_out["conv_y"])
    _causal_conv(sd, "decoder.norm_out.conv_b", norm_out["conv_b"])
    _causal_conv(sd, "decoder.conv_out", dec["conv_out"])
    return sd
