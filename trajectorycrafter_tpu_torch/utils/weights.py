"""JAX parameter tree -> PyTorch state_dict, for every model the port runs.

The inverses of trajectorycrafter_tpu/utils/convert.py ``convert_dit``,
``convert_vae``, ``convert_svd_unet``, ``convert_svd_vae``,
``convert_clip_vision``, ``convert_t5_encoder`` and
``convert_vda_official``: given the flax tree
(numpy arrays), return a state_dict under the reference checkpoint's names,
which the port's modules keep, so ``module.load_state_dict(sd, strict=True)``
loads it and ``convert_dit(dit_from_jax(p)) == p`` (and likewise for each).  This module needs neither jax nor
flax: the tree is plain nested dicts of arrays.

Layout rules (the converter's, reversed):
  flax Dense kernel (in, out)            -> Linear weight (out, in)
  int8 Dense kernel_q (in, out), scale   -> Int8Linear weight_q (out, in), weight_scale
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
    """One Dense / Conv / norm leaf dict -> ``prefix.weight`` (+ ``.bias``);
    an int8 Dense leaf {kernel_q (in, out), scale[, bias]} -> ``Int8Linear``'s
    ``prefix.weight_q`` (out, in), ``.weight_scale`` (+ ``.bias``).  The int8
    leaf is tested first: its ``scale`` is not a norm's."""
    if "kernel_q" in leaf:
        sd[prefix + ".weight_q"] = _tensor(np.asarray(leaf["kernel_q"]).T)
        sd[prefix + ".weight_scale"] = _tensor(leaf["scale"])
        if "bias" in leaf:
            sd[prefix + ".bias"] = _tensor(leaf["bias"])
        return
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


# ----------------------------------------------------------------------------
# the depth stack (inverses of convert_svd_unet, convert_svd_vae,
# convert_clip_vision) and the T5 encoder (of convert_t5_encoder)
# ----------------------------------------------------------------------------


def _put_each(sd: StateDict, prefix: str, tree: Tree, names) -> None:
    for name in names:
        if name in tree:
            _put(sd, f"{prefix}.{name}", tree[name])


def _res(sd: StateDict, prefix: str, tree: Tree) -> None:
    """A spatial or temporal resnet: the converter's ``_res2d`` / ``_res_temporal``."""
    _put_each(sd, prefix, tree, ("norm1", "norm2", "conv1", "conv2", "time_emb_proj",
                                 "conv_shortcut"))


def _mixer(sd: StateDict, prefix: str, tree: Tree) -> None:
    sd[prefix + ".time_mixer.mix_factor"] = _tensor(tree["time_mixer"]["mix_factor"])


def _st_resblock(sd: StateDict, prefix: str, tree: Tree) -> None:
    _res(sd, prefix + ".spatial_res_block", tree["spatial_res_block"])
    _res(sd, prefix + ".temporal_res_block", tree["temporal_res_block"])
    _mixer(sd, prefix, tree)


def _attention(sd: StateDict, prefix: str, tree: Tree) -> None:
    _put_each(sd, prefix, tree, ("group_norm", "to_q", "to_k", "to_v"))
    _put(sd, prefix + ".to_out.0", tree["to_out"])


def _feed_forward(sd: StateDict, prefix: str, tree: Tree) -> None:
    _put(sd, prefix + ".net.0.proj", tree["proj_in"])
    _put(sd, prefix + ".net.2", tree["proj_out"])


def _st_transformer(sd: StateDict, prefix: str, tree: Tree) -> None:
    _put_each(sd, prefix, tree, ("norm", "proj_in", "proj_out"))
    _put(sd, prefix + ".time_pos_embed.linear_1", tree["time_pos_embed_linear_1"])
    _put(sd, prefix + ".time_pos_embed.linear_2", tree["time_pos_embed_linear_2"])
    _mixer(sd, prefix, tree)
    for kind in ("transformer_blocks", "temporal_transformer_blocks"):
        for i, blk in _indexed(tree, kind):
            p = f"{prefix}.{kind}.{i}"
            _put_each(sd, p, blk, ("norm_in", "norm1", "norm2", "norm3"))
            _attention(sd, p + ".attn1", blk["attn1"])
            _attention(sd, p + ".attn2", blk["attn2"])
            _feed_forward(sd, p + ".ff", blk["ff"])
            if "ff_in" in blk:
                _feed_forward(sd, p + ".ff_in", blk["ff_in"])


def _levels(sd: StateDict, params: Tree, prefix: str, res, attn) -> None:
    """``{down,up}_{i}_{res,attn}_{j}`` and ``{down,up}_{i}_{down,up}sample``
    entries -> ``{prefix}{down,up}_blocks.{i}.{resnets,attentions}.{j}`` and
    ``...{down,up}samplers.0.conv``."""
    for key, tree in params.items():
        parts = key.split("_")
        if parts[0] not in ("down", "up") or not parts[1].isdigit():
            continue
        level = f"{prefix}{parts[0]}_blocks.{parts[1]}"
        if parts[2] == "res":
            res(sd, f"{level}.resnets.{parts[3]}", tree)
        elif parts[2] == "attn":
            attn(sd, f"{level}.attentions.{parts[3]}", tree)
        else:  # downsample / upsample
            _put(sd, f"{level}.{parts[2]}rs.0.conv", tree)


def svd_unet_from_jax(params: Tree) -> StateDict:
    """UNetSpatioTemporalConditionModel flax tree -> torch state_dict."""
    sd: StateDict = {}
    for name in ("conv_in", "conv_out", "conv_norm_out"):
        _put(sd, name, params[name])
    for name in ("time_embedding", "add_embedding"):
        for layer in ("linear_1", "linear_2"):
            _put(sd, f"{name}.{layer}", params[f"{name}_{layer}"])
    _levels(sd, params, "", _st_resblock, _st_transformer)
    _st_resblock(sd, "mid_block.resnets.0", params["mid_res_0"])
    _st_resblock(sd, "mid_block.resnets.1", params["mid_res_1"])
    _st_transformer(sd, "mid_block.attentions.0", params["mid_attn"])
    return sd


def svd_vae_from_jax(params: Tree) -> StateDict:
    """AutoencoderKLTemporalDecoder flax tree -> torch state_dict."""
    sd: StateDict = {}
    enc, dec = params["encoder"], params["decoder"]
    _put(sd, "quant_conv", enc["quant_conv"])
    for part, tree, mid_res in (("encoder", enc, _res), ("decoder", dec, _st_resblock)):
        _put_each(sd, part, tree, ("conv_in", "conv_out", "conv_norm_out", "time_conv_out"))
        mid_res(sd, f"{part}.mid_block.resnets.0", tree["mid_res_0"])
        mid_res(sd, f"{part}.mid_block.resnets.1", tree["mid_res_1"])
        _attention(sd, f"{part}.mid_block.attentions.0", tree["mid_attn"])
        _levels(sd, tree, part + ".", mid_res, None)
    return sd


def clip_from_jax(params: Tree) -> StateDict:
    """CLIPVisionModelWithProjection flax tree -> torch state_dict."""
    v = "vision_model."
    sd: StateDict = {
        v + "embeddings.class_embedding": _tensor(params["class_embedding"]),
        v + "embeddings.position_embedding.weight": _tensor(params["position_embedding"]),
    }
    _put(sd, v + "embeddings.patch_embedding", params["patch_embedding"])
    _put(sd, v + "pre_layrnorm", params["pre_layrnorm"])
    _put(sd, v + "post_layernorm", params["post_layernorm"])
    _put(sd, "visual_projection", params["visual_projection"])
    for i, layer in _indexed(params, "layers"):
        p = f"{v}encoder.layers.{i}"
        _put_each(sd, p, layer, ("layer_norm1", "layer_norm2"))
        _put_each(sd, p + ".self_attn", layer["self_attn"],
                  ("q_proj", "k_proj", "v_proj", "out_proj"))
        _put_each(sd, p + ".mlp", layer["mlp"], ("fc1", "fc2"))
    return sd


def t5_from_jax(params: Tree) -> StateDict:
    """T5EncoderModel flax tree -> torch state_dict."""
    sd: StateDict = {
        "shared.weight": _tensor(params["shared_embedding"]),
        "encoder.final_layer_norm.weight": _tensor(params["final_layer_norm"]["weight"]),
    }
    for i, blk in _indexed(params, "block"):
        p = f"encoder.block.{i}.layer"
        attn = blk["attention"]
        _put_each(sd, f"{p}.0.SelfAttention", attn, ("q", "k", "v", "o"))
        if "relative_attention_bias" in attn:
            sd[f"{p}.0.SelfAttention.relative_attention_bias.weight"] = _tensor(
                attn["relative_attention_bias"])
        sd[f"{p}.0.layer_norm.weight"] = _tensor(blk["attn_layer_norm"]["weight"])
        sd[f"{p}.1.layer_norm.weight"] = _tensor(blk["ff_layer_norm"]["weight"])
        _put_each(sd, f"{p}.1.DenseReluDense", blk, ("wi_0", "wi_1", "wo"))
    return sd


def vda_from_jax(params: Tree, reassemble_factors=(4.0, 2.0, 1.0, 0.5)) -> StateDict:
    """VideoDepthAnything flax tree -> the official checkpoint's state_dict
    (``video_depth_anything_*.pth``): q/k/v re-fused into ``attn.qkv``, the
    ConvTranspose kernels flipped back, the deepest refinenet's unused
    ``resConfUnit1`` zeros, and the keys the converter consumes and drops
    filled in by ``checkpoints.vda_official_state_dict``.
    ``reassemble_factors`` tells the up-sampling ConvTranspose from the
    stride-2 conv, which the tree does not."""
    from trajectorycrafter_tpu_torch.utils.checkpoints import vda_official_state_dict

    bb, head = params["backbone"], params["head"]
    sd: StateDict = {
        "pretrained.cls_token": _tensor(bb["cls_token"]),
        "pretrained.pos_embed": _tensor(bb["position_embeddings"]),
    }
    _put(sd, "pretrained.patch_embed.proj", bb["patch_embeddings"])
    _put(sd, "pretrained.norm", bb["layernorm"])
    for i, layer in _indexed(bb, "layer"):
        p = f"pretrained.blocks.{i}"
        attn = layer["attention"]
        qkv = [attn[n] for n in ("query", "key", "value")]
        sd[p + ".attn.qkv.weight"] = _tensor(np.concatenate(
            [np.asarray(x["kernel"]).T for x in qkv]))
        sd[p + ".attn.qkv.bias"] = _tensor(np.concatenate([np.asarray(x["bias"]) for x in qkv]))
        _put(sd, p + ".attn.proj", attn["out"])
        _put_each(sd, p, layer, ("norm1", "norm2"))
        _put_each(sd, p + ".mlp", layer["mlp"], ("fc1", "fc2"))
        sd[p + ".ls1.gamma"] = _tensor(layer["layer_scale1"])
        sd[p + ".ls2.gamma"] = _tensor(layer["layer_scale2"])

    n = len(reassemble_factors)
    for i, factor in enumerate(reassemble_factors):
        _put(sd, f"head.projects.{i}", head[f"reassemble_{i}_projection"])
        if factor > 1:
            tr = head[f"reassemble_{i}_resize"]
            sd[f"head.resize_layers.{i}.weight"] = _tensor(np.transpose(
                np.asarray(tr["kernel"])[::-1, ::-1], (2, 3, 0, 1)))
            sd[f"head.resize_layers.{i}.bias"] = _tensor(tr["bias"])
        elif factor < 1:
            _put(sd, f"head.resize_layers.{i}", head[f"reassemble_{i}_resize"])
        _put(sd, f"head.scratch.layer{i + 1}_rn", head[f"neck_conv_{i}"])
    for i in range(n):
        fusion, p = head[f"fusion_{i}"], f"head.scratch.refinenet{n - i}"
        _put(sd, p + ".out_conv", fusion["projection"])
        for unit, name in (("resConfUnit1", "residual_layer1"),
                           ("resConfUnit2", "residual_layer2")):
            res = fusion.get(name, fusion["residual_layer2"])
            for conv in ("conv1", "conv2"):
                _put(sd, f"{p}.{unit}.{conv}", res[conv.replace("conv", "convolution")])
                if name not in fusion:  # the deepest stage's unused unit
                    for key in ("weight", "bias"):
                        sd[f"{p}.{unit}.{conv}.{key}"].zero_()
    _put(sd, "head.scratch.output_conv1", head["head_conv1"])
    _put(sd, "head.scratch.output_conv2.0", head["head_conv2"])
    _put(sd, "head.scratch.output_conv2.2", head["head_conv3"])
    for i, tm in _indexed(head, "temporal"):
        tt = f"head.motion_modules.{i}.temporal_transformer"
        _put_each(sd, tt, tm, ("norm", "proj_in", "proj_out"))
        blk, block = f"{tt}.transformer_blocks.0", tm["blocks_0"]
        for k, attn in _indexed(block, "attention_blocks"):
            a = f"{blk}.attention_blocks.{k}"
            _put_each(sd, a, attn, ("to_q", "to_k", "to_v"))
            _put(sd, a + ".to_out.0", attn["to_out"])
            _put(sd, f"{blk}.norms.{k}", block[f"norms_{k}"])
        _put(sd, blk + ".ff.net.0.proj", block["ff_proj"])
        _put(sd, blk + ".ff.net.2", block["ff_out"])
        _put(sd, blk + ".ff_norm", block["ff_norm"])
    return vda_official_state_dict(sd)
