"""Checkpoint loading: HF-layout safetensors directories -> the port's modules.

Counterpart of trajectorycrafter_tpu/utils/checkpoints.py and of the parts
of trajectorycrafter_tpu/utils/convert.py that loading uses: the port's
modules carry the checkpoints' own parameter names, so a checkpoint loads
without conversion.  Every module is built on the ``meta`` device (no
memory), each tensor is read from its file straight onto the target device
and cast there one at a time, and ``load_state_dict(strict=True,
assign=True)`` adopts the tensors: no second copy of a model is made.

Key contracts:
  * the DiT and the CogVideoX VAE are held to ``expected_dit_keys`` /
    ``expected_vae_keys`` by ``verify_state_dict``: a key missing or a key
    too many fails with its message before anything is loaded;
  * T5, the SVD UNet, the SVD VAE, CLIP and BLIP-2 read exactly the keys
    of their module (the keys the JAX package's converters read): a missing
    one fails, any other key in the files is skipped as the converters skip
    it -- a tied ``encoder.embed_tokens.weight`` or
    ``language_model.lm_head.weight``, a ``.position_ids`` buffer.

Under ``--quant int8`` the layers that ``ops/int8.py`` quantizes are built
as ``Int8Linear`` on ``meta`` and each one's weight is quantized from the
file's own values as it is read (the JAX loaders quantize the converted
host tree before they cast it), so the bf16 weight of such a layer never
reaches the card.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Callable, Dict, Optional, Set

import torch
from torch import nn

from trajectorycrafter_tpu_torch.ops.int8 import (
    Int8Linear,
    quantize_dense,
    quantize_depth_unet_,
    quantize_dit_,
)

LOG = "[trajcrafter-torch]"


# ----------------------------------------------------------------------------
# key contracts (copies of the JAX package's utils/convert.py)
# ----------------------------------------------------------------------------


def _wb(prefix: str) -> list:
    return [prefix + ".weight", prefix + ".bias"]


def expected_dit_keys(num_layers: int = 42, cross_attn_interval: int = 2,
                      has_ref_branch: bool = True, attention_bias: bool = True) -> set:
    """The TrajectoryCrafter CrossTransformer3D checkpoint's keys: patch_embed
    (proj conv, text_proj), ref_patch_embed, time_embedding, the CogVideoX
    blocks (norm1/norm2 linear + norm, attn1 q/k/v [bias], to_out.0,
    norm_q/norm_k, ff net.0.proj / net.2), norm_final, norm_out, proj_out,
    and with the reference branch a Perceiver every ``cross_attn_interval``
    blocks (norm1/norm2, bias-free to_q/to_kv/to_out).  ``pos_embedding`` is
    a non-persistent buffer and not in the checkpoint."""
    keys: list = []
    keys += _wb("patch_embed.proj") + _wb("patch_embed.text_proj")
    if has_ref_branch:
        keys += _wb("ref_patch_embed.proj")
    keys += _wb("time_embedding.linear_1") + _wb("time_embedding.linear_2")
    keys += _wb("norm_final") + _wb("norm_out.linear") + _wb("norm_out.norm")
    keys += _wb("proj_out")
    for i in range(num_layers):
        p = f"transformer_blocks.{i}"
        keys += _wb(f"{p}.norm1.linear") + _wb(f"{p}.norm1.norm")
        keys += _wb(f"{p}.norm2.linear") + _wb(f"{p}.norm2.norm")
        for proj in ("to_q", "to_k", "to_v"):
            keys.append(f"{p}.attn1.{proj}.weight")
            if attention_bias:
                keys.append(f"{p}.attn1.{proj}.bias")
        keys += _wb(f"{p}.attn1.to_out.0")
        keys += _wb(f"{p}.attn1.norm_q") + _wb(f"{p}.attn1.norm_k")
        keys += _wb(f"{p}.ff.net.0.proj") + _wb(f"{p}.ff.net.2")
    if has_ref_branch:
        for i in range(num_layers // cross_attn_interval):
            p = f"perceiver_cross_attention.{i}"
            keys += _wb(f"{p}.norm1") + _wb(f"{p}.norm2")
            keys += [f"{p}.to_q.weight", f"{p}.to_kv.weight", f"{p}.to_out.weight"]
    return set(keys)


def expected_vae_keys(block_out_channels=(128, 256, 256, 512), layers_per_block: int = 3) -> set:
    """The CogVideoX-Fun 3D VAE checkpoint's keys: causal convs at ``.conv``,
    GroupNorm resnets in the encoder and SpatialNorm3D (norm_layer, conv_y,
    conv_b) ones in the decoder, a 1x1x1 ``conv_shortcut`` where the channels
    change, 2-D down/upsampler convs on all but the last block, no
    quant_conv / post_quant_conv and no temb_proj."""
    def causal(prefix):
        return _wb(prefix + ".conv")

    def spatial_norm(prefix):
        return _wb(prefix + ".norm_layer") + causal(prefix + ".conv_y") + causal(prefix + ".conv_b")

    def resnet(prefix, spatial: bool, shortcut: bool):
        keys = causal(prefix + ".conv1") + causal(prefix + ".conv2")
        if spatial:
            keys += spatial_norm(prefix + ".norm1") + spatial_norm(prefix + ".norm2")
        else:
            keys += _wb(prefix + ".norm1") + _wb(prefix + ".norm2")
        if shortcut:
            keys += _wb(prefix + ".conv_shortcut")
        return keys

    n = len(block_out_channels)
    keys: list = causal("encoder.conv_in")
    ch = block_out_channels[0]
    for i in range(n):
        for j in range(layers_per_block):
            shortcut = j == 0 and block_out_channels[i] != ch
            keys += resnet(f"encoder.down_blocks.{i}.resnets.{j}", False, shortcut)
        ch = block_out_channels[i]
        if i < n - 1:
            keys += _wb(f"encoder.down_blocks.{i}.downsamplers.0.conv")
    for j in range(2):
        keys += resnet(f"encoder.mid_block.resnets.{j}", False, False)
    keys += _wb("encoder.norm_out") + causal("encoder.conv_out")
    rev = tuple(reversed(block_out_channels))
    keys += causal("decoder.conv_in")
    for j in range(2):
        keys += resnet(f"decoder.mid_block.resnets.{j}", True, False)
    ch = rev[0]
    for i in range(n):
        for j in range(layers_per_block + 1):
            shortcut = j == 0 and rev[i] != ch
            keys += resnet(f"decoder.up_blocks.{i}.resnets.{j}", True, shortcut)
        ch = rev[i]
        if i < n - 1:
            keys += _wb(f"decoder.up_blocks.{i}.upsamplers.0.conv")
    keys += spatial_norm("decoder.norm_out") + causal("decoder.conv_out")
    return set(keys)


def expected_vda_official_keys(num_layers: int = 24,
                               reassemble_factors=(4.0, 2.0, 1.0, 0.5),
                               num_temporal_blocks: int = 4,
                               num_attention_blocks: int = 2) -> set:
    """The official ``video_depth_anything_*.pth``'s keys: the torchhub
    DINOv2 backbone (``pretrained``: fused ``attn.qkv``, ``ls1.gamma``,
    ``mask_token``), the MiDaS-scratch DPT head (``projects``,
    ``resize_layers`` where the factor is not 1, ``scratch.layerN_rn``,
    ``scratch.refinenetN``, ``output_conv1``, ``output_conv2.0`` / ``.2``)
    and the AnimateDiff motion modules (one transformer block of two
    temporal attentions with a ``pos_encoder.pe`` buffer each, a GEGLU
    feed-forward)."""
    keys: list = ["pretrained.cls_token", "pretrained.pos_embed", "pretrained.mask_token"]
    keys += _wb("pretrained.patch_embed.proj") + _wb("pretrained.norm")
    for i in range(num_layers):
        p = f"pretrained.blocks.{i}"
        keys += _wb(p + ".norm1") + _wb(p + ".norm2")
        keys += _wb(p + ".attn.qkv") + _wb(p + ".attn.proj")
        keys += _wb(p + ".mlp.fc1") + _wb(p + ".mlp.fc2")
        keys += [p + ".ls1.gamma", p + ".ls2.gamma"]
    n = len(reassemble_factors)
    for i, factor in enumerate(reassemble_factors):
        keys += _wb(f"head.projects.{i}")
        if factor != 1:
            keys += _wb(f"head.resize_layers.{i}")
        keys.append(f"head.scratch.layer{i + 1}_rn.weight")
    for i in range(1, n + 1):
        p = f"head.scratch.refinenet{i}"
        keys += _wb(p + ".out_conv")
        for r in ("resConfUnit1", "resConfUnit2"):
            keys += _wb(f"{p}.{r}.conv1") + _wb(f"{p}.{r}.conv2")
    keys += _wb("head.scratch.output_conv1")
    keys += _wb("head.scratch.output_conv2.0") + _wb("head.scratch.output_conv2.2")
    for i in range(num_temporal_blocks):
        tt = f"head.motion_modules.{i}.temporal_transformer"
        keys += _wb(tt + ".norm") + _wb(tt + ".proj_in") + _wb(tt + ".proj_out")
        blk = f"{tt}.transformer_blocks.0"
        for k in range(num_attention_blocks):
            a = f"{blk}.attention_blocks.{k}"
            keys += [a + ".to_q.weight", a + ".to_k.weight", a + ".to_v.weight",
                     a + ".pos_encoder.pe"]
            keys += _wb(a + ".to_out.0") + _wb(f"{blk}.norms.{k}")
        keys += _wb(blk + ".ff.net.0.proj") + _wb(blk + ".ff.net.2") + _wb(blk + ".ff_norm")
    return set(keys)


def verify_state_dict(sd, expected: set, label: str,
                      ignore_suffixes: tuple = (".position_ids",)) -> None:
    """Fail when a checkpoint's key set (``sd``: any iterable of keys) does
    not match the contract, naming what is missing and what is too many."""
    present = {k for k in sd if not k.endswith(ignore_suffixes)}
    missing = sorted(expected - present)
    unexpected = sorted(present - expected)
    if missing or unexpected:
        def _fmt(keys):
            head = ", ".join(keys[:8])
            return f"{len(keys)} keys ({head}{', ...' if len(keys) > 8 else ''})"

        raise ValueError(
            f"{label}: checkpoint key set does not match the expected "
            f"{label} contract. Missing: {_fmt(missing) if missing else 'none'}. "
            f"Unexpected: {_fmt(unexpected) if unexpected else 'none'}. "
            "Check that the directory holds the right model family "
            "(see SURVEY.md section 1 zoo table) and matches config.json."
        )


def adapt_patch_embed_in_channels(weight: torch.Tensor, target_in: int) -> torch.Tensor:
    """The shape-adaptive patch-embed load: a (O, I, kh, kw) conv weight with
    fewer input channels than the model gets zero channels appended, one
    with more is cropped (dim 1)."""
    cin = weight.shape[1]
    if cin == target_in:
        return weight
    if cin < target_in:
        pad = weight.new_zeros((weight.shape[0], target_in - cin, *weight.shape[2:]))
        return torch.cat([weight, pad], dim=1)
    return weight[:, :target_in].contiguous()


# ----------------------------------------------------------------------------
# reading a safetensors directory
# ----------------------------------------------------------------------------


def _safe_device(device) -> str:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def safetensors_index(path: str) -> Dict[str, str]:
    """{key: file} over every ``*.safetensors`` file in ``path``, in sorted
    order: a key in a later file wins, as ``dict.update`` over the files."""
    from safetensors import safe_open

    index: Dict[str, str] = {}
    for f in sorted(glob.glob(os.path.join(path, "*.safetensors"))):
        with safe_open(f, framework="pt") as handle:
            index.update({key: f for key in handle.keys()})
    return index


def iter_safetensors(index: Dict[str, str], device="cpu", keys: Optional[Set[str]] = None):
    """(key, tensor) of every entry of ``index`` (``safetensors_index``: a
    key in a later file wins, as in the JAX package's
    ``load_safetensors_dir``; only ``keys`` when given), each read straight
    onto ``device`` in the file's dtype."""
    from safetensors import safe_open

    by_file: Dict[str, list] = {}
    for key, f in index.items():
        if keys is None or key in keys:
            by_file.setdefault(f, []).append(key)
    for f, names in by_file.items():
        with safe_open(f, framework="pt", device=_safe_device(device)) as handle:
            for key in names:
                yield key, handle.get_tensor(key)


# ----------------------------------------------------------------------------
# loading a module
# ----------------------------------------------------------------------------


def _int8_prefixes(module: nn.Module) -> Set[str]:
    return {name for name, m in module.named_modules() if isinstance(m, Int8Linear)}


def checkpoint_keys(module: nn.Module) -> Set[str]:
    """The checkpoint keys ``module`` reads: its state_dict's, with an
    ``Int8Linear``'s ``weight_q`` / ``weight_scale`` read as the ``weight``
    they are quantized from."""
    int8 = _int8_prefixes(module)
    keys = set()
    for key in module.state_dict():
        prefix, _, leaf = key.rpartition(".")
        if prefix in int8 and leaf in ("weight_q", "weight_scale"):
            keys.add(prefix + ".weight")
        else:
            keys.add(key)
    return keys


def require_keys(present, needed: Set[str], label: str) -> None:
    """Fail as the JAX converters' ``KeyError`` does when a key the module
    reads is not in the checkpoint."""
    missing = sorted(needed - set(present))
    if missing:
        head = ", ".join(missing[:8])
        raise KeyError(f"{label}: the checkpoint lacks {len(missing)} keys the model reads "
                       f"({head}{', ...' if len(missing) > 8 else ''})")


def load_module(make: Callable[[], nn.Module], path: str, device, dtype: torch.dtype,
                label: str, contract: Optional[set] = None,
                quantize_: Optional[Callable[[nn.Module], nn.Module]] = None,
                adapt: Optional[Callable[[Dict[str, torch.Tensor]], None]] = None,
                stats: Optional[dict] = None,
                index: Optional[Dict[str, str]] = None) -> nn.Module:
    """``make()`` (quantized by ``quantize_`` when given) built on ``meta``
    and loaded from the safetensors files in ``path`` onto ``device``:
    floating tensors in ``dtype``, an int8 layer's codes and fp32 scales
    quantized from its weight as read.  ``contract``: the exact key set the
    files must hold (``verify_state_dict``); without one, the module's keys
    must be present and any other key is skipped.  ``adapt`` may rewrite the
    read tensors in place before they load.  ``stats`` (when given) gets
    ``{label: {"bytes", "seconds", "tensors"}}``.  ``index``: the
    ``safetensors_index(path)`` a caller has already read."""
    t0 = time.perf_counter()
    with torch.device("meta"):
        module = make()
        if quantize_ is not None:
            quantize_(module)
    needed = checkpoint_keys(module)
    if index is None:
        index = safetensors_index(path)
    if contract is not None:
        verify_state_dict(index, contract, label)
    require_keys(index, needed, label)
    int8 = _int8_prefixes(module)
    sd: Dict[str, torch.Tensor] = {}
    for key, t in iter_safetensors(index, device, needed):
        prefix = key[:-len(".weight")]
        if key.endswith(".weight") and prefix in int8:
            sd[prefix + ".weight_q"], sd[prefix + ".weight_scale"] = quantize_dense(t)
        else:
            sd[key] = t.to(dtype) if t.is_floating_point() else t
        del t
    if adapt is not None:
        adapt(sd)
    nbytes = sum(t.numel() * t.element_size() for t in sd.values())
    module.load_state_dict(sd, strict=True, assign=True)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(f"{LOG} loaded {label} from {path}: {len(sd)} tensors, {nbytes / 1e9:.2f} GB on "
          f"{device} in {seconds:.2f} s")
    if stats is not None:
        stats[label] = {"bytes": nbytes, "seconds": seconds, "tensors": len(sd)}
    return module.eval()


# ----------------------------------------------------------------------------
# the model families
# ----------------------------------------------------------------------------


def dit_kwargs_from_config(transformer_path: str, **model_kwargs) -> dict:
    """The DiT's constructor arguments from ``config.json`` (heads, head dim,
    layers, input channels, rotary, Perceiver interval and the optional
    widths), with the JAX loader's defaults; ``model_kwargs`` win."""
    hf = {}
    cfg_path = os.path.join(transformer_path, "config.json")
    if os.path.isfile(cfg_path):
        with open(cfg_path) as f:
            hf = json.load(f)
    kwargs = dict(model_kwargs)
    kwargs.setdefault("num_attention_heads", hf.get("num_attention_heads", 48))
    kwargs.setdefault("attention_head_dim", hf.get("attention_head_dim", 64))
    kwargs.setdefault("num_layers", hf.get("num_layers", 42))
    kwargs.setdefault("in_channels", hf.get("in_channels", 33))
    kwargs.setdefault("use_rotary_positional_embeddings",
                      hf.get("use_rotary_positional_embeddings", True))
    kwargs.setdefault("cross_attn_interval", hf.get("cross_attn_interval", 2))
    for opt in ("out_channels", "cross_attn_dim_head", "cross_attn_num_heads",
                "time_embed_dim", "text_embed_dim", "max_text_seq_length"):
        if opt in hf:
            kwargs.setdefault(opt, hf[opt])
    return kwargs


def load_dit(transformer_path: str, device="cuda", dtype=torch.bfloat16, quant: str = "none",
             stats: Optional[dict] = None, **model_kwargs) -> nn.Module:
    """The TrajectoryCrafter CrossTransformer3D from ``transformer_path``
    (``quant="int8"``: its blocks' and Perceivers' linears quantized as they
    load, ``quantize_dit_``).  A checkpoint without
    ``ref_patch_embed.proj.weight`` builds the model without its reference
    branch."""
    from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel

    kwargs = dit_kwargs_from_config(transformer_path, **model_kwargs)
    index = safetensors_index(transformer_path)
    has_ref = "ref_patch_embed.proj.weight" in index
    kwargs.setdefault("is_train_cross", has_ref)
    contract = expected_dit_keys(kwargs["num_layers"], kwargs["cross_attn_interval"],
                                 has_ref_branch=has_ref)

    def adapt(sd):
        sd["patch_embed.proj.weight"] = adapt_patch_embed_in_channels(
            sd["patch_embed.proj.weight"], kwargs["in_channels"])

    return load_module(lambda: CrossTransformer3DModel(**kwargs), transformer_path, device,
                       dtype, "dit", contract=contract,
                       quantize_=quantize_dit_ if quant == "int8" else None, adapt=adapt,
                       stats=stats, index=index)


def load_vae(vae_path: str, device="cuda", dtype=torch.bfloat16,
             stats: Optional[dict] = None) -> nn.Module:
    """The CogVideoX-Fun VAE (deployed architecture), held to ``expected_vae_keys``."""
    from trajectorycrafter_tpu_torch.models.vae import AutoencoderKLCogVideoX

    return load_module(AutoencoderKLCogVideoX, vae_path, device, dtype, "vae",
                       contract=expected_vae_keys(), stats=stats)


def load_t5(text_encoder_path: str, device="cuda", dtype=torch.bfloat16,
            stats: Optional[dict] = None) -> nn.Module:
    """The T5-XXL encoder (the architecture is fixed, as in the JAX package)."""
    from trajectorycrafter_tpu_torch.models.t5 import T5EncoderModel

    return load_module(T5EncoderModel, text_encoder_path, device, dtype, "t5", stats=stats)


def load_depthcrafter(cfg, device="cuda", dtype=torch.bfloat16,
                      stats: Optional[dict] = None) -> Callable:
    """The windowed depth callable (``DepthCrafterDemo.infer``): the
    DepthCrafter UNet from ``cfg.depth.unet_path`` (its transformers in int8
    under ``--quant_depth int8``), the SVD VAE from
    ``<pre_train_path>/vae``, and CLIP from ``<pre_train_path>/image_encoder``
    when that directory exists."""
    from trajectorycrafter_tpu_torch.models.clip import CLIPVisionModelWithProjection
    from trajectorycrafter_tpu_torch.models.depthcrafter import UNetSpatioTemporalConditionModel
    from trajectorycrafter_tpu_torch.models.svd_vae import AutoencoderKLTemporalDecoder
    from trajectorycrafter_tpu_torch.pipelines.depth import DepthCrafterDemo, DepthCrafterPipeline

    unet = load_module(UNetSpatioTemporalConditionModel, cfg.depth.unet_path, device, dtype,
                       "svd_unet",
                       quantize_=quantize_depth_unet_ if cfg.depth.quant == "int8" else None,
                       stats=stats)
    vae = load_module(AutoencoderKLTemporalDecoder,
                      os.path.join(cfg.depth.pre_train_path, "vae"), device, dtype, "svd_vae",
                      stats=stats)
    clip = None
    ie_path = os.path.join(cfg.depth.pre_train_path, "image_encoder")
    if os.path.isdir(ie_path):
        clip = load_module(CLIPVisionModelWithProjection, ie_path, device, dtype, "clip",
                           stats=stats)
    return DepthCrafterDemo(DepthCrafterPipeline(
        unet=unet, vae=vae, image_encoder=clip, dtype=dtype)).infer



# the tolerance of a checkpoint's ``pos_encoder.pe`` against the table the
# model computes: float32 sin / cos of arguments below ~50, by any library
PE_ATOL = 1e-4
# the length of each ``pos_encoder.pe`` buffer in the official checkpoints
VDA_PE_LENGTH = 32


def vda_module_state_dict(sd: Dict[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """An official VDA state dict held to ``expected_vda_official_keys`` for
    ``cfg`` (a key missing or a key too many fails), ``pretrained.mask_token``
    dropped (DINOv2's masking is not used) and each ``pos_encoder.pe`` held to
    ``sinusoidal_frame_encoding`` over its length, then dropped (the model
    computes the table for any frame count): the state dict of
    ``VideoDepthAnything(cfg)``."""
    from trajectorycrafter_tpu_torch.models.vda import sinusoidal_frame_encoding

    verify_state_dict(sd, expected_vda_official_keys(
        cfg.num_hidden_layers, cfg.reassemble_factors, cfg.num_temporal_blocks), "vda_official")
    out = {}
    for key, t in sd.items():
        if key == "pretrained.mask_token":
            continue
        if key.endswith(".pos_encoder.pe"):
            pe = t.detach().float().cpu().reshape(t.shape[-2], t.shape[-1])
            want = sinusoidal_frame_encoding(*pe.shape)
            if not torch.allclose(pe, want, rtol=0.0, atol=PE_ATOL):
                raise ValueError(f"vda_official: {key} is not the sinusoidal frame table "
                                 f"(max |difference| {(pe - want).abs().max().item():.3g})")
            continue
        out[key] = t
    return out


def vda_official_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A ``VideoDepthAnything`` state dict ``sd`` under the official
    checkpoint's full key set (the inverse of ``vda_module_state_dict``):
    ``pretrained.mask_token`` zeros and each motion module's
    ``pos_encoder.pe`` the table over ``VDA_PE_LENGTH`` frames, as a ``.pth``
    of the official code holds them."""
    from trajectorycrafter_tpu_torch.models.vda import sinusoidal_frame_encoding

    sd = dict(sd)
    cls = sd["pretrained.cls_token"]
    sd["pretrained.mask_token"] = torch.zeros(1, cls.shape[-1], device=cls.device)
    for key, t in list(sd.items()):
        if key.endswith(".to_q.weight") and ".attention_blocks." in key:
            pe = sinusoidal_frame_encoding(VDA_PE_LENGTH, t.shape[0], t.device)
            sd[key[:-len("to_q.weight")] + "pos_encoder.pe"] = pe[None]
    return sd


def load_vda(path: str, encoder: str = "vitl", device="cuda", cfg=None) -> nn.Module:
    """Video-Depth-Anything from the official checkpoint at ``path`` (the
    ``.pth``, read with ``torch.load(weights_only=True)``, or a
    ``.safetensors`` file of the same keys), fp32 on ``device``: the preset
    ``encoder`` (or ``cfg``), the keys checked by ``vda_module_state_dict``,
    ``load_state_dict(strict=True)``."""
    from trajectorycrafter_tpu_torch.models.vda import VideoDepthAnything, vda_config

    t0 = time.perf_counter()
    label = encoder if cfg is None else "given config"
    cfg = cfg if cfg is not None else vda_config(encoder)
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: (v.float() if v.is_floating_point() else v)
          for k, v in vda_module_state_dict(sd, cfg).items()}
    with torch.device("meta"):
        model = VideoDepthAnything(cfg)
    model.load_state_dict(sd, strict=True, assign=True)
    model = model.to(device).eval()
    nbytes = sum(t.numel() * t.element_size() for t in sd.values())
    print(f"{LOG} loaded vda ({label}) from {path}: {len(sd)} tensors, "
          f"{nbytes / 1e9:.2f} GB on {device} in {time.perf_counter() - t0:.2f} s")
    return model
