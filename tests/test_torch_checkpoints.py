"""Checkpoint loading of the port (trajectorycrafter_tpu_torch/utils/checkpoints.py
and ``orchestrator.load_full_bundle``) vs the JAX package's loaders.

* A tiny DiT tree (safetensors + a ``config.json`` with tiny widths) goes
  through the JAX ``load_dit`` (fp32) and the port's; the forward passes
  agree at tests/test_torch_dit.py's tolerance (2e-5) in bf16-free fp32, and
  the int8 ones at tests/test_torch_int8.py's (1e-4 of the output's largest
  magnitude): both quantize the same fp32 file values.
* The patch embed padded and cropped is the JAX ``adapt_patch_embed_in_channels``;
  a tree without the reference branch builds the DiT without it.
* A key missing or a key too many fails in ``verify_state_dict`` with the
  JAX message, for the DiT and the VAE (full-width key sets of 1-element
  tensors: the check runs on the file index, before any tensor is read).
* On ``meta`` at the deployed widths: the port's key contracts are the JAX
  ones, and each other family reads exactly the keys its JAX converter
  consumes (``RecordingDict``), the tied / buffer keys the converters skip
  aside.
* The VAE, T5 and the depth stack load at tiny widths through the port's
  loaders (their fixed-width constructors patched to tiny ones) and agree
  with the JAX models built from ``convert_*`` of the same files, at the
  tolerances of tests/test_torch_vae.py, test_torch_t5.py and
  test_torch_depth.py (1e-4).
* The whole bundle: ``build_models(cfg, device="cpu")`` on a tiny tree runs
  ``infer_gradual`` with no ``--prompt`` (BLIP-2 captions) and with
  ``--mask``; the loaded tensors are the written ones.
"""

import functools
import json
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from safetensors.numpy import load_file as np_load_file
from safetensors.torch import save_file
from test_tokenizer import _synth_spiece
from torch_parity import fill_from_numpy_

from trajectorycrafter_tpu.models.clip import CLIPVisionConfig
from trajectorycrafter_tpu.models.clip import CLIPVisionModelWithProjection as JaxCLIP
from trajectorycrafter_tpu.models.depthcrafter import UNetSpatioTemporalConditionModel as JaxUNet
from trajectorycrafter_tpu.models.svd_vae import AutoencoderKLTemporalDecoder as JaxSVDVAE
from trajectorycrafter_tpu.models.t5 import T5Config
from trajectorycrafter_tpu.models.t5 import T5EncoderModel as JaxT5
from trajectorycrafter_tpu.models.vae import AutoencoderKLCogVideoX as JaxVAE
from trajectorycrafter_tpu.models.vae import vae_decode as jax_vae_decode
from trajectorycrafter_tpu.ops.rope import rope_for_sample
from trajectorycrafter_tpu.utils import checkpoints as jax_checkpoints
from trajectorycrafter_tpu.utils import convert as jax_convert
from trajectorycrafter_tpu_torch import orchestrator
from trajectorycrafter_tpu_torch.cli import config_from_args, get_parser
from trajectorycrafter_tpu_torch.config import TrajCrafterConfig
from trajectorycrafter_tpu_torch.models import clip as clip_mod
from trajectorycrafter_tpu_torch.models import depthcrafter as unet_mod
from trajectorycrafter_tpu_torch.models import svd_vae as svd_vae_mod
from trajectorycrafter_tpu_torch.models import t5 as t5_mod
from trajectorycrafter_tpu_torch.models import vae as vae_mod
from trajectorycrafter_tpu_torch.models.blip2 import Blip2Captioner, Blip2Config
from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel
from trajectorycrafter_tpu_torch.models.vae import vae_decode
from trajectorycrafter_tpu_torch.ops.int8 import Int8Linear, int8_linears, quantize_depth_unet_
from trajectorycrafter_tpu_torch.utils import checkpoints
from trajectorycrafter_tpu_torch.utils.bpe import bytes_to_unicode
from trajectorycrafter_tpu_torch.utils.weights import svd_unet_from_jax

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
DIT_TOL = dict(atol=2e-5, rtol=2e-5)
INT8_MODEL_TOL = 1e-4
TOL = dict(atol=1e-4, rtol=1e-4)

DIT_CONFIG = dict(num_attention_heads=2, attention_head_dim=16, num_layers=4, in_channels=9,
                  use_rotary_positional_embeddings=True, cross_attn_interval=2,
                  out_channels=4, cross_attn_dim_head=8, cross_attn_num_heads=4,
                  time_embed_dim=16, text_embed_dim=32, max_text_seq_length=7)
VAE_DEV = dict(latent_channels=4, block_out_channels=(8, 16, 16, 32), layers_per_block=1,
               norm_num_groups=4)
T5_TINY = dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=3, num_heads=4)
UNET_TINY = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
                 num_attention_heads=(2, 2, 2, 2), cross_attention_dim=12, norm_num_groups=4)
SVD_VAE_TINY = dict(block_out_channels=(32, 32, 64, 64))
CLIP_TINY = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                 num_attention_heads=4, image_size=28, patch_size=14, projection_dim=12)


def _write(module_or_sd, path: Path, config=None, name="model.safetensors", extra=None):
    """Save a module's (or a dict's) tensors, plus ``extra`` tensors, as one
    safetensors file under ``path``, with ``config`` as config.json."""
    path.mkdir(parents=True, exist_ok=True)
    sd = module_or_sd if isinstance(module_or_sd, dict) else module_or_sd.state_dict()
    sd = {k: v.detach().contiguous().clone() for k, v in {**sd, **(extra or {})}.items()}
    save_file(sd, str(path / name))
    if config is not None:
        (path / "config.json").write_text(json.dumps(config))
    return sd


def _dit_inputs(seed=1):
    rng = np.random.default_rng(seed)
    b, f, h, w = 1, 3, 8, 12
    return (rng.standard_normal((b, f, h, w, 4)).astype(np.float32),
            rng.standard_normal((b, 7, 32)).astype(np.float32),
            np.asarray([311.0], np.float32),
            rng.standard_normal((b, f, h, w, 5)).astype(np.float32),
            rng.standard_normal((b, 2, h, w, 4)).astype(np.float32))


def _dit_tree(tmp_path, drop_ref=False, patch_in=None):
    """A tiny DiT written from seeded weights; ``patch_in``: the file's patch
    embed has that many input channels (the model keeps config's 9)."""
    module = fill_from_numpy_(CrossTransformer3DModel(**DIT_CONFIG), 0)
    sd = dict(module.state_dict())
    if drop_ref:
        sd = {k: v for k, v in sd.items()
              if not k.startswith(("ref_patch_embed", "perceiver_cross_attention"))}
    if patch_in is not None:
        rng = np.random.default_rng(5)
        w = sd["patch_embed.proj.weight"]
        sd["patch_embed.proj.weight"] = torch.from_numpy(
            rng.standard_normal((w.shape[0], patch_in, *w.shape[2:])).astype(np.float32))
    path = tmp_path / "transformer"
    _write(sd, path, DIT_CONFIG)
    return path


def _jax_dit_out(path, quant, cross=True):
    model, params = jax_checkpoints.load_dit(str(path), jnp.float32, quant=quant,
                                             attention_impl="xla")
    args = [jnp.asarray(a) for a in _dit_inputs()]
    if not cross:
        args[4] = None
    rope = tuple(jnp.asarray(t) for t in rope_for_sample(16, 64, 96, 3))
    return np.asarray(jax.jit(model.apply)({"params": params}, *args, image_rotary_emb=rope))


def _port_dit_out(dit):
    rope = tuple(torch.from_numpy(t) for t in rope_for_sample(16, 64, 96, 3))
    with torch.no_grad():
        return dit(*(torch.from_numpy(a) for a in _dit_inputs()), image_rotary_emb=rope).numpy()


def _max_rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_dit_tree_loads_as_the_jax_load_dit(tmp_path, quant):
    path = _dit_tree(tmp_path)
    dit = checkpoints.load_dit(str(path), "cpu", torch.float32, quant=quant)
    assert len(dit.transformer_blocks) == 4 and len(dit.perceiver_cross_attention) == 2
    assert int8_linears(dit) == (30 if quant == "int8" else 0)
    want = _jax_dit_out(path, quant)
    got = _port_dit_out(dit)
    if quant == "none":
        np.testing.assert_allclose(got, want, **DIT_TOL)
    else:
        assert _max_rel(got, want) <= INT8_MODEL_TOL


@pytest.mark.parametrize("patch_in", [7, 11], ids=["padded", "cropped"])
def test_patch_embed_is_padded_or_cropped_as_in_jax(tmp_path, patch_in):
    path = _dit_tree(tmp_path, patch_in=patch_in)
    dit = checkpoints.load_dit(str(path), "cpu", torch.float32)
    written = np_load_file(str(path / "model.safetensors"))["patch_embed.proj.weight"]
    kernel = jax_convert.adapt_patch_embed_in_channels(written.transpose(2, 3, 1, 0), 9)
    np.testing.assert_array_equal(dit.patch_embed.proj.weight.detach().numpy(),
                                  kernel.transpose(3, 2, 0, 1))
    assert dit.patch_embed.proj.weight.shape[1] == 9
    np.testing.assert_allclose(_port_dit_out(dit), _jax_dit_out(path, "none"), **DIT_TOL)


def test_dit_tree_without_reference_branch(tmp_path):
    path = _dit_tree(tmp_path, drop_ref=True)
    dit = checkpoints.load_dit(str(path), "cpu", torch.float32)
    assert dit.perceiver_cross_attention is None and not hasattr(dit, "ref_patch_embed")
    # the JAX model, without the branch's weights, runs with no reference latents
    np.testing.assert_allclose(_port_dit_out(dit), _jax_dit_out(path, "none", cross=False),
                               **DIT_TOL)


def _key_file(path: Path, keys):
    """A safetensors file of 1-element tensors under ``keys``: enough for the
    key checks, which read the file index only."""
    path.mkdir(parents=True, exist_ok=True)
    save_file({k: torch.zeros(1) for k in keys}, str(path / "model.safetensors"))
    return path


@pytest.mark.parametrize("family,damage", [
    ("dit", "missing"), ("dit", "extra"), ("vae", "missing"), ("vae", "extra")])
def test_damaged_key_sets_fail_with_the_jax_message(tmp_path, family, damage):
    expected = (jax_convert.expected_dit_keys() if family == "dit"
                else jax_convert.expected_vae_keys())
    keys = set(expected)
    if damage == "missing":
        keys.discard(sorted(keys)[len(keys) // 2])
    else:
        keys.add("transformer_blocks.42.norm1.norm.weight" if family == "dit"
                 else "decoder.up_blocks.4.resnets.0.conv1.conv.weight")
    with pytest.raises(ValueError) as jax_error:
        jax_convert.verify_state_dict(keys, expected, family)
    path = _key_file(tmp_path / family, keys)
    load = checkpoints.load_dit if family == "dit" else checkpoints.load_vae
    with pytest.raises(ValueError) as port_error:
        load(str(path), "cpu", torch.float32)
    assert str(port_error.value) == str(jax_error.value)
    assert ("Missing: 1 keys" if damage == "missing" else "Unexpected: 1 keys") \
        in str(port_error.value)


@pytest.mark.parametrize("kwargs", [
    dict(), dict(num_layers=6), dict(num_layers=6, has_ref_branch=False),
    dict(num_layers=4, cross_attn_interval=1, attention_bias=False)])
def test_dit_contract_is_the_jax_one(kwargs):
    assert checkpoints.expected_dit_keys(**kwargs) == jax_convert.expected_dit_keys(**kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(), dict(block_out_channels=(8, 16, 16, 32), layers_per_block=1)])
def test_vae_contract_is_the_jax_one_and_the_modules(kwargs):
    assert checkpoints.expected_vae_keys(**kwargs) == jax_convert.expected_vae_keys(**kwargs)
    with torch.device("meta"):
        dit = CrossTransformer3DModel(num_layers=6)
    assert checkpoints.checkpoint_keys(dit) == jax_convert.expected_dit_keys(num_layers=6)


# family -> (port module at the deployed widths, JAX converter and kwargs, the
# keys a published checkpoint holds that the converter skips)
FAMILIES = {
    "t5": (lambda: t5_mod.T5EncoderModel(),
           functools.partial(jax_convert.convert_t5_encoder, num_layers=24),
           {"encoder.embed_tokens.weight": (32128, 4096)}),
    "svd_unet": (lambda: unet_mod.UNetSpatioTemporalConditionModel(),
                 jax_convert.convert_svd_unet, {}),
    "svd_unet_int8": (lambda: quantize_depth_unet_(unet_mod.UNetSpatioTemporalConditionModel()),
                      jax_convert.convert_svd_unet, {}),
    "svd_vae": (lambda: svd_vae_mod.AutoencoderKLTemporalDecoder(),
                jax_convert.convert_svd_vae, {}),
    "clip": (lambda: clip_mod.CLIPVisionModelWithProjection(),
             functools.partial(jax_convert.convert_clip_vision, num_layers=32),
             {"vision_model.embeddings.position_ids": (1, 257)}),
    "blip2": (lambda: Blip2Captioner(Blip2Config()), jax_convert.convert_blip2,
              {"language_model.lm_head.weight": (50272, 2560)}),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_reads_the_keys_its_jax_converter_consumes(family):
    make, convert, skipped = FAMILIES[family]
    with torch.device("meta"):
        module = make()
    keys = checkpoints.checkpoint_keys(module)
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    for k in keys - set(shapes):  # an int8 layer's weight, read to be quantized
        prefix = k[:-len(".weight")]
        shapes[k] = shapes[prefix + ".weight_q"]
    sd = jax_convert.RecordingDict({k: np.broadcast_to(np.float32(0), shapes[k])
                                    for k in keys})
    sd.update({k: np.broadcast_to(np.float32(0), s) for k, s in skipped.items()})
    convert(sd)
    assert sd.consumed - set(skipped) == keys
    checkpoints.require_keys(sd, keys, family)  # the port reads them all
    with pytest.raises(KeyError, match=f"{family}: the checkpoint lacks 1 keys"):
        checkpoints.require_keys(set(sd) - {sorted(keys)[0]}, keys, family)


# ----------------------------------------------------------------------------
# the other families at tiny widths, through the port's loaders
# ----------------------------------------------------------------------------


def _tiny(monkeypatch):
    """Patch the fixed-width constructors (and the VAE contract) to tiny ones."""
    monkeypatch.setattr(vae_mod, "AutoencoderKLCogVideoX",
                        functools.partial(vae_mod.AutoencoderKLCogVideoX, **VAE_DEV))
    monkeypatch.setattr(checkpoints, "expected_vae_keys", functools.partial(
        checkpoints.expected_vae_keys, VAE_DEV["block_out_channels"],
        VAE_DEV["layers_per_block"]))
    monkeypatch.setattr(t5_mod, "T5EncoderModel",
                        functools.partial(t5_mod.T5EncoderModel, **T5_TINY))
    monkeypatch.setattr(unet_mod, "UNetSpatioTemporalConditionModel",
                        functools.partial(unet_mod.UNetSpatioTemporalConditionModel, **UNET_TINY))
    monkeypatch.setattr(svd_vae_mod, "AutoencoderKLTemporalDecoder", functools.partial(
        svd_vae_mod.AutoencoderKLTemporalDecoder, **SVD_VAE_TINY))
    monkeypatch.setattr(clip_mod, "CLIPVisionModelWithProjection",
                        functools.partial(clip_mod.CLIPVisionModelWithProjection, **CLIP_TINY))


def _assert_loaded_as_written(module, written):
    """Every tensor the module holds is the written one, bit for bit."""
    for key, value in module.state_dict().items():
        assert value.dtype == written[key].dtype and torch.equal(value, written[key]), key


def test_vae_and_t5_load_and_match_jax(tmp_path, monkeypatch):
    _tiny(monkeypatch)
    written = _write(fill_from_numpy_(vae_mod.AutoencoderKLCogVideoX(), 0), tmp_path / "vae")
    vae = checkpoints.load_vae(str(tmp_path / "vae"), "cpu", torch.float32)
    _assert_loaded_as_written(vae, written)
    params = jax_convert.convert_vae(np_load_file(str(tmp_path / "vae/model.safetensors")),
                                     layers_per_block=1)
    z = np.random.default_rng(1).standard_normal((1, 3, 4, 6, 4)).astype(np.float32)
    want = np.asarray(jax_vae_decode(JaxVAE(**VAE_DEV), params, jnp.asarray(z)))
    np.testing.assert_allclose(vae_decode(vae, torch.from_numpy(z)).numpy(), want, **TOL)

    t5 = fill_from_numpy_(t5_mod.T5EncoderModel(), 1)
    written = _write(t5, tmp_path / "t5", extra={"encoder.embed_tokens.weight": t5.shared.weight})
    t5 = checkpoints.load_t5(str(tmp_path / "t5"), "cpu", torch.float32)
    assert "encoder.embed_tokens.weight" not in t5.state_dict()
    _assert_loaded_as_written(t5, written)
    params = jax_convert.convert_t5_encoder(np_load_file(str(tmp_path / "t5/model.safetensors")), 3)
    ids = np.random.default_rng(2).integers(0, 128, (2, 11)).astype(np.int32)
    want = np.asarray(JaxT5(T5Config(**T5_TINY)).apply({"params": params}, jnp.asarray(ids)))
    with torch.no_grad():
        got = t5(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_depth_stack_loads_and_matches_jax(tmp_path, monkeypatch, quant):
    """The DepthCrafter UNet, SVD VAE and CLIP from ``unet_path`` and
    ``pre_train_path/{vae,image_encoder}``; ``--quant_depth int8`` quantizes
    the UNet's transformers from the file's values (JAX:
    ``quantize_depth_unet_params`` of the converted tree)."""
    from trajectorycrafter_tpu.ops.int8 import quantize_depth_unet_params

    _tiny(monkeypatch)
    unet_w = _write(fill_from_numpy_(unet_mod.UNetSpatioTemporalConditionModel(), 2),
                    tmp_path / "unet")
    vae_w = _write(fill_from_numpy_(svd_vae_mod.AutoencoderKLTemporalDecoder(), 3),
                   tmp_path / "svd/vae")
    clip = fill_from_numpy_(clip_mod.CLIPVisionModelWithProjection(), 4)
    clip_w = _write(clip, tmp_path / "svd/image_encoder",
                    extra={"vision_model.embeddings.position_ids": torch.arange(5)[None]})
    cfg = TrajCrafterConfig()
    cfg.depth.unet_path, cfg.depth.pre_train_path = str(tmp_path / "unet"), str(tmp_path / "svd")
    cfg.depth.quant = quant
    pipe = checkpoints.load_depthcrafter(cfg, "cpu", torch.float32).__self__.pipe
    _assert_loaded_as_written(pipe.vae, vae_w)
    _assert_loaded_as_written(pipe.image_encoder, clip_w)
    if quant == "none":
        _assert_loaded_as_written(pipe.unet, unet_w)
    else:
        assert int8_linears(pipe.unet) == 200

    unet_params = jax_convert.convert_svd_unet(np_load_file(str(tmp_path / "unet/model.safetensors")),
                                               layers_per_block=1)
    if quant == "int8":
        unet_params = quantize_depth_unet_params(unet_params)
        # the codes and scales quantized on load are the JAX package's, bit for bit
        want_sd = svd_unet_from_jax(unet_params)
        _assert_loaded_as_written(pipe.unet, want_sd)
    rng = np.random.default_rng(4)
    b, f, h, w = 2, 3, 8, 8
    args = (rng.standard_normal((b, f, h, w, 8)).astype(np.float32),
            np.full((b,), 0.25 * np.log(2.5), np.float32),
            rng.standard_normal((b, f, 1, 12)).astype(np.float32),
            np.array([[6.0, 127.0, 0.02], [3.0, 80.0, 0.1]], np.float32))
    want = np.asarray(jax.jit(JaxUNet(**UNET_TINY, quant=quant).apply)(
        {"params": unet_params}, *map(jnp.asarray, args)))
    with torch.no_grad():
        got = pipe.unet(*map(torch.from_numpy, args)).numpy()
    if quant == "none":
        np.testing.assert_allclose(got, want, **TOL)
    else:  # int8 codes flip at 8-16 channels (tests/test_torch_int8.py)
        assert float(np.corrcoef(got.ravel(), want.ravel())[0, 1]) > 0.99

    px = rng.standard_normal((3, 28, 28, 3)).astype(np.float32)
    clip_params = jax_convert.convert_clip_vision(
        np_load_file(str(tmp_path / "svd/image_encoder/model.safetensors")), 2)
    want = np.asarray(JaxCLIP(CLIPVisionConfig(**CLIP_TINY)).apply({"params": clip_params},
                                                                   jnp.asarray(px)))
    with torch.no_grad():
        np.testing.assert_allclose(pipe.image_encoder(torch.from_numpy(px)).numpy(), want, **TOL)

    vae_params = jax_convert.convert_svd_vae(np_load_file(str(tmp_path / "svd/vae/model.safetensors")))
    frames = rng.uniform(-1, 1, (1, 2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(JaxSVDVAE(**SVD_VAE_TINY).apply(
        {"params": vae_params}, jnp.asarray(frames), method=JaxSVDVAE.encode))
    with torch.no_grad():
        got = pipe.vae.encode(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


# ----------------------------------------------------------------------------
# the whole bundle
# ----------------------------------------------------------------------------

BUNDLE_DIT = dict(num_attention_heads=4, attention_head_dim=16, num_layers=4, in_channels=9,
                  out_channels=4, time_embed_dim=32, text_embed_dim=32, max_text_seq_length=16,
                  cross_attn_dim_head=16, cross_attn_num_heads=4, cross_attn_interval=2,
                  use_rotary_positional_embeddings=True)
BLIP_TINY = dict(
    vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                       num_attention_heads=4, image_size=28, patch_size=14),
    qformer_config=dict(hidden_size=24, num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=48, cross_attention_frequency=2),
    text_config=dict(vocab_size=300, hidden_size=16, num_hidden_layers=2, num_attention_heads=4,
                     ffn_dim=32, max_position_embeddings=64, bos_token_id=2),
    num_query_tokens=4)


def write_tiny_tree(root: Path, tokenizer_dir: Path) -> dict:
    """An HF-layout tree of seeded tiny models (the ``_tiny`` widths, the
    DiT's from its config.json, BLIP-2's from its config.json) -> {family:
    written state_dict}."""
    from trajectorycrafter_tpu_torch.models.blip2 import blip2_config_from_hf

    model = root / "CogVideoX-Fun"
    written = {
        "vae": _write(fill_from_numpy_(vae_mod.AutoencoderKLCogVideoX(), 0), model / "vae"),
        "dit": _write(fill_from_numpy_(CrossTransformer3DModel(**BUNDLE_DIT), 1),
                      root / "TrajectoryCrafter", BUNDLE_DIT),
        "t5": _write(fill_from_numpy_(t5_mod.T5EncoderModel(), 2),
                     model / "text_encoder"),
        "svd_unet": _write(fill_from_numpy_(unet_mod.UNetSpatioTemporalConditionModel(), 3),
                           root / "DepthCrafter"),
        "svd_vae": _write(fill_from_numpy_(svd_vae_mod.AutoencoderKLTemporalDecoder(), 4),
                          root / "svd/vae"),
        "clip": _write(fill_from_numpy_(clip_mod.CLIPVisionModelWithProjection(), 5),
                       root / "svd/image_encoder"),
    }
    (model / "tokenizer").mkdir()
    (model / "tokenizer/spiece.model").write_bytes((tokenizer_dir / "spiece.model").read_bytes())
    blip = root / "blip2"
    written["blip2"] = _write(
        fill_from_numpy_(Blip2Captioner(blip2_config_from_hf(BLIP_TINY)), 6), blip, BLIP_TINY)
    vocab = {t: i for i, t in enumerate(bytes_to_unicode().values())}
    (blip / "vocab.json").write_text(json.dumps(vocab))
    (blip / "merges.txt").write_text("#version: 0.2\n")
    (blip / "generation_config.json").write_text(json.dumps({"eos_token_id": 7, "max_length": 6}))
    return written


def _bundle_cfg(root: Path, out: Path, *extra):
    args = get_parser().parse_args([
        "--video_path", str(REPO / "test/videos/synth.mp4"), "--camera", "traj",
        "--traj_txt", str(REPO / "test/trajs/loop1.txt"), "--mode", "gradual",
        "--diffusion_inference_steps", "2", "--video_length", "9", "--sample_size", "32", "48",
        "--depth_inference_steps", "2",
        "--model_name", str(root / "CogVideoX-Fun"),
        "--transformer_path", str(root / "TrajectoryCrafter"),
        "--unet_path", str(root / "DepthCrafter"), "--pre_train_path", str(root / "svd"),
        "--blip_path", str(root / "blip2"), "--out_dir", str(out), "--exp_name", "run", *extra])
    cfg = config_from_args(args)
    cfg.warp_size = (64, 128)  # the SVD UNet takes sides that are multiples of 64
    return cfg


def test_build_models_loads_the_tree_and_runs_gradual_with_caption_and_mask(
        tmp_path, monkeypatch):
    _tiny(monkeypatch)
    _synth_spiece(tmp_path)
    written = write_tiny_tree(tmp_path / "tree", tmp_path)
    cfg = _bundle_cfg(tmp_path / "tree", tmp_path / "out", "--mask")
    assert cfg.diffusion.prompt is None and cfg.render.mask and cfg.diffusion.quant == "int8"
    models = orchestrator.build_models(cfg, device="cpu")
    assert set(models.load_stats) == {"vae", "dit", "t5", "svd_unet", "svd_vae", "clip", "blip2"}
    pipe = models.depth_infer.__self__.pipe
    loaded = {"vae": models.pipeline.vae, "t5": models.encode_prompt.t5, "svd_unet": pipe.unet,
              "svd_vae": pipe.vae, "clip": pipe.image_encoder,
              "blip2": models.get_caption.model}
    for family, module in loaded.items():
        for key, value in module.state_dict().items():
            assert torch.equal(value, written[family][key].to(value.dtype)), (family, key)
    dit = models.pipeline.transformer
    assert int8_linears(dit) == 4 * 6 + 2 * 3
    q = dit.transformer_blocks[0].attn1.to_q
    assert isinstance(q, Int8Linear) and torch.equal(
        q.weight_q, Int8Linear.from_linear(_linear(written["dit"],
                                                   "transformer_blocks.0.attn1.to_q")).weight_q)

    seen = {}
    t5_ids = []
    models.encode_prompt.t5.register_forward_pre_hook(lambda m, args: t5_ids.append(args[0]))
    warp = orchestrator.forward_warp_batch

    def recording_warp(*args, **kwargs):
        out = warp(*args, **kwargs)
        seen.setdefault("known", []).append(float(out[1].mean()))
        return out

    monkeypatch.setattr(orchestrator, "forward_warp_batch", recording_warp)
    tc = orchestrator.TrajCrafter(cfg, models=models)
    caption_of = models.get_caption
    captions = []
    models.get_caption = lambda frame: captions.append(caption_of(frame)) or captions[-1]
    gen = tc.infer_gradual()
    assert gen.shape == (9, 32, 48, 3) and np.isfinite(gen).all()
    for name in ("input", "render", "mask", "gen", "viz"):
        assert (Path(cfg.save_dir) / f"{name}.mp4").stat().st_size > 0, name
    assert {"caption", "depth", "warp", "prompt_encode", "denoise"} <= set(tc.timer.seconds)
    # the caption is the decode of the greedy ids (5 new tokens: max_length 6)
    assert caption_of.last_ids.shape == (5,)
    assert captions == [caption_of.tokenizer.decode(caption_of.last_ids.tolist()).strip()]
    # T5 read the tokenizer's ids of the captioned prompt and the negative prompt
    want_ids = models.encode_prompt.tokenizer(
        [captions[0] + cfg.diffusion.refine_prompt, cfg.diffusion.negative_prompt], 226)
    assert len(t5_ids) == 1 and torch.equal(t5_ids[0], want_ids)
    assert not torch.equal(t5_ids[0][1:], orchestrator.stand_in_token_ids(
        cfg.diffusion.negative_prompt, 226, 128))
    # --mask: the dilated holes leave fewer known pixels than the same warp without it
    cfg.render.mask = False
    tc.infer_gradual()
    masked, plain = seen["known"]
    assert 0.0 < masked < plain


def _linear(sd, prefix):
    w = sd[prefix + ".weight"]
    linear = torch.nn.Linear(w.shape[1], w.shape[0])
    with torch.no_grad():
        linear.weight.copy_(w)
        linear.bias.copy_(sd[prefix + ".bias"])
    return linear


def test_missing_text_encoder_and_depth_follow_the_stub_rules(tmp_path, monkeypatch, capsys):
    """Without ``--allow_dev_stubs`` a missing DepthCrafter or T5 raises the
    JAX package's message; with it the stand-ins run and a line says so."""
    import shutil

    _tiny(monkeypatch)
    _synth_spiece(tmp_path)
    write_tiny_tree(tmp_path / "tree", tmp_path)
    cfg = _bundle_cfg(tmp_path / "tree", tmp_path / "out", "--prompt", "a scene")
    shutil.rmtree(tmp_path / "tree/DepthCrafter")
    with pytest.raises(RuntimeError, match="DepthCrafter unavailable .*--allow_dev_stubs"):
        orchestrator.build_models(cfg, device="cpu")
    cfg.allow_dev_stubs = True
    models = orchestrator.build_models(cfg, device="cpu")
    assert models.depth_infer is orchestrator._plane_depth_infer
    assert "plane-depth stub (--allow_dev_stubs)" in capsys.readouterr().out
    assert models.get_caption(None) == "a scene"  # --prompt: no captioner is built
    assert "blip2" not in models.load_stats

    shutil.rmtree(tmp_path / "tree/CogVideoX-Fun/text_encoder")
    cfg.allow_dev_stubs = False
    with pytest.raises(RuntimeError, match="text encoder/tokenizer unavailable .*--allow_dev_stubs"):
        orchestrator.build_models(cfg, device="cpu")
    cfg.allow_dev_stubs = True
    models = orchestrator.build_models(cfg, device="cpu")
    assert "falling back to pseudo-embeddings" in capsys.readouterr().out
    pe, ne = models.encode_prompt("a scene", "bad")
    assert pe.shape == (1, 226, 4096) and not torch.equal(pe, ne)
