"""JAX tree -> torch state_dict (trajectorycrafter_tpu_torch/utils/weights.py),
for the DiT and VAE, and for the depth stack (SVD UNet, SVD VAE, CLIP) and T5.

The port's modules carry the reference checkpoint's names: at the deployed
widths their state_dict keys are exactly ``expected_dit_keys`` /
``expected_vae_keys`` (built on the meta device, no memory).  A tiny JAX tree
with the flax model's exact parameter paths and shapes (checked against
``jax.eval_shape`` of its ``init``) loads with ``strict=True``, and
``convert_dit(dit_from_jax(p)) == p`` (likewise for the VAE) holds exactly:
the bridge only transposes.

The int8 trees (``quantize_dit_params``, ``quantize_depth_unet_params``) load
with ``strict=True`` into the port's models quantized in place
(``quantize_dit_``, ``quantize_depth_unet_``): each int8 leaf
{kernel_q, scale, bias} becomes an ``Int8Linear``'s ``weight_q`` (transposed),
``weight_scale`` and ``bias``, never a norm's ``weight``.  The scales stay
fp32 when the model is cast to bf16.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch_parity import jax_tree

from trajectorycrafter_tpu.models.dit import CrossTransformer3DModel as JaxDiT
from trajectorycrafter_tpu.models.vae import AutoencoderKLCogVideoX as JaxVAE
from trajectorycrafter_tpu.ops.int8 import quantize_depth_unet_params, quantize_dit_params
from trajectorycrafter_tpu.utils.convert import (
    RecordingDict,
    convert_clip_vision,
    convert_dit,
    convert_svd_unet,
    convert_svd_vae,
    convert_t5_encoder,
    convert_vae,
    expected_dit_keys,
    expected_vae_keys,
)
from trajectorycrafter_tpu_torch.models.clip import CLIPVisionModelWithProjection
from trajectorycrafter_tpu_torch.models.depthcrafter import UNetSpatioTemporalConditionModel
from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel
from trajectorycrafter_tpu_torch.models.svd_vae import AutoencoderKLTemporalDecoder
from trajectorycrafter_tpu_torch.models.t5 import T5EncoderModel
from trajectorycrafter_tpu_torch.models.vae import AutoencoderKLCogVideoX
from trajectorycrafter_tpu_torch.ops.int8 import Int8Linear, quantize_depth_unet_, quantize_dit_
from trajectorycrafter_tpu_torch.utils.weights import (
    clip_from_jax,
    dit_from_jax,
    svd_unet_from_jax,
    svd_vae_from_jax,
    t5_from_jax,
    vae_from_jax,
)

torch.set_num_threads(1)

TINY_DIT = dict(num_attention_heads=2, attention_head_dim=16, in_channels=9, out_channels=4,
                time_embed_dim=16, text_embed_dim=32, num_layers=4, max_text_seq_length=7,
                cross_attn_dim_head=8, cross_attn_num_heads=4)
DEV_VAE = dict(latent_channels=4, block_out_channels=(8, 16, 16, 32), layers_per_block=1,
               norm_num_groups=4)


def _assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
    for key in a:
        if isinstance(a[key], dict):
            _assert_trees_equal(a[key], b[key], f"{path}/{key}")
        else:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]),
                                          err_msg=f"{path}/{key}")


def _assert_same_structure(tree, shapes):
    """``tree`` has exactly the flax model's parameter paths and shapes."""
    flat = lambda t: {jax.tree_util.keystr(k): tuple(v.shape)
                      for k, v in jax.tree_util.tree_leaves_with_path(t)}
    assert flat(tree) == flat(shapes)


@pytest.fixture(scope="module")
def dit_params():
    b, f, h, w = 1, 3, 4, 6
    shapes = jax.eval_shape(
        JaxDiT(**TINY_DIT, attention_impl="xla").init, jax.random.PRNGKey(1),
        jnp.zeros((b, f, h, w, 4)), jnp.zeros((b, 7, 32)), jnp.zeros((b,)),
        jnp.zeros((b, f, h, w, 5)), jnp.zeros((b, 1, h, w, 4)))["params"]
    params = jax_tree(CrossTransformer3DModel(**TINY_DIT), 1, convert_dit, num_layers=4)
    _assert_same_structure(params, shapes)
    return params


@pytest.fixture(scope="module")
def vae_params():
    shapes = jax.eval_shape(JaxVAE(**DEV_VAE).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 5, 16, 16, 3)))["params"]
    params = jax_tree(AutoencoderKLCogVideoX(**DEV_VAE), 0, convert_vae, layers_per_block=1)
    _assert_same_structure(params, shapes)
    return params


def test_deployed_key_sets_match_the_reference_contract():
    with torch.device("meta"):
        dit, vae = CrossTransformer3DModel(), AutoencoderKLCogVideoX()
    assert set(dit.state_dict()) == expected_dit_keys(num_layers=42, cross_attn_interval=2)
    assert set(vae.state_dict()) == expected_vae_keys()
    n_params = sum(p.numel() for p in dit.parameters())
    assert 5.5e9 < n_params < 6.5e9, n_params  # the 5B CogVideoX-Fun DiT + Perceivers


def test_dit_round_trip_and_strict_load(dit_params):
    sd = dit_from_jax(dit_params)
    _assert_trees_equal(convert_dit(sd, num_layers=4), dit_params)
    model = CrossTransformer3DModel(**TINY_DIT)
    model.load_state_dict(sd, strict=True)
    torch.testing.assert_close(model.transformer_blocks[1].attn1.to_q.weight,
                               torch.from_numpy(dit_params["blocks_1"]["attn1"]["to_q"]["kernel"].T.copy()))


def test_vae_round_trip_and_strict_load(vae_params):
    sd = vae_from_jax(vae_params)
    _assert_trees_equal(convert_vae(sd, layers_per_block=1), vae_params)
    AutoencoderKLCogVideoX(**DEV_VAE).load_state_dict(sd, strict=True)


DEPTH_TINY = {
    "svd_unet": (dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
                      num_attention_heads=(2, 2, 2, 2), cross_attention_dim=12,
                      norm_num_groups=4), dict(layers_per_block=1)),
    "svd_vae": (dict(block_out_channels=(32, 32, 64, 64)), {}),
    "clip": (dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                  num_attention_heads=4, image_size=28, patch_size=14, projection_dim=16),
             dict(num_layers=2)),
    "t5": (dict(vocab_size=100, d_model=32, d_kv=8, d_ff=64, num_layers=3, num_heads=4),
           dict(num_layers=3)),
}
_BRIDGES = {
    "svd_unet": (UNetSpatioTemporalConditionModel, convert_svd_unet, svd_unet_from_jax),
    "svd_vae": (AutoencoderKLTemporalDecoder, convert_svd_vae, svd_vae_from_jax),
    "clip": (CLIPVisionModelWithProjection, convert_clip_vision, clip_from_jax),
    "t5": (T5EncoderModel, convert_t5_encoder, t5_from_jax),
}


@pytest.mark.parametrize("name", sorted(_BRIDGES))
def test_depth_stack_and_t5_round_trip_and_strict_load(name):
    """``convert_x(x_from_jax(p)) == p`` exactly and the state_dict loads
    strictly into a fresh port module (the flax paths and shapes of each
    tree are checked in tests/test_torch_depth.py and test_torch_t5.py)."""
    module_cls, convert, from_jax = _BRIDGES[name]
    kwargs, convert_kwargs = DEPTH_TINY[name]
    params = jax_tree(module_cls(**kwargs), 3, convert, **convert_kwargs)
    sd = from_jax(params)
    _assert_trees_equal(convert(sd, **convert_kwargs), params)
    module_cls(**kwargs).load_state_dict(sd, strict=True)


@pytest.mark.parametrize("name,convert_kwargs,n_params", [
    ("svd_unet", {}, (1.45e9, 1.6e9)),  # the SVD img2vid UNet, 1.5B
    ("svd_vae", {}, (0.08e9, 0.11e9)),
    ("clip", dict(num_layers=32), (0.6e9, 0.66e9)),  # ViT-H/14 + projection
    ("t5", dict(num_layers=24), (4.7e9, 4.8e9)),  # T5-XXL encoder
])
def test_deployed_depth_stack_and_t5_keys_are_the_converters(name, convert_kwargs, n_params):
    """At the deployed widths (meta device, no memory) the converter reads
    every key of the port module's state_dict and the size is the published
    model's."""
    module_cls, convert, _ = _BRIDGES[name]
    with torch.device("meta"):
        module = module_cls()
    sd = RecordingDict({k: np.broadcast_to(np.float32(0), v.shape)
                        for k, v in module.state_dict().items()})
    convert(sd, **convert_kwargs)
    assert sd.consumed == set(sd)
    n = sum(p.numel() for p in module.parameters())
    assert n_params[0] < n < n_params[1], n


def _int8_leaves(tree, path=()):
    """{dotted flax path: leaf} of every int8 Dense leaf in ``tree``."""
    if not isinstance(tree, dict):
        return {}
    if "kernel_q" in tree:
        return {".".join(path): tree}
    found = {}
    for key, sub in tree.items():
        found.update(_int8_leaves(sub, path + (key,)))
    return found


def _assert_int8_state(sd, qparams):
    """Every int8 leaf is in ``sd`` as weight_q (transposed), weight_scale and
    bias, and nothing of it as a ``.weight``."""
    leaves = _int8_leaves(qparams)
    weight_q = {k[:-len(".weight_q")]: v for k, v in sd.items() if k.endswith(".weight_q")}
    assert len(leaves) == len(weight_q) > 0
    pairs = {}
    for prefix, wq in weight_q.items():
        assert prefix + ".weight" not in sd
        assert wq.dtype == torch.int8 and sd[prefix + ".weight_scale"].dtype == torch.float32
        pairs[(wq.numpy().T.tobytes(), sd[prefix + ".weight_scale"].numpy().tobytes())] = prefix
    for leaf in leaves.values():  # each leaf's codes and scales, once
        assert (np.asarray(leaf["kernel_q"]).tobytes(), np.asarray(leaf["scale"]).tobytes()) \
            in pairs


def test_int8_dit_tree_strict_load(dit_params):
    qparams = quantize_dit_params(dit_params)
    sd = dit_from_jax(qparams)
    _assert_int8_state(sd, qparams)
    model = quantize_dit_(CrossTransformer3DModel(**TINY_DIT))
    model.load_state_dict(sd, strict=True)
    to_q = qparams["blocks_1"]["attn1"]["to_q"]
    layer = model.transformer_blocks[1].attn1.to_q
    assert torch.equal(layer.weight_q, torch.from_numpy(to_q["kernel_q"].T.copy()))
    assert torch.equal(layer.weight_scale, torch.from_numpy(to_q["scale"]))
    assert torch.equal(layer.bias.detach(), torch.from_numpy(np.asarray(to_q["bias"])))
    # the bf16 layers around them load as before
    assert torch.equal(model.transformer_blocks[1].norm1.norm.weight.detach(),
                       torch.from_numpy(np.asarray(qparams["blocks_1"]["norm1"]["norm"]["scale"])))


def test_int8_depth_unet_tree_strict_load():
    kwargs, convert_kwargs = DEPTH_TINY["svd_unet"]
    params = jax_tree(UNetSpatioTemporalConditionModel(**kwargs), 3, convert_svd_unet,
                      **convert_kwargs)
    qparams = quantize_depth_unet_params(params)
    sd = svd_unet_from_jax(qparams)
    _assert_int8_state(sd, qparams)
    quantize_depth_unet_(UNetSpatioTemporalConditionModel(**kwargs)).load_state_dict(
        sd, strict=True)


def test_weight_scale_stays_fp32_when_the_model_is_cast():
    """``module.to(torch.bfloat16)`` casts every floating buffer; the JAX
    package keeps the scales fp32 and casts only the bias."""
    layer = Int8Linear.from_linear(torch.nn.Linear(32, 16))
    scale = layer.weight_scale.clone()
    layer.to(torch.bfloat16)
    assert layer.weight_scale.dtype == torch.float32 and torch.equal(layer.weight_scale, scale)
    assert layer.bias.dtype == torch.bfloat16 and layer.weight_q.dtype == torch.int8
    model = quantize_dit_(CrossTransformer3DModel(**TINY_DIT)).to(torch.bfloat16)
    scales = [m.weight_scale for m in model.modules() if isinstance(m, Int8Linear)]
    assert len(scales) == 30 and all(s.dtype == torch.float32 for s in scales)
    with torch.device("meta"):
        meta = quantize_dit_(CrossTransformer3DModel(**TINY_DIT))
    meta = meta.to(torch.bfloat16).to_empty(device="cpu")
    assert meta.transformer_blocks[0].ff.net[2].weight_scale.dtype == torch.float32
