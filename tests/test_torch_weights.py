"""JAX tree -> torch state_dict (trajectorycrafter_tpu_torch/utils/weights.py).

The port's modules carry the reference checkpoint's names: at the deployed
widths their state_dict keys are exactly ``expected_dit_keys`` /
``expected_vae_keys`` (built on the meta device, no memory).  A tiny JAX tree
with the flax model's exact parameter paths and shapes (checked against
``jax.eval_shape`` of its ``init``) loads with ``strict=True``, and
``convert_dit(dit_from_jax(p)) == p`` (likewise for the VAE) holds exactly:
the bridge only transposes.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch_parity import jax_tree

from trajectorycrafter_tpu.models.dit import CrossTransformer3DModel as JaxDiT
from trajectorycrafter_tpu.models.vae import AutoencoderKLCogVideoX as JaxVAE
from trajectorycrafter_tpu.utils.convert import (
    convert_dit,
    convert_vae,
    expected_dit_keys,
    expected_vae_keys,
)
from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel
from trajectorycrafter_tpu_torch.models.vae import AutoencoderKLCogVideoX
from trajectorycrafter_tpu_torch.utils.weights import dit_from_jax, vae_from_jax

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
