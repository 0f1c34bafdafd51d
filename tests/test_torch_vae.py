"""Port VAE (trajectorycrafter_tpu_torch/models/vae.py) vs the JAX VAE.

The dev VAE of the JAX orchestrator (latent 4, channels (8, 16, 16, 32), one
layer per block, 4 groups), fp32, with seeded numpy weights
(tests/torch_parity.py) loaded into the port through ``vae_from_jax`` and a
strict ``load_state_dict``.  The chunked encode runs
at 9 frames (first chunk 5, then 4: the causal cache carries across) and the
chunked decode at 5 latent frames (first chunk 3, then 2).

Tolerance: 1e-4 absolute and relative.  Both sides are fp32; they differ in
convolution algorithms and group-norm summation order through ~20 layers:
near 3e-6 relative, 2.5e-5 absolute at decoded values up to ~8.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch_parity import jax_tree

from trajectorycrafter_tpu.models.vae import AutoencoderKLCogVideoX as JaxVAE
from trajectorycrafter_tpu.models.vae import sample_posterior as jax_sample_posterior
from trajectorycrafter_tpu.models.vae import vae_decode as jax_vae_decode
from trajectorycrafter_tpu.models.vae import vae_encode as jax_vae_encode
from trajectorycrafter_tpu.utils.convert import convert_vae
from trajectorycrafter_tpu_torch.models.vae import (
    AutoencoderKLCogVideoX,
    posterior_mode,
    sample_posterior,
    vae_decode,
    vae_encode,
)
from trajectorycrafter_tpu_torch.utils.weights import vae_from_jax

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
DEV = dict(latent_channels=4, block_out_channels=(8, 16, 16, 32), layers_per_block=1,
           norm_num_groups=4)


@pytest.fixture(scope="module")
def vae_pair():
    jmodel = JaxVAE(**DEV)
    params = jax_tree(AutoencoderKLCogVideoX(**DEV), 0, convert_vae, layers_per_block=1)
    tmodel = AutoencoderKLCogVideoX(**DEV)
    tmodel.load_state_dict(vae_from_jax(params), strict=True)
    return jmodel, params, tmodel.eval()


def test_chunked_encode_matches_jax(vae_pair):
    jmodel, params, tmodel = vae_pair
    video = np.random.default_rng(0).uniform(-1, 1, (1, 9, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax_vae_encode(jmodel, params, jnp.asarray(video)))
    got = vae_encode(tmodel, torch.from_numpy(video)).numpy()
    assert got.shape == (1, 3, 4, 4, 8)
    np.testing.assert_allclose(got, want, **TOL)


def test_chunked_decode_matches_jax(vae_pair):
    jmodel, params, tmodel = vae_pair
    latents = np.random.default_rng(1).standard_normal((1, 5, 4, 6, 4)).astype(np.float32)
    want = np.asarray(jax_vae_decode(jmodel, params, jnp.asarray(latents)))
    got = vae_decode(tmodel, torch.from_numpy(latents)).numpy()
    assert got.shape == (1, 17, 32, 48, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_posterior_matches_jax():
    rng = np.random.default_rng(2)
    moments = rng.standard_normal((1, 3, 4, 4, 8)).astype(np.float32) * 20.0  # hits the clamp
    noise = rng.standard_normal((1, 3, 4, 4, 4)).astype(np.float32)
    want = np.asarray(jax_sample_posterior(jnp.asarray(moments), None, 4,
                                           noise=jnp.asarray(noise)))
    got = sample_posterior(torch.from_numpy(moments), 4, noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(posterior_mode(torch.from_numpy(moments), 4).numpy(),
                                  moments[..., :4])
