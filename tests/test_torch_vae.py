"""Port VAE (trajectorycrafter_tpu_torch/models/vae.py) vs the JAX VAE.

The dev VAE of the JAX orchestrator (latent 4, channels (8, 16, 16, 32), one
layer per block, 4 groups), fp32, with seeded numpy weights
(tests/torch_parity.py) loaded into the port through ``vae_from_jax`` and a
strict ``load_state_dict``.  The chunked encode runs
at 9 frames (first chunk 5, then 4: the causal cache carries across) and the
chunked decode at 5 latent frames (first chunk 3, then 2).

The tiled decode (``vae_decode_tiled``) runs at 3 latent frames of 9 x 12
with tiles that cut 3 ways each way (the JAX default overlaps) and with the
auto route's full-width strips, against the JAX function on the same
weights; one tile with no overlap is ``vae_decode`` bit for bit.
``vae_decode_auto`` picks the one-shot decode or the strips on the JAX
rule, checked on both sides of its threshold.

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
from trajectorycrafter_tpu.models.vae import vae_decode_auto as jax_vae_decode_auto
from trajectorycrafter_tpu.models.vae import vae_decode_tiled as jax_vae_decode_tiled
from trajectorycrafter_tpu.models.vae import vae_encode as jax_vae_encode
from trajectorycrafter_tpu.utils.convert import convert_vae
from trajectorycrafter_tpu_torch.models import vae as vae_mod
from trajectorycrafter_tpu_torch.models.vae import (
    AutoencoderKLCogVideoX,
    decode_is_tiled,
    decode_memory_bytes,
    posterior_mode,
    sample_posterior,
    vae_decode,
    vae_decode_auto,
    vae_decode_tiled,
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


TILED_LATENTS = (1, 3, 9, 12, 4)


@pytest.mark.parametrize("tiling", [(4, 5, 1.0 / 6.0, 1.0 / 5.0), (4, 12, 1.0 / 7.0, 0.0)],
                         ids=["tiles", "strips"])
def test_tiled_decode_matches_jax(vae_pair, tiling):
    """(4, 5) latent tiles start every 3 rows and 4 columns of 9 x 12: 3 x 3
    tiles, blended over 5 and 8 pixels; strips of 4 start every 3 rows."""
    jmodel, params, tmodel = vae_pair
    latents = np.random.default_rng(3).standard_normal(TILED_LATENTS).astype(np.float32)
    want = np.asarray(jax_vae_decode_tiled(jmodel, params, jnp.asarray(latents), *tiling))
    got = vae_decode_tiled(tmodel, torch.from_numpy(latents), *tiling)
    assert got.dtype == torch.float32 and got.shape == (1, 9, 72, 96, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_one_tile_without_overlap_is_the_one_shot_decode(vae_pair):
    _, _, tmodel = vae_pair
    latents = torch.from_numpy(
        np.random.default_rng(4).standard_normal(TILED_LATENTS).astype(np.float32))
    assert torch.equal(vae_decode_tiled(tmodel, latents, 9, 12, 0.0, 0.0),
                       vae_decode(tmodel, latents).float())
    assert torch.equal(vae_decode_tiled(tmodel, latents, 16, 16, 0.0, 0.0),
                       vae_decode(tmodel, latents).float())


def test_decode_auto_chooses_as_jax_on_both_sides_of_the_threshold(vae_pair, monkeypatch):
    """At 3 latent frames of 9 x 12 the one-shot estimate is 9 x 72 x 96 x
    896 bytes: with 0.6 x the memory just above it the decode is one shot,
    just below it strips (here of 4 rows, the strips of the test above) --
    in the port and in the JAX function given the same memory."""
    from trajectorycrafter_tpu.utils import offload

    jmodel, params, tmodel = vae_pair
    latents = np.random.default_rng(5).standard_normal(TILED_LATENTS).astype(np.float32)
    est = 9 * 72 * 96 * 128 * 2 * 3.5
    one_shot = vae_decode(tmodel, torch.from_numpy(latents)).numpy()
    strips = vae_decode_tiled(tmodel, torch.from_numpy(latents), 4, 12, 1.0 / 7.0, 0.0).numpy()
    for memory, tiled in ((est / 0.6 + 64, False), (est / 0.6 - 64, True)):
        assert decode_is_tiled(TILED_LATENTS, memory) is tiled
        got = vae_decode_auto(tmodel, torch.from_numpy(latents), memory, strip_height=4).numpy()
        np.testing.assert_array_equal(got, strips if tiled else one_shot)
        monkeypatch.setattr(offload, "device_hbm_bytes", lambda memory=memory: int(memory))
        want = np.asarray(jax_vae_decode_auto(jmodel, params, jnp.asarray(latents),
                                              strip_height=4))
        np.testing.assert_allclose(got, want, **TOL)
        assert bool(np.abs(want - strips).max() < np.abs(want - one_shot).max()) is tiled


def test_decode_auto_plans_the_deployed_sizes_in_one_shot_on_80_gb():
    """49 frames at 576x1024 (the estimate 25.9 GB) and at 384x672 decode in
    one shot on an 85.0 GB card; the pipeline passes the host memory on the
    CPU."""
    card = 85_000_000_000
    assert not decode_is_tiled((1, 13, 72, 128, 16), card)
    assert not decode_is_tiled((1, 13, 48, 84, 16), card)
    assert decode_is_tiled((1, 13, 72, 128, 16), 16 * 1024**3)
    assert decode_memory_bytes("cpu") > 0
    assert vae_mod._DECODE_PEAK_FACTOR == 128 * 2 * 3.5
