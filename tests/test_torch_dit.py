"""Port DiT (trajectorycrafter_tpu_torch/models/dit.py) vs the JAX DiT.

The tiny config of tests/test_dit.py, fp32, the JAX model with
``attention_impl="xla"`` (the einsum path) and the port on the CPU (its plain
attention); the port gets the JAX weights through ``dit_from_jax`` and a
strict ``load_state_dict``.  Weights and inputs come from
``np.random.default_rng`` (tests/torch_parity.py).

Tolerance: 2e-5 absolute and relative.  Both sides are fp32; they differ in
summation order (matmul blocking, softmax, layer-norm variance) over 4
blocks, which at O(1) activations stays near 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch_parity import jax_tree

from trajectorycrafter_tpu.models.dit import CrossTransformer3DModel as JaxDiT
from trajectorycrafter_tpu.ops.posemb import timestep_embedding as jax_timestep_embedding
from trajectorycrafter_tpu.ops.rope import apply_rotary_emb as jax_apply_rotary_emb
from trajectorycrafter_tpu.ops.rope import rope_for_sample as jax_rope_for_sample
from trajectorycrafter_tpu.utils.convert import convert_dit
from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel
from trajectorycrafter_tpu_torch.ops.posemb import timestep_embedding
from trajectorycrafter_tpu_torch.ops.rope import apply_rotary_emb, rope_for_sample
from trajectorycrafter_tpu_torch.utils.weights import dit_from_jax

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=2e-5)

TINY = dict(
    num_attention_heads=2,
    attention_head_dim=16,
    in_channels=9,  # 4 noise + 5 inpaint
    out_channels=4,
    time_embed_dim=16,
    text_embed_dim=32,
    num_layers=4,
    sample_width=12,
    sample_height=8,
    sample_frames=9,
    max_text_seq_length=7,
    cross_attn_dim_head=8,
    cross_attn_num_heads=4,
)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    b, f, h, w = 1, 3, 8, 12
    return (
        rng.standard_normal((b, f, h, w, 4)).astype(np.float32),  # noisy latents
        rng.standard_normal((b, 7, 32)).astype(np.float32),  # text
        np.asarray([311.0], np.float32),  # timestep
        rng.standard_normal((b, f, h, w, 5)).astype(np.float32),  # inpaint
        rng.standard_normal((b, 2, h, w, 4)).astype(np.float32),  # reference latents
    )


def _pair(use_rope: bool):
    """(jax model, jax params, port model with the same weights, rope tables)."""
    rope = jax_rope_for_sample(16, 8 * 8, 12 * 8, 3) if use_rope else None
    jmodel = JaxDiT(**TINY, use_rotary_positional_embeddings=use_rope, attention_impl="xla")
    make = lambda: CrossTransformer3DModel(**TINY, use_rotary_positional_embeddings=use_rope)
    params = jax_tree(make(), 0, convert_dit, num_layers=TINY["num_layers"])
    tmodel = make()
    tmodel.load_state_dict(dit_from_jax(params), strict=True)
    return jmodel, params, tmodel.eval(), rope


@pytest.mark.parametrize("use_rope", [True, False], ids=["rope", "sincos"])
def test_dit_matches_jax(use_rope):
    jmodel, params, tmodel, rope = _pair(use_rope)
    args = _inputs(1)
    jrope = None if rope is None else tuple(jnp.asarray(t) for t in rope)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, *(jnp.asarray(a) for a in args),
                                   image_rotary_emb=jrope))
    trope = None if rope is None else tuple(torch.from_numpy(t) for t in rope)
    with torch.no_grad():
        got = tmodel(*(torch.from_numpy(a) for a in args), image_rotary_emb=trope).numpy()
    assert got.shape == (1, 3, 8, 12, 4)
    np.testing.assert_allclose(got, want, **TOL)


def test_dit_without_reference_branch_matches_jax():
    """cross_latents=None skips the Perceivers on both sides."""
    jmodel, params, tmodel, rope = _pair(True)
    hidden, text, t, inpaint, _ = _inputs(2)
    jrope = tuple(jnp.asarray(x) for x in rope)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(hidden), jnp.asarray(text),
                                   jnp.asarray(t), jnp.asarray(inpaint), None,
                                   image_rotary_emb=jrope))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(hidden), torch.from_numpy(text), torch.from_numpy(t),
                     torch.from_numpy(inpaint), None,
                     image_rotary_emb=tuple(torch.from_numpy(x) for x in rope)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_rope_tables_and_rotation_match_jax():
    cos, sin = rope_for_sample(64, 384, 672, 13)
    jcos, jsin = jax_rope_for_sample(64, 384, 672, 13)
    np.testing.assert_array_equal(cos, jcos)
    np.testing.assert_array_equal(sin, jsin)
    x = np.random.default_rng(3).standard_normal((2, 24, 3, 16)).astype(np.float32)
    c, s = (t[:24, None, :16] for t in (cos, sin))
    want = np.asarray(jax_apply_rotary_emb(jnp.asarray(x), jnp.asarray(c), jnp.asarray(s)))
    got = apply_rotary_emb(torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_timestep_embedding_matches_jax():
    t = np.asarray([0.0, 1.0, 311.0, 999.0], np.float32)
    want = np.asarray(jax_timestep_embedding(jnp.asarray(t), 3072))
    got = timestep_embedding(torch.from_numpy(t), 3072).numpy()
    # sin/cos of arguments up to 999 rad: fp32 argument rounding is ~6e-5
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
