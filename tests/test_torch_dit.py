"""Port DiT (trajectorycrafter_tpu_torch/models/dit.py) vs the JAX DiT.

The tiny config of tests/test_dit.py, fp32, the JAX model with
``attention_impl="xla"`` (the einsum path) and the port on the CPU (its plain
attention); the port gets the JAX weights through ``dit_from_jax`` and a
strict ``load_state_dict``.  Weights and inputs come from
``np.random.default_rng`` (tests/torch_parity.py).

Tolerance: 2e-5 absolute and relative.  Both sides are fp32; they differ in
summation order (matmul blocking, softmax, layer-norm variance) over 4
blocks, which at O(1) activations stays near 1e-6.  The same holds with
``attention_impl="flash"`` on both sides (JAX's Pallas K1 in interpret
mode); the RoPE tables match exactly at 576x1024, 384x672 and 144x256.
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


@pytest.mark.parametrize("height,width,frames", [
    (576, 1024, 13),  # the JAX bench's diffusion size: a 36 x 64 grid, 29,952 video tokens
    (384, 672, 13),  # the default sample size: 24 x 42
    (144, 256, 3),  # a small 9:16 size: 9 x 16
], ids=["576x1024", "384x672", "144x256"])
def test_rope_for_sample_matches_jax(height, width, frames):
    """The tables and the crop region of the grid against the 30 x 45 base
    grid (480x720), exactly: both build them in float64 numpy."""
    from trajectorycrafter_tpu.ops.rope import (
        get_resize_crop_region_for_grid as jax_crop_region,
    )
    from trajectorycrafter_tpu_torch.ops.rope import get_resize_crop_region_for_grid

    grid = (height // 16, width // 16)
    assert get_resize_crop_region_for_grid(grid, 45, 30) == jax_crop_region(grid, 45, 30)
    cos, sin = rope_for_sample(64, height, width, frames)
    jcos, jsin = jax_rope_for_sample(64, height, width, frames)
    assert cos.shape == (frames * grid[0] * grid[1], 64)
    np.testing.assert_array_equal(cos, jcos)
    np.testing.assert_array_equal(sin, jsin)


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


def test_dit_flash_pv8_matches_jax():
    """``attention_impl="flash_pv8"`` on both sides: the joint self-attention
    and the Perceivers run K6's function (the port's plain version on the
    CPU, the JAX Pallas kernel in interpret mode, patched in as
    tests/test_int8_attention.py does).  Tolerance as the exact model's
    plus K6's: a softmax code that the two sides' fp32 scores round
    differently moves an attention output by |v| / (its row's code sum), and
    four blocks carry that on; 2e-3 absolute on O(1) outputs, and the
    output moves well beyond it against the exact-attention model."""
    import unittest.mock as mock

    from trajectorycrafter_tpu.ops.pallas import flash_pv8 as jax_flash_pv8

    rope = jax_rope_for_sample(16, 8 * 8, 12 * 8, 3)
    jmodel = JaxDiT(**TINY, attention_impl="flash_pv8")
    make = lambda: CrossTransformer3DModel(**TINY, attention_impl="flash_pv8")
    params = jax_tree(make(), 0, convert_dit, num_layers=TINY["num_layers"])
    tmodel = make()
    tmodel.load_state_dict(dit_from_jax(params), strict=True)
    args = _inputs(1)
    orig = jax_flash_pv8.flash_attention_exp2_t_pv8

    def interp(*a, **kw):
        return orig(*a, **{**kw, "interpret": True})

    with mock.patch.object(jax_flash_pv8, "flash_attention_exp2_t_pv8", interp):
        want = np.asarray(jax.jit(jmodel.apply)(
            {"params": params}, *(jnp.asarray(a) for a in args),
            image_rotary_emb=tuple(jnp.asarray(t) for t in rope)))
    trope = tuple(torch.from_numpy(t) for t in rope)
    with torch.no_grad():
        got = tmodel.eval()(*(torch.from_numpy(a) for a in args), image_rotary_emb=trope).numpy()
        for m in tmodel.modules():
            if hasattr(m, "attention_impl"):
                m.attention_impl = "reference"
        exact = tmodel(*(torch.from_numpy(a) for a in args), image_rotary_emb=trope).numpy()
    assert got.shape == (1, 3, 8, 12, 4)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
    assert np.abs(exact - want).max() > 1e-2


def test_dit_flash_matches_jax():
    """``attention_impl="flash"``, the route both JAX benches build the DiT
    with: the JAX model runs the joint self-attention and the Perceivers on
    the Pallas K1 kernel in interpret mode (patched in as
    tests/test_torch_attention.py does), the port on K1's plain version on
    the CPU.  Tolerance as ``test_dit_matches_jax``'s, 2e-5: fp32 on both
    sides, and the kernel's fixed exp2 bias in place of a running max moves
    nothing at these scores."""
    import unittest.mock as mock

    from trajectorycrafter_tpu.ops.pallas import flash_exp2 as jax_flash_exp2

    rope = jax_rope_for_sample(16, 8 * 8, 12 * 8, 3)
    jmodel = JaxDiT(**TINY, attention_impl="flash")
    make = lambda: CrossTransformer3DModel(**TINY, attention_impl="flash")
    params = jax_tree(make(), 0, convert_dit, num_layers=TINY["num_layers"])
    tmodel = make()
    tmodel.load_state_dict(dit_from_jax(params), strict=True)
    args = _inputs(1)
    orig, calls = jax_flash_exp2.flash_attention_exp2_t, []

    def interp(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **{**kw, "interpret": True})

    with mock.patch.object(jax_flash_exp2, "flash_attention_exp2_t", interp):
        want = np.asarray(jax.jit(jmodel.apply)(
            {"params": params}, *(jnp.asarray(a) for a in args),
            image_rotary_emb=tuple(jnp.asarray(t) for t in rope)))
    with torch.no_grad():
        got = tmodel.eval()(*(torch.from_numpy(a) for a in args),
                            image_rotary_emb=tuple(torch.from_numpy(t) for t in rope)).numpy()
    assert len(calls) == TINY["num_layers"] + TINY["num_layers"] // 2  # blocks, Perceivers
    assert got.shape == (1, 3, 8, 12, 4)
    np.testing.assert_allclose(got, want, **TOL)
