"""The port's T5 encoder (trajectorycrafter_tpu_torch/models/t5.py) vs the JAX package.

Seeded numpy weights into a tiny port T5 (3 layers, 4 heads of 8, d_model
32), through ``convert_t5_encoder`` into the JAX tree (checked against the
flax model's parameter paths and shapes) and back through ``t5_from_jax``;
fp32, ids with a padded second row.  Tolerance 1e-4 absolute and relative:
both sides compute the same fp32 RMS norms, biased softmax and gated gelu
and differ in summation order only (readings ~1e-6 on outputs of order 1).
Also the relative-position buckets (exact), and the stand-in token ids the
prompt encode feeds T5 until the tokenizer is ported.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch_parity import jax_tree

from trajectorycrafter_tpu.models.t5 import T5Config
from trajectorycrafter_tpu.models.t5 import T5EncoderModel as JaxT5
from trajectorycrafter_tpu.models.t5 import relative_position_bucket as jax_bucket
from trajectorycrafter_tpu.utils.convert import convert_t5_encoder
from trajectorycrafter_tpu_torch.models.t5 import T5EncoderModel, relative_position_bucket
from trajectorycrafter_tpu_torch.orchestrator import stand_in_token_ids, T5PromptEncoder
from trajectorycrafter_tpu_torch.utils.weights import t5_from_jax

torch.set_num_threads(1)
T5_TINY = dict(vocab_size=100, d_model=32, d_kv=8, d_ff=64, num_layers=3, num_heads=4)


@pytest.fixture(scope="module")
def t5s():
    params = jax_tree(T5EncoderModel(**T5_TINY), 0, convert_t5_encoder, num_layers=3)
    jt5 = JaxT5(T5Config(**T5_TINY))
    shapes = jax.eval_shape(jt5.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 11), jnp.int32))["params"]
    flat = lambda t: {jax.tree_util.keystr(k): tuple(v.shape)
                      for k, v in jax.tree_util.tree_leaves_with_path(t)}
    assert flat(params) == flat(shapes)
    t5 = T5EncoderModel(**T5_TINY)
    t5.load_state_dict(t5_from_jax(params), strict=True)
    return (jt5, params), t5.eval()


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "padded_row"])
def test_t5_matches_jax(t5s, masked):
    (jt5, params), t5 = t5s
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 100, (2, 11))
    mask = np.ones((2, 11), bool)
    mask[1, 7:] = False
    jmask = jnp.asarray(mask) if masked else None
    want = np.asarray(jt5.apply({"params": params}, jnp.asarray(ids), jmask))
    with torch.no_grad():
        got = t5(torch.from_numpy(ids), torch.from_numpy(mask) if masked else None).numpy()
    assert got.shape == (2, 11, 32)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_relative_position_buckets_match_jax():
    pos = np.arange(300)
    rel = pos[None, :] - pos[:, None]
    for buckets, distance in ((32, 128), (8, 20)):
        np.testing.assert_array_equal(relative_position_bucket(rel, buckets, distance),
                                      jax_bucket(rel, buckets, distance))


def test_stand_in_token_ids_are_a_function_of_the_prompt(t5s):
    """Same prompt, same ids (in any process: the seed is the sha256, not
    Python's salted ``hash``); another prompt, other ids; all in the vocab."""
    a = stand_in_token_ids("a scene", 226, 32128)
    assert a.shape == (1, 226) and a.dtype == torch.int64
    assert 0 <= a.min() and a.max() < 32128
    assert torch.equal(a, stand_in_token_ids("a scene", 226, 32128))
    assert not torch.equal(a, stand_in_token_ids("a scene.", 226, 32128))
    assert torch.equal(stand_in_token_ids("", 16, 100), stand_in_token_ids("", 16, 100))
    # the bundle's encode: both prompts in one batch, each row on its own ids
    _, t5 = t5s
    pe, ne = T5PromptEncoder(t5, 9)("a scene", None)
    assert pe.shape == ne.shape == (1, 9, 32)
    with torch.no_grad():
        torch.testing.assert_close(pe, t5(stand_in_token_ids("a scene", 9, 100)))
        torch.testing.assert_close(ne, t5(stand_in_token_ids("", 9, 100)))
