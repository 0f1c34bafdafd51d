"""Port attention (trajectorycrafter_tpu_torch/ops/attention.py) vs the JAX package.

The plain version ``attention_reference`` is held against the JAX einsum
``_xla_attention`` and against the Pallas kernel ``flash_attention_exp2_t``
run in interpret mode (the kernel the hand-written CUDA one replaces).
Inputs are fp32 from ``np.random.default_rng``; tolerance 1e-5 absolute:
both sides compute fp32 softmax attention and differ only in summation
order (and, for the Pallas kernel, exp2 with a fixed bias instead of a
running max) -- at unit-variance inputs the outputs are O(1) and fp32
rounding stays near 1e-6.

The tolerance the CUDA kernel is held to on the card (``attention_error``)
is checked here too: it passes a sound bf16 answer and fails planted faults.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from trajectorycrafter_tpu.ops.attention import _xla_attention
from trajectorycrafter_tpu.ops.pallas.flash_exp2 import flash_attention_exp2_t
from trajectorycrafter_tpu_torch.ops.attention import (
    attention_error,
    attention_reference,
    multi_head_attention,
)
from trajectorycrafter_tpu_torch.ops.kernels import FLASH_KEY_TILE, flash_attention

torch.set_num_threads(1)
ATOL = 1e-5


def _qkv(seed, b, h, sq, skv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, h, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, h, d)).astype(np.float32)
    return q, k, v


def _jax_bshd(fn, q, k, v, *args):
    """Run a JAX (B, H, S, D) attention on (B, S, H, D) numpy inputs."""
    qt, kt, vt = (jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v))
    return np.swapaxes(np.asarray(fn(qt, kt, vt, *args)), 1, 2)


@pytest.mark.parametrize("shape", [
    (1, 2, 256, 256, 64),  # DiT head dim
    (2, 3, 77, 130, 128),  # Perceiver head dim, cross lengths
    (1, 1, 5, 300, 16),  # dev-model head dim
])
def test_reference_matches_xla_attention(shape):
    b, h, sq, skv, d = shape
    q, k, v = _qkv(0, b, h, sq, skv, d)
    scale = d ** -0.5
    want = _jax_bshd(_xla_attention, q, k, v, scale)
    # chunk=32 runs several query chunks and a ragged last one
    got = attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), scale, chunk=32)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_reference_matches_flash_exp2_interpret():
    """Against the Pallas kernel in interpret mode, with the TPU dispatch's
    zero-padded tail (200 real tokens padded to 256) and its kv_pad count."""
    b, h, s, s_pad, d = 1, 2, 200, 256, 64
    q, k, v = _qkv(1, b, h, s, s, d)
    pad = lambda x: np.pad(x, ((0, 0), (0, s_pad - s), (0, 0), (0, 0)))
    scale = d ** -0.5

    def kernel(qt, kt, vt):
        out_t = flash_attention_exp2_t(qt, kt, vt, kv_pad=s_pad - s, sm_scale=scale,
                                       block_q=128, block_k=128, interpret=True)
        return jnp.swapaxes(out_t, 2, 3)  # (B, H, D, S) -> (B, H, S, D)

    want = _jax_bshd(kernel, pad(q), pad(k), pad(v))[:, :s]
    got = attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), scale)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_multi_head_attention_takes_plain_version_on_cpu():
    """On CPU tensors the dispatch computes the plain version and never
    touches the kernel: the launch counter stays put."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 2, 4, 33, 21, 64))
    before = flash_attention.launches
    got = multi_head_attention(q, k, v, scale=0.2)
    assert flash_attention.launches == before
    assert got.shape == (2, 33, 4 * 64)
    want = attention_reference(q, k, v, 0.2).reshape(2, 33, 4 * 64)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    # "reference" is the same plain version on any device
    torch.testing.assert_close(multi_head_attention(q, k, v, 0.2, impl="reference"), want,
                               atol=0, rtol=0)


def _exact_bf16(q, k, v, scale):
    """Attention in float64, rounded once to bf16: a sound bf16 kernel."""
    qt, kt, vt = (x.double().transpose(1, 2) for x in (q, k, v))
    weights = torch.softmax(qt @ kt.transpose(-1, -2) * scale, dim=-1)
    return (weights @ vt).transpose(1, 2).bfloat16()


@pytest.mark.parametrize("shape,gain", [
    ((1, 2, 128, 4096, 64), 1.0),  # flat softmax over many key tiles (the DiT's case)
    ((1, 2, 128, 3024, 128), 4.0),  # peaked softmax (the Perceiver's, no QK-norm)
    ((1, 2, 200, 1000, 64), 1.0),  # ragged last key tile
], ids=["flat_d64", "peaked_d128", "ragged_d64"])
def test_attention_error_passes_sound_and_rejects_planted_faults(shape, gain):
    """The kernel's tolerance (``attention_error``) sits between a sound bf16
    answer and the two faults it must catch: a row sum off by 10%, and the
    last quarter of the key tiles skipped."""
    b, h, sq, skv, d = shape
    q, k, v = _qkv(4, b, h, sq, skv, d)
    q, k, v = (torch.from_numpy(x).bfloat16() for x in (q * gain, k, v))
    scale = d ** -0.5
    sound = _exact_bf16(q, k, v, scale)
    assert attention_error(sound, q, k, v, scale)["ok"]
    row_sum_off = (sound.float() / 1.1).bfloat16()
    assert not attention_error(row_sum_off, q, k, v, scale)["ok"]
    tiles = -(-skv // FLASH_KEY_TILE)
    keep = (tiles - tiles // 4) * FLASH_KEY_TILE
    tiles_skipped = _exact_bf16(q, k[:, :keep], v[:, :keep], scale)
    assert not attention_error(tiles_skipped, q, k, v, scale)["ok"]


def test_dispatch_and_wrapper_reject_what_they_do_not_take():
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 1, 2, 8, 8, 64))
    with pytest.raises(ValueError, match="unknown attention impl"):
        multi_head_attention(q, k, v, impl="flash_stock")
    # the kernel wrapper takes CUDA tensors only: it never falls back
    before = flash_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), 0.125)
    assert flash_attention.launches == before
