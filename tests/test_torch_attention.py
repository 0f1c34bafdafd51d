"""Port attention (trajectorycrafter_tpu_torch/ops/attention.py) vs the JAX package.

The plain version ``attention_reference`` is held against the JAX einsum
``_xla_attention`` and against the Pallas kernel ``flash_attention_exp2_t``
run in interpret mode (the kernel the hand-written CUDA one replaces).
Inputs are fp32 from ``np.random.default_rng``; tolerance 1e-5 absolute:
both sides compute fp32 softmax attention and differ only in summation
order (and, for the Pallas kernel, exp2 with a fixed bias instead of a
running max) -- at unit-variance inputs the outputs are O(1) and fp32
rounding stays near 1e-6.

The plain version is also held against the two-pass kernel
``flash_attention_maxpass`` in interpret mode (K4b, the depth UNet's opt-in
kernel), at unbounded scores, all-negative score rows and padded keys.  The
depth UNet's routing rule (which attention shapes launch a kernel) is
checked from its shapes at 576x1024; ``flash_pv8`` is routed there too.
The JAX package's route names ``"flash"`` (K1, against its dispatch with
the Pallas kernel in interpret mode) and the depth UNet's ``"xla"`` are
accepted; unknown names are refused on both routes.

The tolerance the CUDA kernels are held to on the card (``attention_error``)
is checked here too: it passes a sound bf16 answer and fails planted faults.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from trajectorycrafter_tpu.ops.attention import _xla_attention
from trajectorycrafter_tpu.ops.pallas.flash_exp2 import flash_attention_exp2_t
from trajectorycrafter_tpu.ops.pallas.flash_max import flash_attention_maxpass
from trajectorycrafter_tpu_torch.models.depthcrafter import (
    DEPTH_ATTN_ENV,
    UNetSpatioTemporalConditionModel,
    depth_attention_impl,
)
from trajectorycrafter_tpu_torch.ops.attention import (
    attention_error,
    attention_reference,
    maxpass_plain_inputs,
    maxpass_reference,
    multi_head_attention,
    output_error,
)
from trajectorycrafter_tpu_torch.ops.attention_variants import pv8_block_k, pv8_reference
from trajectorycrafter_tpu_torch.ops.kernels import (
    ATTENTION_KEY_TILE,
    BWD_DKV_QUERY_TILE,
    BWD_DQ_KEY_TILE,
    flash_attention,
    flash_exp2,
    flash_lse,
    flash_maxpass,
    flash_pv8,
)

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
    touches a kernel: the launch counters stay put, whichever impl."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 2, 4, 33, 21, 64))
    before = flash_attention.launches, flash_maxpass.launches
    want = attention_reference(q, k, v, 0.2).reshape(2, 33, 4 * 64)
    # "reference" and "xla" are the same plain version on any device
    for impl in ("auto", "flash_stock", "reference", "xla"):
        got = multi_head_attention(q, k, v, scale=0.2, impl=impl)
        assert got.shape == (2, 33, 4 * 64)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    # "flash_max" computes the two-pass kernel's own function
    got = multi_head_attention(q, k, v, scale=0.2, impl="flash_max")
    torch.testing.assert_close(got, maxpass_reference(q, k, v, 0.2).reshape(2, 33, 4 * 64),
                               atol=0, rtol=0)
    assert (flash_attention.launches, flash_maxpass.launches) == before


@pytest.mark.parametrize("shape", [
    (1, 2, 200, 200, 64),  # DiT head dim: 200 tokens padded to the 512 block
    (2, 2, 77, 130, 128),  # Perceiver head dim, cross lengths
], ids=["self_d64", "cross_d128"])
def test_flash_route_matches_the_jax_flash_route(shape):
    """``impl="flash"``, the JAX package's name of its K1 route (its benches
    build the DiT with it), is accepted: on CPU tensors it takes K1's plain
    version, bit for bit what ``"auto"`` gives, launches nothing, and
    matches JAX's ``multi_head_attention(impl="flash")`` with the Pallas
    kernel in interpret mode (the dispatch's zero-padded tail and
    ``kv_pad``) within ``ATOL`` (fp32 on both sides, the kernel's fixed
    exp2 bias in place of a running max)."""
    from unittest import mock

    from trajectorycrafter_tpu.ops import attention as jax_attention
    from trajectorycrafter_tpu.ops.pallas import flash_exp2 as jax_flash_exp2

    b, h, sq, skv, d = shape
    q, k, v = _qkv(7, b, h, sq, skv, d)
    orig, calls = jax_flash_exp2.flash_attention_exp2_t, []

    def interp(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **{**kw, "interpret": True})

    with mock.patch.object(jax_flash_exp2, "flash_attention_exp2_t", interp):
        want = np.asarray(jax_attention.multi_head_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="flash"))
    assert len(calls) == 1
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    before = flash_attention.launches
    got = multi_head_attention(tq, tk, tv, impl="flash")
    assert flash_attention.launches == before
    torch.testing.assert_close(got, multi_head_attention(tq, tk, tv, impl="auto"),
                               atol=0, rtol=0)
    assert got.shape == (b, sq, h * d)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_route_names_of_the_jax_package_are_accepted_and_unknown_ones_refused(monkeypatch):
    """Both routes take the names the JAX package takes: ``multi_head_attention``
    ``"flash"`` (K1) and ``"xla"``, the depth UNet's ``TRAJCRAFTER_DEPTH_ATTN``
    (or a module's ``attention_impl``) ``"xla"``, which takes the plain
    version even where a kernel would launch, as the JAX UNet hands it on to
    its einsum.  A name neither package knows is refused on both routes,
    where the JAX dispatch would send it to XLA without a word."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 1, 2, 8, 8, 64))
    for impl in ("flash", "xla"):
        assert multi_head_attention(q, k, v, impl=impl).shape == (1, 8, 2 * 64)
    for impl in ("flsh", "flash_bogus", "XLA"):
        with pytest.raises(ValueError, match="unknown attention impl"):
            multi_head_attention(q, k, v, impl=impl)
    monkeypatch.setenv(DEPTH_ATTN_ENV, "xla")
    assert depth_attention_impl(9216, 9216, True) == "xla"
    assert depth_attention_impl(2304, 2304, True) == "xla"
    assert depth_attention_impl(9216, 9216, False) == "xla"
    assert depth_attention_impl(9216, 9216, True, "flash_stock") == "flash_stock"
    monkeypatch.delenv(DEPTH_ATTN_ENV)
    assert depth_attention_impl(9216, 9216, True, "xla") == "xla"
    for impl in ("flsh", "XLA"):
        monkeypatch.setenv(DEPTH_ATTN_ENV, impl)
        with pytest.raises(ValueError, match="'xla'"):  # the message lists the names
            depth_attention_impl(9216, 9216, True)


def test_flash_max_on_cpu_is_the_two_pass_kernels_function():
    """On a CPU tensor ``impl="flash_max"`` computes what the two-pass Pallas
    kernel (interpret mode) computes in bf16 -- the attention of q * scale *
    log2(e) rounded to bf16 -- within ``output_error``'s bound around the
    kernel's output; with peaked scores (q x 6) it sits outside the bound
    around the unrounded attention."""
    q, k, v = _qkv(6, 1, 2, 128, 256, 64)
    q, k, v = (torch.from_numpy(x).bfloat16() for x in (q * 6.0, k, v))
    scale = 64 ** -0.5
    to_jax = lambda x: jnp.asarray(x.float().numpy()).astype(jnp.bfloat16).swapaxes(1, 2)

    def pallas(v_in):
        out_t = flash_attention_maxpass(to_jax(q), to_jax(k), to_jax(v_in), sm_scale=scale,
                                        block_q=128, block_k=128, interpret=True)
        return torch.from_numpy(np.array(out_t.transpose(0, 3, 1, 2).astype(jnp.float32)))

    before = flash_maxpass.launches
    got = multi_head_attention(q, k, v, scale=scale, impl="flash_max").reshape(q.shape)
    assert flash_maxpass.launches == before
    held = output_error(got, pallas(v), pallas(v.abs()))
    assert held["ok"] and held["max_row_rel_err"] < 2 ** -7, held
    assert not attention_error(got, q, k, v, scale)["ok"]


def test_flash_pv8_takes_its_plain_version_on_cpu():
    """``flash_pv8`` computes K6's quantized function, not the exact
    attention: on CPU tensors it takes K6's plain version (with the JAX
    dispatch's key block), as ``flash_pv8_reference`` does on any device,
    and launches nothing."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 2, 4, 33, 21, 64))
    before = flash_pv8.launches
    want = pv8_reference(q, k, v, 0.2, pv8_block_k(33)).reshape(2, 33, 4 * 64)
    for impl in ("flash_pv8", "flash_pv8_reference"):
        got = multi_head_attention(q, k, v, scale=0.2, impl=impl)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert flash_pv8.launches == before
    exact = multi_head_attention(q, k, v, scale=0.2, impl="reference")
    assert (got - exact).abs().max() > 1e-3  # a function of its own


@pytest.mark.parametrize("case", ["unbounded", "all_negative", "padded_keys"])
def test_reference_matches_flash_maxpass_interpret(case):
    """Against the two-pass Pallas kernel in interpret mode, as
    tests/test_flash_max.py runs it: scores spanning ~[-90, 90] (no
    QK-norm), rows whose every score is far below zero, and 200 real keys
    zero-padded to 256 with the kernel's ``kv_pad`` count."""
    rng = np.random.default_rng(5)
    b, h, s, d = 1, 2, 256, 32
    q = rng.standard_normal((b, s, h, d)) * 6
    k = rng.standard_normal((b, s, h, d)) * 6
    v = rng.standard_normal((b, s, h, d))
    s_real = s
    if case == "all_negative":
        q = rng.standard_normal((b, s, h, d)) + 4.0
        k = -(rng.standard_normal((b, s, h, d)) * 0.1 + 4.0)
    elif case == "padded_keys":
        s_real = 200
        k[:, s_real:] = 0.0
        v[:, s_real:] = 0.0
    q, k, v = (x.astype(np.float32) for x in (q, k, v))
    scale = d ** -0.5

    def kernel(qt, kt, vt):
        out_t = flash_attention_maxpass(qt, kt, vt, kv_pad=s - s_real, sm_scale=scale,
                                        block_q=128, block_k=128, interpret=True)
        return jnp.swapaxes(out_t, 2, 3)

    want = _jax_bshd(kernel, q, k, v)
    got = attention_reference(*(torch.from_numpy(x) for x in (q, k[:, :s_real], v[:, :s_real])),
                              scale)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


def test_flash_maxpass_in_bf16_is_the_attention_of_its_rounded_q():
    """In bf16 the two-pass Pallas kernel (interpret mode) rounds q * scale *
    log2(e) to bf16 before the product: with peaked scores (q x 6) it sits
    outside the bound around the unrounded attention, and well inside it
    around ``attention_reference`` on ``maxpass_plain_inputs`` -- the plain
    version the CUDA two-pass kernel is held to."""
    q, k, v = _qkv(6, 1, 2, 128, 256, 64)
    q, k, v = (torch.from_numpy(x).bfloat16() for x in (q * 6.0, k, v))
    scale = 64 ** -0.5
    to_jax = lambda x: jnp.asarray(x.float().numpy()).astype(jnp.bfloat16).swapaxes(1, 2)
    out_t = flash_attention_maxpass(to_jax(q), to_jax(k), to_jax(v), sm_scale=scale,
                                    block_q=128, block_k=128, interpret=True)
    out = torch.from_numpy(np.array(out_t.transpose(0, 3, 1, 2).astype(jnp.float32))).bfloat16()
    q_rounded, scale_base2 = maxpass_plain_inputs(q, scale)
    own = attention_error(out, q_rounded, k, v, scale_base2)
    assert own["ok"] and own["max_row_rel_err"] < 2 ** -7, own
    assert not attention_error(out, q, k, v, scale)["ok"]


def test_depth_unet_routing_rule(monkeypatch):
    """At 576x1024 (latents 72 x 128) the rule sends the spatial
    self-attention of the 9,216- and 2,304-token levels to a kernel (10 per
    UNet forward: 2 + 2 down, 3 + 3 up), and the 576- and 144-token
    levels, all temporal attention over 49 frames and all cross-attention
    to the one CLIP token to the plain version; nothing launches off the
    card."""
    monkeypatch.delenv(DEPTH_ATTN_ENV, raising=False)
    assert depth_attention_impl(9216, 9216, True) == "flash_stock"
    assert depth_attention_impl(2304, 2304, True) == "flash_stock"
    assert depth_attention_impl(1024, 1024, True) == "flash_stock"  # 2^20, the threshold
    for s, s_kv in ((576, 576), (144, 144), (49, 49), (9216, 1), (1023, 1024)):
        assert depth_attention_impl(s, s_kv, True) == "xla"
    assert depth_attention_impl(9216, 9216, False) == "xla"
    assert depth_attention_impl(9216, 9216, True, "reference") == "reference"
    monkeypatch.setenv(DEPTH_ATTN_ENV, "flash_max")
    assert depth_attention_impl(9216, 9216, True) == "flash_max"
    assert depth_attention_impl(9216, 9216, True, "flash_stock") == "flash_stock"
    monkeypatch.setenv(DEPTH_ATTN_ENV, "flash_pv8")  # routed, as the JAX UNet passes it on
    assert depth_attention_impl(9216, 9216, True) == "flash_pv8"
    assert depth_attention_impl(576, 576, True) == "xla"
    monkeypatch.setenv(DEPTH_ATTN_ENV, "flash_bogus")
    with pytest.raises(ValueError, match="flash_bogus"):
        depth_attention_impl(9216, 9216, True)
    monkeypatch.delenv(DEPTH_ATTN_ENV)

    # the count per UNet forward, from the deployed module's attention layers
    with torch.device("meta"):
        unet = UNetSpatioTemporalConditionModel()
    tokens = {0: 72 * 128, 1: 36 * 64, 2: 18 * 32, 3: 9 * 16}
    kernel_calls = 0
    for part, levels in (("down", unet.down_blocks), ("up", unet.up_blocks)):
        for i, level in enumerate(levels):
            depth = i if part == "down" else len(levels) - 1 - i
            for attn in level.attentions:
                for blk in attn.transformer_blocks:
                    n = tokens[depth]
                    kernel_calls += depth_attention_impl(n, n, True) != "xla"
                    assert depth_attention_impl(n, 1, True) == "xla"  # attn2, CLIP
                for blk in attn.temporal_transformer_blocks:
                    assert depth_attention_impl(49, 49, True) == "xla"
    assert depth_attention_impl(tokens[3], tokens[3], True) == "xla"  # mid block
    assert kernel_calls == 10


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
    tiles = -(-skv // ATTENTION_KEY_TILE)
    keep = (tiles - tiles // 4) * ATTENTION_KEY_TILE
    tiles_skipped = _exact_bf16(q, k[:, :keep], v[:, :keep], scale)
    assert not attention_error(tiles_skipped, q, k, v, scale)["ok"]


def test_dispatch_and_wrapper_reject_what_they_do_not_take():
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 1, 2, 8, 8, 64))
    # the ring route needs its sp axis (ops/ring_attention.py;
    # tests/test_torch_ring_attention.py runs it in gloo worlds)
    with pytest.raises(ValueError, match="ring route needs the sp axis"):
        multi_head_attention(q, k, v, impl="ring")
    with pytest.raises(ValueError, match="unknown attention impl"):
        multi_head_attention(q, k, v, impl="rings")
    # the kernel wrappers take CUDA tensors only: they never fall back
    for wrapper in (flash_attention, flash_maxpass, flash_lse, flash_exp2):
        before = wrapper.launches
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(q.bfloat16(), k.bfloat16(), v.bfloat16(), 0.125)
        assert wrapper.launches == before


def test_quantized_wrappers_reject_cpu_tensors():
    """K6's and K7's wrappers take CUDA tensors only, as the others do."""
    from trajectorycrafter_tpu_torch.ops.attention_variants import pv8_keys_last, quantize_per_head
    from trajectorycrafter_tpu_torch.ops.kernels import int8_flash_attention

    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(3, 1, 2, 8, 8, 64))
    v8, vs = quantize_per_head(v)
    q8, _ = quantize_per_head(q)
    for call in (lambda: flash_pv8(q, k, pv8_keys_last(v8), vs.reshape(-1), 0.18, 512),
                 lambda: int8_flash_attention(q8, q8, pv8_keys_last(v8), vs.reshape(-1),
                                              vs.reshape(-1), 128)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert flash_pv8.launches == 0 and int8_flash_attention.launches == 0


# ----------------------------------------------------------------------------
# the gradient: the plain backward against jax.grad, the autograd Function
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [
    (1, 2, 130, 130, 64),  # DiT head dim, ragged around 64-row tiles
    (2, 2, 77, 203, 128),  # Perceiver head dim, cross lengths
    (1, 3, 65, 63, 64),
])
def test_backward_reference_matches_jax_grad(shape):
    """``attention_backward_reference`` on the forward's out and lse against
    ``jax.grad`` of the JAX ``multi_head_attention(impl="xla")`` (the plain
    reference of K4 and its backward kernels): fp32 on both sides, rtol 1e-5
    (atol 1e-6 for the entries that cancel to near zero)."""
    from trajectorycrafter_tpu.ops.attention import multi_head_attention as jax_mha
    from trajectorycrafter_tpu_torch.ops.attention import attention_backward_reference
    from trajectorycrafter_tpu_torch.ops.attention_variants import lse_reference

    b, h, sq, skv, d = shape
    q, k, v = _qkv(5, b, h, sq, skv, d)
    dout = np.random.default_rng(6).standard_normal((b, sq, h, d)).astype(np.float32)
    scale = d ** -0.5
    loss = lambda q, k, v: jnp.sum(jax_mha(q, k, v, scale, impl="xla")
                                   * jnp.asarray(dout).reshape(b, sq, h * d))
    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, dout))
    out, lse = attention_reference(tq, tk, tv, scale), lse_reference(tq, tk, scale)
    got = attention_backward_reference(tq, tk, tv, out, lse, tdo, scale)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_function_passes_gradcheck_in_float64_on_cpu():
    """On the CPU the Function takes its plain versions, which keep float64:
    ``torch.autograd.gradcheck`` against finite differences."""
    from trajectorycrafter_tpu_torch.ops.attention import FlashAttentionFunction
    from trajectorycrafter_tpu_torch.ops.attention_variants import lse_reference

    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in ((1, 6, 2, 8), (1, 9, 2, 8), (1, 9, 2, 8)))
    assert attention_reference(q, k, v, 0.3).dtype == torch.float64
    assert lse_reference(q, k, 0.3).dtype == torch.float64
    assert torch.autograd.gradcheck(lambda *x: FlashAttentionFunction.apply(*x, 0.3),
                                    (q, k, v))


def test_flash_stock_under_autograd_takes_the_function_and_auto_the_plain_ops():
    """With a gradient needed, ``flash_stock`` runs the Function (on the CPU
    its plain versions) and ``auto`` autograd through the plain version; both
    give jax.grad's gradients' values, and no kernel counter moves."""
    from trajectorycrafter_tpu_torch.ops.kernels import (
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )

    q, k, v = (torch.from_numpy(x) for x in _qkv(8, 1, 2, 40, 50, 64))
    dout = torch.from_numpy(np.random.default_rng(9).standard_normal((1, 40, 128))
                            .astype(np.float32))
    counters = (flash_lse, flash_attention_bwd_dkv, flash_attention_bwd_dq)
    before = [c.launches for c in counters]
    grads = {}
    for impl in ("flash_stock", "auto"):
        x = [t.clone().requires_grad_() for t in (q, k, v)]
        out = multi_head_attention(*x, impl=impl)
        assert ("FlashAttentionFunction" in type(out.grad_fn.next_functions[0][0]).__name__) == (
            impl == "flash_stock")
        grads[impl] = torch.autograd.grad(out, x, dout)
    for a, b in zip(grads["flash_stock"], grads["auto"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert [c.launches for c in counters] == before
    with torch.no_grad():
        out = multi_head_attention(q.requires_grad_(), k, v, impl="flash_stock")
    assert out.grad_fn is None


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def _tiled_backward(q, k, v, dout, lse, di, scale, fault=None):
    """The backward kernels' arithmetic as they pair their operands, in
    float32 (csrc/flash_attention_bwd.cu): dK/dV per 64 keys (a warpgroup's
    rows) from S^T = k q^T and dP^T = v dO^T over tiles of
    ``BWD_DKV_QUERY_TILE`` queries, zero past Sq, lse (+inf past Sq) and di
    (0 past Sq) per column; dQ per 64 queries from S = q k^T and dP = dO v^T
    over tiles of ``BWD_DQ_KEY_TILE`` keys, zero past Skv and p = 0 there.
    p and ds are rounded to bf16 before their products, the sums stay fp32.
    ``fault="q_transposed"``: the dK product reads the q tile transposed
    (q_tile^T in place of q_tile; a square tile at head dim 64).  (B, S, H,
    D) in, (dq, dk, dv) out."""
    qt, kt, vt, dot = (x.transpose(1, 2).float() for x in (q, k, v, dout))  # (B, H, S, D)
    b, h, sq, d = qt.shape
    skv = kt.shape[2]
    log2e = 1.4426950408889634
    pad_rows = lambda x, n: torch.nn.functional.pad(x, (0, 0, 0, n - x.shape[2]))
    nq = -(-sq // BWD_DKV_QUERY_TILE) * BWD_DKV_QUERY_TILE
    nk = -(-skv // BWD_DQ_KEY_TILE) * BWD_DQ_KEY_TILE
    qp, dop = pad_rows(qt, nq), pad_rows(dot, nq)
    kp, vp = pad_rows(kt, nk), pad_rows(vt, nk)
    lse2 = torch.full((b, h, nq), float("inf"))
    lse2[..., :sq] = lse.float() * log2e
    dip = torch.zeros((b, h, nq))
    dip[..., :sq] = di.float()
    dk, dv = torch.zeros_like(kt), torch.zeros_like(vt)
    for k0 in range(0, skv, 64):
        kb, vb = kt[:, :, k0:k0 + 64], vt[:, :, k0:k0 + 64]
        acc_k, acc_v = torch.zeros_like(kb), torch.zeros_like(vb)
        for j in range(0, nq, BWD_DKV_QUERY_TILE):
            cols = slice(j, j + BWD_DKV_QUERY_TILE)
            q_tile, do_tile = qp[:, :, cols], dop[:, :, cols]
            st = kb @ q_tile.transpose(-1, -2)  # keys x queries
            dpt = vb @ do_tile.transpose(-1, -2)
            pt = torch.exp2(st * (scale * log2e) - lse2[:, :, None, cols])
            dst = pt * (dpt - dip[:, :, None, cols])
            acc_v += _bf16(pt) @ do_tile
            acc_k += _bf16(dst) @ (q_tile.transpose(-1, -2) if fault == "q_transposed" else q_tile)
        dk[:, :, k0:k0 + 64], dv[:, :, k0:k0 + 64] = acc_k * scale, acc_v
    dq = torch.zeros_like(qt)
    lse2_rows, di_rows = lse2[..., :sq, None], dip[..., :sq, None]
    for m0 in range(0, sq, 64):
        rows = slice(m0, m0 + 64)
        acc = torch.zeros_like(qt[:, :, rows])
        for j in range(0, nk, BWD_DQ_KEY_TILE):
            keys = slice(j, j + BWD_DQ_KEY_TILE)
            s = qt[:, :, rows] @ kp[:, :, keys].transpose(-1, -2)
            dp = dot[:, :, rows] @ vp[:, :, keys].transpose(-1, -2)
            pm = torch.exp2(s * (scale * log2e) - lse2_rows[:, :, rows])
            pm = pm.masked_fill(torch.arange(j, j + BWD_DQ_KEY_TILE) >= skv, 0.0)
            acc += _bf16(pm * (dp - di_rows[:, :, rows])) @ kp[:, :, keys]
        dq[:, :, rows] = acc * scale
    return tuple(g.transpose(1, 2) for g in (dq, dk, dv))


@pytest.mark.parametrize("shape", [
    (1, 2, 146, 203, 64),   # Sq = 13,330 mod 128 (the DiT's last tiles), Skv ragged
    (2, 1, 146, 61, 128),   # the same at the Perceiver's head dim, Skv below one tile
    (1, 3, 77, 130, 64),    # ragged both sides
    (1, 2, 129, 274, 128),
])
def test_backward_tiling_matches_jax_grad(shape):
    """The kernels' tiling (``_tiled_backward``) against ``jax.grad`` of the
    JAX ``multi_head_attention(impl="xla")`` on the same fp32 inputs.  Each
    per-head relative L2 error is held to 2^-8: p and ds are rounded to
    bf16 (unit roundoff 2^-9) and the rounding errors of the products' terms
    do not add up in one direction.  The kernels' own tolerance
    (``attention_backward_error``) passes these gradients and rejects the q
    tile read transposed in dK (at head dim 64, where the tile is square)."""
    from trajectorycrafter_tpu.ops.attention import multi_head_attention as jax_mha
    from trajectorycrafter_tpu_torch.ops.attention import attention_backward_error
    from trajectorycrafter_tpu_torch.ops.attention_variants import lse_reference

    b, h, sq, skv, d = shape
    q, k, v = _qkv(12, b, h, sq, skv, d)
    q = q * 2.0  # peaked rows: di carries weight
    dout = np.random.default_rng(13).standard_normal((b, sq, h, d)).astype(np.float32)
    scale = d ** -0.5
    loss = lambda q, k, v: jnp.sum(jax_mha(q, k, v, scale, impl="xla")
                                   * jnp.asarray(dout).reshape(b, sq, h * d))
    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, dout))
    out, lse = attention_reference(tq, tk, tv, scale), lse_reference(tq, tk, scale)
    di = (out * tdo).sum(-1).transpose(1, 2)
    got = _tiled_backward(tq, tk, tv, tdo, lse, di, scale)
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(w))
        assert g.shape == w.shape
        err = (g - w).square().sum((1, 3)).sqrt() / w.square().sum((1, 3)).sqrt()
        assert err.max().item() <= 2.0 ** -8, err
    grads = dict(zip(("dq", "dk", "dv"), got))
    held = lambda grads: attention_backward_error(grads, tq, tk, tv, out, lse, tdo, scale)
    assert held(grads)["ok"]
    if d == BWD_DKV_QUERY_TILE:
        _, dk, _ = _tiled_backward(tq, tk, tv, tdo, lse, di, scale, fault="q_transposed")
        assert not held({"dk": dk})["ok"]


@pytest.mark.parametrize("shape,gain,tile", [
    ((1, 2, 512, 512, 64), 4.0, 64),  # peaked rows: di matters
    ((1, 2, 300, 700, 128), 4.0, 64),
    ((1, 2, 512, 512, 64), 4.0, BWD_DQ_KEY_TILE),
    ((1, 2, 300, 700, 128), 4.0, BWD_DQ_KEY_TILE),
], ids=["d64", "d128", "d64_tile128", "d128_tile128"])
def test_backward_error_passes_sound_and_rejects_planted_faults(shape, gain, tile):
    """The backward kernels' tolerance (``attention_backward_error``) passes
    the plain gradients rounded to bf16 (a sound kernel's output) on bf16
    inputs, and rejects di left out (out zeroed makes di 0), the last
    quarter of the ``tile``-row query tiles skipped in dK/dV, and the last
    quarter of the ``tile``-row key tiles skipped in dQ: at 64-row tiles
    (dK/dV's query tile) and at dQ's 128-key tile."""
    from trajectorycrafter_tpu_torch.ops.attention import (
        attention_backward_error,
        attention_backward_reference,
    )
    from trajectorycrafter_tpu_torch.ops.attention_variants import lse_reference

    b, h, sq, skv, d = shape
    q, k, v = _qkv(10, b, h, sq, skv, d)
    q, k, v = (torch.from_numpy(x).bfloat16() for x in (q * gain, k, v))
    dout = torch.from_numpy(np.random.default_rng(11).standard_normal((b, sq, h, d))
                            .astype(np.float32)).bfloat16()
    scale = d ** -0.5
    out, lse = attention_reference(q, k, v, scale), lse_reference(q, k, scale)
    bf16 = lambda grads: {n: g.bfloat16() for n, g in zip(("dq", "dk", "dv"), grads)}
    held = lambda grads: attention_backward_error(grads, q, k, v, out, lse, dout, scale)
    assert held(bf16(attention_backward_reference(q, k, v, out, lse, dout, scale)))["ok"]
    no_di = bf16(attention_backward_reference(q, k, v, torch.zeros_like(out), lse, dout, scale))
    assert not held({"dq": no_di["dq"]})["ok"] and not held({"dk": no_di["dk"]})["ok"]
    keep = (-(-sq // tile) - -(-(-(-sq // tile)) // 4)) * tile
    part = bf16(attention_backward_reference(q[:, :keep], k, v, out[:, :keep],
                                             lse[..., :keep], dout[:, :keep], scale))
    assert not held({"dk": part["dk"]})["ok"] and not held({"dv": part["dv"]})["ok"]
    keep = (-(-skv // tile) - -(-(-(-skv // tile)) // 4)) * tile
    part = bf16(attention_backward_reference(q, k[:, :keep], v[:, :keep], out, lse, dout,
                                             scale))
    assert not held({"dq": part["dq"]})["ok"]
