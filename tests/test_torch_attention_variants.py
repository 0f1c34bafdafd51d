"""The port's attention variants (trajectorycrafter_tpu_torch/ops/
attention_variants.py) vs the JAX package's Pallas kernels in interpret mode.

Plain versions of K5 (``flash_attention_with_lse``), K1b
(``flash_attention_exp2``), K6 (``flash_attention_exp2_t_pv8``) and K7
(``int8_flash_attention``) against the JAX functions; K6 and K7 also taken
as their kernel pairs the operands (the codes in the A fragment's slot order
against ``pv8_keys_last``'s V^T; K7 with the int32 row max converted once,
the exp2 weights and the fp32 sum of the weights), with K7's exact score
conversion and row max checked on their own; and the port's
``multi_head_attention(impl="flash_pv8")`` against the JAX dispatch with
the Pallas kernel patched to interpret mode.  Inputs are fp32 from
``np.random.default_rng``; each side runs in fp32 on the CPU.

Tolerances:
  * K5 and K1b: 1e-5 absolute on outputs of O(1) (fp32 softmax on both
    sides, summed in another order), 1e-5 relative on the lse.
  * K6 and K7 quantize the softmax weights to integer codes p8 = rint(.):
    where the two sides' fp32 scores (K6: q'.k summed in another order) or
    exponentials (K7: XLA's and torch's exp, or the kernel's exp2 of its
    offset) differ in their last bits on a rounding boundary of the code,
    one code moves by 1, which moves that
    row's output by |v| / (the row's code sum) -- at most ~1e-2 at these
    shapes.  So the outputs agree to 1e-5 on all but a few elements (at most
    0.1%), and every element within 2e-2.
"""

import unittest.mock as mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from trajectorycrafter_tpu.ops import attention as jax_attention
from trajectorycrafter_tpu.ops.pallas import flash_pv8 as jax_flash_pv8
from trajectorycrafter_tpu.ops.pallas.flash_exp2 import flash_attention_exp2 as jax_exp2
from trajectorycrafter_tpu.ops.pallas.flash_lse import flash_attention_with_lse as jax_lse
from trajectorycrafter_tpu.ops.pallas.int8_flash_attention import int8_flash_attention as jax_int8
from trajectorycrafter_tpu_torch.ops import attention_variants as av
from trajectorycrafter_tpu_torch.ops.attention import multi_head_attention, quantized_error
from trajectorycrafter_tpu_torch.ops.kernels import flash_pv8, int8_flash_attention

torch.set_num_threads(1)
QUANT_CLOSE, QUANT_FAR, QUANT_SHARE = 1e-5, 2e-2, 1e-3


def _rng_bhsd(seed, b, h, s, d, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(n)]


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _assert_quantized_close(got, want):
    """The quantized tolerance of the module docstring."""
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert np.isfinite(got).all() and got.shape == want.shape
    assert err.max() <= QUANT_FAR, err.max()
    assert (err > QUANT_CLOSE).mean() <= QUANT_SHARE, (err > QUANT_CLOSE).mean()


# ----------------------------------------------------------------------------
# K6: flash_pv8
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("s,pad,d,block_k,case", [
    (256, 0, 64, 128, "random"),
    (256, 40, 64, 128, "random"),  # padded keys
    (256, 40, 64, 128, "all_negative"),  # pad must not win the block max
    (1024, 124, 64, 512, "random"),
    (384, 130, 128, 128, "random"),  # the Perceiver's head dim
], ids=["bk128", "bk128_pad40", "bk128_all_negative", "bk512_pad124", "d128_pad130"])
def test_pv8_plain_matches_jax_interpret(s, pad, d, block_k, case):
    b, h = 1, 2
    q, k, v = _rng_bhsd(3, b, h, s, d)
    if case == "all_negative":
        rng = np.random.default_rng(4)
        u = np.full(d, d ** -0.5, np.float32)
        q = (u + 0.01 * rng.standard_normal((b, h, s, d))).astype(np.float32)
        k = (-80.0 * u + 0.01 * rng.standard_normal((b, h, s, d))).astype(np.float32)
    valid = s - pad
    k[:, :, valid:] = 0.0
    v[:, :, valid:] = 0.0
    scale = d ** -0.5
    want = jax_flash_pv8.flash_attention_exp2_t_pv8(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_pad=pad, sm_scale=scale,
        block_q=128, block_k=block_k, interpret=True)
    want = np.asarray(jnp.swapaxes(want, 2, 3))
    tq, tk, tv = _t(q, k[:, :, :valid], v[:, :, :valid])
    got = av.flash_attention_exp2_t_pv8(tq, tk, tv, sm_scale=scale, block_k=block_k).numpy()
    if case == "all_negative":
        assert np.abs(got).max() > 0.01, "all-zeros output: a pad key won the block max"
    _assert_quantized_close(got, want)


@pytest.mark.parametrize("s", [200, 2100], ids=["s200_block512", "s2100_block1024"])
def test_flash_pv8_dispatch_matches_jax_dispatch(s):
    """``multi_head_attention(impl="flash_pv8")`` on CPU tensors against the
    JAX dispatch (which pads to its blocks and passes ``kv_pad``) with the
    Pallas kernel in interpret mode: 512-key blocks below 2,048 queries,
    1,024-key blocks from 2,048 on.  No kernel launches."""
    b, h, d = 1, 1, 64
    q, k, v = (np.swapaxes(x, 1, 2) for x in _rng_bhsd(5, b, h, s, d))  # (B, S, H, D)
    orig = jax_flash_pv8.flash_attention_exp2_t_pv8

    def interp(*a, **kw):
        return orig(*a, **{**kw, "interpret": True})

    with mock.patch.object(jax_flash_pv8, "flash_attention_exp2_t_pv8", interp):
        want = np.asarray(jax_attention.multi_head_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="flash_pv8"))
    before = flash_pv8.launches
    got = multi_head_attention(*_t(q, k, v), impl="flash_pv8").numpy()
    assert flash_pv8.launches == before
    assert got.shape == (b, s, h * d)
    _assert_quantized_close(got, want)


def _fragment_key_order():
    """The key each slot of K6's s8 A fragment holds, derived from the
    registers: thread t of a quad holds keys 8 j + 2 t and 8 j + 2 t + 1 of
    each 8-key column j of the scores, and packs keys 2t, 2t+1, 8+2t, 9+2t
    of a 32-key chunk into slots 4t..4t+3 (the same 16 on into 16+4t..)."""
    order = [0] * 32
    for t in range(4):
        held = (2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t)
        for h in range(2):
            for e in range(4):
                order[16 * h + 4 * t + e] = 16 * h + held[e]
    return order


def test_pv8_key_order_is_the_fragment_order():
    assert av.pv8_key_order().tolist() == _fragment_key_order()


def test_pv8_key_blocks_are_whole_key_tiles():
    """K6 and K7, both on the PV-int8 loop, take key blocks and V^T rows of
    whole 128-key tiles: both of the JAX dispatch's block sizes for K6 and
    every block K7's rule picks are."""
    from trajectorycrafter_tpu_torch.ops import kernels

    tile = kernels.PV8_KEY_TILE
    assert all(av.pv8_block_k(s) % tile == 0 for s in (1, 2047, 2048, 13330))
    assert all(av.int8_block_k(s) % tile == 0 for s in (1, 129, 700, 4096, 13330))
    for kernel in ("flash_pv8", "int8_flash_attention"):
        for block_k in (128, 512, 1024):
            kernels._check_block_k(kernel, block_k, tile)
        for block_k in (0, 64, 192):
            with pytest.raises(ValueError, match="multiple of 128"):
                kernels._check_block_k(kernel, block_k, tile)
    v8 = torch.ones((2, 130, 3, 64), dtype=torch.int8)
    assert av.pv8_keys_last(v8).shape == (6, 64, 256)
    assert av.pv8_keys_last(v8[:, :128]).shape == (6, 64, 128)


def _pv8_on_kernel_layout(q, k, v, scale, block_k):
    """K6 with its PV product taken as the kernel pairs the operands, (B, S,
    H, D) fp32 in and out: per key block, the codes of each 32-key chunk in
    the A fragment's slot order against ``pv8_keys_last``'s V^T; the rest in
    ``pv8_reference``'s operation order."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    v8, vs = av.quantize_per_head(v)
    vt = av.pv8_keys_last(v8).float()  # (B * H, D, L)
    assert vt.shape[-1] % 128 == 0 and not vt[..., -(-skv // 32) * 32:].any()  # zero-padded
    qt = av.scaled_q(q, scale).transpose(1, 2).reshape(b * h, sq, d)
    kt = k.transpose(1, 2).reshape(b * h, skv, d)
    order = torch.tensor(_fragment_key_order())
    acc = torch.zeros((b * h, sq, d))
    den = torch.zeros((b * h, sq, 1))
    for j in range(0, skv, block_k):
        s_ = (qt @ kt[:, j:j + block_k].transpose(1, 2)).clamp_max(av.PV8_CLAMP)
        m_adj = (s_.amax(-1, keepdim=True) - av.LOG2_127).clamp_min(-av.PV8_CLAMP)
        p8 = torch.round(torch.exp2(s_ - m_adj))
        width = -(-p8.shape[-1] // 32) * 32
        p8 = torch.nn.functional.pad(p8, (0, width - p8.shape[-1]))
        slots = p8.unflatten(-1, (-1, 32))[..., order].flatten(-2)
        w = torch.exp2(m_adj)
        acc = acc + (slots @ vt[:, :, j:j + width].transpose(1, 2)) * w
        den = den + (p8.sum(-1, keepdim=True) * 127.0) * w
    out = acc / den.clamp_min(av.LSE_FLOOR) * (vs.reshape(-1, 1, 1) * 127.0)
    return out.reshape(b, h, sq, d).transpose(1, 2)


@pytest.mark.parametrize("s,pad,d,block_k", [(384, 84, 64, 128), (1024, 24, 128, 512)],
                         ids=["d64_bk128_pad84", "d128_bk512_pad24"])
def test_pv8_kernel_layout_matches_jax_interpret(s, pad, d, block_k):
    """``pv8_keys_last`` pairs every code with its own key's values: K6 taken
    on that layout matches the JAX Pallas kernel in interpret mode."""
    b, h = 1, 2
    q, k, v = _rng_bhsd(6, b, h, s, d)
    valid = s - pad
    k[:, :, valid:] = 0.0
    v[:, :, valid:] = 0.0
    scale = d ** -0.5
    want = jax_flash_pv8.flash_attention_exp2_t_pv8(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_pad=pad, sm_scale=scale,
        block_q=128, block_k=block_k, interpret=True)
    want = np.asarray(jnp.swapaxes(want, 2, 3))
    tq, tk, tv = (x.transpose(1, 2) for x in _t(q, k[:, :, :valid], v[:, :, :valid]))
    got = _pv8_on_kernel_layout(tq, tk, tv, scale, block_k).transpose(1, 2).numpy()
    _assert_quantized_close(got, want)


# ----------------------------------------------------------------------------
# K7: int8 flash attention
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("s", [200, 256, 384])
def test_int8_attention_plain_matches_jax_interpret(s):
    b, h, d = 1, 2, 64
    q, k, v = _rng_bhsd(6, b, h, s, d)
    want = np.asarray(jax_int8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    before = int8_flash_attention.launches
    got = av.int8_flash_attention(*_t(q, k, v)).numpy()
    assert int8_flash_attention.launches == before
    _assert_quantized_close(got, want)


INT32_SCORE_BOUND = 127 * 127 * 128  # |q8 . k8| at head dim 128: below 2^22


def _exact_float(x: np.ndarray) -> np.ndarray:
    """The kernel's int32 -> fp32 conversion of a score: the bits of 1.5 x
    2^23 + x, less 1.5 x 2^23 (an integer add and an fp32 subtraction)."""
    return (x.astype(np.int32) + np.int32(0x4B400000)).view(np.float32) - np.float32(12582912.0)


def test_int8_score_conversion_is_exact():
    """Every score of the int32 QK, |x| <= 127^2 x 128 = 2,064,512, converts
    exactly: at 0, +-1, the bound and every integer between."""
    edges = np.array([0, 1, -1, INT32_SCORE_BOUND, -INT32_SCORE_BOUND], np.int32)
    np.testing.assert_array_equal(_exact_float(edges), edges.astype(np.float32))
    every = np.arange(-INT32_SCORE_BOUND, INT32_SCORE_BOUND + 1, dtype=np.int32)
    assert np.array_equal(_exact_float(every), every.astype(np.float32))


@pytest.mark.parametrize("logit", [1e-7, 3.1e-5, 2.7e-3, 0.37])
def test_int8_row_max_converted_once_is_the_max_of_the_products(logit):
    """K7 takes a key block's row max on the int32 scores and converts it
    once: for logit = qs ks scale > 0 that is exactly the max of the rounded
    fp32 products float(x) * logit the plain version takes."""
    rng = np.random.default_rng(12)
    x = rng.integers(-INT32_SCORE_BOUND, INT32_SCORE_BOUND + 1, size=(64, 1024))
    x[0] = rng.integers(-INT32_SCORE_BOUND, -INT32_SCORE_BOUND + 64, size=1024)  # all negative
    x[1, :2] = [INT32_SCORE_BOUND - 1, INT32_SCORE_BOUND]  # neighbours at the top
    x[2] = 7  # one value throughout
    xt = torch.from_numpy(x).float()  # exact: below 2^24
    lg = torch.tensor(logit, dtype=torch.float32)
    assert torch.equal((xt * lg).amax(-1), xt.amax(-1) * lg)


def _round_up_f32(x: torch.Tensor) -> torch.Tensor:
    """float64 -> the least float32 >= it (``__fmul_ru`` of an exact product)."""
    f = x.float()
    return torch.where(f.double() < x, torch.nextafter(f, torch.tensor(float("inf"))), f)


def _int8_on_kernel_layout(q, k, v, scale, block_k):
    """K7 as the kernel computes it, (B, S, H, D) fp32 in and out: the int32
    scores; per key block the int32 row max x_max converted once, m_new =
    max(m, x_max logit), alpha = exp(m - m_new) and the exp2 offset max(x_max
    l2 rounded up, m log2 e) with l2 = logit log2 e; each weight p = exp2(x
    l2 - offset) rounded once (the kernel's fused multiply-add), its code
    rint(127 p) rounded once, the codes of each 32-key chunk in the A
    fragment's slot order against ``pv8_keys_last``'s V^T, and the fp32 sum
    of the p; the fold in ``int8_attention_reference``'s order."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    q8, k8, v8, logit, v127 = av.int8_operands(q, k, v, scale)
    vt = av.pv8_keys_last(v8).float()  # (B * H, D, L)
    qt = q8.transpose(1, 2).reshape(b * h, sq, d).float()
    kt = k8.transpose(1, 2).reshape(b * h, skv, d).float()
    logit, v127 = logit.reshape(-1, 1, 1), v127.reshape(-1, 1, 1)
    log2e = torch.tensor(av.LOG2E, dtype=torch.float32)
    l2 = logit * log2e
    order = torch.tensor(_fragment_key_order())
    m = torch.full((b * h, sq, 1), -1e30)
    den = torch.zeros((b * h, sq, 1))
    acc = torch.zeros((b * h, sq, d))
    for j in range(0, skv, block_k):
        x = qt @ kt[:, j:j + block_k].transpose(1, 2)  # the int32 scores, exact in fp32
        x_max = x.amax(-1, keepdim=True)
        m_new = torch.maximum(m, x_max * logit)
        alpha = torch.exp(m - m_new)
        offset = torch.maximum(_round_up_f32(x_max.double() * l2.double()), m * log2e)
        p = torch.exp2((x.double() * l2.double() - offset.double()).float())
        p8 = torch.round(p.double() * 127.0).float()
        width = -(-p8.shape[-1] // 32) * 32
        p8 = torch.nn.functional.pad(p8, (0, width - p8.shape[-1]))
        slots = p8.unflatten(-1, (-1, 32))[..., order].flatten(-2)
        acc = acc * alpha + (slots @ vt[:, :, j:j + width].transpose(1, 2)) * v127
        den = den * alpha + p.sum(-1, keepdim=True)
        m = m_new
    out = acc / den.clamp_min(av.INT8_ATTN_FLOOR)
    return out.reshape(b, h, sq, d).transpose(1, 2)


@pytest.mark.parametrize("s,d,block_k", [(300, 64, 128), (300, 128, 128), (700, 64, 512),
                                         (700, 128, 512)],
                         ids=["d64_bk128_s300", "d128_bk128_s300", "d64_bk512_s700",
                              "d128_bk512_s700"])
def test_int8_kernel_layout_matches_jax_interpret(s, d, block_k):
    """K7 taken as the kernel pairs its operands (``_int8_on_kernel_layout``)
    matches the JAX Pallas kernel in interpret mode within
    ``quantized_error`` (the JAX kernel run on |v| weighs the codes), with
    ragged lengths (the last key block and the last 128-key tile part
    full)."""
    b, h = 1, 2
    q, k, v = _rng_bhsd(13, b, h, s, d)
    want, weighted_v = (
        torch.from_numpy(np.asarray(jax_int8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(x),
                                             block_k=block_k, interpret=True))).transpose(1, 2)
        for x in (v, np.abs(v)))
    tq, tk, tv = (x.transpose(1, 2) for x in _t(q, k, v))
    got = _int8_on_kernel_layout(tq, tk, tv, d ** -0.5, block_k)
    readings = quantized_error(got, want, weighted_v)
    assert readings["ok"], readings


# ----------------------------------------------------------------------------
# K5: attention with its logsumexp; K1b: exp2 attention with a fixed bias
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("sq,skv,d", [(256, 256, 64), (128, 384, 128)])
def test_lse_plain_matches_jax_interpret(sq, skv, d):
    b, h = 1, 2
    q, = _rng_bhsd(7, b, h, sq, d, n=1)
    k, v = _rng_bhsd(8, b, h, skv, d, n=2)
    k[:, :, -30:] = 0.0  # zero keys count, with score 0, on both sides
    out_j, lse_j = jax_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           block_q=128, block_k=128, interpret=True)
    out, lse = av.flash_attention_with_lse(*_t(q, k, v))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=0, rtol=1e-5)
    out_f, lse_f = av.flash_lse_inner(*_t(q, k, v), d ** -0.5)
    assert out_f.dtype == torch.float32 and torch.equal(lse_f, lse)


@pytest.mark.parametrize("bias,clamp,gain,masked", [
    (0.0, True, 1.0, 0),
    (3.0, True, 1.0, 56),  # a nonzero bias and kv_valid
    (0.0, True, 30.0, 56),  # scores above 110: the clamp changes the answer
    (0.0, False, 1.0, 56),
], ids=["plain", "bias_valid", "clamped", "no_clamp"])
def test_exp2_plain_matches_jax_interpret(bias, clamp, gain, masked):
    b, h, s, d = 1, 2, 256, 64
    q, k, v = _rng_bhsd(9, b, h, s, d)
    q = q * gain
    valid = (np.arange(s) < s - masked).astype(np.float32)
    want = np.asarray(jax_exp2(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               kv_valid=jnp.asarray(valid), bias=bias, clamp=clamp,
                               block_q=128, block_k=128, interpret=True))
    got = av.flash_attention_exp2(*_t(q, k, v), kv_valid=torch.from_numpy(valid), bias=bias,
                                  clamp=clamp).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    if gain > 1.0:  # the clamp engaged: without it exp2 overflows or weighs otherwise
        unclamped = av.flash_attention_exp2(*_t(q, k, v), kv_valid=torch.from_numpy(valid),
                                            clamp=False).numpy()
        assert not np.allclose(unclamped, want, atol=0.1)


def test_plain_versions_use_the_jax_key_blocks():
    """The block rules: K6 as the JAX dispatch picks it, K7 as the JAX
    function does."""
    assert [av.pv8_block_k(s) for s in (200, 2047, 2048, 13330)] == [512, 512, 1024, 1024]
    assert [av.int8_block_k(s) for s in (1, 100, 200, 256, 384, 1000, 13330)] == \
        [128, 128, 256, 256, 512, 1024, 1024]


def test_quantize_per_head_matches_jax():
    """q, k, v quantization per (batch, head) of both quantized kernels."""
    from trajectorycrafter_tpu.ops.pallas.int8_flash_attention import _quantize

    x, = _rng_bhsd(10, 2, 3, 50, 64, n=1)
    x[1, 2] = 0.0  # an all-zero head: scale 1e-8 / 127
    want_q, want_s = (np.asarray(a) for a in _quantize(jnp.asarray(x)))
    got_q, got_s = av.quantize_per_head(torch.from_numpy(np.swapaxes(x, 1, 2).copy()))
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=2e-7, atol=0)
    diff = np.abs(np.swapaxes(got_q.numpy(), 1, 2).astype(int) - want_q.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
