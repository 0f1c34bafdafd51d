"""The int8 path of the port (``--quant int8``, ``--quant_depth int8``) vs the
JAX package, on the CPU.

Inputs are made with numpy from a seed and go through both packages.  The
JAX package's Pallas kernels (ops/pallas/int8_matmul.py) run in interpret
mode, as its own tests run them; the port's functions take their plain
versions, which stand beside the CUDA kernels (tests/test_torch_kernels_cuda.py
holds the kernels against them on the card).

Tolerances, with their reasons:
  * quantization (weights, activation rows): bit-equal.  Both take the same
    fp32 max, an IEEE division and round half to even.  One exception: XLA
    compiles the division of a row's max by the constant 127 into a multiply
    by the rounded reciprocal when it jits a function (as the Pallas
    interpret mode does), which can move a scale by one fp32 ulp; the codes
    are still bit-equal.
  * the GEMMs: the int32 product is exact on both sides, and the fp32
    epilogue takes the same operations in the same order, but XLA may fuse
    its last multiply and add: 1e-6 of the output's largest magnitude.
  * the gelu-quant GEMM: scales 1e-6 relative; codes off by at most 1, on at
    most 0.1% of the elements (a code flips where y / scale lands within an
    fp32 rounding of a .5 boundary, if the two tanh implementations differ
    by an ulp there).
  * the whole tiny DiT (and the tiny pipeline, tests/test_torch_pipeline.py):
    the fp32 activations of the two packages agree to ~1e-6, and at these
    sizes no activation lands within that of a rounding boundary, so both
    quantize to the same codes and the outputs agree to fp32 rounding
    (~3e-7): 1e-4 of the output's largest magnitude.  The planted faults --
    a per-tensor activation scale in place of the per-row one, the
    Perceivers' ``to_kv`` left unquantized -- read ~1e-2.
  * each int8 layer of the tiny DiT and the tiny depth UNet, on the
    activations the port's model gives it: the JAX package's
    ``int8_dense_forward`` on the same input and weights, to 1e-6 of the
    output's largest magnitude, which the per-tensor fault fails.  The depth
    UNet's whole output cannot be held tighter than its int8 noise: at its
    tiny widths (8-16 channels) one code flipped by an fp32 difference moves
    the next layer's input by about half a quantization step, so flips
    cascade and the two packages' outputs differ by about as much as int8
    differs from fp32.  It is held, as the JAX package holds its own int8
    UNet, to a cosine > 0.999 against the fp32 UNet.
"""

import math
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch_parity import jax_tree, per_tensor_quantize_rows

from trajectorycrafter_tpu.models.depthcrafter import UNetSpatioTemporalConditionModel as JaxUNet
from trajectorycrafter_tpu.models.dit import CrossTransformer3DModel as JaxDiT
from trajectorycrafter_tpu.ops import int8 as jax_int8
from trajectorycrafter_tpu.ops.pallas import int8_matmul as jax_mm
from trajectorycrafter_tpu.ops.rope import rope_for_sample
from trajectorycrafter_tpu.utils import quality as jax_quality
from trajectorycrafter_tpu.utils.convert import convert_dit, convert_svd_unet
from trajectorycrafter_tpu_torch.models.depthcrafter import UNetSpatioTemporalConditionModel
from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel
from trajectorycrafter_tpu_torch.ops import int8_matmul as im
from trajectorycrafter_tpu_torch.ops.int8 import (
    Int8Linear,
    int8_linears,
    quantize_dense,
    quantize_depth_unet_,
    quantize_dit_,
)
from trajectorycrafter_tpu_torch.utils import quality
from trajectorycrafter_tpu_torch.utils.weights import dit_from_jax, svd_unet_from_jax

torch.set_num_threads(1)
GEMM_TOL = 1e-6
MODEL_TOL = 1e-4
LAYER_TOL = 1e-6
T = torch.from_numpy


def _np(x):
    return np.asarray(x)


def _max_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _cosine(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _weight(rng, k, n, zero_col=None):
    """A flax-layout (K, N) kernel, one output channel zero if asked."""
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    if zero_col is not None:
        w[:, zero_col] = 0
    return w


def _quantized(rng, k, n, bias=True):
    """A JAX int8 leaf and the port's (N, K) codes, scales and bias."""
    leaf = {"kernel": _weight(rng, k, n)}
    if bias:
        leaf["bias"] = (rng.standard_normal(n) * 0.1).astype(np.float32)
    q = jax_int8.quantize_dense_params(leaf)
    port = (T(q["kernel_q"].T.copy()), T(q["scale"]), T(leaf["bias"]) if bias else None)
    return q, port


# ----------------------------------------------------------------------------
# the functions
# ----------------------------------------------------------------------------


def test_quantize_dense_matches_jax_bit_for_bit(rng):
    w = _weight(rng, 96, 64, zero_col=5)
    want = jax_int8.quantize_dense_params({"kernel": w})
    weight_q, scale = quantize_dense(T(w.T.copy()))
    assert weight_q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(weight_q.numpy().T, want["kernel_q"])
    np.testing.assert_array_equal(scale.numpy(), want["scale"])
    assert scale[5] == np.float32(1e-12) / np.float32(127) and not weight_q[5].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_rows_matches_jax_bit_for_bit(rng, dtype):
    x = torch.from_numpy(rng.standard_normal((70, 256)).astype(np.float32)).to(dtype)
    x[5] = 0  # a zero row: scale 1e-8 / 127, codes 0
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                               else jnp.float32)
    xq, xs = im.quantize_rows(x)
    jq, js = jax_mm.quantize_rows(xj)
    np.testing.assert_array_equal(xq.numpy(), _np(jq))
    np.testing.assert_array_equal(xs.numpy(), _np(js))
    # the Pallas kernel in interpret mode, which XLA compiles: its scale may
    # be one ulp off (see above); its codes are bit-equal in every row whose
    # scale is (with bf16 inputs an exact tie x / scale = n + 1/2 is common,
    # and an ulp of the scale decides it)
    pq, ps = jax_mm.quantize_rows_pallas(xj, block_m=70, interpret=True)
    ps = _np(ps)[:, 0]
    np.testing.assert_allclose(xs.numpy(), ps, rtol=2.0 ** -23, atol=0)
    same = xs.numpy() == ps
    np.testing.assert_array_equal(xq.numpy()[same], _np(pq)[same])
    if dtype == torch.float32:
        np.testing.assert_array_equal(xq.numpy(), _np(pq))
    assert xs[5] == np.float32(1e-8) / np.float32(127) and not xq[5].any()


@pytest.mark.parametrize("m,bias", [(70, True), (64, False)], ids=["ragged_bias", "no_bias"])
def test_int8_matmul_matches_jax_interpret(rng, m, bias):
    q, (wq, ws, b) = _quantized(rng, 256, 512, bias)
    xq, xs = jax_mm.quantize_rows(jnp.asarray(rng.standard_normal((m, 256)), jnp.float32))
    want = jax_mm.int8_matmul(xq, q["kernel_q"], xs, q["scale"], bias=q.get("bias"), block_m=m,
                              block_n=256, block_k=128, out_dtype=jnp.float32, interpret=True)
    got = im.int8_matmul(T(np.array(xq)), wq, T(np.array(xs)), ws, b, out_dtype=torch.float32)
    assert got.shape == (m, 512)
    assert _max_rel(got.numpy(), want) <= GEMM_TOL


def test_int8_matmul_gelu_quant_matches_jax_interpret(rng):
    q, (wq, ws, b) = _quantized(rng, 256, 512)
    xq, xs = jax_mm.quantize_rows(jnp.asarray(rng.standard_normal((70, 256)), jnp.float32))
    want_q, want_s = jax_mm.int8_matmul_gelu_quant(
        xq, q["kernel_q"], xs, q["scale"], bias=q["bias"], block_m=70, block_n=256,
        block_k=128, interpret=True)
    hq, hs = im.int8_matmul_gelu_quant(T(np.array(xq)), wq, T(np.array(xs)), ws, b, group=256)
    readings = im.gelu_quant_error(hq, hs, T(np.array(want_q)),
                                   T(np.array(want_s)[:, ::128].copy()))  # lane-broadcast layout
    assert hs.shape == (70, 2) and readings["ok"], readings


def test_int8_matmul_gscale_matches_jax_interpret(rng):
    q, (wq, ws, b) = _quantized(rng, 512, 256)
    hq = rng.integers(-127, 128, (70, 512)).astype(np.int8)
    hs = rng.uniform(0.001, 0.02, (70, 2)).astype(np.float32)
    want = jax_mm.int8_matmul_gscale(
        jnp.asarray(hq), q["kernel_q"], jnp.repeat(jnp.asarray(hs), 128, axis=1), q["scale"],
        bias=q["bias"], block_m=70, block_n=256, block_k=256, out_dtype=jnp.float32,
        interpret=True)
    got = im.int8_matmul_gscale(T(hq), wq, T(hs), ws, b, group=256, out_dtype=torch.float32)
    assert _max_rel(got.numpy(), want) <= GEMM_TOL


def test_int8_ff_apply_matches_jax_interpret(rng):
    """The fused chain at a ragged M of 70 rows (the JAX wrapper pads to its
    32-row block with rows of 1.0; the port masks nothing on the CPU)."""
    q1, (wq1, ws1, b1) = _quantized(rng, 256, 1024)
    q2, (wq2, ws2, b2) = _quantized(rng, 1024, 256)
    x = rng.standard_normal((70, 256)).astype(np.float32)
    want = jax_mm.int8_ff_apply(jnp.asarray(x), q1["kernel_q"], q1["scale"], q1["bias"],
                                q2["kernel_q"], q2["scale"], q2["bias"],
                                out_dtype=jnp.float32, group=256, interpret=True)
    got = im.int8_ff_apply(T(x), wq1, ws1, b1, wq2, ws2, b2, group=256)
    assert got.shape == (70, 256)
    assert _max_rel(got.numpy(), want) <= GEMM_TOL


def test_int8_dense_apply_matches_jax_int8_dense_forward(rng):
    q, (wq, ws, b) = _quantized(rng, 256, 512)
    x = rng.standard_normal((2, 35, 256)).astype(np.float32)
    want = jax_int8.int8_dense_forward(jnp.asarray(x), q["kernel_q"], q["scale"], q["bias"])
    assert _max_rel(im.int8_dense_apply(T(x), wq, ws, b).numpy(), want) <= GEMM_TOL
    layer = Int8Linear(256, 512)
    layer.weight_q, layer.weight_scale, layer.bias = wq, ws, torch.nn.Parameter(b)
    assert _max_rel(layer(T(x)).detach().numpy(), want) <= GEMM_TOL
    layer.int8_impl = "nearest"
    with pytest.raises(ValueError, match="int8 impl"):
        layer(T(x))


def test_fused_ff_matches_unfused_within_the_jax_bound(rng):
    """The port's FeedForward, fused against unfused, within the bound the
    JAX package holds its own fused chain to (tests/test_int8_ff.py): the
    group scales of the intermediate differ from per-row ones.  The JAX
    model's fused branch runs the Pallas chain without interpret mode, so
    it is compared here with the port's unfused chain, which the tiny-DiT
    test holds against the JAX model."""
    from trajectorycrafter_tpu_torch.models.dit import FeedForward

    ff = FeedForward(256)
    with torch.no_grad():
        for p in ff.parameters():
            p.copy_(T((rng.standard_normal(p.shape) * 0.05).astype(np.float32)))
    ff.net[0].proj = Int8Linear.from_linear(ff.net[0].proj)
    ff.net[2] = Int8Linear.from_linear(ff.net[2])
    x = T(rng.standard_normal((96, 256)).astype(np.float32))
    proj_in, proj_out = ff.net[0].proj, ff.net[2]
    with torch.no_grad():
        unfused = ff(x).numpy()
        fused = im.int8_ff_apply(x, proj_in.weight_q, proj_in.weight_scale, proj_in.bias,
                                 proj_out.weight_q, proj_out.weight_scale, proj_out.bias,
                                 group=256).numpy()  # the JAX test's group
        ff.fuse = True
        module_fused = ff(x).numpy()  # the module's group: 1,024 columns, the whole row
    assert _max_rel(fused, unfused) < 0.02 and _cosine(fused, unfused) > 0.9995
    # one group spanning the whole intermediate is the unfused chain's per-row
    # quantization, and then the two chains compute one function exactly
    np.testing.assert_array_equal(module_fused, unfused)


def test_quality_matches_jax(rng):
    a = rng.uniform(0, 255, (3, 40, 48, 3))
    b = np.clip(a + rng.normal(0, 8, a.shape), 0, 255)
    for fn in ("psnr", "ms_ssim"):
        assert getattr(quality, fn)(a[0], b[0]) == getattr(jax_quality, fn)(a[0], b[0])
    got, want = quality.video_quality(a, b), jax_quality.video_quality(a, b)
    assert got == want
    assert quality.gate_metrics(dict(got), 30.0) == jax_quality.gate_metrics(dict(want), 30.0)
    same = quality.video_quality(a, a)
    assert same["psnr_db"] == math.inf and quality.gate_metrics(same, 30.0)["psnr_db"] == 99.0


# ----------------------------------------------------------------------------
# the models
# ----------------------------------------------------------------------------

DIT_TINY = dict(num_attention_heads=2, attention_head_dim=16, in_channels=9, out_channels=4,
                time_embed_dim=16, text_embed_dim=32, num_layers=4, sample_width=12,
                sample_height=8, sample_frames=9, max_text_seq_length=7, cross_attn_dim_head=8,
                cross_attn_num_heads=4)
UNET_TINY = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
                 num_attention_heads=(2, 2, 2, 2), cross_attention_dim=12, norm_num_groups=4)


def _kernel_q_leaves(tree) -> int:
    if isinstance(tree, dict):
        return ("kernel_q" in tree) + sum(_kernel_q_leaves(v) for v in tree.values())
    return 0


def _layer_errors(model, run) -> list:
    """Run the port's ``model``; for each int8 layer it called, the error of
    its output against the JAX package's ``int8_dense_forward`` on the same
    input and weights (relative to that output's largest magnitude)."""
    calls = []
    hooks = [m.register_forward_hook(lambda mod, inp, out: calls.append((mod, inp[0], out)))
             for m in model.modules() if isinstance(m, Int8Linear)]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    errors = []
    for mod, x, out in calls:
        want = jax_int8.int8_dense_forward(
            jnp.asarray(x.numpy()), jnp.asarray(mod.weight_q.numpy().T),
            jnp.asarray(mod.weight_scale.numpy()),
            None if mod.bias is None else jnp.asarray(mod.bias.detach().numpy()))
        errors.append(_max_rel(out.numpy(), want))
    return errors


@pytest.fixture(scope="module")
def dit_case():
    params = jax_tree(CrossTransformer3DModel(**DIT_TINY), 0, convert_dit, num_layers=4)
    qparams = jax_int8.quantize_dit_params(params)
    rng = np.random.default_rng(1)
    b, f, h, w = 1, 3, 8, 12
    args = tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((b, f, h, w, 4), (b, 7, 32))) + (np.asarray([311.0], np.float32),) + tuple(
        rng.standard_normal(s).astype(np.float32) for s in ((b, f, h, w, 5), (b, 2, h, w, 4)))
    rope = rope_for_sample(16, 64, 96, 3)
    want = _np(jax.jit(JaxDiT(**DIT_TINY, quant="int8", attention_impl="xla").apply)(
        {"params": qparams}, *map(jnp.asarray, args),
        image_rotary_emb=tuple(map(jnp.asarray, rope))))
    return params, qparams, args, rope, want


def test_int8_dit_matches_jax(dit_case):
    params, qparams, args, rope, want = dit_case
    model = quantize_dit_(CrossTransformer3DModel(**DIT_TINY)).eval()
    model.load_state_dict(dit_from_jax(qparams), strict=True)
    assert int8_linears(model) == _kernel_q_leaves(qparams) == 4 * 6 + 2 * 3

    def run():
        with torch.no_grad():
            return model(*map(T, args), image_rotary_emb=tuple(map(T, rope))).numpy()

    assert _max_rel(run(), want) <= MODEL_TOL
    errors = _layer_errors(model, run)
    assert len(errors) == 30 and max(errors) <= LAYER_TOL

    # planted faults: a per-tensor activation scale; the Perceivers' to_kv
    # left in fp32 (a model quantized from the fp32 weights, then to_kv put back)
    with mock.patch.object(im, "quantize_rows_reference", per_tensor_quantize_rows):
        assert _max_rel(run(), want) > MODEL_TOL
        assert max(_layer_errors(model, run)) > LAYER_TOL
    fp32 = CrossTransformer3DModel(**DIT_TINY)
    fp32.load_state_dict(dit_from_jax(params), strict=True)
    for i, perceiver in enumerate(model.perceiver_cross_attention):
        perceiver.to_kv = fp32.perceiver_cross_attention[i].to_kv
    assert _max_rel(run(), want) > MODEL_TOL


def test_quantize_dit_equals_loading_the_jax_int8_tree(dit_case):
    """Quantizing the port's fp32 DiT gives the state_dict that the JAX
    package's quantized tree loads into, bit for bit, and ``fuse`` reaches
    every block."""
    params, qparams, *_ = dit_case
    model = CrossTransformer3DModel(**DIT_TINY)
    model.load_state_dict(dit_from_jax(params), strict=True)
    quantize_dit_(model, fuse=True)
    want = dit_from_jax(qparams)
    got = model.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and torch.equal(got[key], value), key
    assert all(block.ff.fuse for block in model.transformer_blocks)
    assert not isinstance(model.proj_out, Int8Linear)


def test_int8_depth_unet_matches_jax():
    params = jax_tree(UNetSpatioTemporalConditionModel(**UNET_TINY), 0, convert_svd_unet,
                      layers_per_block=1)
    qparams = jax_int8.quantize_depth_unet_params(params)
    model = quantize_depth_unet_(UNetSpatioTemporalConditionModel(**UNET_TINY)).eval()
    model.load_state_dict(svd_unet_from_jax(qparams), strict=True)
    assert int8_linears(model) == _kernel_q_leaves(qparams) == 10 * 20

    rng = np.random.default_rng(4)
    b, f = 2, 3
    inputs = (rng.standard_normal((b, f, 8, 8, 8)).astype(np.float32),
              np.full((b,), 0.25 * np.log(2.5), np.float32),
              rng.standard_normal((b, f, 1, 12)).astype(np.float32),
              np.array([[6.0, 127.0, 0.02], [3.0, 80.0, 0.1]], np.float32))

    def run():
        with torch.no_grad():
            return model(*map(T, inputs)).numpy()

    errors = _layer_errors(model, run)
    assert len(errors) == 200 and max(errors) <= LAYER_TOL
    with mock.patch.object(im, "quantize_rows_reference", per_tensor_quantize_rows):
        assert max(_layer_errors(model, run)) > LAYER_TOL

    # the fp32 UNet is the port's own, which tests/test_torch_depth.py holds
    # to the JAX one at 1e-4
    fp32_model = UNetSpatioTemporalConditionModel(**UNET_TINY).eval()
    fp32_model.load_state_dict(svd_unet_from_jax(params), strict=True)
    with torch.no_grad():
        fp32 = fp32_model(*map(T, inputs)).numpy()
    want = _np(jax.jit(JaxUNet(**UNET_TINY, quant="int8").apply)({"params": qparams},
                                                                 *map(jnp.asarray, inputs)))
    got = run()
    assert _cosine(got, fp32) > 0.999 and _cosine(want, fp32) > 0.999
    assert _cosine(got, want) > 0.999
