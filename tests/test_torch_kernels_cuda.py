"""The hand-written kernels on the card vs their plain versions.

Needs an NVIDIA card with nvcc (the kernels are CUDA C++ for sm_90a and have
no CPU mode); elsewhere every test here skips.  Run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: tests/conftest.py imports jax, which the card's machine
need not have).

Kernels: ``flash_attention`` (csrc/flash_attention.cu; the DiT's K1 and
the depth UNet's K4) and ``flash_maxpass`` (csrc/flash_maxpass.cu, the
depth UNet's two-pass K4b).  Shapes: those chip_smoke.py checks (the DiT
self-attention with heads cut, the Perceiver cross-attention, the depth
UNet's two kernel shapes cut in frames, a small ragged one) plus odd
lengths that leave ragged query and key tiles (``EDGE_LENGTHS``, in every
mode of the bf16 kernels at d 64 and d 128) and q, k, v read as strided
views.  Tolerance:
``attention_error`` in trajectorycrafter_tpu_torch/ops/attention.py, as in
chip_smoke.py -- per element 2^-6 (|ref| + P|v|), per row a relative L2
error of 2^-6 (the reasons are stated there).  At the DiT and depth shapes
the same bound must reject a row sum off by 10% and a run that skips the
last quarter of the kernel's own key tiles (``ATTENTION_KEY_TILE``).

The int8 family (ops/int8_matmul.py): ``int8_quantize_rows`` (K2a) bit-equal
to its plain version; ``int8_gemm`` (K2b) and ``int8_gemm_gscale`` (K3b)
within one bf16 ulp of theirs (``gemm_error``); ``int8_gemm_gelu_quant``
(K3a) within ``gelu_quant_error`` (scales 1e-6 relative, codes off by at
most 1 on at most 0.1% of the elements), at the shapes chip_smoke.py checks
cut in M and in full (K3a at every cluster size its groups give: 1, 2, 3,
4 and 7 blocks), with odd M, and at the edges of K2b's and K3b's `wgmma` main loop
(csrc/int8_gemm_hopper.cuh: K past its 128-byte K tile, N past the block,
ragged M, A a strided view, one and twelve K groups), there bit-equal (0
ulps).  At the feed-forward shapes the bounds must reject the
planted faults: a K step of 32 skipped, the bias dropped and the column
scales shifted by one (K2b, K3b); a group of 512 columns in place of 1,024
and the gelu dropped (K3a).

The attention variants (ops/attention_variants.py): ``flash_lse`` (K5) by
``attention_error`` and ``lse_error``, ``flash_exp2`` (K1b) by
``output_error``, ``flash_pv8`` (K6) and ``int8_flash_attention`` (K7) by
``quantized_error``, each against its own plain version, at the shapes
chip_smoke.py checks (heads or frames cut) and ragged ones (K6 at both of
its key block sizes and head dims and on the Perceiver's strided views; K7
at both head dims, key blocks of 128, 512 and 1,024 and strided views); the
bounds
reject an lse in base 2, a dropped clamp, a row sum off by 10%, the last
quarter of the key blocks skipped and zero-padded keys taken as real ones
where every score is negative.

The attention backward (csrc/flash_attention_bwd.cu): ``flash_attention_bwd_dkv``
(K4-dkv) and ``flash_attention_bwd_dq`` (K4-dq) within
``attention_backward_error`` (per element 2^-6 of the gradient's sum of
magnitudes, per head a relative L2 error of 2^-6) of
``attention_backward_reference``, at the DiT's and the Perceiver's training
shapes (heads cut), ragged lengths at and around the kernels' 64-query
and 128-key tiles (one key, one query, 13,330 of either), odd B * H, and
strided views; two launches on the same inputs agree bit for bit (no
atomics); the bound rejects di left out, the last quarter of the 64-query
tiles skipped in dK/dV and of the 128-key tiles in dQ
(``BWD_DKV_QUERY_TILE``, ``BWD_DQ_KEY_TILE``).  ``FlashAttentionFunction`` through
``multi_head_attention(impl="flash_stock")`` launches K5 and both kernels
once and gives the plain gradients; the routes with no backward raise
under autograd.

The long-trajectory path's device code, which has no kernel of its own:
the z-buffer render on the card against the CPU's (the warp's bounds; two
card renders bit-equal), and the tiled VAE decode at one tile bit-equal to
the one-shot decode.
"""

import math

import pytest
import torch

from trajectorycrafter_tpu_torch.ops import attention_variants as av
from trajectorycrafter_tpu_torch.ops.attention import (
    FlashAttentionFunction,
    attention_backward_error,
    attention_di,
    attention_error,
    kernel_error,
    lse_error,
    multi_head_attention,
    output_error,
    plain_refs,
    quantized_error,
)
from trajectorycrafter_tpu_torch.ops import int8_matmul as im
from trajectorycrafter_tpu_torch.ops.int8 import quantize_dense
from trajectorycrafter_tpu_torch.ops.kernels import (
    ATTENTION_KEY_TILE,
    BWD_DKV_QUERY_TILE,
    BWD_DQ_KEY_TILE,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_exp2,
    flash_lse,
    flash_maxpass,
    flash_pv8,
    int8_flash_attention,
    int8_gemm,
    int8_gemm_gelu_quant,
    int8_gemm_gscale,
    int8_quantize_rows,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, gain=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * gain).bfloat16()


def _check(out, q, k, v, scale, kernel=flash_attention):
    assert out.dtype == torch.bfloat16
    readings = kernel_error(kernel, out, q, k, v, scale)
    assert readings["ok"], readings


# Ragged lengths around the bf16 kernels' 64-row boxes and 128-key tiles,
# each on the query and on the key side: (Sq, Skv) pairs, Skv shorter than
# one key tile in four of them; every mode runs them at d 64 and d 128.
EDGE_LENGTHS = (1, 63, 65, 127, 129, 777, 1000)
EDGE_CASES = [(sq, skv, d) for sq, skv in zip(EDGE_LENGTHS, reversed(EDGE_LENGTHS))
              for d in (64, 128)]


@pytest.mark.parametrize("b,h,sq,skv,d,gain", [
    (1, 8, 13330, 13330, 64, 1.0),  # DiT self-attention, heads cut
    (2, 16, 13104, 3024, 128, 4.0),  # Perceiver, unbounded scores
    (1, 2, 1000, 1000, 64, 1.0),
    (1, 1, 1, 1, 64, 1.0),
    (2, 3, 17, 129, 128, 2.0),
    (1, 4, 65, 63, 64, 1.0),
    *[(1, 2, sq, skv, d, 2.0) for sq, skv, d in EDGE_CASES],
])
def test_kernel_matches_reference(gen, b, h, sq, skv, d, gain):
    q = _randn(gen, b, sq, h, d, gain=gain)
    k, v = _randn(gen, b, skv, h, d), _randn(gen, b, skv, h, d)
    before = flash_attention.launches
    out = flash_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _check(out, q, k, v, d ** -0.5)


@pytest.mark.parametrize("b,h,sq,skv,d,gain", [
    (2, 5, 9216, 9216, 64, 4.0),  # depth UNet level 0, frames cut
    (1, 1, 1, 1, 64, 1.0),
    (1, 4, 65, 63, 64, 6.0),
    (2, 3, 17, 129, 128, 2.0),
    (1, 2, 1000, 777, 64, 1.0),
    *[(1, 2, sq, skv, d, 4.0) for sq, skv, d in EDGE_CASES],
])
def test_maxpass_kernel_matches_reference(gen, b, h, sq, skv, d, gain):
    q = _randn(gen, b, sq, h, d, gain=gain)
    k, v = _randn(gen, b, skv, h, d), _randn(gen, b, skv, h, d)
    before = flash_maxpass.launches
    out = flash_maxpass(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert flash_maxpass.launches == before + 1
    _check(out, q, k, v, d ** -0.5, flash_maxpass)


@pytest.mark.parametrize("d", [64, 128])
def test_maxpass_all_negative_rows(gen, d):
    """Every score far below zero: the exact row max keeps exp2 in range."""
    b, h, s = 1, 2, 500
    q = (torch.randn((b, s, h, d), generator=gen, device="cuda") + 4.0).bfloat16()
    k = (-(torch.randn((b, s, h, d), generator=gen, device="cuda") * 0.1 + 4.0)).bfloat16()
    v = _randn(gen, b, s, h, d)
    _check(flash_maxpass(q, k, v, d ** -0.5), q, k, v, d ** -0.5, flash_maxpass)


def test_kernel_reads_strided_views(gen):
    """k and v as the two halves of one projection (the Perceiver's layout)."""
    b, s, h, d = 2, 300, 4, 128
    kv = _randn(gen, b, s, 2 * h * d)
    k, v = (t.unflatten(-1, (h, d)) for t in kv.chunk(2, dim=-1))
    q = _randn(gen, b, 77, h, d)
    out = multi_head_attention(q, k, v, scale=d ** -0.5).unflatten(-1, (h, d))
    torch.cuda.synchronize()
    _check(out, q, k, v, d ** -0.5)


def _held_to_plain(kernel, q, k, v, scale):
    """Run a bf16 attention kernel and hold it to its plain version: K1/K4
    and K4b by ``kernel_error``, K5 by ``attention_error`` and ``lse_error``,
    K1b (no mask, with the clamp) by ``output_error``."""
    if kernel is flash_lse:
        out, lse = kernel(q, k, v, scale)
        readings = lse_error(lse, q, k, scale)
        assert readings["ok"], readings
        _check(out, q, k, v, scale)
    elif kernel is flash_exp2:
        out = kernel(q, k, v, scale)
        plain = lambda x: av.exp2_attention_reference(q, k, x, scale)
        readings = output_error(out, *plain_refs(plain, v))
        assert readings["ok"], readings
    else:
        _check(kernel(q, k, v, scale), q, k, v, scale, kernel)


@pytest.mark.parametrize("kernel", [flash_attention, flash_maxpass, flash_lse, flash_exp2])
@pytest.mark.parametrize("layout", ["perceiver_kv", "bhsd"])
def test_every_mode_reads_strided_views(gen, kernel, layout):
    """q, k and v as strided views, read in place by the TMA unit: k and v
    the halves of one projection with q a slice of a wider one (the
    Perceiver's layout, d 128), or (B, H, S, D) tensors seen as (B, S, H, D)
    (d 64)."""
    if layout == "perceiver_kv":
        b, s, h, d = 2, 300, 4, 128
        k, v = (t.unflatten(-1, (h, d)) for t in _randn(gen, b, s, 2 * h * d).chunk(2, dim=-1))
        q = _randn(gen, b, 77, 3 * h * d)[..., h * d:2 * h * d].unflatten(-1, (h, d))
    else:
        b, s, h, d = 2, 300, 4, 64
        q, k, v = (_randn(gen, b, h, n, d).transpose(1, 2) for n in (77, s, s))
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    _held_to_plain(kernel, q, k, v, d ** -0.5)
    torch.cuda.synchronize()


@pytest.mark.parametrize("kernel", [flash_attention, flash_maxpass])
def test_wrapper_rejects_what_the_kernel_does_not_take(gen, kernel):
    q = _randn(gen, 1, 16, 2, 64)
    with pytest.raises(ValueError, match="bf16"):
        kernel(q.float(), q.float(), q.float(), 0.125)
    q32 = _randn(gen, 1, 16, 2, 32)
    with pytest.raises(ValueError, match="head dim"):
        kernel(q32, q32, q32, 0.125)
    odd = _randn(gen, 1, 16, 2, 65)[..., :64]  # rows not 16-byte aligned
    with pytest.raises(ValueError, match="aligned"):
        kernel(odd, odd, odd, 0.125)


def test_tolerance_rejects_planted_faults_at_the_dit_shape(gen):
    """Flat softmax over 209 key tiles: a row sum off by 10% and the last
    quarter of the key tiles skipped (the kernel run on the first three
    quarters of k and v) both fail the bound the sound kernel passes."""
    b, h, s, d = 1, 8, 13330, 64
    q, k, v = (_randn(gen, b, s, h, d) for _ in range(3))
    out = flash_attention(q, k, v, d ** -0.5)
    _check(out, q, k, v, d ** -0.5)
    row_sum_off = (out.float() / 1.1).bfloat16()
    assert not attention_error(row_sum_off, q, k, v, d ** -0.5)["ok"]
    tiles = -(-s // ATTENTION_KEY_TILE)
    keep = (tiles - tiles // 4) * ATTENTION_KEY_TILE
    tiles_skipped = flash_attention(q, k[:, :keep], v[:, :keep], d ** -0.5)
    assert not attention_error(tiles_skipped, q, k, v, d ** -0.5)["ok"]


@pytest.mark.parametrize("kernel,b,h,s", [
    (flash_attention, 2, 5, 9216),  # depth level 0, frames cut
    (flash_attention, 8, 10, 2304),  # depth level 1, frames cut
    (flash_maxpass, 2, 5, 9216),
    (flash_maxpass, 8, 10, 2304),
], ids=["K4_9216", "K4_2304", "K4b_9216", "K4b_2304"])
def test_tolerance_rejects_planted_faults_at_the_depth_shapes(gen, kernel, b, h, s):
    """Peaked softmax (q x 4): the same two faults, with both passes of the
    two-pass kernel run on the shortened k and v, fail the bound."""
    d, gain = 64, 4.0
    q = _randn(gen, b, s, h, d, gain=gain)
    k, v = _randn(gen, b, s, h, d), _randn(gen, b, s, h, d)
    out = kernel(q, k, v, d ** -0.5)
    _check(out, q, k, v, d ** -0.5, kernel)
    row_sum_off = (out.float() / 1.1).bfloat16()
    assert not kernel_error(kernel, row_sum_off, q, k, v, d ** -0.5)["ok"]
    tiles = -(-s // ATTENTION_KEY_TILE)
    keep = (tiles - tiles // 4) * ATTENTION_KEY_TILE
    tiles_skipped = kernel(q, k[:, :keep], v[:, :keep], d ** -0.5)
    assert not kernel_error(kernel, tiles_skipped, q, k, v, d ** -0.5)["ok"]


# ----------------------------------------------------------------------------
# the int8 GEMM family
# ----------------------------------------------------------------------------


def _int8_operands(gen, m, k, n, bias=True):
    """bf16 activations (M, K), their per-row codes and scales (the plain
    version's), a quantized (N, K) weight and a bf16 bias (or None)."""
    x = _randn(gen, m, k)
    wq, ws = quantize_dense(torch.randn((n, k), generator=gen, device="cuda") * k ** -0.5)
    b = (torch.randn(n, generator=gen, device="cuda") * 0.1).bfloat16() if bias else None
    xq, xs = im.quantize_rows_reference(x)
    return x, xq, xs, wq, ws, b


def _counted(kernel, *args):
    before = kernel.launches
    out = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    return out


@pytest.mark.parametrize("m,k", [
    (2084, 3072),  # the DiT's q/k/v/out and FF1 input, M cut (ragged)
    (2084, 12288),  # the FF2 input
    (4133, 320),  # depth level 0
    (70, 2048), (1, 8), (3, 5120),
])
def test_quantize_rows_kernel_is_bit_equal(gen, m, k):
    x = _randn(gen, m, k, gain=3.0)
    x[m // 2] = 0  # a zero row: scale 1e-8 / 127, codes 0
    xq, xs = _counted(int8_quantize_rows, x)
    xq_ref, xs_ref = im.quantize_rows_reference(x)
    assert torch.equal(xq, xq_ref) and torch.equal(xs, xs_ref)


def test_quantize_rows_kernel_rounds_half_to_even_and_reads_strided_rows(gen):
    wide = _randn(gen, 64, 336)
    x = wide[:, :320]  # rows 672 bytes apart
    x[0, :6] = torch.tensor([127.0, 62.5, -62.5, 0.5, 1.5, 2.5])
    x[0, 6:] = 0  # scale 1: the codes are the rounded values themselves
    xq, xs = _counted(int8_quantize_rows, x)
    xq_ref, xs_ref = im.quantize_rows_reference(x)
    assert torch.equal(xq, xq_ref) and torch.equal(xs, xs_ref)
    assert xq[0, :6].tolist() == [127, 62, -62, 0, 2, 2]


@pytest.mark.parametrize("m,k,n,bias", [
    (2084, 3072, 3072, True),  # DiT q/k/v/out, M cut
    (2084, 3072, 12288, True),  # unfused FF1
    (2084, 12288, 3072, True),  # unfused FF2
    (2084, 3072, 2048, False),  # Perceiver to_q
    (1003, 3072, 4096, False),  # Perceiver to_kv
    (2084, 2048, 3072, False),  # Perceiver to_out
    (4133, 320, 320, True),  # depth level 0
    (4133, 320, 2560, True),  # depth GEGLU proj_in
    (70, 48, 48, True), (1, 16, 16, False), (37, 80, 144, True),
])
def test_int8_gemm_kernel_matches_plain(gen, m, k, n, bias):
    _, xq, xs, wq, ws, b = _int8_operands(gen, m, k, n, bias)
    out = _counted(int8_gemm, xq, wq, xs, ws, b)
    readings = im.gemm_error(out, im.int8_matmul_reference(xq, wq, xs, ws, b))
    assert out.dtype == torch.bfloat16 and readings["ok"], readings


@pytest.mark.parametrize("m,k,n,group", [
    (2084, 3072, 12288, 1024),  # the fused FF1, M cut
    (26660, 3072, 12288, 1024),  # the fused FF1 in full: a ragged last M tile
    (2084, 3072, 12288, 512), (2084, 3072, 12288, 256),  # clusters of 2 and 1
    (2084, 3072, 12288, 384),  # 128-column tiles, clusters of 3
    (300, 256, 1792, 896),  # 128-column tiles, clusters of 7
    (70, 256, 512, 256), (33, 64, 128, 128), (130, 160, 1024, 512),
])
def test_gelu_quant_kernel_matches_plain(gen, m, k, n, group):
    _, xq, xs, wq, ws, b = _int8_operands(gen, m, k, n)
    hq, hs = _counted(int8_gemm_gelu_quant, xq, wq, xs, ws, b, group)
    readings = im.gelu_quant_error(
        hq, hs, *im.int8_matmul_gelu_quant_reference(xq, wq, xs, ws, b, group))
    assert readings["ok"], readings


@pytest.mark.parametrize("m,k,n,group", [
    (2084, 12288, 3072, 1024),  # the fused FF2, M cut
    (70, 512, 256, 256), (33, 128, 48, 128),
])
def test_gscale_kernel_matches_plain(gen, m, k, n, group):
    _, xq, xs, wq1, ws1, b1 = _int8_operands(gen, m, 64, k)
    hq, hs = im.int8_matmul_gelu_quant_reference(xq, wq1, xs, ws1, b1, group)
    _, _, _, wq, ws, b = _int8_operands(gen, 1, k, n)
    out = _counted(int8_gemm_gscale, hq, wq, hs, ws, b, group)
    readings = im.gemm_error(out, im.int8_matmul_gscale_reference(hq, wq, hs, ws, b, group))
    assert readings["ok"], readings


# The edges of the wgmma main loop (csrc/int8_gemm_hopper.cuh): its K tile is
# 128 bytes, int8_gemm's block 128 x 256 and int8_gemm_gscale's 128 x 128;
# the TMA unit zero-fills past K, N and M.  Each case bit-equal (0 ulps).
@pytest.mark.parametrize("m,k,n", [
    (70, 48, 256), (70, 160, 256), (70, 320, 256),  # K not a multiple of the K tile
    (129, 256, 48), (129, 256, 320),  # N not a multiple of the block
    (70, 384, 512), (2084, 384, 512),  # ragged M
], ids=["k48", "k160", "k320", "n48", "n320", "m70", "m2084"])
def test_int8_gemm_main_loop_edges_are_bit_equal(gen, m, k, n):
    _, xq, xs, wq, ws, b = _int8_operands(gen, m, k, n)
    out = _counted(int8_gemm, xq, wq, xs, ws, b)
    readings = im.gemm_error(out, im.int8_matmul_reference(xq, wq, xs, ws, b))
    assert readings["ok"] and readings["max_ulps"] == 0, readings


def test_int8_gemms_read_a_as_a_strided_view(gen):
    """A column slice of a wider int8 tensor: row stride lda > K and a data
    pointer 32 bytes into the row, read through the tensor map as it is."""
    m, k, n, group = 300, 1024, 320, 256
    _, xq, xs, wq, ws, b = _int8_operands(gen, m, k, n)
    wide = torch.zeros((m, k + 96), dtype=torch.int8, device="cuda")
    wide[:, 32:32 + k] = xq
    view = wide[:, 32:32 + k]
    assert view.stride(0) == k + 96 and not view.is_contiguous()
    out = _counted(int8_gemm, view, wq, xs, ws, b)
    readings = im.gemm_error(out, im.int8_matmul_reference(xq, wq, xs, ws, b))
    assert readings["ok"] and readings["max_ulps"] == 0, readings
    hs = torch.rand((m, k // group), generator=gen, device="cuda") * 0.01 + 1e-3
    out = _counted(int8_gemm_gscale, view, wq, hs, ws, b, group)
    readings = im.gemm_error(out, im.int8_matmul_gscale_reference(xq, wq, hs, ws, b, group))
    assert readings["ok"] and readings["max_ulps"] == 0, readings


@pytest.mark.parametrize("m,k,n,group", [
    (300, 1024, 256, 1024),  # one group
    (300, 12 * 128, 320, 128),  # 12 groups, N not a multiple of the block
], ids=["one_group", "twelve_groups"])
def test_gscale_kernel_groups_are_bit_equal(gen, m, k, n, group):
    _, xq, xs, wq1, ws1, b1 = _int8_operands(gen, m, 64, k)
    hq, hs = im.int8_matmul_gelu_quant_reference(xq, wq1, xs, ws1, b1, group)
    _, _, _, wq, ws, b = _int8_operands(gen, 1, k, n)
    out = _counted(int8_gemm_gscale, hq, wq, hs, ws, b, group)
    readings = im.gemm_error(out, im.int8_matmul_gscale_reference(hq, wq, hs, ws, b, group))
    assert readings["ok"] and readings["max_ulps"] == 0, readings


def test_gscale_wrapper_refuses_a_group_of_64(gen):
    """A K group must be a whole number of the main loop's 128-byte K tiles."""
    _, xq, _, wq, ws, b = _int8_operands(gen, 33, 128, 48)
    before = int8_gemm_gscale.launches
    with pytest.raises(ValueError, match="multiple of 128"):
        int8_gemm_gscale(xq, wq, torch.ones((33, 2), device="cuda"), ws, b, 64)
    assert int8_gemm_gscale.launches == before


def _k_step_skipped(q):
    """The codes with the last 32 of K zeroed: the kernel then skips the
    last 32-wide K step's products."""
    q = q.clone()
    q[:, -32:] = 0
    return q


def test_gemm_tolerances_reject_planted_faults_at_the_ff_shapes(gen):
    m, dim, inner, group = 1060, 3072, 12288, 1024
    _, xq, xs, wq1, ws1, b1 = _int8_operands(gen, m, dim, inner)
    ref = im.int8_matmul_reference(xq, wq1, xs, ws1, b1)
    assert im.gemm_error(int8_gemm(xq, wq1, xs, ws1, b1), ref)["ok"]
    for fault in (int8_gemm(_k_step_skipped(xq), wq1, xs, ws1, b1),
                  int8_gemm(xq, wq1, xs, ws1, None),
                  int8_gemm(xq, wq1, xs, ws1.roll(1), b1)):
        assert not im.gemm_error(fault, ref)["ok"]

    hq_ref, hs_ref = im.int8_matmul_gelu_quant_reference(xq, wq1, xs, ws1, b1, group)
    assert im.gelu_quant_error(*int8_gemm_gelu_quant(xq, wq1, xs, ws1, b1, group),
                               hq_ref, hs_ref)["ok"]
    hq512, hs512 = int8_gemm_gelu_quant(xq, wq1, xs, ws1, b1, 512)
    no_gelu = im.quantize_groups(int8_gemm(xq, wq1, xs, ws1, b1).float(), group)
    for hq, hs in ((hq512, hs512[:, ::2].contiguous()), no_gelu):
        assert not im.gelu_quant_error(hq, hs, hq_ref, hs_ref)["ok"]

    _, _, _, wq2, ws2, b2 = _int8_operands(gen, 1, inner, dim)
    ref = im.int8_matmul_gscale_reference(hq_ref, wq2, hs_ref, ws2, b2, group)
    assert im.gemm_error(int8_gemm_gscale(hq_ref, wq2, hs_ref, ws2, b2, group), ref)["ok"]
    for fault in (int8_gemm_gscale(_k_step_skipped(hq_ref), wq2, hs_ref, ws2, b2, group),
                  int8_gemm_gscale(hq_ref, wq2, hs_ref, ws2, None, group),
                  int8_gemm_gscale(hq_ref, wq2, hs_ref, ws2.roll(1), b2, group)):
        assert not im.gemm_error(fault, ref)["ok"]


def test_int8_dispatch_launches_the_kernels(gen):
    """``int8_dense_apply`` and ``int8_ff_apply`` on CUDA tensors run the
    kernels, and agree with ``impl="reference"``."""
    x, _, _, wq1, ws1, b1 = _int8_operands(gen, 300, 256, 1024)
    _, _, _, wq2, ws2, b2 = _int8_operands(gen, 1, 1024, 256)
    x = x.reshape(3, 100, 256)
    launches = [kern.launches for kern in (int8_quantize_rows, int8_gemm)]
    out = im.int8_dense_apply(x, wq1, ws1, b1)
    ref = im.int8_dense_apply(x, wq1, ws1, b1, impl="reference")
    assert [kern.launches for kern in (int8_quantize_rows, int8_gemm)] == \
        [n + 1 for n in launches]
    assert out.shape == (3, 100, 1024) and im.gemm_error(out, ref)["ok"]
    before = int8_gemm_gelu_quant.launches, int8_gemm_gscale.launches
    out = im.int8_ff_apply(x, wq1, ws1, b1, wq2, ws2, b2)
    ref = im.int8_ff_apply(x, wq1, ws1, b1, wq2, ws2, b2, impl="reference")
    assert (int8_gemm_gelu_quant.launches, int8_gemm_gscale.launches) == \
        (before[0] + 1, before[1] + 1)
    assert out.shape == (3, 100, 256) and im.gemm_error(out, ref)["ok"]


def test_int8_wrappers_reject_what_the_kernels_do_not_take(gen):
    x, xq, xs, wq, ws, b = _int8_operands(gen, 64, 256, 512)
    with pytest.raises(ValueError, match="bfloat16"):
        int8_quantize_rows(x.float())
    with pytest.raises(ValueError, match="aligned"):
        int8_quantize_rows(_randn(gen, 64, 257)[:, :256])
    with pytest.raises(ValueError, match="int8"):
        int8_gemm(xq.float(), wq, xs, ws, b)
    with pytest.raises(ValueError, match="multiples of 16"):
        int8_gemm(xq[:, :40], wq[:, :40], xs, ws, b)  # rows aligned, K = 40
    with pytest.raises(ValueError, match="shape"):
        int8_gemm(xq, wq, xs[:10], ws, b)
    with pytest.raises(ValueError, match="group"):
        int8_gemm_gelu_quant(xq, wq, xs, ws, b, 384)
    with pytest.raises(ValueError, match="group"):
        int8_gemm_gscale(xq, wq, torch.ones((64, 2), device="cuda"), ws, b, 96)
    with pytest.raises(ValueError, match="CUDA"):
        int8_gemm(xq.cpu(), wq, xs, ws, b)


# ----------------------------------------------------------------------------
# the attention variants: K5 (flash_lse), K1b (flash_exp2), K6 (flash_pv8),
# K7 (int8_flash_attention), each held to its plain version with
# ops/attention.py's bounds (attention_error / output_error, lse_error,
# quantized_error)
# ----------------------------------------------------------------------------


def _pv8_plain(q, k, block_k):
    return lambda x: av.pv8_reference(q, k, x, q.shape[-1] ** -0.5, block_k)


def _pv8_launched(q, k, v, block_k):
    """K6 through ``pv8_attention`` (V quantized and laid out first), one launch."""
    before = flash_pv8.launches
    out = av.pv8_attention(q, k, v, q.shape[-1] ** -0.5, block_k)
    torch.cuda.synchronize()
    assert flash_pv8.launches == before + 1
    return out


def _int8_plain(q, k, block_k):
    return lambda x: av.int8_attention_reference(q, k, x, q.shape[-1] ** -0.5, block_k)


def _all_negative(gen, b, s, h, d):
    """q along +u, k along -80 u (|u| = 1): at d = 64 every score q.k / 8
    lies near -10."""
    u = torch.full((d,), d ** -0.5, device="cuda")
    q = u + 0.3 * torch.randn((b, s, h, d), generator=gen, device="cuda") * d ** -0.5
    k = -80.0 * u + torch.randn((b, s, h, d), generator=gen, device="cuda") * d ** -0.5
    return q.bfloat16(), k.bfloat16(), _randn(gen, b, s, h, d)


@pytest.mark.parametrize("b,h,sq,skv,d,gain", [
    (1, 4, 30720, 30720, 64, 1.0),  # the bench's DiT shape, heads cut
    (1, 2, 1000, 777, 64, 4.0),
    (2, 3, 17, 129, 128, 2.0),
    (1, 1, 1, 1, 64, 1.0),
    *[(1, 2, sq, skv, d, 2.0) for sq, skv, d in EDGE_CASES],
])
def test_lse_kernel_matches_plain(gen, b, h, sq, skv, d, gain):
    q = _randn(gen, b, sq, h, d, gain=gain)
    k, v = _randn(gen, b, skv, h, d), _randn(gen, b, skv, h, d)
    out, lse = _counted(flash_lse, q, k, v, d ** -0.5)
    _check(out, q, k, v, d ** -0.5)
    readings = lse_error(lse, q, k, d ** -0.5)
    assert lse.shape == (b, h, sq) and readings["ok"], readings
    assert not lse_error(lse / math.log(2.0), q, k, d ** -0.5)["ok"]  # lse in base 2


@pytest.mark.parametrize("b,h,sq,skv,d,gain,masked", [
    (1, 4, 30720, 30720, 64, 1.0, 542),  # the bench's DiT shape: 30,178 real keys
    (1, 2, 1000, 777, 64, 1.0, 100),
    (2, 3, 17, 129, 128, 2.0, 0),
    # the last fifth of the keys masked by kv_valid, besides the ragged edge
    *[(1, 2, sq, skv, d, 2.0, skv // 5) for sq, skv, d in EDGE_CASES],
])
def test_exp2_kernel_matches_plain(gen, b, h, sq, skv, d, gain, masked):
    q = _randn(gen, b, sq, h, d, gain=gain)
    k, v = _randn(gen, b, skv, h, d), _randn(gen, b, skv, h, d)
    valid = (torch.arange(skv, device="cuda") < skv - masked).float() if masked else None
    scale = d ** -0.5
    out = _counted(flash_exp2, q, k, v, scale, valid, 0.5, True)
    plain = lambda x: av.exp2_attention_reference(q, k, x, scale, valid, 0.5, True)
    readings = output_error(out, *plain_refs(plain, v))
    assert readings["ok"], readings


@pytest.mark.parametrize("s,d,gain", [(4096, 64, 20.0), (777, 128, 30.0)])
def test_exp2_tolerance_rejects_a_dropped_clamp(gen, s, d, gain):
    """Scores above 110 in the exp2 domain: the clamp at 110 changes the
    function, and the kernel run without it fails the bound."""
    b, h = 1, 2
    q, k, v = _randn(gen, b, s, h, d, gain=gain), _randn(gen, b, s, h, d), _randn(gen, b, s, h, d)
    scale = d ** -0.5
    plain = lambda x: av.exp2_attention_reference(q, k, x, scale)
    refs = plain_refs(plain, v)
    assert output_error(flash_exp2(q, k, v, scale), *refs)["ok"]
    assert not output_error(flash_exp2(q, k, v, scale, clamp=False), *refs)["ok"]


@pytest.mark.parametrize("b,h,sq,skv,d,gain", [
    (1, 8, 13330, 13330, 64, 1.0),  # the DiT self-attention, heads cut
    (2, 16, 13104, 3024, 128, 4.0),  # the Perceiver
    (2, 5, 9216, 9216, 64, 4.0),  # depth level 0, frames cut
    (8, 10, 2304, 2304, 64, 4.0),  # depth level 1, frames cut
    (1, 2, 200, 200, 64, 1.0), (2, 3, 17, 129, 128, 2.0),
])
def test_pv8_kernel_matches_plain(gen, b, h, sq, skv, d, gain):
    q = _randn(gen, b, sq, h, d, gain=gain)
    k, v = _randn(gen, b, skv, h, d), _randn(gen, b, skv, h, d)
    block_k = av.pv8_block_k(sq)
    before = flash_pv8.launches
    out = av.pv8_attention(q, k, v, d ** -0.5, block_k)
    torch.cuda.synchronize()
    assert flash_pv8.launches == before + 1
    readings = quantized_error(out, *plain_refs(_pv8_plain(q, k, block_k), v))
    assert readings["ok"], readings


# K6's key blocks are whole 128-key tiles: both of the JAX dispatch's block
# sizes at both head dims, against the Perceiver's 3,024 keys (a last block
# of 976) and lengths that leave a ragged last key tile.
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("block_k", [512, 1024])
@pytest.mark.parametrize("skv", [3024, 1000, 129, 1])
def test_pv8_kernel_blocks_and_ragged_keys(gen, d, block_k, skv):
    b, h, sq = 1, 2, 300
    q = _randn(gen, b, sq, h, d, gain=2.0)
    k, v = _randn(gen, b, skv, h, d), _randn(gen, b, skv, h, d)
    out = _pv8_launched(q, k, v, block_k)
    readings = quantized_error(out, *plain_refs(_pv8_plain(q, k, block_k), v))
    assert readings["ok"], readings


def test_pv8_kernel_reads_the_perceivers_strided_views(gen):
    """q a slice of a wider projection, k (and v) halves of one: the
    Perceiver's layout, read in place by the TMA unit."""
    b, sq, skv, h, d = 2, 333, 3024, 4, 128
    k, v = (t.unflatten(-1, (h, d)) for t in _randn(gen, b, skv, 2 * h * d).chunk(2, dim=-1))
    q = _randn(gen, b, sq, 3 * h * d, gain=4.0)[..., h * d:2 * h * d].unflatten(-1, (h, d))
    assert not (q.is_contiguous() or k.is_contiguous())
    block_k = av.pv8_block_k(sq)
    out = _pv8_launched(q, k, v, block_k)
    readings = quantized_error(out, *plain_refs(_pv8_plain(q, k, block_k), v))
    assert readings["ok"], readings


def _int8_launched(q, k, v, block_k):
    """K7 through ``int8_attention`` (q, k, v quantized and V laid out
    first), one launch."""
    before = int8_flash_attention.launches
    out = av.int8_attention(q, k, v, q.shape[-1] ** -0.5, block_k)
    torch.cuda.synchronize()
    assert int8_flash_attention.launches == before + 1
    return out


# K7 on the PV-int8 loop: its own block rule at the DiT shape (heads cut)
# and at small ones, both head dims, key blocks of 128, 512 and 1,024 keys,
# Skv that is a multiple of neither the 128-key tile nor the 192-row query
# tile (nor Sq), and q, k, v read as strided views.
@pytest.mark.parametrize("b,h,sq,skv,d,block_k", [
    (1, 8, 13330, 13330, 64, None),  # the DiT shape, heads cut
    (1, 2, 200, 200, 64, None), (1, 2, 384, 384, 64, None), (2, 3, 129, 129, 128, None),
    (1, 16, 4096, 4096, 128, None),  # chip_smoke.py's d-128 shape
    (1, 2, 500, 1000, 64, 128), (1, 2, 1000, 777, 64, 512), (1, 2, 300, 3001, 64, 1024),
    (1, 2, 500, 1000, 128, 128), (1, 2, 1000, 777, 128, 512), (1, 2, 300, 3001, 128, 1024),
    (2, 3, 65, 1, 64, 128), (1, 2, 1, 130, 128, 512),
])
def test_int8_attention_kernel_matches_plain(gen, b, h, sq, skv, d, block_k):
    q = _randn(gen, b, sq, h, d)
    k, v = _randn(gen, b, skv, h, d), _randn(gen, b, skv, h, d)
    block_k = block_k or av.int8_block_k(sq)
    out = _int8_launched(q, k, v, block_k)
    readings = quantized_error(out, *plain_refs(_int8_plain(q, k, block_k), v))
    assert readings["ok"], readings


@pytest.mark.parametrize("d", [64, 128])
def test_int8_attention_kernel_reads_strided_views(gen, d):
    """q a slice of a wider projection, k and v halves of one: read in place
    by the TMA unit, after quantization (which keeps the layout)."""
    b, sq, skv, h = 2, 333, 1000, 4
    k, v = (t.unflatten(-1, (h, d)) for t in _randn(gen, b, skv, 2 * h * d).chunk(2, dim=-1))
    q = _randn(gen, b, sq, 3 * h * d)[..., h * d:2 * h * d].unflatten(-1, (h, d))
    assert not (q.is_contiguous() or k.is_contiguous())
    q8, k8, v8, logit, v127 = av.int8_operands(q, k, v, d ** -0.5)
    q8s = torch.zeros((b, sq, 3 * h * d), dtype=torch.int8, device="cuda")
    q8s[..., h * d:2 * h * d] = q8.flatten(-2)
    kv8 = torch.cat([k8.flatten(-2), v8.flatten(-2)], dim=-1)
    q8v = q8s[..., h * d:2 * h * d].unflatten(-1, (h, d))
    k8v = kv8[..., :h * d].unflatten(-1, (h, d))
    assert not (q8v.is_contiguous() or k8v.is_contiguous())
    block_k = av.int8_block_k(sq)
    out = int8_flash_attention(q8v, k8v, av.pv8_keys_last(v8), logit, v127, block_k)
    readings = quantized_error(out, *plain_refs(_int8_plain(q, k, block_k), v))
    assert readings["ok"], readings


@pytest.mark.parametrize("variant", ["pv8", "int8"])
def test_quantized_tolerances_reject_planted_faults(gen, variant):
    """At the DiT shape (heads cut): a row sum off by 10% and the last quarter
    of the key blocks skipped; at a ragged shape with every score negative,
    zero-padded keys passed as real keys."""
    b, h, s, d = 1, 4, 13330, 64
    run, plain, block_k = ((av.pv8_attention, _pv8_plain, av.pv8_block_k(s))
                           if variant == "pv8" else
                           (av.int8_attention, _int8_plain, av.int8_block_k(s)))
    q, k, v = (_randn(gen, b, s, h, d) for _ in range(3))
    out = run(q, k, v, d ** -0.5, block_k)
    refs = plain_refs(plain(q, k, block_k), v)
    assert quantized_error(out, *refs)["ok"]
    assert not quantized_error((out.float() / 1.1).bfloat16(), *refs)["ok"]
    blocks = -(-s // block_k)
    keep = (blocks - -(-blocks // 4)) * block_k
    skipped = run(q, k[:, :keep], v[:, :keep], d ** -0.5, block_k)
    assert not quantized_error(skipped, *refs)["ok"]

    s = 1000
    q, k, v = _all_negative(gen, 1, s, 2, d)
    block_k = av.pv8_block_k(s) if variant == "pv8" else av.int8_block_k(s)
    out = run(q, k, v, d ** -0.5, block_k)
    refs = plain_refs(plain(q, k, block_k), v)
    assert quantized_error(out, *refs)["ok"]
    pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, block_k - s))
    padded = run(q, pad(k), pad(v), d ** -0.5, block_k)
    assert not quantized_error(padded, *refs)["ok"]


def test_attention_variant_wrappers_reject_what_the_kernels_do_not_take(gen):
    q = _randn(gen, 1, 64, 2, 64)
    with pytest.raises(ValueError, match="bf16"):
        flash_lse(q.float(), q.float(), q.float(), 0.125)
    with pytest.raises(ValueError, match="kv_valid"):
        flash_exp2(q, q, q, 0.125, torch.ones(3, device="cuda"))
    v8, vs = av.quantize_per_head(q)
    vt = av.pv8_keys_last(v8)
    vt64 = vt[..., :64].contiguous()  # 64 keys a row: not whole 128-key tiles
    with pytest.raises(ValueError, match="multiple of 128"):
        flash_pv8(q, q, vt64, vs.reshape(-1), 0.18, 512)
    with pytest.raises(ValueError, match="block_k"):
        flash_pv8(q, q, vt, vs.reshape(-1), 0.18, 100)
    with pytest.raises(ValueError, match="block_k 192 must be a positive multiple of 128"):
        flash_pv8(q, q, vt, vs.reshape(-1), 0.18, 192)
    with pytest.raises(ValueError, match="int8"):
        int8_flash_attention(q, q, vt, vs.reshape(-1), vs.reshape(-1), 128)
    # K7 takes K6's 128-key tiles: V^T rows and key blocks
    q8 = v8
    with pytest.raises(ValueError, match="multiple of 128"):
        int8_flash_attention(q8, q8, vt64, vs.reshape(-1), vs.reshape(-1), 128)
    for block_k in (64, 192):
        with pytest.raises(ValueError, match=f"block_k {block_k} must be a positive multiple of 128"):
            int8_flash_attention(q8, q8, vt, vs.reshape(-1), vs.reshape(-1), block_k)


# ----------------------------------------------------------------------------
# checkpoint loading onto the card (utils/checkpoints.py)
# ----------------------------------------------------------------------------

# a small DiT whose attention and int8 GEMMs take the kernels: head dim 64,
# every linear's K and N multiples of 16
CARD_DIT = dict(num_attention_heads=2, attention_head_dim=64, num_layers=2, in_channels=9,
                out_channels=4, time_embed_dim=64, text_embed_dim=64, max_text_seq_length=16,
                cross_attn_dim_head=64, cross_attn_num_heads=2, cross_attn_interval=2,
                use_rotary_positional_embeddings=True)


def _card_dit_tree(tmp_path):
    """A seeded bf16 DiT written as two safetensors shards and a config.json
    -> (dir, the written tensors)."""
    import json

    from safetensors.torch import save_file

    from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel

    torch.manual_seed(0)
    sd = {k: (v.detach() + 0.02 * torch.randn_like(v)).bfloat16().contiguous()
          for k, v in CrossTransformer3DModel(**CARD_DIT).state_dict().items()}
    keys = sorted(sd)
    save_file({k: sd[k] for k in keys[::2]}, str(tmp_path / "model-00001-of-00002.safetensors"))
    save_file({k: sd[k] for k in keys[1::2]}, str(tmp_path / "model-00002-of-00002.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(CARD_DIT))
    return tmp_path, sd


def test_checkpoint_tree_loads_onto_the_card_bit_equal(gen, tmp_path):
    from trajectorycrafter_tpu_torch.utils.checkpoints import load_dit

    path, written = _card_dit_tree(tmp_path)
    dit = load_dit(str(path), "cuda", torch.bfloat16)
    got = dit.state_dict()
    assert set(got) == set(written)
    for key, value in got.items():
        assert value.is_cuda and value.dtype == torch.bfloat16, key
        assert torch.equal(value.cpu().view(torch.int16), written[key].view(torch.int16)), key


def test_int8_dit_loaded_from_a_tree_launches_the_int8_kernels(gen, tmp_path):
    from trajectorycrafter_tpu_torch.ops.int8 import Int8Linear
    from trajectorycrafter_tpu_torch.ops.rope import rope_for_sample
    from trajectorycrafter_tpu_torch.utils.checkpoints import load_dit

    path, written = _card_dit_tree(tmp_path)
    dit = load_dit(str(path), "cuda", torch.bfloat16, quant="int8")
    layers = {name: m for name, m in dit.named_modules() if isinstance(m, Int8Linear)}
    assert len(layers) == 2 * 6 + 1 * 3
    for name, layer in layers.items():  # quantized on the card from the written bf16 weight
        wq, ws = quantize_dense(written[name + ".weight"].cuda())
        assert torch.equal(layer.weight_q, wq) and torch.equal(layer.weight_scale, ws), name
    b, f, h, w = 2, 3, 8, 12
    args = (_randn(gen, b, f, h, w, 4), _randn(gen, b, 16, 64),
            torch.full((b,), 500.0, device="cuda"))
    kwargs = dict(inpaint_latents=_randn(gen, b, f, h, w, 5),
                  cross_latents=_randn(gen, b, 2, h, w, 4),
                  image_rotary_emb=tuple(torch.from_numpy(t).cuda()
                                         for t in rope_for_sample(64, h * 8, w * 8, f)))
    before = [k.launches for k in (int8_quantize_rows, int8_gemm, flash_attention)]
    with torch.no_grad():
        out = dit(*args, **kwargs)
    torch.cuda.synchronize()
    after = [k.launches for k in (int8_quantize_rows, int8_gemm, flash_attention)]
    assert [a - b0 for a, b0 in zip(after, before)] == [15, 15, 2 + 1]
    assert out.shape == (b, f, h, w, 4) and torch.isfinite(out).all()


# The samplers have no kernel: one step of each on the card against the same
# step on the CPU, from the same fp32 inputs, with chip_smoke.py's helpers
# and bound (1e-5 of the largest magnitude involved: the card may contract
# a multiply-add into an FMA and divide by a scalar as a multiply by its
# reciprocal).
@pytest.mark.parametrize("name", ["Euler", "Euler A", "DPM++", "PNDM", "DDIM_Cog"])
def test_sampler_step_on_the_card_matches_the_cpu(gen, name):
    from chip_smoke import SAMPLER_STEP_TOL, sampler_step_draws, sampler_step_error

    err, scale = sampler_step_error(name, sampler_step_draws())
    assert err <= SAMPLER_STEP_TOL * scale, (name, err, scale)


# The long-trajectory path's device code without kernels of its own: the
# z-buffer render (scatter_reduce over pixel bins) on the card against the
# same render on the CPU, and the tiled VAE decode at one tile against the
# one-shot decode.  The render holds ties (a clip lifted from one camera
# over a plane, duplicated points) and is held to tests/test_torch_warp.py's
# bounds (masks disagree on at most 0.5% of the pixels; colour and depth
# within 1e-3 where both are known, but on at most 3% of them), and two
# card renders are bit-equal (the tie rule decides every pixel).
@pytest.mark.parametrize("point_size", [1, 3])
def test_zbuffer_render_on_the_card_matches_the_cpu(gen, point_size):
    from trajectorycrafter_tpu_torch.geometry.pointcloud import (
        lift_video_to_pointcloud,
        render_zbuffer,
    )

    f, h, w = 6, 96, 160
    g = torch.Generator().manual_seed(1)
    frames = torch.rand((f, h, w, 3), generator=g)
    plane = (2.0 + 2.0 * torch.arange(h, dtype=torch.float32) / h)[:, None].expand(h, w)
    K = torch.tensor([[120.0, 0, w / 2], [0, 120.0, h / 2], [0, 0, 1]])
    anchor = torch.diag(torch.tensor([-1.0, 1.0, -1.0, 1.0]))
    pts, cols = lift_video_to_pointcloud(frames, plane.expand(f, h, w).contiguous(),
                                         K.expand(f, 3, 3), anchor.expand(f, 4, 4))
    pts = torch.cat([pts, pts[:5000], torch.rand((3000, 3), generator=g) * 4 - 2])
    cols = torch.cat([cols, torch.rand((8000, 3), generator=g)])
    w2c = torch.linalg.inv(anchor.clone())
    w2c[:3, 3] += torch.tensor([0.1, -0.05, 0.2])
    want = render_zbuffer(pts, cols, K, w2c, h, w, point_size=point_size)
    got = render_zbuffer(pts.cuda(), cols.cuda(), K.cuda(), w2c.cuda(), h, w,
                         point_size=point_size)
    again = render_zbuffer(pts.cuda(), cols.cuda(), K.cuda(), w2c.cuda(), h, w,
                           point_size=point_size)
    assert all(x.is_cuda for x in got) and all(torch.equal(a, b) for a, b in zip(got, again))
    img, depth, mask = (x.cpu() for x in got)
    assert (mask != want[2]).float().mean() <= 0.005
    both = (mask > 0) & (want[2] > 0)
    assert both.float().mean() > 0.3
    off = ((img - want[0]).abs().amax(-1) > 1e-3) | ((depth - want[1]).abs() > 1e-3)
    assert off[both].float().mean() <= 0.03


def test_tiled_decode_at_one_tile_is_the_one_shot_decode_on_the_card(gen):
    from trajectorycrafter_tpu_torch.models.vae import (
        AutoencoderKLCogVideoX,
        vae_decode,
        vae_decode_tiled,
    )
    from trajectorycrafter_tpu_torch.orchestrator import random_init_

    vae = AutoencoderKLCogVideoX(latent_channels=4, block_out_channels=(8, 16, 16, 32),
                                 layers_per_block=1, norm_num_groups=4)
    vae = random_init_(vae.to("cuda", torch.bfloat16).eval(), 0)
    latents = torch.randn((1, 3, 9, 12, 4), generator=gen, device="cuda").bfloat16()
    one_shot = vae_decode(vae, latents).float()
    assert torch.equal(vae_decode_tiled(vae, latents, 9, 12, 0.0, 0.0), one_shot)
    tiled = vae_decode_tiled(vae, latents, 4, 5, 1.0 / 6.0, 1.0 / 5.0)
    assert tiled.shape == one_shot.shape and torch.isfinite(tiled).all()


# ----------------------------------------------------------------------------
# the attention backward (csrc/flash_attention_bwd.cu) and its autograd Function
# ----------------------------------------------------------------------------

def _backward_inputs(gen, b, h, sq, skv, d, gain):
    """q, k, v, the forward's (out, lse) from K5, a random dout and di."""
    q = _randn(gen, b, sq, h, d, gain=gain)
    k, v = _randn(gen, b, skv, h, d), _randn(gen, b, skv, h, d)
    out, lse = flash_lse(q, k, v, d ** -0.5)
    dout = _randn(gen, b, sq, h, d)
    return q, k, v, out, lse, dout, attention_di(out, dout)


def _backward(q, k, v, dout, lse, di, scale):
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, di, scale)
    return {"dq": flash_attention_bwd_dq(q, k, v, dout, lse, di, scale), "dk": dk, "dv": dv}


@pytest.mark.parametrize("b,h,sq,skv,d,gain", [
    (1, 8, 13330, 13330, 64, 1.0),  # DiT self-attention in training (B = 1), heads cut
    (1, 16, 13104, 3024, 128, 4.0),  # Perceiver in training, unbounded scores
    (1, 2, 1000, 777, 64, 2.0),
    (2, 3, 17, 129, 128, 2.0),
    (1, 1, 1, 1, 64, 1.0),
    # lengths at and around the kernels' 64-query and 128-key tiles and
    # 128-row blocks, B * H odd, both head dims
    (1, 3, 127, 128, 64, 2.0),
    (3, 1, 128, 129, 128, 2.0),
    (1, 3, 129, 127, 128, 2.0),
    (1, 3, 13330, 1, 64, 2.0),
    (1, 3, 1, 13330, 128, 2.0),
    (3, 1, 13330, 129, 128, 2.0),
    (1, 3, 127, 13330, 64, 2.0),
    *[(1, 2, sq, skv, d, 2.0) for sq, skv, d in EDGE_CASES],
])
def test_backward_kernels_match_plain(gen, b, h, sq, skv, d, gain):
    q, k, v, out, lse, dout, di = _backward_inputs(gen, b, h, sq, skv, d, gain)
    before = (flash_attention_bwd_dkv.launches, flash_attention_bwd_dq.launches)
    grads = _backward(q, k, v, dout, lse, di, d ** -0.5)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dkv.launches, flash_attention_bwd_dq.launches) == (
        before[0] + 1, before[1] + 1)
    assert all(g.dtype == torch.bfloat16 for g in grads.values())
    readings = attention_backward_error(grads, q, k, v, out, lse, dout, d ** -0.5)
    assert readings["ok"], readings


@pytest.mark.parametrize("layout", ["perceiver_kv", "bhsd"])
def test_backward_kernels_read_strided_views(gen, layout):
    b, s, h = 2, 300, 4
    if layout == "perceiver_kv":
        d = 128
        k, v = (x.unflatten(-1, (h, d)) for x in _randn(gen, b, s, 2 * h * d).chunk(2, dim=-1))
        q = _randn(gen, b, 77, 3 * h * d)[..., h * d:2 * h * d].unflatten(-1, (h, d))
        dout = _randn(gen, b, 77, 2 * h * d)[..., :h * d].unflatten(-1, (h, d))
    else:
        d = 64
        q, k, v, dout = (_randn(gen, b, h, n, d, gain=2.0).transpose(1, 2)
                         for n in (77, s, s, 77))
    assert not (q.is_contiguous() or k.is_contiguous() or dout.is_contiguous())
    out, lse = flash_lse(q, k, v, d ** -0.5)
    di = attention_di(out, dout)
    grads = _backward(q, k, v, dout, lse, di, d ** -0.5)
    readings = attention_backward_error(grads, q, k, v, out, lse, dout, d ** -0.5)
    assert readings["ok"], readings


def test_backward_kernels_repeat_bit_for_bit(gen):
    """No atomics: each gradient row is written once, by one block, so two
    launches on the same inputs agree bit for bit."""
    for b, h, sq, skv, d in ((1, 3, 1000, 777, 64), (1, 3, 300, 1000, 128)):
        q, k, v, _, lse, dout, di = _backward_inputs(gen, b, h, sq, skv, d, 2.0)
        first = _backward(q, k, v, dout, lse, di, d ** -0.5)
        second = _backward(q, k, v, dout, lse, di, d ** -0.5)
        torch.cuda.synchronize()
        for name in first:
            assert torch.equal(first[name], second[name]), name


def _skip_last_quarter(n, tile):
    tiles = -(-n // tile)
    return (tiles - -(-tiles // 4)) * tile


@pytest.mark.parametrize("b,h,sq,skv,d", [(1, 8, 13330, 13330, 64), (1, 16, 13104, 3024, 128)],
                         ids=["dit", "perceiver"])
def test_backward_tolerance_rejects_planted_faults(gen, b, h, sq, skv, d):
    """Peaked rows (q x 4): di left out of both kernels, the last quarter of
    the query tiles skipped in dK/dV, and the last quarter of the key tiles
    skipped in dQ each fail the bound the sound kernels pass."""
    scale = d ** -0.5
    q, k, v, out, lse, dout, di = _backward_inputs(gen, b, h, sq, skv, d, 4.0)
    held = lambda grads: attention_backward_error(grads, q, k, v, out, lse, dout, scale)
    assert held(_backward(q, k, v, dout, lse, di, scale))["ok"]
    assert not held(_backward(q, k, v, dout, lse, torch.zeros_like(di), scale))["ok"]
    keep = _skip_last_quarter(sq, BWD_DKV_QUERY_TILE)
    dk, dv = flash_attention_bwd_dkv(q[:, :keep], k, v, dout[:, :keep],
                                     lse[..., :keep].contiguous(), di[..., :keep].contiguous(),
                                     scale)
    assert not held({"dk": dk})["ok"] and not held({"dv": dv})["ok"]
    keep = _skip_last_quarter(skv, BWD_DQ_KEY_TILE)
    dq = flash_attention_bwd_dq(q, k[:, :keep], v[:, :keep], dout, lse, di, scale)
    assert not held({"dq": dq})["ok"]


def test_function_gradients_are_the_kernels_and_match_plain(gen):
    b, h, sq, skv, d = 1, 4, 1000, 777, 128
    q, k, v = (_randn(gen, b, n, h, d, gain=2.0).requires_grad_() for n in (sq, skv, skv))
    counts = lambda: (flash_lse.launches, flash_attention_bwd_dkv.launches,
                      flash_attention_bwd_dq.launches)
    before = counts()
    out = multi_head_attention(q, k, v, impl="flash_stock")
    assert out.grad_fn is not None
    dout = _randn(gen, b, sq, h * d)
    out.backward(dout)
    torch.cuda.synchronize()
    assert counts() == tuple(c + 1 for c in before)
    with torch.no_grad():
        o, lse = flash_lse(q, k, v, d ** -0.5)
    grads = {"dq": q.grad, "dk": k.grad, "dv": v.grad}
    readings = attention_backward_error(grads, q.detach(), k.detach(), v.detach(), o, lse,
                                        dout.unflatten(-1, (h, d)), d ** -0.5)
    assert readings["ok"], readings
    assert torch.equal(FlashAttentionFunction.apply(q, k, v, d ** -0.5).detach(), o)


@pytest.mark.parametrize("impl", ["auto", "flash_max", "flash_pv8"])
def test_routes_without_a_backward_raise_under_autograd(gen, impl):
    q = _randn(gen, 1, 300, 2, 64).requires_grad_()
    k, v = _randn(gen, 1, 300, 2, 64), _randn(gen, 1, 300, 2, 64)
    with pytest.raises(RuntimeError, match="flash_stock"):
        multi_head_attention(q, k, v, impl=impl)
    with torch.no_grad():
        assert multi_head_attention(q, k, v, impl=impl).grad_fn is None
    v.requires_grad_()  # v reaches the quantized kernels quantized
    with pytest.raises(RuntimeError, match="flash_stock"):
        av.int8_attention(q.detach(), k, v, 0.125, 128)
    with pytest.raises(RuntimeError, match="flash_stock"):
        av.pv8_attention(q.detach(), k, v, 0.125, 512)
