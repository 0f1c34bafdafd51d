"""The hand-written attention kernels on the card vs their plain version.

Needs an NVIDIA card with nvcc (the kernel is CUDA C++ for sm_90a and has no
CPU mode); elsewhere every test here skips.  Run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: tests/conftest.py imports jax, which the card's machine
need not have).

Kernels: ``flash_attention`` (csrc/flash_attention.cu; the DiT's K1 and
the depth UNet's K4) and ``flash_maxpass`` (csrc/flash_maxpass.cu, the
depth UNet's two-pass K4b).  Shapes: those chip_smoke.py checks (the DiT
self-attention with heads cut, the Perceiver cross-attention, the depth
UNet's two kernel shapes cut in frames, a small ragged one) plus odd
lengths that leave ragged query and key tiles.  Tolerance:
``attention_error`` in trajectorycrafter_tpu_torch/ops/attention.py, as in
chip_smoke.py -- per element 2^-6 (|ref| + P|v|), per row a relative L2
error of 2^-6 (the reasons are stated there).  At the DiT and depth shapes
the same bound must reject a row sum off by 10% and a run that skips the
last quarter of the key tiles.
"""

import pytest
import torch

from trajectorycrafter_tpu_torch.ops.attention import (
    attention_error,
    kernel_error,
    multi_head_attention,
)
from trajectorycrafter_tpu_torch.ops.kernels import (
    FLASH_KEY_TILE,
    flash_attention,
    flash_maxpass,
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


@pytest.mark.parametrize("b,h,sq,skv,d,gain", [
    (1, 8, 13330, 13330, 64, 1.0),  # DiT self-attention, heads cut
    (2, 16, 13104, 3024, 128, 4.0),  # Perceiver, unbounded scores
    (1, 2, 1000, 1000, 64, 1.0),
    (1, 1, 1, 1, 64, 1.0),
    (2, 3, 17, 129, 128, 2.0),
    (1, 4, 65, 63, 64, 1.0),
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
])
def test_maxpass_kernel_matches_reference(gen, b, h, sq, skv, d, gain):
    q = _randn(gen, b, sq, h, d, gain=gain)
    k, v = _randn(gen, b, skv, h, d), _randn(gen, b, skv, h, d)
    before = flash_maxpass.launches
    out = flash_maxpass(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert flash_maxpass.launches == before + 1
    _check(out, q, k, v, d ** -0.5, flash_maxpass)


def test_maxpass_all_negative_rows(gen):
    """Every score far below zero: the exact row max keeps exp2 in range."""
    b, h, s, d = 1, 2, 500, 64
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
    tiles = -(-s // FLASH_KEY_TILE)
    keep = (tiles - tiles // 4) * FLASH_KEY_TILE
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
    tiles = -(-s // FLASH_KEY_TILE)
    keep = (tiles - tiles // 4) * FLASH_KEY_TILE
    tiles_skipped = kernel(q, k[:, :keep], v[:, :keep], d ** -0.5)
    assert not kernel_error(kernel, tiles_skipped, q, k, v, d ** -0.5)["ok"]
