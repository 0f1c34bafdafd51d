"""int8 x int8 -> int32 GEMMs with dequantizing epilogues: the hand-written
CUDA kernels on the card, their plain PyTorch versions on the CPU.

Counterpart of trajectorycrafter_tpu/ops/pallas/int8_matmul.py.  Scheme:
weights per output channel, symmetric int8 (quantized once, ops/int8.py);
activations per row (token), symmetric int8, quantized at each call; the
int32 product rescaled in fp32, plus the bias.  The fused feed-forward keeps
its (M, 4 x dim) intermediate in int8 with one scale per (row, group of
``FF_GROUP`` columns).

Dispatch, as ops/attention.py does it: ``impl="auto"`` launches the kernel
(ops/kernels.py) for CUDA tensors and takes the plain version for CPU
tensors; ``impl="reference"`` takes the plain version on any device, for
holding a kernel run against it.  There is no fallback.

Layouts: weights are (N, K), torch's Linear layout (the JAX package keeps
(K, N)); activation scales are (M,) and group scales (M, groups), not the
TPU kernels' lane-broadcast (M, 128) blocks.

The plain versions follow the JAX functions' operation order.  Their int32
product is exact: on the CPU ``torch.matmul`` of int32 tensors; on the card,
which has no integer matmul, a float64 matmul, exact because every product
and every partial sum is an integer below 2^53 (|acc| <= K * 127^2).  A
division by a Python number is written as a division by a 0-d tensor: on
CUDA, PyTorch turns ``t / 127.0`` into a multiply by the rounded reciprocal,
which is not the IEEE quotient the kernels and the JAX package take.
"""

from __future__ import annotations

from typing import Optional

import torch

from trajectorycrafter_tpu_torch.ops import kernels

# the fused FF's quantization group (the JAX package's block_n)
FF_GROUP = 1024
IMPLS = ("auto", "reference")


def fit_block(want: int, dim: int) -> int:
    """Largest power-of-two-ish block <= ``want`` that divides ``dim`` (the
    JAX package's ``_fit_block``): 1,024 at the DiT's FF width of 12,288,
    256 at the tiny CPU width."""
    if dim % want == 0:
        return want
    b = min(want, dim)
    while b > 128 and dim % b:
        b //= 2
    return b if dim % b == 0 else dim


def ieee_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d with an IEEE division on every device (see the module docstring)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact a (M, K) @ b (N, K)^T of int8 tensors, as fp32 rounded once from
    the exact integer (int32 on the CPU, float64 on the card)."""
    wide = torch.float64 if a.is_cuda else torch.int32
    return (a.to(wide) @ b.to(wide).T).float()


def quantize_groups(y: torch.Tensor, group: int):
    """(M, N) fp32 -> ((M, N) int8, (M, N / group) fp32): symmetric per
    (row, ``group`` columns), scale max(|y|, 1e-8) / 127, codes rounded half
    to even."""
    m, n = y.shape
    yg = y.reshape(m, n // group, group)
    scale = ieee_div(yg.abs().amax(dim=-1).clamp_min(1e-8), 127.0)
    q = torch.clamp(torch.round(yg / scale[..., None]), -127, 127).to(torch.int8)
    return q.reshape(m, n), scale


def quantize_rows_reference(x: torch.Tensor):
    """Per-row symmetric int8: (M, K) float -> ((M, K) int8, (M,) fp32)."""
    xq, xs = quantize_groups(x.float(), x.shape[1])
    return xq, xs[:, 0]


def row_scales(amax: torch.Tensor) -> torch.Tensor:
    """A row's activation scale from its max |x|: max(amax, 1e-8) / 127."""
    return ieee_div(amax.float().clamp_min(1e-8), 127.0)


def quantize_rows_scaled_reference(x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """(M, K) float, (M,) fp32 scales -> (M, K) int8: clip(round-half-even(x
    / xs[row]), -127, 127), an IEEE division (a tensor by a tensor)."""
    return torch.clamp(torch.round(x.float() / xs[:, None]), -127, 127).to(torch.int8)


def _epilogue(acc: torch.Tensor, xs: Optional[torch.Tensor], ws: torch.Tensor,
              bias: Optional[torch.Tensor]) -> torch.Tensor:
    """((acc * xs[:, None]) * ws[None, :]) + bias in fp32 (no xs: acc * ws + bias)."""
    y = (acc if xs is None else acc * xs[:, None]) * ws[None, :]
    return y if bias is None else y + bias.float()


def gelu_tanh(y: torch.Tensor) -> torch.Tensor:
    """diffusers' 'gelu-approximate' in the JAX kernel's operation order."""
    c = 0.7978845608028654  # sqrt(2 / pi)
    return 0.5 * y * (1.0 + torch.tanh(c * (y + 0.044715 * y * y * y)))


def int8_matmul_reference(xq, wq, xs, ws, bias=None, out_dtype=torch.bfloat16):
    """(xq @ wq^T) * xs[:, None] * ws[None, :] + bias -> (M, N) out_dtype."""
    return _epilogue(int_matmul(xq, wq), xs, ws, bias).to(out_dtype)


def int8_matmul_gelu_quant_reference(xq, wq, xs, ws, bias=None, group: int = FF_GROUP):
    """gelu_tanh((xq @ wq^T) * xs * ws + bias), quantized per (row, ``group``
    columns) -> ((M, N) int8, (M, N / group) fp32)."""
    return quantize_groups(gelu_tanh(_epilogue(int_matmul(xq, wq), xs, ws, bias)), group)


def int8_matmul_gscale_reference(hq, wq, hs, ws, bias=None, group: int = FF_GROUP,
                                 out_dtype=torch.bfloat16):
    """Each K group's exact product times its row scale hs[:, j], summed in
    fp32 over the groups in order, then * ws + bias -> (M, N) out_dtype."""
    acc = torch.zeros((hq.shape[0], wq.shape[0]), dtype=torch.float32, device=hq.device)
    for j in range(hq.shape[1] // group):
        cols = slice(j * group, (j + 1) * group)
        acc = acc + int_matmul(hq[:, cols], wq[:, cols]) * hs[:, j:j + 1]
    return _epilogue(acc, None, ws, bias).to(out_dtype)


# Tolerance of an int8 kernel against its plain version on the same inputs:
#
# - the GEMMs with a bf16 output (int8_gemm, int8_gemm_gscale): per element,
#   |out - ref| <= GEMM_ULPS bf16 ulps of ref.  Both sides take the exact
#   int32 product and the same fp32 operations in the same order, so they
#   agree bit for bit unless the compiler reorders an fp32 operation; one
#   ulp of the bf16 output is the most such a reordering can move it.  A
#   K step of 32 skipped, a bias dropped or the column scales shifted by one
#   moves most elements by many ulps.
# - the gelu-quant GEMM: scales within SCALE_REL_TOL relative (a scale is a
#   row group's max |y| / 127, and one fp32 ulp of y is 2^-23 relative);
#   codes off by at most 1, on at most CODE_FLIP_SHARE of the elements: a
#   code flips only where y / scale lands within an fp32 rounding of a .5
#   boundary, if the two tanh implementations differ by an ulp there.  A
#   group of 512 columns in place of 1,024 moves the codes of a half group
#   whose max is smaller by far more than 1; dropping the gelu moves every
#   negative value's code.
GEMM_ULPS = 1.0
SCALE_REL_TOL = 1e-6
CODE_FLIP_SHARE = 1e-3


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (8 significant bits), in fp32; the
    smallest subnormal's at 0."""
    _, exponent = torch.frexp(x.float())
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float32), exponent - 8)
    return torch.where(x == 0, torch.full_like(ulp, 2.0 ** -133), ulp)


def gemm_error(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """Hold a bf16 GEMM output against its plain version: ``max_ulps`` is
    the largest error in bf16 ulps of ``ref`` (at most GEMM_ULPS passes)."""
    ref = ref.float()
    err = (out.float() - ref).abs()
    ulps = (err / bf16_ulp(ref)).max().item() if err.numel() else 0.0
    finite = bool(torch.isfinite(out).all())
    return {"max_abs_err": err.max().item(), "max_ulps": ulps,
            "ok": finite and out.shape == ref.shape and ulps <= GEMM_ULPS}


def gelu_quant_error(hq: torch.Tensor, hs: torch.Tensor, hq_ref: torch.Tensor,
                     hs_ref: torch.Tensor) -> dict:
    """Hold the gelu-quant GEMM's (codes, scales) against its plain version,
    within the tolerance above."""
    if hq.shape != hq_ref.shape or hs.shape != hs_ref.shape:
        return {"max_abs_err": float("inf"), "max_code_diff": float("inf"),
                "code_flip_share": 1.0, "max_scale_rel_err": float("inf"), "ok": False}
    diff = (hq.int() - hq_ref.int()).abs()
    share = (diff != 0).float().mean().item()
    scale_rel = ((hs - hs_ref).abs() / hs_ref.abs()).max().item()
    max_diff = diff.max().item()
    del diff
    group = hq.shape[1] // hs.shape[1]
    abs_err = (hq.float() * hs.repeat_interleave(group, dim=1)
               - hq_ref.float() * hs_ref.repeat_interleave(group, dim=1)).abs().max().item()
    return {"max_abs_err": abs_err, "max_code_diff": max_diff, "code_flip_share": share,
            "max_scale_rel_err": scale_rel,
            "ok": bool(torch.isfinite(hs).all()) and max_diff <= 1
            and share <= CODE_FLIP_SHARE and scale_rel <= SCALE_REL_TOL}


def _kernel_for(x: torch.Tensor, impl: str) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"unknown int8 impl {impl!r} (expected one of {IMPLS})")
    return impl == "auto" and x.is_cuda


def quantize_rows(x: torch.Tensor, impl: str = "auto"):
    """(M, K) -> ((M, K) int8, (M,) fp32), on csrc/int8_quantize_rows.cu for
    a CUDA tensor."""
    if _kernel_for(x, impl):
        return kernels.int8_quantize_rows(x)
    return quantize_rows_reference(x)


def quantize_rows_scaled(x: torch.Tensor, xs: torch.Tensor, impl: str = "auto"):
    """(M, K) with given row scales (M,) -> (M, K) int8, on the scale-taking
    entry of csrc/int8_quantize_rows.cu for a CUDA tensor: the row-parallel
    layer's quantization of its columns with the scale of the whole row."""
    if _kernel_for(x, impl):
        return kernels.int8_quantize_rows_scaled(x, xs)
    return quantize_rows_scaled_reference(x, xs)


def int8_matmul(xq, wq, xs, ws, bias=None, out_dtype=torch.bfloat16, impl: str = "auto"):
    """(M, N) = (xq @ wq^T) * xs * ws + bias, on csrc/int8_gemm.cu (bf16 out)
    for CUDA tensors."""
    if _kernel_for(xq, impl):
        if out_dtype != torch.bfloat16:
            raise ValueError(f"the int8 GEMM kernel writes bf16, not {out_dtype}")
        return kernels.int8_gemm(xq, wq, xs, ws, bias)
    return int8_matmul_reference(xq, wq, xs, ws, bias, out_dtype)


def int8_matmul_gelu_quant(xq, wq, xs, ws, bias=None, group: int = FF_GROUP,
                           impl: str = "auto"):
    """The fused FF's first GEMM, on csrc/int8_gemm_gelu_quant.cu for CUDA
    tensors."""
    if _kernel_for(xq, impl):
        return kernels.int8_gemm_gelu_quant(xq, wq, xs, ws, bias, group)
    return int8_matmul_gelu_quant_reference(xq, wq, xs, ws, bias, group)


def int8_matmul_gscale(hq, wq, hs, ws, bias=None, group: int = FF_GROUP,
                       out_dtype=torch.bfloat16, impl: str = "auto"):
    """The fused FF's second GEMM, on csrc/int8_gemm_gscale.cu (bf16 out) for
    CUDA tensors."""
    if _kernel_for(hq, impl):
        if out_dtype != torch.bfloat16:
            raise ValueError(f"the int8 GEMM kernel writes bf16, not {out_dtype}")
        return kernels.int8_gemm_gscale(hq, wq, hs, ws, bias, group)
    return int8_matmul_gscale_reference(hq, wq, hs, ws, bias, group, out_dtype)


def int8_dense_apply(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, out_dtype=None,
                     impl: str = "auto") -> torch.Tensor:
    """An int8 linear layer on (..., K) activations: per-row quantization,
    then the int8 GEMM; out_dtype defaults to x's."""
    lead, k = x.shape[:-1], x.shape[-1]
    xq, xs = quantize_rows(x.reshape(-1, k).contiguous(), impl)
    out = int8_matmul(xq, wq, xs, ws, bias, out_dtype or x.dtype, impl)
    return out.reshape(*lead, wq.shape[0])


def int8_ff_apply(x: torch.Tensor, wq1, ws1, bias1, wq2, ws2, bias2, out_dtype=None,
                  group: int = FF_GROUP, impl: str = "auto") -> torch.Tensor:
    """The fused int8 feed-forward: GEMM1 with bias, tanh-gelu and the group
    re-quantization in its epilogue, then GEMM2 dequantizing per K group.
    The (M, 4 x dim) intermediate stays int8 throughout."""
    lead, k = x.shape[:-1], x.shape[-1]
    group = fit_block(group, wq1.shape[0])
    xq, xs = quantize_rows(x.reshape(-1, k).contiguous(), impl)
    hq, hs = int8_matmul_gelu_quant(xq, wq1, xs, ws1, bias1, group, impl)
    out = int8_matmul_gscale(hq, wq2, hs, ws2, bias2, group, out_dtype or x.dtype, impl)
    return out.reshape(*lead, wq2.shape[0])
