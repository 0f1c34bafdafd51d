"""int8 linear layers for the DiT's and the depth UNet's transformer GEMMs.

Counterpart of trajectorycrafter_tpu/ops/int8.py.  Scheme: weights per
output channel, symmetric int8, quantized once from the bf16 (or fp32)
weight; activations per row (token), symmetric int8, quantized at every call;
the int32 product rescaled in fp32, plus the bias.  On the card every int8
GEMM runs in the hand-written kernels of ops/int8_matmul.py; the JAX
package's ``int8_dense_forward`` is ``int8_matmul.int8_dense_apply``, whose
``impl="reference"`` is its plain version on any device.

``quantize_dit_`` and ``quantize_depth_unet_`` swap ``nn.Linear`` for
``Int8Linear`` in place on exactly the layers that the JAX package's
``quantize_dit_params`` and ``quantize_depth_unet_params`` convert, so a
model quantized here holds what ``utils/weights.py`` loads from the JAX
package's int8 tree, bit for bit.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import torch
from torch import nn

from trajectorycrafter_tpu_torch.ops.int8_matmul import (
    ieee_div,
    int8_dense_apply,
    int8_matmul,
    quantize_rows_scaled,
    row_scales,
)
from trajectorycrafter_tpu_torch.parallel import distributed as D
from trajectorycrafter_tpu_torch.utils.timing import span


@torch.no_grad()
def quantize_dense(weight: torch.Tensor):
    """(N, K) weight -> ((N, K) int8, (N,) fp32 scale), per output channel:
    scale = max(max |w| over K, 1e-12) / 127, codes clip(round(w / scale),
    -127, 127), in fp32 (``quantize_dense_params``)."""
    w = weight.float()
    scale = ieee_div(w.abs().amax(dim=1).clamp_min(1e-12), 127.0)
    weight_q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return weight_q, scale


class Int8Linear(nn.Module):
    """A linear layer with int8 weights and per-row int8 activations.

    Buffers ``weight_q`` (out, in) int8 -- torch's Linear layout, whose
    K-contiguous rows are the column-major B operand of the kernels' int8
    ``mma`` -- and ``weight_scale`` (out,) fp32, with ``weight ~= weight_q *
    weight_scale[:, None]``; ``bias`` as ``nn.Linear``'s.  ``int8_impl``:
    ``"auto"`` launches the kernels for CUDA tensors, ``"reference"`` takes
    the plain version.

    ``weight_scale`` stays fp32 when the module is cast: ``module.to(
    torch.bfloat16)`` casts every floating buffer, and the JAX package keeps
    its scales in fp32 and casts only the bias.
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.int8_impl = "auto"
        self.register_buffer("weight_q", torch.zeros((out_features, in_features),
                                                     dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.ones(out_features, dtype=torch.float32,
                                                        device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device), requires_grad=False)
                     if bias else None)

    @classmethod
    def from_linear(cls, linear: nn.Linear) -> "Int8Linear":
        """Quantize ``linear``'s weight; the bias is ``linear``'s own."""
        weight = linear.weight
        module = cls(linear.in_features, linear.out_features, bias=False, device=weight.device)
        module.weight_q, module.weight_scale = quantize_dense(weight)
        module.bias = linear.bias
        return module

    def _apply(self, fn, recurse=True):
        scale = self.weight_scale
        super()._apply(fn, recurse)
        moved = self.weight_scale
        if moved.dtype != torch.float32:
            self.weight_scale = (torch.empty_like(moved, dtype=torch.float32) if scale.is_meta
                                 else scale.to(device=moved.device, dtype=torch.float32))
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("linear", x):
            return int8_dense_apply(x, self.weight_q, self.weight_scale, self.bias,
                                    impl=self.int8_impl)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"bias={self.bias is not None}")


class Int8RowParallelLinear(Int8Linear):
    """A row-parallel ``Int8Linear`` (parallel/sharding.py): this rank holds
    the input columns of ``weight_q`` and the whole ``weight_scale`` and
    bias.  The activation scale stays the JAX package's, max |x| over all
    input features of the row (ops/int8.py:56 there, which XLA keeps under
    the mesh): the local row maxima are reduced by max over tp, and the
    local columns are quantized with that scale (K2a's scale-taking entry),
    so every code is the unsharded layer's.  Then the int8 GEMM of the
    local columns (K2b, no bias), its partials summed over tp in fp32, and
    the bias added once."""

    def __init__(self, in_features: int, out_features: int, bias: bool, axis: D.Axis,
                 device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.tp_axis = axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("linear", x):
            lead, k = x.shape[:-1], x.shape[-1]
            x2 = x.reshape(-1, k).contiguous()
            amax = D.all_reduce(x2.abs().amax(dim=1).float(), self.tp_axis, op="max")
            xs = row_scales(amax)
            xq = quantize_rows_scaled(x2, xs, self.int8_impl)
            partial = int8_matmul(xq, self.weight_q, xs, self.weight_scale, None, x.dtype,
                                  self.int8_impl)
            return D.sum_partials(partial, self.tp_axis, self.bias).reshape(
                *lead, self.out_features)


def _quantize_paths_(root: nn.Module, paths) -> None:
    """Swap each ``nn.Linear`` at a dotted path under ``root`` for its
    ``Int8Linear``."""
    for path in paths:
        parent_path, _, name = path.rpartition(".")
        parent = root.get_submodule(parent_path) if parent_path else root
        linear = getattr(parent, name)
        if not isinstance(linear, nn.Linear):
            raise TypeError(f"{path} is {type(linear).__name__}, not nn.Linear")
        setattr(parent, name, Int8Linear.from_linear(linear))


# The DiT's int8 layers (``DIT_INT8_TARGETS`` inside ``blocks_*`` and
# ``perceiver_cross_attention_*``): the blocks' attention projections and
# feed-forward, the Perceivers' projections.  The AdaLN modulation, patch,
# time and output layers stay bf16.
DIT_BLOCK_INT8 = ("attn1.to_q", "attn1.to_k", "attn1.to_v", "attn1.to_out.0",
                  "ff.net.0.proj", "ff.net.2")
DIT_PERCEIVER_INT8 = ("to_q", "to_kv", "to_out")
# The depth UNet's (every TransformerSpatioTemporal): proj_in / proj_out, and
# in its spatial and temporal blocks the self-attention q/k/v/out, the
# cross-attention q/out (k/v read the one-token CLIP context: nothing to win)
# and the GEGLU feed-forwards.  Resnet convolutions and the frame embedding
# stay bf16.
_DEPTH_BLOCK_INT8 = ("attn1.to_q", "attn1.to_k", "attn1.to_v", "attn1.to_out.0",
                     "attn2.to_q", "attn2.to_out.0", "ff.net.0.proj", "ff.net.2")
DEPTH_TRANSFORMER_INT8 = (
    "proj_in", "proj_out",
    *(f"transformer_blocks.0.{p}" for p in _DEPTH_BLOCK_INT8),
    *(f"temporal_transformer_blocks.0.{p}"
      for p in (*_DEPTH_BLOCK_INT8, "ff_in.net.0.proj", "ff_in.net.2")),
)


def quantize_dit_unit_(unit: nn.Module, fuse: Optional[bool] = None) -> nn.Module:
    """Quantize one DiT block (its FeedForward gets ``fuse``) or Perceiver
    in place."""
    if hasattr(unit, "ff"):
        _quantize_paths_(unit, DIT_BLOCK_INT8)
        unit.ff.fuse = fuse
    else:
        _quantize_paths_(unit, DIT_PERCEIVER_INT8)
    return unit


def quantize_dit_(model: nn.Module, fuse: Optional[bool] = None) -> nn.Module:
    """Quantize a CrossTransformer3DModel in place (``quant="int8"``); each
    block's FeedForward gets ``fuse`` (None or False: two int8 linears with a
    tanh-gelu between; True: the fused int8 chain)."""
    for unit in (*model.transformer_blocks, *(model.perceiver_cross_attention or ())):
        quantize_dit_unit_(unit, fuse)
    return model


def quantize_depth_unet_(unet: nn.Module) -> nn.Module:
    """Quantize a UNetSpatioTemporalConditionModel in place (``quant="int8"``)."""
    for module in list(unet.modules()):
        if hasattr(module, "temporal_transformer_blocks"):  # a TransformerSpatioTemporal
            _quantize_paths_(module, DEPTH_TRANSFORMER_INT8)
    return unet


def quantized_twin(model: nn.Module, quantize_: Callable[[nn.Module], nn.Module]) -> nn.Module:
    """An int8 twin of ``model``: a copy of its module tree that shares every
    parameter and buffer with it, quantized by ``quantize_``.  Only the int8
    weights are new memory; ``model`` itself is unchanged."""
    memo = {id(t): t for t in (*model.parameters(), *model.buffers())}
    return quantize_(copy.deepcopy(model, memo))


def int8_linears(model: nn.Module) -> int:
    """The number of ``Int8Linear`` layers in ``model``."""
    return sum(isinstance(m, Int8Linear) for m in model.modules())
