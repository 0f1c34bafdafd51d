"""The DiT's tensor-parallel layout and its token shards.

Counterpart of trajectorycrafter_tpu/parallel/sharding.py
(``_spec_for_path``, ``dit_param_sharding``) and of the JAX DiT's
``shard_activations`` constraints.  Tensor-parallel rank r of T holds, of
the port's state dict (torch's (out, in) layout):

  * column-parallel layers (``to_q``, ``to_k``, ``to_v``, ``to_kv``,
    ``proj_in``, in the blocks and the Perceivers): output rows
    [r N/T, (r+1) N/T) of the weight, of an int8 weight's ``weight_scale``
    and of the bias.  The Perceiver's ``to_kv`` packs [k; v]: rank r takes
    its heads of each half, so that its k and v stay local.
  * row-parallel layers (``to_out``, ``proj_out`` -- the feed-forward's
    second layer -- in the blocks and the Perceivers): input columns
    [r K/T, (r+1) K/T) of the weight; ``weight_scale`` and the bias whole.
    The layer sums the ranks' partial products (``RowParallelLinear``,
    ops/int8.py ``Int8RowParallelLinear``) and adds the bias once after.
  * everything else whole: norms, embeddings, modulation, the output
    projection.

Every sharded layer keeps its rule and axis (``tp_rule``, ``tp_axis``;
training/lora.py merges its adapters' slice by them), and each attention
and feed-forward keeps the axis its column-parallel layers' input is
reduced over in the backward pass (``distributed.tp_input``: once for q, k
and v, which read one tensor); the row-parallel output is
``distributed.tp_output``.  Under ``torch.no_grad`` both are the plain
collectives of the inference path.

JAX keeps every 1-D tensor replicated and its ``to_kv`` split as one
contiguous range of columns; both are storage layouts that XLA re-lays for
the computation, where the port slices what each rank computes with.

Tokens (``JointShard``): the joint [text; video] sequence of each block is
split over sp as JAX's ``shard_map`` splits it, in contiguous shards of
ceil(S / sp) tokens (the last one shorter), so the text tokens sit on the
first rank(s), once; the batch (the CFG pair) is split over dp.  Training
takes the same shards (the model's forward with ``sp``), with the split and
the output's gather differentiable.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from trajectorycrafter_tpu_torch.ops.int8 import Int8Linear, Int8RowParallelLinear
from trajectorycrafter_tpu_torch.ops.linear import Linear
from trajectorycrafter_tpu_torch.parallel import distributed as D
from trajectorycrafter_tpu_torch.utils.timing import span

COL_PARALLEL = ("to_q", "to_k", "to_v", "to_kv", "proj_in")
ROW_PARALLEL = ("to_out", "proj_out")
# the layers the rules reach, by their port module path inside a block or a
# Perceiver, with the JAX parameter name each maps to
BLOCK_LAYERS = {"attn1.to_q": "to_q", "attn1.to_k": "to_k", "attn1.to_v": "to_v",
                "attn1.to_out.0": "to_out", "ff.net.0.proj": "proj_in", "ff.net.2": "proj_out"}
PERCEIVER_LAYERS = {"to_q": "to_q", "to_kv": "to_kv", "to_out": "to_out"}
_KEY = re.compile(r"^(transformer_blocks|perceiver_cross_attention)\.\d+\.(.+)\."
                  r"(weight|bias|weight_q|weight_scale)$")


def layer_rule(key: str) -> Optional[str]:
    """The rule of a DiT state-dict key: "col", "kv" (the Perceiver's packed
    to_kv), "row", or None (whole)."""
    m = _KEY.match(key)
    if m is None:
        return None
    layers = BLOCK_LAYERS if m.group(1) == "transformer_blocks" else PERCEIVER_LAYERS
    jax_name = layers.get(m.group(2))
    if jax_name == "to_kv":
        return "kv"
    if jax_name in COL_PARALLEL:
        return "col"
    if jax_name in ROW_PARALLEL:
        return "row"
    return None


def _chunk(x: torch.Tensor, tp: int, r: int, dim: int) -> torch.Tensor:
    """Part ``r`` of ``tp`` along ``dim``, in storage of its own: a view (a
    leading dimension's chunk is one) would keep the whole tensor alive."""
    if x.shape[dim] % tp:
        raise ValueError(f"a dimension of {x.shape[dim]} does not split over tp={tp}")
    return x.chunk(tp, dim=dim)[r].clone(memory_format=torch.contiguous_format)


def shard_tensor(rule: Optional[str], param: str, x: torch.Tensor, tp: int,
                 r: int) -> torch.Tensor:
    """Tensor-parallel rank ``r``'s part of tensor ``param`` (weight, bias,
    weight_q, weight_scale) of a layer under ``rule``."""
    if rule is None or tp == 1:
        return x
    if rule == "row":
        return _chunk(x, tp, r, 1) if x.dim() == 2 else x
    if rule == "kv":
        k, v = x.chunk(2, dim=0)
        return torch.cat([_chunk(k, tp, r, 0), _chunk(v, tp, r, 0)])
    return _chunk(x, tp, r, 0)


def shard_entry(key: str, x: torch.Tensor, tp: int, r: int) -> torch.Tensor:
    """Rank ``r``'s part of the DiT state-dict entry ``key``."""
    return shard_tensor(layer_rule(key), key.rsplit(".", 1)[1], x, tp, r)


def shard_state_dict(sd: Dict[str, torch.Tensor], tp: int, r: int) -> Dict[str, torch.Tensor]:
    """Rank ``r``'s shard of a DiT state dict (bf16 or int8)."""
    return {key: shard_entry(key, x, tp, r) for key, x in sd.items()}


class RowParallelLinear(Linear):
    """A row-parallel linear layer: this rank's input columns of the weight;
    the partial products of the tp ranks are summed in fp32 and the bias
    added once after."""

    def __init__(self, in_features: int, out_features: int, bias: bool, axis: D.Axis,
                 device=None, dtype=None):
        super().__init__(in_features, out_features, bias=bias, device=device, dtype=dtype)
        self.tp_axis = axis

    def forward(self, x):
        with span("linear", x):
            return D.tp_output(F.linear(x, self.weight), self.tp_axis, self.bias)


def _param(x: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(x, requires_grad=False)


def shard_linear(layer: nn.Module, rule: str, axis: D.Axis) -> nn.Module:
    """A new layer holding tp rank ``axis.index``'s part of ``layer``
    (``nn.Linear`` or ``Int8Linear``); row-parallel layers reduce over
    ``axis``."""
    tp, r = axis.size, axis.index
    cut = lambda name, x: shard_tensor(rule, name, x, tp, r)
    bias = layer.bias is not None
    if isinstance(layer, Int8Linear):
        weight_q = cut("weight_q", layer.weight_q)
        n, k = weight_q.shape
        new = (Int8RowParallelLinear(k, n, bias, axis, device=weight_q.device) if rule == "row"
               else Int8Linear(k, n, bias=bias, device=weight_q.device))
        new.weight_q, new.weight_scale = weight_q, cut("weight_scale", layer.weight_scale)
        new.int8_impl = layer.int8_impl
    else:
        weight = cut("weight", layer.weight)
        n, k = weight.shape
        kw = dict(device=weight.device, dtype=weight.dtype)
        new = (RowParallelLinear(k, n, bias, axis, **kw) if rule == "row"
               else Linear(k, n, bias=bias, **kw))
        new.weight = _param(weight)
    if bias:
        new.bias = _param(cut("bias", layer.bias.detach()))
    new.tp_rule, new.tp_axis = rule, axis
    return new


def shard_unit_(unit: nn.Module, axis: D.Axis) -> nn.Module:
    """Shard a DiT block or Perceiver in place over tp ``axis``: its
    layers by the rules above, its head count divided, the axis of its
    column-parallel layers' input set."""
    if axis.size == 1:
        return unit
    is_block = hasattr(unit, "attn1")
    layers = BLOCK_LAYERS if is_block else PERCEIVER_LAYERS
    attn = unit.attn1 if is_block else unit
    if attn.heads % axis.size:
        raise ValueError(f"{attn.heads} heads do not split over tp={axis.size}")
    for path in layers:
        parent_path, _, name = path.rpartition(".")
        parent = unit.get_submodule(parent_path) if parent_path else unit
        key = ("transformer_blocks.0." if is_block else "perceiver_cross_attention.0.") + path
        setattr(parent, name, shard_linear(getattr(parent, name), layer_rule(key + ".weight"),
                                           axis))
    attn.heads //= axis.size
    attn.tp_axis = axis
    if is_block:
        unit.ff.tp_axis = axis
    return unit


def shard_units_(model: nn.Module, axis: D.Axis) -> nn.Module:
    """Shard every block and Perceiver of a CrossTransformer3DModel in place
    over tp ``axis`` (training: the model's forward stays unsharded over the
    batch and the tokens, and the step shards the batch)."""
    for unit in (*model.transformer_blocks, *(model.perceiver_cross_attention or ())):
        shard_unit_(unit, axis)
    return model


def shard_dit_(model: nn.Module, mesh, units_done: bool = False) -> nn.Module:
    """Shard a CrossTransformer3DModel in place over ``mesh``: every block
    and Perceiver over tp (unless ``units_done``: built shard by shard),
    the joint self-attention on the ring when sp > 1 (the Perceivers keep
    their route: their keys are the short, whole reference tokens), and the
    model's forward over dp and sp."""
    if getattr(model, "mesh", None) is mesh:
        return model
    if not units_done:
        shard_units_(model, mesh.tp)
    if mesh.sp.size > 1:
        for block in model.transformer_blocks:
            block.attn1.attention_impl = "ring"
    model.mesh = mesh
    return model


def shard_sizes(n: int, parts: int) -> list:
    """The lengths of ``parts`` contiguous shards of ``n`` items of
    ceil(n / parts) each, the last ones shorter (as shard_map splits a
    sequence padded to a multiple of ``parts``)."""
    c = -(-n // parts)
    return [max(0, min(c, n - j * c)) for j in range(parts)]


class JointShard:
    """This rank's shard of the joint [text; video] token sequence over the
    sp axis: ``text`` and ``video`` are its slices of each stream, ``sizes``
    every rank's token count (the ring's visiting shards)."""

    def __init__(self, axis: D.Axis, text_len: int, video_len: int):
        self.axis = axis
        self.sizes = shard_sizes(text_len + video_len, axis.size)
        lo = sum(self.sizes[:axis.index])
        hi = lo + self.sizes[axis.index]
        self.text = slice(min(lo, text_len), min(hi, text_len))
        self.video = slice(max(lo, text_len) - text_len, max(hi, text_len) - text_len)
        starts = [sum(self.sizes[:j]) for j in range(axis.size)]
        self.video_sizes = [max(0, lo_j + n - max(lo_j, text_len))
                            for lo_j, n in zip(starts, self.sizes)]
        if min(self.video_sizes) == 0:
            raise ValueError(f"{video_len} video tokens after {text_len} text tokens leave an "
                             f"sp rank of {axis.size} without video tokens")

    def split(self, text: torch.Tensor, video: torch.Tensor) -> tuple:
        """This rank's (text, video) tokens of the whole streams (B, S, C).
        With grad enabled the backward pass puts the shard's gradient into
        zeros of the whole stream, with no sum over sp: the whole gradient
        of a stream is the sum of the ranks' pieces, but what lies upstream
        (the patch, text and time embeddings) is frozen in LoRA training,
        so nothing reads it."""
        return text[:, self.text], video[:, self.video]

    def gather_video(self, x: torch.Tensor) -> torch.Tensor:
        """(B, local video tokens, C) -> (B, all video tokens, C) on every
        rank; with grad enabled its backward takes this rank's slice of the
        gradient (``distributed.gather_tokens``)."""
        return D.gather_tokens(x, self.axis, 1, self.video_sizes)


def batch_shard(x: Optional[torch.Tensor], axis: D.Axis) -> Optional[torch.Tensor]:
    """This dp rank's rows of a batch-leading tensor."""
    if x is None or axis.size == 1:
        return x
    return _chunk(x, axis.size, axis.index, 0)
