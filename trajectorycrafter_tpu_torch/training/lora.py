"""LoRA adapters for the CrossTransformer3D DiT.

Counterpart of trajectorycrafter_tpu/training/lora.py (the reference's
``create_network`` LoRA stack, rank 8 / alpha 8 on the attention and
feed-forward dense layers): trainable (A, B) factors over the frozen base
weights, merged at apply time, W + (alpha / r) B A cast to W's dtype, as the
JAX ``apply_lora`` merges (and rounds) them.

The adapters are a flat dict of fp32 tensors, ``{"<module>.lora_A": (r,
in), "<module>.lora_B": (out, r)}`` under the port's module names, which
``utils/weights.py lora_from_jax`` / ``lora_to_jax`` map to and from JAX's
``{"blocks_3/attn1/to_q/kernel": {"a": (in, r), "b": (r, out)}}`` (the
torch weight is the transpose of the JAX kernel, so B A is (a b)^T).

``apply_lora`` attaches the merge to each target layer as a
parametrization (``torch.nn.utils.parametrize``): the layer's ``weight``
is the merged weight each time it is read.  A functional merge
(``torch.func.functional_call``) would not do: under the DiT's ``remat`` a
block is recomputed in the backward pass, after such a call has put the
base weights back, and it would be recomputed, and differentiated, with
the base weights.

On a tensor-parallel model (training under ``--mesh_tp``, parallel/
sharding.py ``shard_units_``) the adapters stay whole on every rank, as the
JAX package replicates them: ``init_lora_params`` draws them at the
unsharded layers' shapes, so the draws are the single-card run's, and the
checkpoints are unchanged.  A sharded layer's merge adds only this rank's
slice of (alpha / r) B A, by the layer's rule: its rows of B (column-
parallel; the Perceiver's packed ``to_kv``: its rows of each of the k and
v halves) or its columns of A (row-parallel).
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn
from torch.nn.utils import parametrize

from trajectorycrafter_tpu_torch.parallel.sharding import shard_tensor
from trajectorycrafter_tpu_torch.utils.weights import dit_dense_path

DEFAULT_TARGET_SUFFIXES = (
    "to_q", "to_k", "to_v", "to_out", "to_kv", "proj_in", "proj_out",
)

LoRA = Dict[str, torch.Tensor]


def _jax_path(name: str):
    try:
        return dit_dense_path(name)
    except KeyError:
        return None


def lora_target_paths(model: nn.Module, target_suffixes=DEFAULT_TARGET_SUFFIXES,
                      skip_substrings=()) -> List[str]:
    """The port's names of the layers eligible for LoRA, sorted: JAX's rule
    (a 2-D Dense kernel under a module whose own name is in
    ``target_suffixes``, its path free of ``skip_substrings``) applied to
    each ``nn.Linear`` through its JAX path.  At full width: 316 layers."""
    out = []
    for name, module in model.named_modules():
        # a parametrized layer's class is a subclass of nn.Linear
        path = _jax_path(name) if isinstance(module, nn.Linear) else None
        if (path is not None and path.split("/")[-1] in target_suffixes
                and not any(s in path + "/kernel" for s in skip_substrings)):
            out.append(name)
    return sorted(out)


def _base(module: nn.Module) -> torch.Tensor:
    """A layer's own weight, under a LoRA parametrization or not."""
    if parametrize.is_parametrized(module, "weight"):
        return module.parametrizations.weight.original
    return module.weight


def _whole_shape(module: nn.Module) -> tuple:
    """(out, in) of a layer's unsharded weight."""
    d_out, d_in = _base(module).shape
    axis = getattr(module, "tp_axis", None)
    if axis is not None:
        if module.tp_rule == "row":
            d_in *= axis.size
        else:
            d_out *= axis.size
    return d_out, d_in


def init_lora_params(generator: torch.Generator, model: nn.Module, rank: int = 8,
                     target_suffixes=DEFAULT_TARGET_SUFFIXES, skip_substrings=()) -> LoRA:
    """-> {"<module>.lora_A": (r, in), "<module>.lora_B": (out, r)}, fp32 on
    the model's device, at the unsharded layers' shapes: A ~ N(0, 1) / r
    (divided by r, as the JAX init does), B = 0, so the adapters start as the
    identity.  The layers draw their A in sorted order from ``generator``
    (on the model's device)."""
    lora: LoRA = {}
    for name in lora_target_paths(model, target_suffixes, skip_substrings):
        module = model.get_submodule(name)
        weight = _base(module)
        d_out, d_in = _whole_shape(module)
        a = torch.randn((rank, d_in), generator=generator, device=weight.device) / rank
        lora[name + ".lora_A"] = a.requires_grad_()
        lora[name + ".lora_B"] = torch.zeros((d_out, rank), device=weight.device,
                                             requires_grad=True)
    return lora


class _Merge(nn.Module):
    """W -> W + (scaling (B A)) cast to W's dtype, with the factors read from
    the adapters dict each time (the optimizer updates them in place); on a
    layer sharded over tp (``axis``), the slice of B A its ``rule`` keeps."""

    def __init__(self, lora: LoRA, name: str, scaling: float, rule=None, axis=None):
        super().__init__()
        self.lora, self.name, self.scaling = lora, name, scaling
        self.rule, self.axis = rule, axis

    def forward(self, weight: torch.Tensor) -> torch.Tensor:
        a, b = self.lora[self.name + ".lora_A"], self.lora[self.name + ".lora_B"]
        if self.axis is not None:
            tp, r = self.axis.size, self.axis.index
            if self.rule == "row":
                a = shard_tensor("row", "weight", a, tp, r)
            else:
                b = shard_tensor(self.rule, "weight", b, tp, r)
        return weight + (torch.matmul(b, a) * self.scaling).to(weight.dtype)


def remove_lora(model: nn.Module) -> nn.Module:
    """Detach every adapter ``apply_lora`` attached: the base model again."""
    for module in model.modules():
        if parametrize.is_parametrized(module, "weight"):
            parametrize.remove_parametrizations(module, "weight", leave_parametrized=False)
    return model


def apply_lora(model: nn.Module, lora: LoRA, alpha: float = 8.0, rank: int = 8) -> nn.Module:
    """Attach ``lora`` to ``model`` (replacing adapters attached before): each
    adapted layer's ``weight`` then reads W + (alpha / rank) B A in W's dtype.
    ``lora=None`` or an empty dict leaves the base model.  Returns ``model``."""
    remove_lora(model)
    scaling = alpha / rank
    for name in sorted({key.rpartition(".")[0] for key in lora or {}}):
        module = model.get_submodule(name)
        merge = _Merge(lora, name, scaling, getattr(module, "tp_rule", None),
                       getattr(module, "tp_axis", None))
        parametrize.register_parametrization(module, "weight", merge, unsafe=True)
    return model

