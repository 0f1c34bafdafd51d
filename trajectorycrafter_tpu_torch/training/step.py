"""Diffusion training step (LoRA fine-tuning of the DiT).

Counterpart of trajectorycrafter_tpu/training/step.py, on torch autograd and
``torch.optim`` in place of ``jax.grad`` and optax.  The same objective
(the reference latent-space training semantics,
notebooks/05_11_25_training/lora_utils_ours/training_loop.py:90-309):
  * conditioning dropout with probability p, one keep-mask per sample for
    each of text, reference and inpaint latents; dropped conditions become
    zeros; p = 0 draws nothing;
  * uniform timesteps, q(x_t | x_0) noising, an epsilon or v target;
  * MSE plus the optional 0.1 x temporal-difference "motion" term;
  * AdamW over the adapters after clipping by global norm; with
    ``grad_accum_steps`` k, the mean of k micro-gradients, clipped, then one
    update (optax.MultiSteps).

The batch's latents are cast to the model's dtype and its prediction to
fp32, as in JAX.  ``timesteps`` and ``noise`` come from the batch when it
holds them, else from the step's ``torch.Generator``: torch cannot replay a
JAX key, so the parity tests supply them.  The port updates the adapters in
place.

Under a mesh (``make_train_step(..., mesh)``: dp x sp x tp, the model's
blocks and Perceivers over tp, parallel/sharding.py ``shard_units_``) every
rank holds the whole adapters and the global batch, draws the global
batch's timesteps, noise and dropout masks from the same generator, and
runs its dp rows (JAX shards the batch on dp).  With sp > 1 the model's
forward keeps the rank's shard of the joint token stream (JAX's
``shard_activations``; models/dit.py with ``sp``) and gathers the output
over sp before the loss, so every sp rank computes the same loss on the
whole prediction (the motion term's frame differences cross the shards).
Before clipping and AdamW the adapter gradients are reduced
(``reduce_lora_grads``): summed over sp, every adapter (a rank's layers,
the replicated top-level ``proj_out`` too, see only its tokens); summed
over tp for the adapters of tp-sharded layers (each rank holds its slice's
part), not for ``proj_out``, whose whole gradient every tp rank already
holds; then averaged over dp.  Every reduction sums in coordinate order, so
the adapters stay bit-equal on every rank; with accumulation the running
mean of the local gradients is reduced once per update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from trajectorycrafter_tpu_torch.parallel import distributed as D
from trajectorycrafter_tpu_torch.parallel.sharding import batch_shard
from trajectorycrafter_tpu_torch.training.lora import LoRA, apply_lora, remove_lora

Batch = Dict[str, Union[np.ndarray, torch.Tensor]]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32 (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


@dataclass
class OptState:
    """The optimizer's state: torch's AdamW over the adapters, and with
    accumulation the running mean of the micro-gradients and its count."""
    adamw: torch.optim.AdamW
    acc: Optional[List[torch.Tensor]] = None
    mini_step: int = 0


@dataclass
class Optimizer:
    """optax.chain(clip_by_global_norm(clip_norm), adamw(lr, 0.9, 0.999,
    eps 1e-8, weight_decay)), wrapped in optax.MultiSteps when
    ``grad_accum_steps`` > 1."""
    lr: float = 1e-4
    weight_decay: float = 1e-2
    clip_norm: float = 1.0
    grad_accum_steps: int = 1

    def init(self, lora: LoRA) -> OptState:
        adamw = torch.optim.AdamW(list(lora.values()), lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=self.weight_decay)
        return OptState(adamw)

    def update(self, grads: Sequence[torch.Tensor], state: OptState,
               reduce: Optional[Callable] = None) -> Optional[torch.Tensor]:
        """Take one (micro-)step with ``grads``, in the adapters' order: with
        accumulation the adapters change only every ``grad_accum_steps``-th
        call.  ``reduce`` (a sharded step's ``reduce_lora_grads``) maps the
        gradients to the mesh's before they are clipped, once per update.
        Returns the global norm of the gradient it clipped, None at a
        micro-step that only accumulates."""
        grads = [g.detach().float() for g in grads]
        if self.grad_accum_steps > 1:
            if state.acc is None:
                state.acc = [torch.zeros_like(g) for g in grads]
            # optax.MultiSteps: the running mean acc + (g - acc) / (i + 1)
            for a, g in zip(state.acc, grads):
                a.add_((g - a) / (state.mini_step + 1))
            state.mini_step += 1
            if state.mini_step < self.grad_accum_steps:
                return None
            grads, state.acc, state.mini_step = state.acc, None, 0
        if reduce is not None:
            grads = reduce(grads)
        # optax.clip_by_global_norm: g / norm * max_norm where norm >= max_norm
        # (torch's clip_grad_norm_ divides by norm + 1e-6)
        norm = global_norm(grads)
        if norm >= self.clip_norm:
            grads = [g / norm * self.clip_norm for g in grads]
        for p, g in zip(state.adamw.param_groups[0]["params"], grads):
            p.grad = g
        state.adamw.step()
        state.adamw.zero_grad(set_to_none=True)
        return norm


def make_optimizer(lr: float = 1e-4, weight_decay: float = 1e-2, clip_norm: float = 1.0,
                   grad_accum_steps: int = 1) -> Optimizer:
    """AdamW with clipping; ``grad_accum_steps`` > 1 averages the gradients
    of that many micro-steps before one update."""
    return Optimizer(lr, weight_decay, clip_norm, grad_accum_steps)


class TrainState(NamedTuple):
    lora: LoRA
    opt_state: OptState
    step: int


def to_device(batch: Batch, device) -> Dict[str, torch.Tensor]:
    """numpy or torch batch values -> tensors on ``device`` (a tuple, the
    rotary tables, value by value)."""
    put = lambda v: torch.as_tensor(v).to(device)
    return {k: tuple(map(put, v)) if isinstance(v, (tuple, list)) else put(v)
            for k, v in batch.items()}


def tp_sharded_adapters(model: nn.Module, names: Sequence[str]) -> set:
    """The adapters (by key) of the layers sharded over tp, whose gradients
    the tp ranks hold in parts."""
    return {n for n in names
            if getattr(model.get_submodule(n.rpartition(".")[0]), "tp_axis", None) is not None}


def dp_mean(flat: torch.Tensor, dp: D.Axis) -> torch.Tensor:
    """The mean over dp of every rank's ``flat``, summed in coordinate order."""
    return D.sum_partials(flat, dp) / dp.size


def sp_sum(flat: torch.Tensor, sp: D.Axis) -> torch.Tensor:
    """The sum over sp of every rank's ``flat`` (each its tokens' share), in
    coordinate order."""
    return D.sum_partials(flat, sp)


def _reduced(grads: List[torch.Tensor], picked: List[int], fn) -> None:
    """``fn`` of the gradients ``picked``, flattened into one tensor, written
    back in place of them."""
    if not picked:
        return
    flat = fn(torch.cat([grads[i].reshape(-1) for i in picked]))
    for i, part in zip(picked, flat.split([grads[i].numel() for i in picked])):
        grads[i] = part.view_as(grads[i])


def reduce_lora_grads(grads: Sequence[torch.Tensor], names: Sequence[str], model: nn.Module,
                      mesh) -> List[torch.Tensor]:
    """The adapter gradients of one rank (fp32, in the order of ``names``)
    -> the mesh's: every adapter summed over sp, then summed over tp for the
    adapters of tp-sharded layers, then averaged over dp (one flat
    collective each)."""
    grads = list(grads)
    if mesh.sp.size > 1:
        _reduced(grads, list(range(len(grads))), lambda flat: sp_sum(flat, mesh.sp))
    if mesh.tp.size > 1:
        sharded = tp_sharded_adapters(model, names)
        _reduced(grads, [i for i, n in enumerate(names) if n in sharded],
                 lambda flat: D.sum_partials(flat, mesh.tp))
    if mesh.dp.size > 1:
        _reduced(grads, list(range(len(grads))), lambda flat: dp_mean(flat, mesh.dp))
    return grads


def make_loss_fn(
    model: nn.Module,
    scheduler,
    sch_state,
    prediction_type: str = "v_prediction",
    cfg_dropout_prob: float = 0.1,
    motion_sub_loss: bool = False,
    lora_alpha: float = 8.0,
    lora_rank: int = 8,
    num_train_timesteps: int = 1000,
    dp: Optional[D.Axis] = None,
    sp: Optional[D.Axis] = None,
) -> Callable:
    """The training objective as loss(lora, batch, rng) -> 0-d fp32 tensor.

    The one implementation of noising, conditioning and target: the train
    step runs it with dropout on, validation (``make_eval_loss``) with
    dropout off and the timesteps in the batch.  ``lora=None`` evaluates the
    base model.  ``rng`` is a ``torch.Generator`` on the model's device, or
    an int seed for one.  The base model is frozen (``requires_grad_(False)``)
    and keeps the adapters attached after the call, so that the backward
    pass (and, under ``remat``, its recomputation) runs on the merged
    weights.  Under ``dp`` every rank passes the global batch and draws its
    timesteps, noise and masks, then takes its dp rows: the loss is the mean
    over the rank's rows.  Under ``sp`` the model keeps the rank's shard of
    the joint tokens and gathers its prediction, so the loss is the whole
    rows' on every sp rank.
    """
    model.requires_grad_(False)
    base = next(model.parameters())
    device, dtype = base.device, base.dtype

    def loss_fn(lora: Optional[LoRA], batch: Batch, rng) -> torch.Tensor:
        if lora is None:
            remove_lora(model)
        else:
            apply_lora(model, lora, lora_alpha, lora_rank)
        gen = rng if isinstance(rng, torch.Generator) else \
            torch.Generator(device=device).manual_seed(int(rng))
        batch = to_device(batch, device)
        x0 = batch["gt_latents"].float()
        b = x0.shape[0]
        timesteps = batch.get("timesteps")
        if timesteps is None:
            timesteps = torch.randint(0, num_train_timesteps, (b,), generator=gen, device=device)
        noise = batch.get("noise")
        if noise is None:
            noise = torch.randn(x0.shape, generator=gen, device=device)
        noise = noise.float()
        conditions = [batch[k] for k in ("prompt_embeds", "ref_latents", "inpaint_latents")]
        if cfg_dropout_prob > 0.0:
            keeps = [torch.rand((b,) + (1,) * (x.ndim - 1), generator=gen, device=device)
                     >= cfg_dropout_prob for x in conditions]
            conditions = [x * keep.to(x.dtype) for x, keep in zip(conditions, keeps)]
        if dp is not None:  # this rank's rows of the global batch and its draws
            x0, noise, timesteps, *conditions = (batch_shard(x, dp) for x in (
                x0, noise, timesteps, *conditions))
        noisy = scheduler.add_noise(sch_state, x0, noise, timesteps)
        text, ref, inpaint = conditions
        rope = batch.get("rope")
        tokens = {} if sp is None else {"sp": sp}  # the token stream's sp axis
        pred = model(noisy.to(dtype), text.to(dtype), timesteps.float(),
                     inpaint_latents=inpaint.to(dtype), cross_latents=ref.to(dtype),
                     image_rotary_emb=rope, **tokens).float()

        if prediction_type == "v_prediction":
            target = scheduler.get_velocity(sch_state, x0, noise, timesteps)
        else:
            target = noise
        loss = torch.mean((pred - target) ** 2)
        if motion_sub_loss:
            # temporal-difference alignment (reference :242-247)
            d_pred = pred[:, 1:] - pred[:, :-1]
            d_target = target[:, 1:] - target[:, :-1]
            loss = loss + 0.1 * torch.mean((d_pred - d_target) ** 2)
        return loss

    return loss_fn


def make_train_step(
    model: nn.Module,
    scheduler,
    sch_state,
    optimizer: Optimizer,
    prediction_type: str = "v_prediction",
    cfg_dropout_prob: float = 0.1,
    motion_sub_loss: bool = False,
    lora_alpha: float = 8.0,
    lora_rank: int = 8,
    num_train_timesteps: int = 1000,
    mesh=None,
) -> Callable:
    """Returns step(state, batch, rng) -> (state, {"loss", "grad_norm"}), the
    metrics 0-d tensors; ``grad_norm`` is the global norm of the step's
    gradient before clipping.  Under ``mesh`` (dp x sp x tp) the loss is
    the mean over dp of the ranks' losses (every sp rank's is the same) and
    ``grad_norm`` the norm of the reduced gradient; with accumulation that
    gradient is the running mean's at the micro-step that updates, and
    ``grad_norm`` is NaN at the others (their gradients are not reduced).

    batch: channel-last latents, already VAE-encoded: gt_latents (B, F, h,
    w, C), prompt_embeds (B, L, De), ref_latents (B, Fr, h, w, C),
    inpaint_latents (B, F, h, w, C + 1), and optionally timesteps (B,),
    noise like gt_latents, rope (the rotary tables).
    """
    loss_fn = make_loss_fn(
        model, scheduler, sch_state, prediction_type=prediction_type,
        cfg_dropout_prob=cfg_dropout_prob, motion_sub_loss=motion_sub_loss,
        lora_alpha=lora_alpha, lora_rank=lora_rank, num_train_timesteps=num_train_timesteps,
        dp=None if mesh is None else mesh.dp,
        sp=None if mesh is None or mesh.sp.size == 1 else mesh.sp)

    def step(state: TrainState, batch: Batch, rng):
        params = list(state.lora.values())
        loss = loss_fn(state.lora, batch, rng)
        grads = torch.autograd.grad(loss, params)
        if mesh is None:
            optimizer.update(grads, state.opt_state)
            gnorm, loss = global_norm(grads), loss.detach()
        else:
            names = list(state.lora)
            norm = optimizer.update(grads, state.opt_state,
                                    lambda g: reduce_lora_grads(g, names, model, mesh))
            gnorm = norm if norm is not None else torch.tensor(float("nan"))
            loss = dp_mean(loss.detach().reshape(1), mesh.dp)[0]
        return (TrainState(state.lora, state.opt_state, state.step + 1),
                {"loss": loss, "grad_norm": gnorm})

    return step
