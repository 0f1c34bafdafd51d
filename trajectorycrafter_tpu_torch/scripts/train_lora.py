"""LoRA fine-tuning of the DiT on pre-encoded latent samples, on the card.

    python -m trajectorycrafter_tpu_torch.scripts.train_lora \
        --data_dir latents/ --transformer_path ckpt/transformer --train_steps 1000

The port's counterpart of the root ``train_lora.py``: its 19 flags with
the same defaults, and the port's ``--dist_backend``; the samples of
``datagen.generate_dataset`` read by ``training/data.py LatentsDataset``,
the step of ``training/step.py``, validation every ``--validate_every``
steps, checkpoints every ``--checkpointing_steps`` and resume from
``--resume_from_checkpoint``.

``--mesh_dp`` and ``--mesh_tp`` shard the training over that many ranks,
started by torchrun, one process a rank (``--dist_backend``: ``nccl``, one
card a rank, or ``gloo``, which also runs ranks that share a card):

    torchrun --nproc_per_node 4 -m trajectorycrafter_tpu_torch.scripts.train_lora \
        --mesh_dp 2 --mesh_tp 2 --batch_size 2 --data_dir latents/ ...

as the JAX script's ``make_mesh(dp, sp=1, tp)``: every rank holds its
tensor-parallel shard of the base DiT's blocks and Perceivers (sharded as
it loads or is drawn, so no rank holds more of the whole model than one
tensor or block beside its shard) and the whole adapters; each step every
rank reads the global batch and draws its timesteps, noise and dropout
masks, runs its dp rows, and reduces the adapter gradients over tp and dp
before the clip and AdamW (training/step.py), so the adapters stay the same
on every rank.  ``--batch_size`` must be a multiple of dp; a mesh whose
product is not the world size, or mesh flags without torchrun, raise.
Validation runs the held-out samples at B = 1 on every rank's shard, as
JAX's ``eval_jit`` under the mesh.  Rank 0 alone writes the checkpoints,
``metrics.jsonl`` and ``lora_final``; the ranks wait for each checkpoint
at a barrier and all resume from ``latest``.

The base DiT is ``utils/checkpoints.py load_dit`` of ``--transformer_path``
at bf16 (``quant="none"``), or without it a dev-scale random model shaped
by the first sample (fp32 on the CPU, bf16 on the card, whose attention
kernels take bf16 at head dims 64 and 128): 4 heads of 64 in the blocks
and the Perceivers, where the JAX dev model has 4 heads of 16, so that it
splits over tp as JAX's does.  Either is built with
``attention_impl="flash_stock"``, the route whose kernels have a backward
(ops/attention.py ``FlashAttentionFunction``), and ``remat=True``, which
recomputes each block in the backward pass: on the card training needs
both (the other kernel routes have no gradient; a full-width step without
recomputation would not fit beside the weights).  Neither changes the
function computed.  ``main(argv, device="cpu")`` runs it all on the CPU
with the plain versions.

orbax is not ported: a checkpoint is
``<output_dir>/ckpt_<step:07d>/lora.safetensors`` with the step in its
metadata, and ``lora_final/`` at the end; resuming restores the adapters
and the step, not the optimizer state, as the JAX script does.
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from trajectorycrafter_tpu_torch.parallel import distributed as D

LORA_FILE = "lora.safetensors"


def get_parser():
    p = argparse.ArgumentParser(description="TrajectoryCrafter LoRA training (PyTorch port)")
    p.add_argument("--data_dir", type=str, required=True,
                   help="directory of pre-encoded .npz latent samples")
    p.add_argument("--output_dir", type=str, default="./lora_out")
    p.add_argument("--transformer_path", type=str, default=None,
                   help="base DiT checkpoint; dev-scale random model if unset")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--train_steps", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--lora_rank", type=int, default=8)
    p.add_argument("--lora_alpha", type=float, default=8.0)
    p.add_argument("--cfg_dropout", type=float, default=0.1)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1,
                   help="average gradients over N micro-batches per update")
    p.add_argument("--motion_sub_loss", action="store_true")
    p.add_argument("--checkpointing_steps", type=int, default=200)
    p.add_argument("--resume_from_checkpoint", type=str, default=None,
                   help="'latest' or a checkpoint path")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--mesh_dp", type=int, default=1)
    p.add_argument("--mesh_tp", type=int, default=1)
    # the port's transport (the JAX script takes its devices from jax)
    p.add_argument("--dist_backend", choices=D.BACKENDS, default="nccl",
                   help="process-group backend of a sharded run: nccl (one card a "
                        "rank) or gloo (also ranks that share a card)")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--validate_every", type=int, default=0,
                   help="run held-out validation every N steps (0 = off)")
    p.add_argument("--val_fraction", type=float, default=0.1,
                   help="fraction of samples held out for validation")
    return p


def build_base_model(args, sample, device, attention_impl: str = "flash_stock",
                     remat: bool = True, tp=None):
    """The frozen base DiT: ``--transformer_path`` at bf16, or the dev-scale
    model shaped by ``sample``; both with ``attention_impl`` and ``remat``
    (training: ``flash_stock`` and ``remat``; the probe script: ``auto``, the
    JAX default, without).  ``tp`` (a mesh axis): this rank's tensor-parallel
    shard of its blocks and Perceivers."""
    from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel
    from trajectorycrafter_tpu_torch.orchestrator import random_init_
    from trajectorycrafter_tpu_torch.parallel.sharding import shard_units_

    route = dict(attention_impl=attention_impl, remat=remat)
    if args.transformer_path and os.path.isdir(args.transformer_path):
        from trajectorycrafter_tpu_torch.utils.checkpoints import load_dit

        return load_dit(args.transformer_path, device=device, dtype=torch.bfloat16,
                        quant="none", tp=tp, **route)
    c = sample["gt_latents"].shape[-1]
    length, text_dim = sample["prompt_embeds"].shape
    model = CrossTransformer3DModel(
        num_attention_heads=4, attention_head_dim=64, in_channels=2 * c + 1, out_channels=c,
        time_embed_dim=32, text_embed_dim=text_dim, num_layers=4,
        max_text_seq_length=length, cross_attn_dim_head=64, cross_attn_num_heads=4,
        use_rotary_positional_embeddings=True, **route)
    dtype = torch.float32 if torch.device(device).type == "cpu" else torch.bfloat16
    model = random_init_(model.to(device=device, dtype=dtype), 0)
    return model if tp is None else shard_units_(model, tp)


def save_lora(path: str, lora: dict, step: int) -> str:
    """Write the adapters to ``<path>/lora.safetensors`` with the step in its
    metadata; returns the file's path."""
    from safetensors.torch import save_file

    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, LORA_FILE)
    save_file({k: v.detach().cpu().contiguous() for k, v in lora.items()}, out,
              metadata={"step": str(int(step))})
    return out


def load_lora(path: str, lora: dict) -> int:
    """Copy ``<path>/lora.safetensors`` into the adapters ``lora`` in place
    (every key must match); returns the step it was saved at."""
    from safetensors import safe_open

    with safe_open(os.path.join(path, LORA_FILE), framework="pt") as f:
        keys = set(f.keys())
        if keys != set(lora):
            raise ValueError(f"{path}: adapters {sorted(keys ^ set(lora))[:4]}... do not "
                             "match the model's")
        with torch.no_grad():
            for key in keys:
                lora[key].copy_(f.get_tensor(key))
        return int((f.metadata() or {}).get("step", 0))


def latest_checkpoint(output_dir: str):
    ckpts = sorted(d for d in os.listdir(output_dir) if d.startswith("ckpt_"))
    return os.path.join(output_dir, ckpts[-1]) if ckpts else None


def start_mesh(args, device):
    """The dp x tp mesh of ``--mesh_dp`` / ``--mesh_tp`` (None at 1 x 1) over
    the process group, started from torchrun's environment unless it runs
    already (a caller's world, as the tests' gloo worlds); and whether this
    call started it.  Raises where the mesh's product is not the world
    size."""
    from trajectorycrafter_tpu_torch.parallel.mesh import make_mesh

    n = args.mesh_dp * args.mesh_tp
    if n == 1:
        return None, False
    started = not dist.is_initialized()
    world = int(os.environ.get("WORLD_SIZE", "1")) if started else dist.get_world_size()
    if n != world:
        raise ValueError(f"the mesh --mesh_dp {args.mesh_dp} x --mesh_tp {args.mesh_tp} = {n} "
                         f"ranks does not match the world of {world} (torchrun "
                         "--nproc_per_node)")
    if args.batch_size % args.mesh_dp:
        raise ValueError(f"--batch_size {args.batch_size} is not a multiple of --mesh_dp "
                         f"{args.mesh_dp}")
    cpu = torch.device(device).type == "cpu"
    if started:
        D.init_from_env(args.dist_backend, "cpu" if cpu else None)
    return make_mesh(dp=args.mesh_dp, tp=args.mesh_tp, device="cpu" if cpu else None), started


def main(argv=None, device: str = "cuda"):
    """Train; returns the final ``TrainState``.  ``device="cpu"`` runs on the
    CPU (the tests); otherwise a CUDA card is required."""
    from trajectorycrafter_tpu_torch.cli import require_card

    args = get_parser().parse_args(argv)
    if torch.device(device).type == "cuda":
        require_card()
    mesh, started = start_mesh(args, device)
    try:
        return _train(args, device if mesh is None else mesh.device, mesh)
    finally:
        if started:
            D.shutdown()


def _train(args, device, mesh):
    from trajectorycrafter_tpu_torch.schedulers import CogVideoXDDIMScheduler
    from trajectorycrafter_tpu_torch.training import (
        TrainState,
        init_lora_params,
        make_train_step,
    )
    from trajectorycrafter_tpu_torch.training.data import LatentsDataset
    from trajectorycrafter_tpu_torch.training.step import make_optimizer
    from trajectorycrafter_tpu_torch.training.validation import (
        MetricsLogger,
        make_eval_loss,
        run_validation,
        sanity_check_batch,
    )

    leader = mesh is None or mesh.leader
    say = print if leader else (lambda *a, **k: None)
    if leader:
        os.makedirs(args.output_dir, exist_ok=True)
    data = LatentsDataset(args.data_dir)
    val_data = None
    if args.validate_every > 0:
        data, val_data = data.split(args.val_fraction, seed=args.seed)
        say(f"dataset split: {len(data)} train / {len(val_data)} val")
    model = build_base_model(args, data[0], device, tp=None if mesh is None else mesh.tp)
    logger = MetricsLogger(os.path.join(args.output_dir, "metrics.jsonl")) if leader else None

    scheduler = CogVideoXDDIMScheduler()
    sch_state = scheduler.set_timesteps(50)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    lora = init_lora_params(gen, model, rank=args.lora_rank)
    optimizer = make_optimizer(lr=args.learning_rate,
                               grad_accum_steps=args.gradient_accumulation_steps)
    state = TrainState(lora=lora, opt_state=optimizer.init(lora), step=0)

    start_step = 0
    if args.resume_from_checkpoint:
        path = args.resume_from_checkpoint
        if path == "latest":
            path = latest_checkpoint(args.output_dir) if os.path.isdir(args.output_dir) else None
        if path and os.path.isdir(path):
            start_step = load_lora(path, lora)
            state = state._replace(step=start_step)
            say(f"resumed from {path} at step {start_step}")

    step_fn = make_train_step(
        model, scheduler, sch_state, optimizer, cfg_dropout_prob=args.cfg_dropout,
        motion_sub_loss=args.motion_sub_loss, lora_alpha=args.lora_alpha,
        lora_rank=args.lora_rank, mesh=mesh)
    eval_loss = None
    if val_data is not None:
        eval_loss = make_eval_loss(model, scheduler, sch_state, lora_alpha=args.lora_alpha,
                                   lora_rank=args.lora_rank)

    def save(path, step):
        # rank 0 writes; every rank waits until the file is there
        if leader:
            save_lora(path, state.lora, step)
            say(f"saved {path}")
        if mesh is not None:
            D.barrier(mesh.world)

    batches = data.iter_batches(args.batch_size, seed=args.seed)
    t0 = time.time()
    for step in range(start_step, args.train_steps):
        batch = next(batches)
        if step == start_step:
            # first-batch sanity dump (reference training_loop.py:312-321)
            say(sanity_check_batch(batch, step))
        state, metrics = step_fn(state, batch, gen)
        if (step + 1) % args.log_every == 0:
            loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
            dt = (time.time() - t0) / args.log_every
            say(f"step {step + 1}: loss {loss:.4f} grad_norm {gn:.3f} "
                f"{dt * 1000:.0f} ms/step")
            if logger is not None:
                logger.log(step + 1, loss=loss, grad_norm=gn, ms_per_step=dt * 1000.0,
                           lr=args.learning_rate)
            t0 = time.time()
        if eval_loss is not None and (step + 1) % args.validate_every == 0:
            val = run_validation(eval_loss, state.lora,
                                 ({k: v[None] for k, v in val_data[i].items()}
                                  for i in range(len(val_data))), seed=args.seed)
            say(f"step {step + 1}: val_loss {val['val_loss']:.4f} "
                f"({val['val_samples']} samples)")
            if logger is not None:
                logger.log(step + 1, **val)
            t0 = time.time()
        if (step + 1) % args.checkpointing_steps == 0:
            save(os.path.join(args.output_dir, f"ckpt_{step + 1:07d}"), step + 1)

    final = os.path.join(args.output_dir, "lora_final")
    save(final, args.train_steps)
    if logger is not None:
        logger.close()
    say(f"training done; adapters at {final}")
    return state


if __name__ == "__main__":
    main()
