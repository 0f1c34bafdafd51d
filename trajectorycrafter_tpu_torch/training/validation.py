"""Training-time validation metrics and observability helpers.

Counterpart of trajectorycrafter_tpu/training/validation.py (the reference's
held-out validation and sanity instrumentation,
notebooks/05_11_25_training/lora_utils_ours/validation.py:28-135 and
training_loop.py:312-321):
  * relative depth error over all / inpainted / non-inpainted pixels, with
    the [1, 100] depth unnormalisation and the > 127.5 inpaint-mask
    threshold, and the temporal alignment error over valid pixels;
  * a deterministic held-out eval loss: the training objective with
    conditioning dropout off, timesteps stratified over the whole held-out
    set;
  * the first-batch shape / mean / std dump;
  * a jsonl metrics sink, plus tensorboard when torch's SummaryWriter
    imports (the reference logs through accelerate's tensorboard tracker).

Under a training mesh (scripts/train_lora.py ``--mesh_dp/--mesh_tp``) every
rank runs the held-out samples at B = 1 on its tensor-parallel shard, as
JAX's ``eval_jit`` runs under ``jax.set_mesh``: the eval loss takes no dp
rows (a sample of one cannot split), and the tp sums give every rank the
same loss.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Iterable

import numpy as np
import torch


def unnormalize_depth(depth: torch.Tensor, depth_min: float = 1.0,
                      depth_max: float = 100.0) -> torch.Tensor:
    """[0, 1]-normalised depth video -> metric depth; zeros stay zero."""
    out = depth * (depth_max - depth_min) + depth_min
    return torch.where(depth > 0, out, torch.zeros_like(out))


def relative_depth_error(pred: torch.Tensor, gt: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """mean |pred - gt| / gt over mask & gt > 1e-6; NaN when the mask selects
    nothing, as the reference gives."""
    valid = mask & (gt > 1e-6)
    err = (pred - gt).abs() / gt.clamp_min(1e-6)
    n = valid.sum()
    total = torch.where(valid, err, torch.zeros_like(err)).sum()
    return total / n if n > 0 else torch.tensor(float("nan"))


def depth_error_metrics(pred_video: torch.Tensor, gt_video: torch.Tensor,
                        masks: torch.Tensor, mask_threshold: float = 127.5) -> Dict[str, Any]:
    """Rel-depth error split by inpainted region.

    pred_video / gt_video: (F, H, W, 3) depth-as-rgb videos in [0, 1] (the
    channel mean is taken, as the reference does for its 3-channel depth
    renders); masks: (F, H, W), > mask_threshold marks inpainted pixels.
    """
    pred = unnormalize_depth(pred_video.float().mean(-1))
    gt = unnormalize_depth(gt_video.float().mean(-1))
    inpainted = masks > mask_threshold
    # TAE over valid pixels only: invalid pixels stay exactly 0, and a 0 -> d
    # transition would add d / 1e-6 to the mean
    tae_valid = (pred[1:] > 0) & (pred[:-1] > 0)
    tae_rel = (pred[1:] - pred[:-1]).abs() / pred[:-1].clamp_min(1e-6)
    tae_n = tae_valid.sum()
    out = {
        "overall_rel_error": relative_depth_error(pred, gt, torch.ones_like(inpainted)),
        "inpainted_rel_error": relative_depth_error(pred, gt, inpainted),
        "non_inpainted_rel_error": relative_depth_error(pred, gt, ~inpainted),
        "tae": (torch.where(tae_valid, tae_rel, torch.zeros_like(tae_rel)).sum() / tae_n
                if tae_n > 0 else torch.tensor(float("nan"))),
        "inpainted_pixels": inpainted.sum(),
        "non_inpainted_pixels": (~inpainted).sum(),
    }
    return {k: float(v) for k, v in out.items()}


def make_eval_loss(model, scheduler, sch_state, prediction_type: str = "v_prediction",
                   lora_alpha: float = 8.0, lora_rank: int = 8,
                   num_train_timesteps: int = 1000) -> Callable:
    """Deterministic held-out loss: the train step's objective
    (``training.step.make_loss_fn``, one implementation) with conditioning
    dropout and the motion term off.  ``run_validation`` puts stratified
    timesteps in each batch."""
    from trajectorycrafter_tpu_torch.training.step import make_loss_fn

    return make_loss_fn(model, scheduler, sch_state, prediction_type=prediction_type,
                        cfg_dropout_prob=0.0, motion_sub_loss=False, lora_alpha=lora_alpha,
                        lora_rank=lora_rank, num_train_timesteps=num_train_timesteps)


def run_validation(eval_loss, lora, val_batches: Iterable[dict], seed: int = 0,
                   num_train_timesteps: int = 1000) -> Dict[str, float]:
    """The mean eval loss over the held-out set, without gradients.

    Timesteps are stratified over the whole set (sample i of n gets t = i /
    (n - 1) of the schedule), not within each batch; a single sample gets
    the middle of the schedule.  Batch i's noise, unless it holds some,
    comes from a generator seeded ``seed + i``.
    """
    val_batches = [dict(b) for b in val_batches]
    if not val_batches:
        raise ValueError("run_validation got an empty validation set")
    sizes = [np.asarray(b["gt_latents"]).shape[0] for b in val_batches]
    total = sum(sizes)
    pos = 0
    losses = []
    for i, batch in enumerate(val_batches):
        if "timesteps" not in batch:
            if total == 1:
                ts = np.array([(num_train_timesteps - 1) // 2])
            else:
                ts = np.round(np.arange(pos, pos + sizes[i])
                              * (num_train_timesteps - 1) / (total - 1))
            batch["timesteps"] = ts.astype(np.int32)
        pos += sizes[i]
        with torch.no_grad():
            losses.append(float(eval_loss(lora, batch, seed + i)))
    return {"val_loss": float(np.mean(losses)), "val_samples": len(losses)}


def sanity_check_batch(batch: Dict[str, np.ndarray], step: int = 0) -> str:
    """The first batch's shape / mean / std dump; returns the text so callers
    can print and log it."""
    lines = [f"Sanity check at step {step} - batch keys: {sorted(batch)}"]
    for key in sorted(batch):
        v = np.asarray(batch[key])
        lines.append(f"  {key}: {tuple(v.shape)} {v.dtype}, "
                     f"mean {float(v.mean()):.6f}, std {float(v.std()):.6f}")
    return "\n".join(lines)


class MetricsLogger:
    """Append-only jsonl metrics sink, plus a tensorboard event stream in
    ``<dir>/tb`` when torch's SummaryWriter imports."""

    def __init__(self, path: str, tensorboard: bool = True):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass  # the jsonl stays the record
            else:
                self._tb = SummaryWriter(os.path.join(os.path.dirname(path) or ".", "tb"))

    def log(self, step: int, **metrics) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            if isinstance(v, (int, float, np.floating)) or (
                    hasattr(v, "shape") and np.ndim(v) == 0):
                rec[k] = float(v)
            elif hasattr(v, "shape"):
                rec[k] = np.asarray(v).tolist()
            else:
                rec[k] = v
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "time") and isinstance(v, (int, float)):
                    self._tb.add_scalar(k, float(v), int(step))
            self._tb.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
            self._tb = None
