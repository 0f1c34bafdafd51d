"""DiT feature probing: capture the video-token output of chosen transformer
blocks and train small conv / MLP probes to regress depth from it.

Counterpart of trajectorycrafter_tpu/probing.py (the reference's
notebooks/15_10_25_depth/ ``collect_dataset.py`` and ``mlp_probing.py``).
JAX captures a block's output through flax's ``capture_intermediates``; here
a forward hook on ``model.transformer_blocks[i]`` takes the same tensor: the
block's own output, before the Perceiver residual that the DiT's loop adds
after it.  The forward runs under ``torch.no_grad()``, as JAX's
``model.apply`` does (the kernel wrappers refuse a tensor that needs a
gradient).

The probes are ``nn.Module``s on channels-last tokens with flax's layer
names (``utils/weights.py probe_from_jax`` carries a flax probe across);
their first layer is lazy, so that, as flax's ``init``, ``make_probe_trainer``'s
``init_fn`` takes the token width from the tokens it is given.  The
trainer is the JAX one's: MSE mean, ``torch.optim.Adam`` with optax's
``adam`` defaults; the probes start from flax's default init (LeCun normal
kernels truncated at two standard deviations, zero biases), drawn from a
``torch.Generator`` (a JAX key cannot be replayed in torch).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# flax's ``lecun_normal``: a normal truncated at +-2 whose standard deviation
# is sqrt(1 / fan_in) after the truncation (variance_scaling's constant)
_TRUNCATED_STD = 0.87962566103423978


def collect_features(model: nn.Module, block_indices: Sequence[int], *model_args,
                     **model_kwargs) -> Dict[str, torch.Tensor]:
    """Run the DiT and capture each requested block's video-token output
    ``{"transformer_block_<i>": (B, S_video, D)}`` in the model's dtype."""
    feats: Dict[str, torch.Tensor] = {}
    handles = []
    for i in block_indices:
        def hook(module, args, output, key=f"transformer_block_{i}"):
            feats[key] = output[0].detach()

        handles.append(model.transformer_blocks[i].register_forward_hook(hook))
    try:
        with torch.no_grad():
            model(*model_args, **model_kwargs)
    finally:
        for h in handles:
            h.remove()
    return {f"transformer_block_{i}": feats[f"transformer_block_{i}"] for i in block_indices}


class ConvProbe(nn.Module):
    """Tokens (B, S_video, D) -> depth map (B, F, H, W) through a 1x1, a 3x3
    ("SAME") and a 1x1 convolution (reference mlp_probing.py:87)."""

    def __init__(self, frames: int, height: int, width: int, hidden: int = 128):
        super().__init__()
        self.frames, self.height, self.width = frames, height, width
        self.conv1 = nn.LazyConv2d(hidden, 1)
        self.conv2 = nn.Conv2d(hidden, hidden, 3, padding=1)
        self.conv_out = nn.Conv2d(hidden, 1, 1)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        b = tokens.shape[0]
        x = tokens.reshape(b * self.frames, self.height, self.width, tokens.shape[-1])
        x = F.relu(self.conv1(x.permute(0, 3, 1, 2)))
        x = F.relu(self.conv2(x))
        return self.conv_out(x).reshape(b, self.frames, self.height, self.width)


class MLPProbe(nn.Module):
    """Per-token depth regression (reference mlp_probing.py:148)."""

    def __init__(self, frames: int, height: int, width: int, hidden: int = 256):
        super().__init__()
        self.frames, self.height, self.width = frames, height, width
        self.fc1 = nn.LazyLinear(hidden)
        self.fc2 = nn.Linear(hidden, 1)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.fc2(F.relu(self.fc1(tokens)))
        return x.reshape(tokens.shape[0], self.frames, self.height, self.width)


class ProbeTrainState(NamedTuple):
    params: nn.Module  # the probe, trained in place
    opt_state: torch.optim.Optimizer


@torch.no_grad()
def init_probe_(probe: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's default init: every kernel LeCun normal (truncated at two
    standard deviations), every bias 0."""
    for name, p in probe.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        else:
            std = (1.0 / p[0].numel()) ** 0.5 / _TRUNCATED_STD
            nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    return probe


def make_probe_trainer(probe: nn.Module, lr: float = 1e-3):
    """-> (init_fn(generator, example_tokens), step_fn(state, tokens, depth)).
    ``step_fn`` takes one Adam step on the MSE and returns (state, loss)."""

    def init_fn(generator: torch.Generator, tokens: torch.Tensor) -> ProbeTrainState:
        probe.to(tokens.device)
        with torch.no_grad():
            probe(tokens[:1])  # the lazy first layer takes the token width
        init_probe_(probe, generator)
        opt = torch.optim.Adam(probe.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
        return ProbeTrainState(probe, opt)

    def step_fn(state: ProbeTrainState, tokens: torch.Tensor, target_depth: torch.Tensor):
        state.opt_state.zero_grad(set_to_none=True)
        loss = torch.mean((state.params(tokens) - target_depth) ** 2)
        loss.backward()
        state.opt_state.step()
        return state, loss.detach()

    return init_fn, step_fn


def relative_depth_error(pred: np.ndarray, target: np.ndarray) -> float:
    """mean(|pred - target| / max(|target|, 1e-6)) (reference
    lora_utils_ours/validation.py:38); unmasked, unlike
    ``training/validation.py relative_depth_error``."""
    eps = 1e-6
    return float(np.mean(np.abs(pred - target) / np.maximum(np.abs(target), eps)))


# ----------------------------------------------------------------------------
# the dataset-collection harness (reference collect_dataset.py)
# ----------------------------------------------------------------------------


class CameraMotionFilter:
    """Gate samples by cumulative camera motion (reference
    collect_dataset.py:80-157): keep clips whose total translation and
    rotation stay under the maxima without being static.  numpy, fp32."""

    def __init__(self, min_total_translation: float = 10.0,
                 max_total_translation: float = 100.0,
                 min_total_rotation: float = 0.1,
                 max_total_rotation: float = 0.55):
        self.min_total_translation = min_total_translation
        self.max_total_translation = max_total_translation
        self.min_total_rotation = min_total_rotation
        self.max_total_rotation = max_total_rotation

    def compute_motion_metrics(self, poses: np.ndarray) -> Dict[str, float]:
        poses = np.asarray(poses, np.float32)
        if poses.shape[1:] != (4, 4):
            raise ValueError("Expected poses shape: (n_frames, 4, 4)")
        translations = poses[:, :3, 3]
        rotations = poses[:, :3, :3]
        trans_distances = np.linalg.norm(np.diff(translations, axis=0), axis=1)
        # the relative rotation's angle from the trace of R_curr R_prev^T
        r_rel = rotations[1:] @ np.swapaxes(rotations[:-1], -1, -2)
        traces = np.trace(r_rel, axis1=-2, axis2=-1)
        rotation_angles = np.arccos(np.clip((traces - 1) / 2, -1.0, 1.0))
        return {
            "max_frame_translation": float(trans_distances.max()),
            "mean_frame_translation": float(trans_distances.mean()),
            "total_translation": float(trans_distances.sum()),
            "max_frame_rotation": float(rotation_angles.max()),
            "mean_frame_rotation": float(rotation_angles.mean()),
            "total_rotation": float(rotation_angles.sum()),
        }

    def is_low_motion(self, poses: np.ndarray):
        m = self.compute_motion_metrics(poses)
        translation_ok = m["total_translation"] <= self.max_total_translation
        rotation_ok = m["total_rotation"] <= self.max_total_rotation
        non_zero = (m["total_translation"] >= self.min_total_translation
                    or m["total_rotation"] >= self.min_total_rotation)
        return translation_ok and rotation_ok and non_zero, m


def draw_noise(generator: torch.Generator, shape, device) -> torch.Tensor:
    """One sample's fp32 noise for ``collect_activation_dataset``."""
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


def collect_activation_dataset(
    model: nn.Module,
    scheduler,
    sch_state,
    samples,
    timesteps: Sequence[int],
    block_indices: Sequence[int],
    out_dir: str,
    motion_filter: Optional[CameraMotionFilter] = None,
    seed: int = 0,
) -> Dict[str, Any]:
    """Write the per-timestep x per-block activation dataset the probes train
    on: ``<out_dir>/<name>/features/timestep_<t>/transformer_block_<i>.npy``
    (fp32, (S_video, D)), ``<name>/depths/{depths,poses}.npy`` and
    ``manifest.json`` (reference collect_dataset.py:292-344).

    ``samples``: dicts of gt_latents (F, h, w, C), prompt_embeds,
    ref_latents, inpaint_latents and optionally poses (N, 4, 4) and depth.
    Each kept sample's latents are noised by q(x_t | x_0) at each timestep
    with one noise draw per sample (``draw_noise`` from a generator seeded
    with ``seed``, in sample order), cast to the model's dtype, and run
    through the DiT.  Returns the manifest {kept, skipped, files}."""
    device = model.proj_out.weight.device
    dtype = model.proj_out.weight.dtype
    generator = torch.Generator(device=device).manual_seed(seed)
    as_input = lambda a: torch.as_tensor(np.asarray(a))[None].to(device, dtype)
    manifest = {"kept": [], "skipped": [], "files": 0}
    for idx, s in enumerate(samples):
        name = s.get("name", f"sample_{idx:04d}")
        if motion_filter is not None and "poses" in s:
            ok, metrics = motion_filter.is_low_motion(s["poses"])
            if not ok:
                manifest["skipped"].append({"name": name, "metrics": metrics})
                continue
        sample_dir = os.path.join(out_dir, name)
        os.makedirs(sample_dir, exist_ok=True)

        x0 = torch.as_tensor(np.asarray(s["gt_latents"]))[None].to(device, torch.float32)
        noise = draw_noise(generator, x0.shape, device)
        prompt, inpaint, ref = (as_input(s[k]) for k in
                                ("prompt_embeds", "inpaint_latents", "ref_latents"))
        for t in timesteps:
            t_arr = torch.full((1,), t, dtype=torch.int32, device=device)
            noisy = scheduler.add_noise(sch_state, x0, noise, t_arr)
            feats = collect_features(model, block_indices, noisy.to(dtype), prompt,
                                     t_arr.float(), inpaint, ref)
            t_dir = os.path.join(sample_dir, "features", f"timestep_{t}")
            os.makedirs(t_dir, exist_ok=True)
            for key, value in feats.items():
                np.save(os.path.join(t_dir, f"{key}.npy"), value[0].float().cpu().numpy())
                manifest["files"] += 1
        aux_dir = os.path.join(sample_dir, "depths")
        os.makedirs(aux_dir, exist_ok=True)
        if "depth" in s:
            np.save(os.path.join(aux_dir, "depths.npy"), np.asarray(s["depth"], np.float32))
        if "poses" in s:
            np.save(os.path.join(aux_dir, "poses.npy"), np.asarray(s["poses"], np.float32))
        manifest["kept"].append(name)
    # the run's sample list: ActivationDataset trains on exactly these, so
    # leftovers of an earlier collection into the same root never misalign
    # (token, depth) pairs
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class ActivationDataset:
    """One (timestep, block) slice of a collected activation dataset, for
    probe training (reference mlp_probing.py DepthProbingDataset)."""

    def __init__(self, root: str, timestep: int, block: int):
        self.items = []
        man_path = os.path.join(root, "manifest.json")
        if os.path.isfile(man_path):
            # the last collection's kept samples only (stale sample
            # directories of earlier runs may survive in the same root)
            with open(man_path) as f:
                kept = json.load(f)["kept"]
            paths = [os.path.join(root, n, "features", f"timestep_{timestep}",
                                  f"transformer_block_{block}.npy") for n in sorted(kept)]
            missing = [p for p in paths if not os.path.isfile(p)]
            if missing:
                raise FileNotFoundError(
                    f"manifest lists samples without activations for "
                    f"timestep={timestep} block={block}: {missing[:3]}")
        else:
            paths = sorted(glob.glob(os.path.join(
                root, "*", "features", f"timestep_{timestep}", f"transformer_block_{block}.npy")))
        for feat_path in paths:
            sample_dir = os.path.dirname(os.path.dirname(os.path.dirname(feat_path)))
            depth_path = os.path.join(sample_dir, "depths", "depths.npy")
            self.items.append((feat_path, depth_path if os.path.isfile(depth_path) else None))
        if not self.items:
            raise FileNotFoundError(
                f"no activations for timestep={timestep} block={block} under {root}")

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        feat_path, depth_path = self.items[i]
        tokens = np.load(feat_path)
        depth = np.load(depth_path) if depth_path else None
        return tokens, depth

    def stacked(self):
        """-> (tokens (N, S, D), depths (N, ...) or None) for full-batch probes."""
        tokens = np.stack([np.load(f) for f, _ in self.items])
        if any(d is None for _, d in self.items):
            return tokens, None
        return tokens, np.stack([np.load(d) for _, d in self.items])
