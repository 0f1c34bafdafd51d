"""DiT depth probing on the card: capture transformer-block activations over
latent samples and train a probe to regress depth from them.

    python -m trajectorycrafter_tpu_torch.scripts.probe_depth \
        --data_dir latents/ --transformer_path ckpt/transformer --blocks 1 3

The port's counterpart of the root ``probe_depth.py``: the same 11 flags
with the same defaults.  Without ``--collect_dir`` it runs each sample's
un-noised ``gt_latents`` at the float timestep ``--timestep`` through the
DiT once per block and trains a probe per block; with it, it first writes
the timesteps x blocks activation dataset (``probing.py
collect_activation_dataset``: the latents noised by the training
scheduler's q(x_t | x_0) at each of ``--timesteps``, ``--motion_filter``
gating the samples that carry poses) and trains a probe per (timestep,
block) from it.  The target is the sample's ``depth`` or, without one, the
latents' mean magnitude, resized to the latent grid as
``jax.image.resize(..., "linear")`` does (``ops/resize.py
resize_linear_jax``).

The DiT is ``scripts/train_lora.py build_base_model``'s, with the JAX
default route ``attention_impl="auto"`` (the attention kernel on the card)
and no recomputation; no rotary tables are passed, as in JAX.  orbax is not
ported: a probe is ``<output_dir>/probe_<tag>.safetensors``, its state
dict.  ``main(argv, device="cpu")`` runs it all on the CPU with the plain
versions; otherwise a CUDA card is required.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def get_parser():
    p = argparse.ArgumentParser(description="DiT depth probing (PyTorch port)")
    p.add_argument("--data_dir", type=str, required=True,
                   help=".npz latent samples (training/data.py layout) with an optional "
                        "'depth' key per sample")
    p.add_argument("--transformer_path", type=str, default=None)
    p.add_argument("--blocks", type=int, nargs="+", default=[1, 3])
    p.add_argument("--timestep", type=float, default=311.0)
    p.add_argument("--collect_dir", type=str, default=None,
                   help="collect a features/<timestep>/<block> activation dataset here "
                        "first, then train probes from it; --timesteps selects the sweep")
    p.add_argument("--timesteps", type=int, nargs="+", default=None,
                   help="timesteps for --collect_dir (default: [--timestep])")
    p.add_argument("--motion_filter", action="store_true",
                   help="apply the CameraMotionFilter to samples with poses")
    p.add_argument("--probe", choices=["conv", "mlp"], default="conv")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--output_dir", type=str, default="./probe_out")
    return p


def depth_target(sample, grid) -> torch.Tensor:
    """A sample's probe target on the latent ``grid`` (f, h, w): its ``depth``
    or, without one, the latents' mean magnitude, resized as
    ``jax.image.resize(..., "linear")``."""
    from trajectorycrafter_tpu_torch.ops.resize import resize_linear_jax

    depth = sample.get("depth")
    if depth is None:
        depth = np.abs(sample["gt_latents"]).mean(-1)
    return resize_linear_jax(torch.as_tensor(np.asarray(depth, np.float32)), grid)


def main(argv=None, device: str = "cuda"):
    """Probe; returns {tag: {"first_loss", "last_loss",
    "relative_depth_error"}} of the probes trained."""
    from safetensors.torch import save_file

    from trajectorycrafter_tpu_torch.cli import require_card
    from trajectorycrafter_tpu_torch.probing import (
        ConvProbe,
        MLPProbe,
        collect_features,
        make_probe_trainer,
        relative_depth_error,
    )
    from trajectorycrafter_tpu_torch.scripts.train_lora import build_base_model
    from trajectorycrafter_tpu_torch.training.data import LatentsDataset

    args = get_parser().parse_args(argv)
    if torch.device(device).type == "cuda":
        require_card()
    os.makedirs(args.output_dir, exist_ok=True)

    data = LatentsDataset(args.data_dir)
    sample = data[0]
    model = build_base_model(args, sample, device, attention_impl="auto", remat=False)
    dtype = model.proj_out.weight.dtype
    f, h, w, _ = sample["gt_latents"].shape
    hp, wp = h // model.patch_size, w // model.patch_size
    results = {}

    def train_probe(tokens, target, tag):
        cls = ConvProbe if args.probe == "conv" else MLPProbe
        probe = cls(frames=f, height=hp, width=wp)
        init_fn, step_fn = make_probe_trainer(probe, lr=args.lr)
        state = init_fn(torch.Generator(device=device).manual_seed(0), tokens)
        losses = []
        for step in range(args.steps):
            state, loss = step_fn(state, tokens, target)
            losses.append(loss)
            if (step + 1) % 50 == 0:
                print(f"{tag} step {step + 1}: loss {float(loss):.5f}")
        losses = torch.stack(losses).tolist() if losses else [None]
        with torch.no_grad():
            pred = state.params(tokens)
        err = relative_depth_error(pred.cpu().numpy(), target.cpu().numpy())
        print(f"{tag}: relative depth error {err:.4f}")
        save_file({k: v.detach().cpu().contiguous() for k, v in probe.state_dict().items()},
                  os.path.join(args.output_dir, f"probe_{tag}.safetensors"))
        results[tag] = {"first_loss": losses[0], "last_loss": losses[-1],
                        "relative_depth_error": err}

    if args.collect_dir:
        # collect once (timesteps x blocks), then train per slice: the
        # reference's two-stage collect_dataset.py -> mlp_probing.py flow
        from trajectorycrafter_tpu_torch.probing import (
            ActivationDataset,
            CameraMotionFilter,
            collect_activation_dataset,
        )
        from trajectorycrafter_tpu_torch.schedulers import CogVideoXDDIMScheduler

        scheduler = CogVideoXDDIMScheduler()
        sch_state = scheduler.set_timesteps(50)
        timesteps = args.timesteps or [int(args.timestep)]
        samples = []
        for i in range(len(data)):
            s = dict(data[i])
            s["name"] = f"sample_{i:04d}"
            samples.append(s)
        manifest = collect_activation_dataset(
            model, scheduler, sch_state, samples, timesteps, args.blocks, args.collect_dir,
            motion_filter=CameraMotionFilter() if args.motion_filter else None)
        print(f"collected {manifest['files']} feature files; "
              f"kept {len(manifest['kept'])}, skipped {len(manifest['skipped'])}")
        if not manifest["kept"]:
            print("no samples passed the camera-motion filter; nothing to train (adjust "
                  "CameraMotionFilter thresholds or drop --motion_filter)")
            return results
        kept = set(manifest["kept"])
        targets = torch.stack([depth_target(s, (f, hp, wp))
                               for s in samples if s["name"] in kept]).to(device)
        for t in timesteps:
            for block in args.blocks:
                tokens, _ = ActivationDataset(args.collect_dir, t, block).stacked()
                train_probe(torch.from_numpy(tokens).to(device), targets, f"t{t}_block{block}")
        return results

    as_input = lambda a: torch.as_tensor(a)[None].to(device, dtype)
    timestep = torch.tensor([args.timestep], dtype=torch.float32, device=device)
    for block in args.blocks:
        feats_all, targets = [], []
        for i in range(len(data)):
            s = data[i]
            feats = collect_features(
                model, [block], as_input(s["gt_latents"]), as_input(s["prompt_embeds"]),
                timestep, as_input(s["inpaint_latents"]), as_input(s["ref_latents"]))
            feats_all.append(feats[f"transformer_block_{block}"][0].float())
            targets.append(depth_target(s, (f, hp, wp)))
        train_probe(torch.stack(feats_all), torch.stack(targets).to(device), f"block{block}")
    return results


if __name__ == "__main__":
    main()
