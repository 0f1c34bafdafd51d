"""Run T alone: chip_smoke.py's run T (sharded LoRA training and the GPipe
block stack) in a torchrun world of its own, without the rest of the smoke.

    python tools/run_t.py     # from the root of a checkout; one card

Builds the full-scale bundle (bf16), writes run P's SceneFlow tree, runs
phase 5e's part for run T (the 9-frame samples and the unsharded twin),
frees the bundle, and saves a DiT call's inputs for T3 and T4: the two
samples' latents, noised at one timestep, as a batch of 2 (the smoke uses
run S's first DiT call, run A9's CFG pair, which needs runs A9 and S).
Then four ranks on the one card over gloo (``chip_smoke.py --run-t-rank
DIR T_DIR``) run T1-T5, and their readings are held to the smoke's checks.
Its seconds are not a speed figure: the ranks time-share the card and
stage their hops through host memory.
"""

import dataclasses
import gc
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def save_forward(t_dir: Path, out_dir: Path) -> None:
    """A DiT call's inputs from run T's two samples: their gt latents
    noised at t = 500, prompts, inpaint and reference latents, the rotary
    tables at 384 x 672."""
    import numpy as np
    import torch

    from trajectorycrafter_tpu_torch.ops.rope import rope_for_sample
    from trajectorycrafter_tpu_torch.training.data import LatentsDataset

    data = LatentsDataset(str(t_dir / "latents"))
    batch = {k: np.stack([data[i][k] for i in range(len(data))]) for k in data[0]}
    bf16 = lambda x: torch.from_numpy(x).bfloat16()
    gen = torch.Generator().manual_seed(0)
    gt = torch.from_numpy(batch["gt_latents"])
    noisy = 0.5 * gt + 0.85 * torch.randn(gt.shape, generator=gen)
    frames = gt.shape[1]
    rope = tuple(torch.from_numpy(np.asarray(t, np.float32))
                 for t in rope_for_sample(64, 384, 672, frames))
    torch.save({"args": [noisy.bfloat16(), bf16(batch["prompt_embeds"]),
                         torch.full((gt.shape[0],), 500.0)],
                "kwargs": {"inpaint_latents": bf16(batch["inpaint_latents"]),
                           "cross_latents": bf16(batch["ref_latents"]),
                           "image_rotary_emb": rope},
                "output": torch.zeros(0)}, out_dir / "forward.pt")


def main() -> None:
    os.chdir(REPO)
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke as smoke
    from trajectorycrafter_tpu_torch.cli import parse_config
    from trajectorycrafter_tpu_torch.orchestrator import (
        TrajCrafter,
        build_dit,
        build_full_scale_models,
        full_scale_dit,
    )

    smoke.phase_device()
    smoke.run_phase("build", smoke.phase_build)
    cfg = parse_config(smoke.MAIN_ARGV)
    cfg = dataclasses.replace(cfg, diffusion=dataclasses.replace(cfg.diffusion, quant="none"))
    data_root = Path(tempfile.mkdtemp(prefix="run_t_data_"))
    t_dir = Path(tempfile.mkdtemp(prefix="run_t_"))
    out_dir = Path(tempfile.mkdtemp(prefix="run_t_out_"))
    try:
        tc = TrajCrafter(cfg, models=build_full_scale_models(cfg, "cuda"))
        scenes = smoke.write_sceneflow_tree(data_root / "sceneflow", smoke.TRAIN_SCENES,
                                            smoke.TRAIN_FRAMES)
        smoke.run_phase("5e run T's twin", smoke._run_t_twin, tc, data_root, t_dir, scenes)
        del tc
        gc.collect()
        torch.cuda.empty_cache()
        save_forward(t_dir, out_dir)
        text, rc, seconds = smoke._torchrun(["--run-t-rank", str(out_dir), str(t_dir)])
        results = [json.loads(p.read_text()) if p.is_file() else {"error": "no readings"}
                   for p in (out_dir / f"run_t_rank{r}.json" for r in range(4))]
        errors = [r["error"] for r in results if "error" in r]
        if rc or errors:
            for line in text.splitlines()[-60:]:
                smoke.log("  run T | " + line)
            raise AssertionError(f"run T: torchrun rc {rc}; {json.dumps(errors)[-4000:]}")
        smoke.log(f"run T: {seconds:.1f} s wall for torchrun")
        dit = build_dit(full_scale_dit, "cuda", torch.bfloat16, 1, "int8")
        args, kwargs, _ = smoke._saved_forward(out_dir)
        reference = {}
        with torch.no_grad():
            reference["hidden"], reference["encoder"] = dit.run_blocks(
                *smoke._blocks_inputs(dit, args, kwargs))
        del dit
        smoke._run_t_check(out_dir, t_dir, results, reference)
        smoke.log(f"phases {smoke.PHASE_SECONDS}")
    finally:
        for d in (data_root, t_dir, out_dir):
            shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    main()
