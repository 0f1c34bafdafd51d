#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, each of which raises on failure (the script then exits nonzero and
prints no result line):
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile every kernel of the main path from csrc/ (nvcc, sm_90a);
  3. kernel vs plain: each kernel against its plain PyTorch version on the
     card, at the shapes the main path gives it, within a stated tolerance;
     then both timed at the DiT's full attention shape;
  4. main path: ``TrajCrafter.infer_gradual`` at the deployed widths (random
     weights from a seed, 2 denoise steps, 49 frames, diffusion at 384x672),
     counting the kernel's launches; then the whole DiT at full width on a
     small input, kernel against the plain attention;
  5. a JSON line of kernel results, and a final JSON line with the device.

Imports nothing of JAX and no module of the JAX package itself; the port
underneath reuses the JAX package's JAX-free config, CLI parser and video
I/O modules.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Kernel vs plain: ``attention_error`` (trajectorycrafter_tpu_torch/ops/
# attention.py) -- per element |out - ref| <= 2^-6 (|ref| + P|v|), with P|v|
# the attention-weighted |v|, and per row a relative L2 error <= 2^-6; the
# reasons are stated there.  Each case also checks that the bound rejects two
# planted faults: a row sum off by 10%, and the last quarter of the key tiles
# skipped (the kernel run on the first three quarters of k and v).

# Whole DiT, kernel vs plain attention, on a small input: 42 blocks of bf16
# arithmetic carry the per-call bf16 differences forward; relative to the
# output's largest magnitude.
DIT_REL_TOL = 5e-2

MAIN_ARGV = [
    "--video_path", "test/videos/synth.mp4", "--camera", "traj",
    "--traj_txt", "test/trajs/loop1.txt", "--mode", "gradual",
    "--prompt", "a scene", "--quant", "none", "--diffusion_inference_steps", "2",
    "--out_dir", "build/chip_smoke", "--exp_name", "smoke",
]
DIT_LAYERS, PERCEIVER_INTERVAL = 42, 2
MP4S = ("input.mp4", "render.mp4", "mask.mp4", "gen.mp4", "viz.mp4")


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this "
                         "script needs a CUDA card")
    if not (REPO / "trajectorycrafter_tpu_torch").is_dir():
        raise SystemExit("chip_smoke: run it from a checkout of the repository")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), using {torch.cuda.get_device_name(0)}")
    return smi


def phase_build():
    from trajectorycrafter_tpu_torch.ops import kernels

    info = kernels.build_library("flash_attention.cu")
    log(f"built {info['path'].name} in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())


def phase_kernels():
    """flash_attention vs attention_reference at the main path's shapes."""
    import torch

    from trajectorycrafter_tpu_torch.ops.attention import (
        ATTN_ROW_TOL,
        attention_error,
        attention_reference,
    )
    from trajectorycrafter_tpu_torch.ops.kernels import FLASH_KEY_TILE, flash_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    cases = [
        # (name, B, H, Sq, Skv, D, q gain): DiT self-attention with heads cut so
        # the plain version fits beside it; the Perceiver's shape, with scores
        # unbounded as it has no QK-norm; a small ragged shape
        ("dit_self_heads8", 1, 8, 13330, 13330, 64, 1.0),
        ("perceiver_cross", 2, 16, 13104, 3024, 128, 4.0),
        ("ragged_small", 1, 2, 1000, 1000, 64, 1.0),
    ]
    max_err = 0.0
    for name, b, h, sq, skv, d, gain in cases:
        q = (randn(b, sq, h, d) * gain).bfloat16()
        k, v = randn(b, skv, h, d).bfloat16(), randn(b, skv, h, d).bfloat16()
        scale = d ** -0.5
        out = flash_attention(q, k, v, scale)
        torch.cuda.synchronize()
        sound = attention_error(out, q, k, v, scale)
        tiles = -(-skv // FLASH_KEY_TILE)
        keep = (tiles - tiles // 4) * FLASH_KEY_TILE
        faults = {
            "row_sum_x1.1": attention_error((out.float() / 1.1).bfloat16(), q, k, v, scale),
            "last_quarter_of_key_tiles_skipped": attention_error(
                flash_attention(q, k[:, :keep], v[:, :keep], scale), q, k, v, scale),
        }
        log(f"{name} {(b, h, sq, skv, d)}: max abs err {sound['max_abs_err']:.3e}, "
            f"max row rel err {sound['max_row_rel_err']:.3e} (limit {ATTN_ROW_TOL:.3e}), "
            f"max elementwise err / bound {sound['max_elem_ratio']:.3e} (limit 1)")
        for fault, r in faults.items():
            log(f"  planted fault {fault}: max row rel err {r['max_row_rel_err']:.3e}, "
                f"max elementwise err / bound {r['max_elem_ratio']:.3e} -> "
                f"{'rejected' if not r['ok'] else 'ACCEPTED'}")
        if not sound["ok"]:
            raise AssertionError(f"flash_attention disagrees with attention_reference at "
                                 f"{name}: {sound}")
        accepted = [fault for fault, r in faults.items() if r["ok"]]
        if accepted:
            raise AssertionError(f"the tolerance at {name} accepts planted faults {accepted}")
        max_err = max(max_err, sound["max_abs_err"])
        del q, k, v, out

    # times at the full DiT shape, in turns: plain, kernel, kernel, plain
    b, h, s, d = 2, 48, 13330, 64
    q, k, v = (randn(b, s, h, d).bfloat16() for _ in range(3))
    kernel = lambda: flash_attention(q, k, v, d ** -0.5)
    plain = lambda: attention_reference(q, k, v, d ** -0.5)
    p1, k1, k2, p2 = cuda_ms(plain, 3), cuda_ms(kernel, 10), cuda_ms(kernel, 10), cuda_ms(plain, 3)
    kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    flop = 4 * b * h * s * s * d
    log(f"dit_self_full {(b, h, s, s, d)}: kernel {k1:.2f} / {k2:.2f} ms "
        f"({flop / kernel_ms / 1e9:.1f} TFLOP/s), plain {p1:.2f} / {p2:.2f} ms")
    del q, k, v
    torch.cuda.empty_cache()
    return {"max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms}


def phase_main_path():
    import numpy as np
    import torch

    from trajectorycrafter_tpu_torch.cli import parse_config
    from trajectorycrafter_tpu_torch.ops.kernels import flash_attention
    from trajectorycrafter_tpu_torch.orchestrator import TrajCrafter, build_full_scale_models

    cfg = parse_config(MAIN_ARGV)
    t0 = time.perf_counter()
    tc = TrajCrafter(cfg, models=build_full_scale_models(cfg, "cuda"))
    torch.cuda.synchronize()
    log(f"built the full-scale models in {time.perf_counter() - t0:.2f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB of parameters)")

    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    gen = tc.infer_gradual()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = flash_attention.launches
    for stage, sec in tc.timer.seconds.items():
        log(f"stage {stage}: {sec:.3f} s")
    log(f"infer_gradual: {total:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    steps = cfg.diffusion.num_inference_steps
    expected = steps * (DIT_LAYERS + DIT_LAYERS // PERCEIVER_INTERVAL)
    if launches != expected:
        raise AssertionError(f"flash_attention launched {launches} times on the main "
                             f"path, expected {expected}")
    for name in MP4S:
        path = Path(cfg.save_dir) / name
        if not path.is_file() or path.stat().st_size == 0:
            raise AssertionError(f"missing or empty output {path}")
    expected_shape = (cfg.video_length, *cfg.diffusion.sample_size, 3)
    if gen.shape != expected_shape:
        raise AssertionError(f"gen shape {gen.shape}, expected {expected_shape}")
    if not np.isfinite(gen).all() or gen.min() < 0.0 or gen.max() > 1.0:
        raise AssertionError("gen is not finite in [0, 1]")
    if gen.max() == gen.min():
        raise AssertionError("gen is constant")
    log(f"gen {gen.shape} in [{gen.min():.4f}, {gen.max():.4f}], std {gen.std():.4f}; "
        f"{launches} flash_attention launches; five mp4s in {cfg.save_dir}")

    # the whole DiT on a small input: kernel against the plain attention
    dit = tc.models.pipeline.transformer
    gen_in = torch.Generator(device="cuda").manual_seed(1)
    randn = lambda *shape: torch.randn(shape, generator=gen_in, device="cuda").bfloat16()
    b, f, h, w = 2, 3, 8, 12
    args = (randn(b, f, h, w, 16), randn(b, 226, 4096), torch.full((b,), 500.0, device="cuda"))
    kwargs = dict(inpaint_latents=randn(b, f, h, w, 17), cross_latents=randn(b, 2, h, w, 16))
    with torch.no_grad():
        out_kernel = dit(*args, **kwargs).float()
        for m in dit.modules():
            if hasattr(m, "attention_impl"):
                m.attention_impl = "reference"
        out_plain = dit(*args, **kwargs).float()
    rel = ((out_kernel - out_plain).abs().max() / out_plain.abs().max()).item()
    log(f"DiT {DIT_LAYERS} layers on {(b, f, h, w)}: kernel vs plain attention, "
        f"max rel err {rel:.3e} (limit {DIT_REL_TOL})")
    if not torch.isfinite(out_kernel).all() or rel > DIT_REL_TOL:
        raise AssertionError(f"DiT output with the kernel disagrees: rel err {rel:.3e}")
    return launches


def main() -> None:
    os.chdir(REPO)
    sys.path.insert(0, str(REPO))
    phase_device()
    phase_build()
    timing = phase_kernels()
    launches = phase_main_path()

    import torch

    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "trajectorycrafter_tpu_torch/csrc/flash_attention.cu",
        "replaces": "trajectorycrafter_tpu/ops/pallas/flash_exp2.py:212",
        "launches": launches, **timing,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
