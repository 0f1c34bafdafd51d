#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, each of which raises on failure (the script then exits nonzero and
prints no result line):
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile every kernel of the main path from csrc/ (nvcc, sm_90a),
     one nvcc per source, all started together;
  3. kernel vs plain: each kernel against its plain PyTorch version on the
     card, at the shapes the main path gives it, within a stated tolerance
     that must also reject two planted faults; then kernels and plain
     version timed at the DiT's and the depth UNet's full attention shapes;
  4. main path: ``TrajCrafter.infer_gradual`` at the deployed widths (random
     weights from a seed; T5-XXL prompt encode; the DepthCrafter depth
     stage, 5 Euler steps over one 49-frame window at 576x1024; 2 denoise
     steps, diffusion at 384x672), once with the default depth attention
     (``flash_stock``) and once with ``TRAJCRAFTER_DEPTH_ATTN=flash_max``,
     counting each kernel's launches per stage; then the whole DiT and the
     whole depth UNet at full width on a small input, kernel against the
     plain attention;
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Kernel vs plain: ``attention_error`` (trajectorycrafter_tpu_torch/ops/
# attention.py) -- per element |out - ref| <= 2^-6 (|ref| + P|v|), with P|v|
# the attention-weighted |v|, and per row a relative L2 error <= 2^-6; the
# reasons are stated there.  The two-pass kernel is held to the plain
# version of its own function (``maxpass_plain_inputs``: q * scale * log2 e
# rounded to bf16 first, as the TPU kernel it replaces does).  Each case
# also checks that the bound rejects two planted faults: a row sum off by
# 10%, and the last quarter of the key tiles skipped (the kernel, both
# passes of the two-pass one, run on the first three quarters of k and v).

# Whole DiT / whole depth UNet, kernel vs plain attention, on a small input:
# dozens of blocks of bf16 arithmetic carry the per-call bf16 differences
# forward; relative to the output's largest magnitude.
DIT_REL_TOL = 5e-2
UNET_REL_TOL = 5e-2

MAIN_ARGV = [
    "--video_path", "test/videos/synth.mp4", "--camera", "traj",
    "--traj_txt", "test/trajs/loop1.txt", "--mode", "gradual",
    "--prompt", "a scene", "--quant", "none", "--diffusion_inference_steps", "2",
    "--out_dir", "build/chip_smoke", "--exp_name", "smoke",
]
DIT_LAYERS, PERCEIVER_INTERVAL = 42, 2
# Depth-UNet attention layers that launch a kernel per forward at 576x1024
# (latents 72 x 128): the spatial self-attention where s * s_kv >= 2^20, i.e.
# the 9,216-token level (down 2 + up 3 layers) and the 2,304-token level
# (down 2 + up 3); tests/test_torch_attention.py derives it from the module.
DEPTH_KERNEL_LAUNCHES_PER_FORWARD = 10
MP4S = ("input.mp4", "render.mp4", "mask.mp4", "gen.mp4", "viz.mp4")
KERNEL_SOURCES = ("flash_attention.cu", "flash_maxpass.cu")
# depth attention shapes (B = frames, H, S, D) at 576x1024 and 49 frames
DEPTH_SHAPES = {"depth_9216": (49, 5, 9216, 64), "depth_2304": (49, 10, 2304, 64)}


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

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        infos = list(pool.map(kernels.build_library, KERNEL_SOURCES))
    for info in infos:
        log(f"built {info['path'].name} in {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())
    log(f"kernel builds: {time.perf_counter() - t0:.2f} s wall")


def check_kernel_case(kernel, name, b, h, sq, skv, d, gain, randn) -> float:
    """One kernel at one shape against its plain version, and the two planted
    faults against the same bound; returns the max abs error."""
    import torch

    from trajectorycrafter_tpu_torch.ops.attention import (
        ATTN_ROW_TOL,
        attention_error,
        kernel_error,
    )
    from trajectorycrafter_tpu_torch.ops.kernels import FLASH_KEY_TILE

    q = (randn(b, sq, h, d) * gain).bfloat16()
    k, v = randn(b, skv, h, d).bfloat16(), randn(b, skv, h, d).bfloat16()
    scale = d ** -0.5
    out = kernel(q, k, v, scale)
    torch.cuda.synchronize()
    sound = kernel_error(kernel, out, q, k, v, scale)
    tiles = -(-skv // FLASH_KEY_TILE)
    keep = (tiles - tiles // 4) * FLASH_KEY_TILE
    faults = {
        "row_sum_x1.1": kernel_error(kernel, (out.float() / 1.1).bfloat16(), q, k, v, scale),
        "last_quarter_of_key_tiles_skipped": kernel_error(
            kernel, kernel(q, k[:, :keep], v[:, :keep], scale), q, k, v, scale),
    }
    label = f"{kernel.__name__} {name} {(b, h, sq, skv, d)} q x {gain:g}"
    log(f"{label}: max abs err {sound['max_abs_err']:.3e}, "
        f"max row rel err {sound['max_row_rel_err']:.3e} (limit {ATTN_ROW_TOL:.3e}), "
        f"max elementwise err / bound {sound['max_elem_ratio']:.3e} (limit 1)")
    if kernel.__name__ == "flash_maxpass":
        exact = attention_error(out, q, k, v, scale)
        log(f"  against the unrounded attention (information): max row rel err "
            f"{exact['max_row_rel_err']:.3e}, max elementwise err / bound "
            f"{exact['max_elem_ratio']:.3e}")
    for fault, r in faults.items():
        log(f"  planted fault {fault}: max row rel err {r['max_row_rel_err']:.3e}, "
            f"max elementwise err / bound {r['max_elem_ratio']:.3e} -> "
            f"{'rejected' if not r['ok'] else 'ACCEPTED'}")
    if not sound["ok"]:
        raise AssertionError(f"{label} disagrees with its plain version: {sound}")
    accepted = [fault for fault, r in faults.items() if r["ok"]]
    if accepted:
        raise AssertionError(f"the tolerance at {label} accepts planted faults {accepted}")
    return sound["max_abs_err"]


def phase_kernels():
    """Each kernel vs the plain version at the main path's shapes, then timed."""
    import torch

    from trajectorycrafter_tpu_torch.ops.attention import attention_reference
    from trajectorycrafter_tpu_torch.ops.kernels import flash_attention, flash_maxpass

    gen = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    # (kernel, name, B, H, Sq, Skv, D, q gain): the DiT self-attention with
    # heads cut so the plain version fits beside it; the Perceiver's shape,
    # with scores unbounded as it has no QK-norm; a small ragged shape; the
    # depth UNet's two kernel shapes cut in frames, peaked (no QK-norm either)
    cases = [
        (flash_attention, "dit_self_heads8", 1, 8, 13330, 13330, 64, 1.0),
        (flash_attention, "perceiver_cross", 2, 16, 13104, 3024, 128, 4.0),
        (flash_attention, "ragged_small", 1, 2, 1000, 1000, 64, 1.0),
    ]
    for kernel in (flash_attention, flash_maxpass):
        cases += [
            (kernel, "depth_9216_frames2", 2, 5, 9216, 9216, 64, 4.0),
            (kernel, "depth_2304_frames8", 8, 10, 2304, 2304, 64, 4.0),
        ]
    cases.append((flash_maxpass, "ragged_small", 1, 2, 1000, 777, 64, 4.0))
    max_err = {"flash_attention": 0.0, "flash_maxpass": 0.0}
    for kernel, *case in cases:
        err = check_kernel_case(kernel, *case, randn)
        max_err[kernel.__name__] = max(max_err[kernel.__name__], err)
        torch.cuda.empty_cache()

    timing = {}
    # the DiT shape, in turns: plain, kernel, kernel, plain
    b, h, s, d = 2, 48, 13330, 64
    q, k, v = (randn(b, s, h, d).bfloat16() for _ in range(3))
    kernel = lambda: flash_attention(q, k, v, d ** -0.5)
    plain = lambda: attention_reference(q, k, v, d ** -0.5)
    p1, k1, k2, p2 = cuda_ms(plain, 3), cuda_ms(kernel, 10), cuda_ms(kernel, 10), cuda_ms(plain, 3)
    flop = 4 * b * h * s * s * d
    timing["dit"] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2}
    log(f"dit_self_full {(b, h, s, s, d)}: flash_attention {k1:.2f} / {k2:.2f} ms "
        f"({flop / timing['dit']['ms'] / 1e9:.1f} TFLOP/s), plain {p1:.2f} / {p2:.2f} ms")
    del q, k, v
    torch.cuda.empty_cache()

    # the depth UNet's level-0 shape at 49 frames, in turns: plain, K4, K4b,
    # K4b, K4, plain (the plain version is the same function for both)
    b, h, s, d = DEPTH_SHAPES["depth_9216"]
    q = (randn(b, s, h, d) * 4.0).bfloat16()
    k, v = randn(b, s, h, d).bfloat16(), randn(b, s, h, d).bfloat16()
    plain = lambda: attention_reference(q, k, v, d ** -0.5)
    stock = lambda: flash_attention(q, k, v, d ** -0.5)
    maxpass = lambda: flash_maxpass(q, k, v, d ** -0.5)
    p1, s1, m1 = cuda_ms(plain, 2), cuda_ms(stock, 5), cuda_ms(maxpass, 5)
    m2, s2, p2 = cuda_ms(maxpass, 5), cuda_ms(stock, 5), cuda_ms(plain, 2)
    flop = 4 * b * h * s * s * d
    timing["depth"] = {"flash_attention": (s1 + s2) / 2, "flash_maxpass": (m1 + m2) / 2,
                       "plain_ms": (p1 + p2) / 2}
    log(f"depth_9216_full {(b, h, s, s, d)}: flash_attention {s1:.2f} / {s2:.2f} ms "
        f"({flop / timing['depth']['flash_attention'] / 1e9:.1f} TFLOP/s), flash_maxpass "
        f"{m1:.2f} / {m2:.2f} ms ({1.5 * flop / timing['depth']['flash_maxpass'] / 1e9:.1f} "
        f"TFLOP/s of its 1.5x products), plain {p1:.2f} / {p2:.2f} ms")
    del q, k, v
    torch.cuda.empty_cache()
    return max_err, timing


def run_gradual(tc, depth_attn: str) -> dict:
    """One ``infer_gradual`` with ``TRAJCRAFTER_DEPTH_ATTN=depth_attn``; the
    kernel launches of the run, split into the depth stage and the rest (the
    denoise: no other stage launches a kernel)."""
    import numpy as np
    import torch

    from trajectorycrafter_tpu_torch.ops.kernels import flash_attention, flash_maxpass

    kernels = (flash_attention, flash_maxpass)
    depth_infer = tc.models.depth_infer
    seen = {}

    def counted_depth(*args, **kwargs):
        before = [kern.launches for kern in kernels]
        seen["depth"] = depth_infer(*args, **kwargs)
        seen["depth_launches"] = {kern.__name__: kern.launches - b0
                                  for kern, b0 in zip(kernels, before)}
        return seen["depth"]

    os.environ["TRAJCRAFTER_DEPTH_ATTN"] = depth_attn
    tc.models.depth_infer = counted_depth
    tc.timer.seconds.clear()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.launches = 0
    t0 = time.perf_counter()
    try:
        gen = tc.infer_gradual()
        torch.cuda.synchronize()
    finally:
        tc.models.depth_infer = depth_infer
        del os.environ["TRAJCRAFTER_DEPTH_ATTN"]
    total = time.perf_counter() - t0
    launches = {kern.__name__: kern.launches for kern in kernels}
    log(f"infer_gradual, depth attention {depth_attn}: {total:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for stage, sec in tc.timer.seconds.items():
        log(f"  stage {stage}: {sec:.3f} s")
    per_path = {"depth": seen["depth_launches"],
                "denoise": {n: launches[n] - seen["depth_launches"][n] for n in launches}}
    log(f"  kernel launches per stage: {json.dumps(per_path)}")

    cfg = tc.cfg
    depth = seen["depth"]
    if depth.shape != (cfg.video_length, 1, *cfg.warp_size):
        raise AssertionError(f"depth shape {depth.shape}")
    if not np.isfinite(depth).all() or depth.min() < cfg.render.near or \
            depth.max() > cfg.render.far or depth.max() == depth.min():
        raise AssertionError(f"depth is not finite, non-constant, in [near, far]: "
                             f"[{depth.min()}, {depth.max()}]")
    log(f"  depth {depth.shape} in [{depth.min():.4f}, {depth.max():.4f}], "
        f"median {np.median(depth):.4f}")
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
    log(f"  gen {gen.shape} in [{gen.min():.4f}, {gen.max():.4f}], std {gen.std():.4f}; "
        f"five mp4s in {cfg.save_dir}")
    return {"seconds": total, "per_path": per_path, "depth": depth}


def _expected_launches(cfg, kernel_name: str, depth_kernel: str) -> dict:
    from trajectorycrafter_tpu_torch.pipelines.depth import window_starts

    windows = len(window_starts(cfg.video_length, cfg.depth.window_size, cfg.depth.overlap))
    depth = cfg.depth.num_inference_steps * windows * DEPTH_KERNEL_LAUNCHES_PER_FORWARD
    denoise = cfg.diffusion.num_inference_steps * (DIT_LAYERS + DIT_LAYERS // PERCEIVER_INTERVAL)
    return {"depth": depth if kernel_name == depth_kernel else 0,
            "denoise": denoise if kernel_name == "flash_attention" else 0}


def phase_main_path():
    import numpy as np
    import torch

    from trajectorycrafter_tpu_torch.cli import parse_config
    from trajectorycrafter_tpu_torch.orchestrator import TrajCrafter, build_full_scale_models

    cfg = parse_config(MAIN_ARGV)
    t0 = time.perf_counter()
    tc = TrajCrafter(cfg, models=build_full_scale_models(cfg, "cuda"))
    torch.cuda.synchronize()
    log(f"built the full-scale models in {time.perf_counter() - t0:.2f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB of parameters)")

    pe, ne = tc.models.encode_prompt("a scene", cfg.diffusion.negative_prompt)
    if pe.shape != (1, 226, 4096) or not torch.isfinite(pe).all() or torch.equal(pe, ne):
        raise AssertionError(f"T5 prompt embeddings: shape {tuple(pe.shape)}, "
                             f"finite {bool(torch.isfinite(pe).all())}")

    runs = {}
    for depth_kernel, depth_attn in (("flash_attention", "flash_stock"),
                                     ("flash_maxpass", "flash_max")):
        run = runs[depth_attn] = run_gradual(tc, depth_attn)
        for name in ("flash_attention", "flash_maxpass"):
            got = {path: run["per_path"][path][name] for path in ("depth", "denoise")}
            want = _expected_launches(cfg, name, depth_kernel)
            if got != want:
                raise AssertionError(f"{name} launched {got} times per stage with depth "
                                     f"attention {depth_attn}, expected {want}")
    rel = np.abs(np.log(runs["flash_max"]["depth"] / runs["flash_stock"]["depth"]))
    log(f"depth of the two runs (information): median |log ratio| {np.median(rel):.3e}, "
        f"max {rel.max():.3e}")
    return tc, runs


def phase_whole_models(tc):
    """The whole DiT and the whole depth UNet at full width on small inputs,
    kernel against the plain attention."""
    import torch

    from trajectorycrafter_tpu_torch.ops.kernels import flash_attention, flash_maxpass

    def set_impl(model, impl):
        for m in model.modules():
            if hasattr(m, "attention_impl"):
                m.attention_impl = impl

    gen_in = torch.Generator(device="cuda").manual_seed(1)
    randn = lambda *shape: torch.randn(shape, generator=gen_in, device="cuda").bfloat16()

    dit = tc.models.pipeline.transformer
    b, f, h, w = 2, 3, 8, 12
    args = (randn(b, f, h, w, 16), randn(b, 226, 4096), torch.full((b,), 500.0, device="cuda"))
    kwargs = dict(inpaint_latents=randn(b, f, h, w, 17), cross_latents=randn(b, 2, h, w, 16))
    with torch.no_grad():
        out_kernel = dit(*args, **kwargs).float()
        set_impl(dit, "reference")
        out_plain = dit(*args, **kwargs).float()
        set_impl(dit, "auto")
    rel = ((out_kernel - out_plain).abs().max() / out_plain.abs().max()).item()
    log(f"DiT {DIT_LAYERS} layers on {(b, f, h, w)}: kernel vs plain attention, "
        f"max rel err {rel:.3e} (limit {DIT_REL_TOL})")
    if not torch.isfinite(out_kernel).all() or rel > DIT_REL_TOL:
        raise AssertionError(f"DiT output with the kernel disagrees: rel err {rel:.3e}")

    unet = tc.models.depth_infer.__self__.pipe.unet
    f, h, w = 2, 72, 128
    args = (randn(1, f, h, w, 8), torch.full((1,), 1.6, device="cuda"),
            randn(1, f, 1, 1024), torch.tensor([[6.0, 127.0, 0.02]], device="cuda"))
    outs = {}
    with torch.no_grad():
        for impl in ("flash_stock", "flash_max", "reference"):
            set_impl(unet, impl)
            before = flash_attention.launches + flash_maxpass.launches
            outs[impl] = unet(*args).float()
            torch.cuda.synchronize()
            launches = flash_attention.launches + flash_maxpass.launches - before
            expected = 0 if impl == "reference" else DEPTH_KERNEL_LAUNCHES_PER_FORWARD
            if launches != expected:
                raise AssertionError(f"depth UNet with {impl}: {launches} kernel launches, "
                                     f"expected {expected}")
        set_impl(unet, "auto")
    for impl in ("flash_stock", "flash_max"):
        rel = ((outs[impl] - outs["reference"]).abs().max()
               / outs["reference"].abs().max()).item()
        log(f"depth UNet on {(1, f, h, w)}, attention {impl} vs plain: max rel err "
            f"{rel:.3e} (limit {UNET_REL_TOL})")
        if not torch.isfinite(outs[impl]).all() or rel > UNET_REL_TOL:
            raise AssertionError(f"depth UNet output with {impl} disagrees: {rel:.3e}")


def main() -> None:
    os.chdir(REPO)
    sys.path.insert(0, str(REPO))
    phase_device()
    phase_build()
    max_err, timing = phase_kernels()
    tc, runs = phase_main_path()
    phase_whole_models(tc)

    import torch

    stock = runs["flash_stock"]["per_path"]
    maxpass = runs["flash_max"]["per_path"]
    src = "trajectorycrafter_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        {"name": "flash_attention", "route": "cuda", "source": src + "flash_attention.cu",
         "replaces": "trajectorycrafter_tpu/ops/pallas/flash_exp2.py:212",
         "also_replaces": "trajectorycrafter_tpu/ops/attention.py:39",
         "launches": sum(stock[p]["flash_attention"] for p in stock),
         "launches_per_path": {p: stock[p]["flash_attention"] for p in stock},
         "max_abs_err": max_err["flash_attention"],
         "ms": timing["dit"]["ms"], "plain_ms": timing["dit"]["plain_ms"],
         "shape": "(2, 48, 13330, 13330, 64)",
         "depth_ms": timing["depth"]["flash_attention"],
         "depth_plain_ms": timing["depth"]["plain_ms"],
         "depth_shape": "(49, 5, 9216, 9216, 64)"},
        {"name": "flash_maxpass", "route": "cuda", "source": src + "flash_maxpass.cu",
         "replaces": "trajectorycrafter_tpu/ops/pallas/flash_max.py:110",
         "launches": sum(maxpass[p]["flash_maxpass"] for p in maxpass),
         "launches_per_path": {f"{p} (TRAJCRAFTER_DEPTH_ATTN=flash_max)":
                               maxpass[p]["flash_maxpass"] for p in maxpass},
         "max_abs_err": max_err["flash_maxpass"],
         "ms": timing["depth"]["flash_maxpass"], "plain_ms": timing["depth"]["plain_ms"],
         "shape": "(49, 5, 9216, 9216, 64)"},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
