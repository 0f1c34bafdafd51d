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
     that must also reject planted faults; then each kernel, its plain
     version and (for the int8 GEMMs) the bf16 ``F.linear`` they replace,
     timed at full shape, in turns;
  4. main path: ``TrajCrafter.infer_gradual`` at the deployed widths (random
     weights from a seed; T5-XXL prompt encode; the DepthCrafter depth
     stage, 5 Euler steps over one 49-frame window at 576x1024; 2 denoise
     steps, diffusion at 384x672), three times on one set of weights:
     A, the default: int8 DiT (``--quant int8``, unfused feed-forward),
       bf16 depth UNet, depth attention ``flash_stock``;
     B: int8 DiT with the fused int8 feed-forward, ``--quant_depth int8``,
       ``TRAJCRAFTER_DEPTH_ATTN=flash_max``;
     C: ``--quant none``, the bf16 DiT and UNet, ``flash_stock``;
     the int8 models are quantizations of the bf16 models' own weights.
     Each kernel's launches are counted per stage and held to counts derived
     from the modules; the PSNR and SSIM of A's video against C's are
     printed as information;
  5. whole models: the bf16 and int8 DiT (unfused and fused) and the bf16
     and int8 depth UNet at full width on small inputs, kernels against the
     plain versions;
  6. a JSON line of kernel results, and a final JSON line with the device.

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

# The int8 kernels: ``int8_quantize_rows`` bit-equal to its plain version;
# ``int8_gemm`` and ``int8_gemm_gscale`` within one bf16 ulp of theirs
# (``gemm_error``), ``int8_gemm_gelu_quant`` within ``gelu_quant_error``
# (trajectorycrafter_tpu_torch/ops/int8_matmul.py states the reasons).  At
# the feed-forward shapes each bound must reject two planted faults, made
# with the sound kernels: a K step of 32 skipped (the last 32 of K zeroed)
# and the bias dropped or the column scales shifted by one (K2b, K3b); a
# group of 512 columns in place of 1,024 and the gelu dropped (K3a).

# Whole DiT / whole depth UNet, kernels vs plain versions, on a small input:
# dozens of blocks of bf16 arithmetic carry the per-call bf16 differences of
# the attention kernels forward (and int8 codes flip where they move a value
# across a rounding boundary); relative to the output's largest magnitude.
DIT_REL_TOL = 5e-2
UNET_REL_TOL = 5e-2

MAIN_ARGV = [
    "--video_path", "test/videos/synth.mp4", "--camera", "traj",
    "--traj_txt", "test/trajs/loop1.txt", "--mode", "gradual",
    "--prompt", "a scene", "--diffusion_inference_steps", "2",
    "--out_dir", "build/chip_smoke", "--exp_name", "smoke",
]
DIT_LAYERS, PERCEIVER_INTERVAL = 42, 2
# Depth-UNet attention layers that launch a kernel per forward at 576x1024
# (latents 72 x 128): the spatial self-attention where s * s_kv >= 2^20, i.e.
# the 9,216-token level (down 2 + up 3 layers) and the 2,304-token level
# (down 2 + up 3); tests/test_torch_attention.py derives it from the module.
DEPTH_KERNEL_LAUNCHES_PER_FORWARD = 10
MP4S = ("input.mp4", "render.mp4", "mask.mp4", "gen.mp4", "viz.mp4")
KERNEL_SOURCES = ("flash_attention.cu", "flash_maxpass.cu", "int8_quantize_rows.cu",
                  "int8_gemm.cu", "int8_gemm_gelu_quant.cu", "int8_gemm_gscale.cu")
KERNELS = ("flash_attention", "flash_maxpass", "int8_quantize_rows", "int8_gemm",
           "int8_gemm_gelu_quant", "int8_gemm_gscale")
# depth attention shapes (B = frames, H, S, D) at 576x1024 and 49 frames
DEPTH_SHAPES = {"depth_9216": (49, 5, 9216, 64), "depth_2304": (49, 10, 2304, 64)}
# int8 GEMMs of the main path, (M, K, N, bias): the DiT's blocks at M = 2 x
# 13,330 tokens (the CFG pair, text + video) -- q/k/v/out and the feed-
# forward; its Perceivers (queries from 2 x 13,104 video tokens, keys and
# values from 2 x 3,024 reference tokens, no biases); the depth UNet's
# level 0 under --quant_depth int8 (49 frames x 9,216 tokens, 320 channels:
# attention/proj and the GEGLU's first projection); a small ragged M
INT8_SHAPES = {
    "dit_qkvo": (26660, 3072, 3072, True),
    "dit_ff1": (26660, 3072, 12288, True),
    "dit_ff2": (26660, 12288, 3072, True),
    "perceiver_to_q": (26208, 3072, 2048, False),
    "perceiver_to_kv": (6048, 3072, 4096, False),
    "perceiver_to_out": (26208, 2048, 3072, False),
    "depth_320": (451584, 320, 320, True),
    "depth_geglu": (451584, 320, 2560, True),
    "ragged_small": (70, 256, 512, True),
}
TPU_KERNELS = {
    "flash_attention": "trajectorycrafter_tpu/ops/pallas/flash_exp2.py:212",
    "flash_maxpass": "trajectorycrafter_tpu/ops/pallas/flash_max.py:110",
    "int8_quantize_rows": "trajectorycrafter_tpu/ops/pallas/int8_matmul.py:363",
    "int8_gemm": "trajectorycrafter_tpu/ops/pallas/int8_matmul.py:62",
    "int8_gemm_gelu_quant": "trajectorycrafter_tpu/ops/pallas/int8_matmul.py:154",
    "int8_gemm_gscale": "trajectorycrafter_tpu/ops/pallas/int8_matmul.py:238",
}


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


def _readings(r: dict) -> str:
    return ", ".join(f"{k} {v:.3e}" for k, v in r.items() if k != "ok")


def check_readings(label: str, readings: dict, faults: dict) -> None:
    """Log a kernel's readings and its planted faults' against one bound;
    raise if the kernel fails it or the bound accepts a fault."""
    log(f"{label}: {_readings(readings)}")
    for fault, r in faults.items():
        log(f"  planted fault {fault}: {_readings(r)} -> "
            f"{'rejected' if not r['ok'] else 'ACCEPTED'}")
    if not readings["ok"]:
        raise AssertionError(f"{label} disagrees with its plain version: {readings}")
    accepted = [fault for fault, r in faults.items() if r["ok"]]
    if accepted:
        raise AssertionError(f"the tolerance at {label} accepts planted faults {accepted}")


def in_turns(fns: dict, iters: dict) -> dict:
    """Mean ms per call of each function, timed in the order given and then
    in reverse (plain, kernel, ..., kernel, plain); the two readings averaged."""
    first = {name: cuda_ms(fn, iters[name]) for name, fn in fns.items()}
    second = {name: cuda_ms(fn, iters[name]) for name, fn in reversed(list(fns.items()))}
    return {name: (first[name] + second[name]) / 2 for name in fns}


def _k_step_skipped(q):
    """Planted fault: the codes with the last 32 of K zeroed, so the sound
    kernel computes what one skipping its last 32-wide K step would."""
    q = q.clone()
    q[:, -32:] = 0
    return q


def phase_int8_kernels():
    """The int8 kernels vs their plain versions at the main path's shapes,
    with planted faults at the feed-forward shapes; then each timed beside
    its plain version and the bf16 ``F.linear`` it replaces."""
    import torch
    import torch.nn.functional as F

    from trajectorycrafter_tpu_torch.ops import int8_matmul as im
    from trajectorycrafter_tpu_torch.ops.int8 import quantize_dense
    from trajectorycrafter_tpu_torch.ops.kernels import (
        int8_gemm,
        int8_gemm_gelu_quant,
        int8_gemm_gscale,
        int8_quantize_rows,
    )

    gen = torch.Generator(device="cuda").manual_seed(2)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    group = im.FF_GROUP
    max_err = dict.fromkeys(KERNELS[2:], 0.0)
    per_shape = {}
    ff1 = None
    for name, (m, k, n, bias) in INT8_SHAPES.items():
        label = f"{name} (M {m}, K {k}, N {n})"
        x = (randn(m, k) * 2.0).bfloat16()
        w = (randn(n, k) * k ** -0.5).bfloat16()
        wq, ws = quantize_dense(w)
        b = (randn(n) * 0.1).bfloat16() if bias else None

        xq, xs = int8_quantize_rows(x)
        xq_ref, xs_ref = im.quantize_rows_reference(x)
        if not (torch.equal(xq, xq_ref) and torch.equal(xs, xs_ref)):
            raise AssertionError(f"int8_quantize_rows {label} is not bit-equal to its plain "
                                 f"version: {(xq != xq_ref).sum().item()} codes, "
                                 f"{(xs != xs_ref).sum().item()} scales differ")
        log(f"int8_quantize_rows {label}: bit-equal to its plain version")
        del xq_ref, xs_ref

        ref = im.int8_matmul_reference(xq, wq, xs, ws, b)
        faults = {}
        if name in ("dit_ff1", "dit_ff2"):
            faults = {
                "last_k_step_of_32_skipped": im.gemm_error(
                    int8_gemm(_k_step_skipped(xq), wq, xs, ws, b), ref),
                "bias_dropped": im.gemm_error(int8_gemm(xq, wq, xs, ws, None), ref),
                "column_scales_shifted_by_one": im.gemm_error(
                    int8_gemm(xq, wq, xs, ws.roll(1), b), ref),
            }
        readings = im.gemm_error(int8_gemm(xq, wq, xs, ws, b), ref)
        check_readings(f"int8_gemm {label}", readings, faults)
        max_err["int8_gemm"] = max(max_err["int8_gemm"], readings["max_abs_err"])
        del ref
        torch.cuda.empty_cache()

        fns = {"plain_ms": lambda: im.int8_matmul_reference(xq, wq, xs, ws, b),
               "quantize_plain_ms": lambda: im.quantize_rows_reference(x),
               "quantize_ms": lambda: int8_quantize_rows(x),
               "gemm_ms": lambda: int8_gemm(xq, wq, xs, ws, b),
               "bf16_linear_ms": lambda: F.linear(x, w, b)}
        iters = {"plain_ms": 2, "quantize_plain_ms": 3, "quantize_ms": 10, "gemm_ms": 10,
                 "bf16_linear_ms": 10}

        if name == "dit_ff1":
            hq_ref, hs_ref = im.int8_matmul_gelu_quant_reference(xq, wq, xs, ws, b, group)
            hq512, hs512 = int8_gemm_gelu_quant(xq, wq, xs, ws, b, group // 2)
            faults = {
                "group_of_512_columns": im.gelu_quant_error(
                    hq512, hs512[:, ::2].contiguous(), hq_ref, hs_ref),
                "gelu_dropped": im.gelu_quant_error(
                    *im.quantize_groups(int8_gemm(xq, wq, xs, ws, b).float(), group),
                    hq_ref, hs_ref),
            }
            del hq512, hs512
            readings = im.gelu_quant_error(*int8_gemm_gelu_quant(xq, wq, xs, ws, b, group),
                                           hq_ref, hs_ref)
            check_readings(f"int8_gemm_gelu_quant {label}, group {group}", readings, faults)
            max_err["int8_gemm_gelu_quant"] = readings["max_abs_err"]
            ff1 = (hq_ref, hs_ref)
            fns["fused_plain_ms"] = lambda: im.int8_matmul_gelu_quant_reference(
                xq, wq, xs, ws, b, group)
            fns["fused_ms"] = lambda: int8_gemm_gelu_quant(xq, wq, xs, ws, b, group)
            iters.update(fused_plain_ms=2, fused_ms=10)
        if name == "dit_ff2":
            hq, hs = ff1
            ref = im.int8_matmul_gscale_reference(hq, wq, hs, ws, b, group)
            faults = {
                "last_k_step_of_32_skipped": im.gemm_error(
                    int8_gemm_gscale(_k_step_skipped(hq), wq, hs, ws, b, group), ref),
                "bias_dropped": im.gemm_error(int8_gemm_gscale(hq, wq, hs, ws, None, group), ref),
                "column_scales_shifted_by_one": im.gemm_error(
                    int8_gemm_gscale(hq, wq, hs, ws.roll(1), b, group), ref),
            }
            readings = im.gemm_error(int8_gemm_gscale(hq, wq, hs, ws, b, group), ref)
            check_readings(f"int8_gemm_gscale {label}, group {group}", readings, faults)
            max_err["int8_gemm_gscale"] = readings["max_abs_err"]
            del ref
            fns["fused_plain_ms"] = lambda: im.int8_matmul_gscale_reference(
                hq, wq, hs, ws, b, group)
            fns["fused_ms"] = lambda: int8_gemm_gscale(hq, wq, hs, ws, b, group)
            iters.update(fused_plain_ms=2, fused_ms=10)
        torch.cuda.empty_cache()

        t = per_shape[name] = in_turns(fns, iters)
        ops = 2 * m * k * n
        line = (f"{name} timed: int8_quantize_rows {t['quantize_ms']:.3f} ms (plain "
                f"{t['quantize_plain_ms']:.3f}), int8_gemm {t['gemm_ms']:.3f} ms "
                f"({ops / t['gemm_ms'] / 1e9:.1f} TOP/s; plain {t['plain_ms']:.3f}), "
                f"bf16 F.linear {t['bf16_linear_ms']:.3f} ms "
                f"({ops / t['bf16_linear_ms'] / 1e9:.1f} TFLOP/s)")
        if "fused_ms" in t:
            fused = "int8_gemm_gelu_quant" if name == "dit_ff1" else "int8_gemm_gscale"
            line += (f"; {fused} {t['fused_ms']:.3f} ms ({ops / t['fused_ms'] / 1e9:.1f} "
                     f"TOP/s; plain {t['fused_plain_ms']:.3f})")
        log(line)
        del x, w, wq, ws, b, xq, xs, fns
        torch.cuda.empty_cache()
    return max_err, per_shape


def _int8_entries(runs: dict, max_err: dict, per_shape: dict) -> list:
    """The int8 kernels' entries of the kernels JSON line."""
    src = "trajectorycrafter_tpu_torch/csrc/"
    shape = lambda name: "(M {}, K {}, N {})".format(*INT8_SHAPES[name][:3])
    per_path = lambda kern: {f"run {r} {p}": runs[r]["per_path"][p][kern]
                             for r in runs for p in ("depth", "denoise")}
    entry = lambda kern, run, **kw: {
        "name": kern, "route": "cuda", "source": f"{src}{kern}.cu",
        "replaces": TPU_KERNELS[kern],
        "launches": sum(runs[run]["per_path"][p][kern] for p in ("depth", "denoise")),
        "launches_run": run, "launches_per_path": per_path(kern),
        "max_abs_err": max_err[kern], **kw}
    ff1, ff2, qkvo = per_shape["dit_ff1"], per_shape["dit_ff2"], per_shape["dit_qkvo"]
    return [
        entry("int8_quantize_rows", "A", ms=qkvo["quantize_ms"],
              plain_ms=qkvo["quantize_plain_ms"], bf16_linear_ms=qkvo["bf16_linear_ms"],
              shape=f"x {shape('dit_qkvo')} (bf16_linear_ms: the q/k/v/out linear it feeds)"),
        entry("int8_gemm", "A", ms=ff1["gemm_ms"], plain_ms=ff1["plain_ms"],
              bf16_linear_ms=ff1["bf16_linear_ms"], shape=shape("dit_ff1"),
              per_shape={name: {key: t[key] for key in
                                ("quantize_ms", "gemm_ms", "plain_ms", "bf16_linear_ms")}
                         for name, t in per_shape.items()}),
        entry("int8_gemm_gelu_quant", "B", ms=ff1["fused_ms"], plain_ms=ff1["fused_plain_ms"],
              bf16_linear_ms=ff1["bf16_linear_ms"], shape=shape("dit_ff1")),
        entry("int8_gemm_gscale", "B", ms=ff2["fused_ms"], plain_ms=ff2["fused_plain_ms"],
              bf16_linear_ms=ff2["bf16_linear_ms"], shape=shape("dit_ff2")),
    ]


def _kernel_counters():
    from trajectorycrafter_tpu_torch.ops import kernels

    return [getattr(kernels, name) for name in KERNELS]


def run_gradual(tc, run: str, depth_attn: str) -> dict:
    """One ``infer_gradual`` with ``TRAJCRAFTER_DEPTH_ATTN=depth_attn``; the
    kernel launches of the run, split into the depth stage and the rest (the
    denoise: no other stage launches a kernel)."""
    import numpy as np
    import torch

    counters = _kernel_counters()
    depth_infer = tc.models.depth_infer
    seen = {}

    def counted_depth(*args, **kwargs):
        before = [kern.launches for kern in counters]
        seen["depth"] = depth_infer(*args, **kwargs)
        seen["depth_launches"] = {kern.__name__: kern.launches - b0
                                  for kern, b0 in zip(counters, before)}
        return seen["depth"]

    os.environ["TRAJCRAFTER_DEPTH_ATTN"] = depth_attn
    tc.models.depth_infer = counted_depth
    tc.timer.seconds.clear()
    torch.cuda.reset_peak_memory_stats()
    for kern in counters:
        kern.launches = 0
    t0 = time.perf_counter()
    try:
        gen = tc.infer_gradual()
        torch.cuda.synchronize()
    finally:
        tc.models.depth_infer = depth_infer
        del os.environ["TRAJCRAFTER_DEPTH_ATTN"]
    total = time.perf_counter() - t0
    launches = {kern.__name__: kern.launches for kern in counters}
    log(f"run {run}: infer_gradual, --quant {tc.cfg.diffusion.quant}, --quant_depth "
        f"{tc.cfg.depth.quant}, depth attention {depth_attn}: {total:.3f} s, peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
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
    return {"seconds": total, "per_path": per_path, "depth": depth, "gen": gen}


def _int8_launches_per_forward(model) -> dict:
    """Kernel launches of one forward of ``model`` through its int8 layers,
    from its modules: an ``Int8Linear`` quantizes its input and runs one GEMM;
    a fused int8 feed-forward replaces its two by one quantization, the
    gelu-quant GEMM and the grouped GEMM."""
    from trajectorycrafter_tpu_torch.models.dit import FeedForward
    from trajectorycrafter_tpu_torch.ops.int8 import Int8Linear

    linears = sum(isinstance(m, Int8Linear) for m in model.modules())
    fused = sum(isinstance(m, FeedForward) and bool(m.fuse)
                and isinstance(m.net[2], Int8Linear) for m in model.modules())
    return {"int8_quantize_rows": linears - fused, "int8_gemm": linears - 2 * fused,
            "int8_gemm_gelu_quant": fused, "int8_gemm_gscale": fused}


def _expected_launches(cfg, dit, unet, depth_kernel: str) -> dict:
    """{stage: {kernel: launches}} of one ``infer_gradual``: one UNet forward
    per Euler step and window, one DiT forward (the CFG pair as a batch of
    2) per denoise step."""
    from trajectorycrafter_tpu_torch.pipelines.depth import window_starts

    windows = len(window_starts(cfg.video_length, cfg.depth.window_size, cfg.depth.overlap))
    unet_forwards = cfg.depth.num_inference_steps * windows
    dit_forwards = cfg.diffusion.num_inference_steps
    depth = {name: 0 for name in KERNELS}
    depth[depth_kernel] = DEPTH_KERNEL_LAUNCHES_PER_FORWARD * unet_forwards
    denoise = {name: 0 for name in KERNELS}
    denoise["flash_attention"] = dit_forwards * (DIT_LAYERS + DIT_LAYERS // PERCEIVER_INTERVAL)
    for name, n in _int8_launches_per_forward(unet).items():
        depth[name] = n * unet_forwards
    for name, n in _int8_launches_per_forward(dit).items():
        denoise[name] = n * dit_forwards
    return {"depth": depth, "denoise": denoise}


def _set_fuse(dit, fuse) -> None:
    for block in dit.transformer_blocks:
        block.ff.fuse = fuse


def phase_main_path():
    import dataclasses

    import numpy as np
    import torch

    from trajectorycrafter_tpu_torch.cli import parse_config
    from trajectorycrafter_tpu_torch.ops.int8 import (
        quantize_depth_unet_,
        quantize_dit_,
        quantized_twin,
    )
    from trajectorycrafter_tpu_torch.orchestrator import TrajCrafter, build_full_scale_models
    from trajectorycrafter_tpu_torch.utils.quality import video_quality

    cfg = parse_config(MAIN_ARGV)
    if (cfg.diffusion.quant, cfg.depth.quant) != ("int8", "none"):
        raise AssertionError(f"the CLI's default quantization is {cfg.diffusion.quant} / "
                             f"{cfg.depth.quant}, expected int8 / none")
    t0 = time.perf_counter()
    # one set of seeded bf16 weights; the int8 models are their quantizations
    bf16_cfg = dataclasses.replace(cfg, diffusion=dataclasses.replace(cfg.diffusion, quant="none"))
    tc = TrajCrafter(cfg, models=build_full_scale_models(bf16_cfg, "cuda"))
    dit = tc.models.pipeline.transformer
    unet = tc.models.depth_infer.__self__.pipe.unet
    dit8 = quantized_twin(dit, quantize_dit_)
    unet8 = quantized_twin(unet, quantize_depth_unet_)
    torch.cuda.synchronize()
    log(f"built the full-scale models and their int8 twins in {time.perf_counter() - t0:.2f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB of parameters)")

    pe, ne = tc.models.encode_prompt("a scene", cfg.diffusion.negative_prompt)
    if pe.shape != (1, 226, 4096) or not torch.isfinite(pe).all() or torch.equal(pe, ne):
        raise AssertionError(f"T5 prompt embeddings: shape {tuple(pe.shape)}, "
                             f"finite {bool(torch.isfinite(pe).all())}")

    # run: (DiT, FF fused, UNet, --quant, --quant_depth, depth attention, its kernel)
    plans = {
        "A": (dit8, None, unet, "int8", "none", "flash_stock", "flash_attention"),
        "B": (dit8, True, unet8, "int8", "int8", "flash_max", "flash_maxpass"),
        "C": (dit, None, unet, "none", "none", "flash_stock", "flash_attention"),
    }
    pipe = tc.models.depth_infer.__self__.pipe
    runs = {}
    for run, (model, fuse, depth_unet, quant, quant_depth, depth_attn, depth_kernel) in \
            plans.items():
        tc.models.pipeline.transformer, pipe.unet = model, depth_unet
        tc.cfg.diffusion.quant, tc.cfg.depth.quant = quant, quant_depth
        _set_fuse(model, fuse)
        try:
            want = _expected_launches(tc.cfg, model, depth_unet, depth_kernel)
            runs[run] = run_gradual(tc, run, depth_attn)
        finally:
            _set_fuse(model, None)
        if runs[run]["per_path"] != want:
            raise AssertionError(f"run {run}: kernel launches per stage "
                                 f"{runs[run]['per_path']}, expected {want}")
    tc.models.pipeline.transformer, pipe.unet = dit, unet
    tc.cfg.diffusion.quant, tc.cfg.depth.quant = cfg.diffusion.quant, cfg.depth.quant

    rel = np.abs(np.log(runs["B"]["depth"] / runs["A"]["depth"]))
    log(f"depth of runs B (int8 UNet, flash_max) and A (information): median |log ratio| "
        f"{np.median(rel):.3e}, max {rel.max():.3e}")
    quality = video_quality(runs["A"]["gen"] * 255.0, runs["C"]["gen"] * 255.0)
    log(f"gen of run A (int8 DiT) against run C (bf16 DiT), information only (random "
        f"weights, 2 steps): {json.dumps(quality)}")
    return tc, runs, (dit8, unet8)


def phase_whole_models(tc, dit8, unet8):
    """The whole DiT and the whole depth UNet, bf16 and int8, at full width on
    small inputs: kernels against the plain versions."""
    import torch

    from trajectorycrafter_tpu_torch.ops.kernels import flash_attention, flash_maxpass

    def set_impl(model, attention, int8="auto"):
        for m in model.modules():
            if hasattr(m, "attention_impl"):
                m.attention_impl = attention
            if hasattr(m, "int8_impl"):
                m.int8_impl = int8

    def held(label, out_kernel, out_plain, limit):
        rel = ((out_kernel - out_plain).abs().max() / out_plain.abs().max()).item()
        log(f"{label}: max rel err {rel:.3e} (limit {limit})")
        if not torch.isfinite(out_kernel).all() or rel > limit:
            raise AssertionError(f"{label} disagrees: rel err {rel:.3e}")

    gen_in = torch.Generator(device="cuda").manual_seed(1)
    randn = lambda *shape: torch.randn(shape, generator=gen_in, device="cuda").bfloat16()

    b, f, h, w = 2, 3, 8, 12
    args = (randn(b, f, h, w, 16), randn(b, 226, 4096), torch.full((b,), 500.0, device="cuda"))
    kwargs = dict(inpaint_latents=randn(b, f, h, w, 17), cross_latents=randn(b, 2, h, w, 16))
    with torch.no_grad():
        for label, model, fuse in (("bf16 DiT", tc.models.pipeline.transformer, None),
                                   ("int8 DiT", dit8, None), ("int8 DiT, fused FF", dit8, True)):
            _set_fuse(model, fuse)
            counts = [kern.launches for kern in _kernel_counters()]
            out_kernel = model(*args, **kwargs).float()
            torch.cuda.synchronize()
            if [kern.launches for kern in _kernel_counters()] == counts:
                raise AssertionError(f"{label}: no kernel launched")
            set_impl(model, "reference", "reference")
            counts = [kern.launches for kern in _kernel_counters()]
            out_plain = model(*args, **kwargs).float()
            if [kern.launches for kern in _kernel_counters()] != counts:
                raise AssertionError(f"{label}: a kernel launched with impl reference")
            set_impl(model, "auto")
            _set_fuse(model, None)
            held(f"{label}, {DIT_LAYERS} layers on {(b, f, h, w)}: kernels vs plain",
                 out_kernel, out_plain, DIT_REL_TOL)

    f, h, w = 2, 72, 128
    args = (randn(1, f, h, w, 8), torch.full((1,), 1.6, device="cuda"),
            randn(1, f, 1, 1024), torch.tensor([[6.0, 127.0, 0.02]], device="cuda"))
    with torch.no_grad():
        for label, unet in (("bf16", tc.models.depth_infer.__self__.pipe.unet),
                            ("int8", unet8)):
            outs = {}
            for impl in ("flash_stock", "flash_max", "reference"):
                set_impl(unet, impl, "reference" if impl == "reference" else "auto")
                before = flash_attention.launches + flash_maxpass.launches
                outs[impl] = unet(*args).float()
                torch.cuda.synchronize()
                launches = flash_attention.launches + flash_maxpass.launches - before
                expected = 0 if impl == "reference" else DEPTH_KERNEL_LAUNCHES_PER_FORWARD
                if launches != expected:
                    raise AssertionError(f"{label} depth UNet with {impl}: {launches} "
                                         f"attention kernel launches, expected {expected}")
            set_impl(unet, "auto")
            for impl in ("flash_stock", "flash_max"):
                held(f"{label} depth UNet on {(1, f, h, w)}, attention {impl} vs plain",
                     outs[impl], outs["reference"], UNET_REL_TOL)


def main() -> None:
    os.chdir(REPO)
    sys.path.insert(0, str(REPO))
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    max_err, timing = phase_kernels()
    int8_err, int8_timing = phase_int8_kernels()
    tc, runs, (dit8, unet8) = phase_main_path()
    phase_whole_models(tc, dit8, unet8)

    import torch

    per_path = lambda run, kern: {p: runs[run]["per_path"][p][kern] for p in ("depth", "denoise")}
    src = "trajectorycrafter_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        {"name": "flash_attention", "route": "cuda", "source": src + "flash_attention.cu",
         "replaces": TPU_KERNELS["flash_attention"],
         "also_replaces": "trajectorycrafter_tpu/ops/attention.py:39",
         "launches": sum(per_path("A", "flash_attention").values()),
         "launches_run": "A",
         "launches_per_path": {f"run {r} {p}": n for r in runs
                               for p, n in per_path(r, "flash_attention").items()},
         "max_abs_err": max_err["flash_attention"],
         "ms": timing["dit"]["ms"], "plain_ms": timing["dit"]["plain_ms"],
         "shape": "(2, 48, 13330, 13330, 64)",
         "depth_ms": timing["depth"]["flash_attention"],
         "depth_plain_ms": timing["depth"]["plain_ms"],
         "depth_shape": "(49, 5, 9216, 9216, 64)"},
        {"name": "flash_maxpass", "route": "cuda", "source": src + "flash_maxpass.cu",
         "replaces": TPU_KERNELS["flash_maxpass"],
         "launches": sum(per_path("B", "flash_maxpass").values()),
         "launches_run": "B (TRAJCRAFTER_DEPTH_ATTN=flash_max)",
         "launches_per_path": {f"run {r} {p}": n for r in runs
                               for p, n in per_path(r, "flash_maxpass").items()},
         "max_abs_err": max_err["flash_maxpass"],
         "ms": timing["depth"]["flash_maxpass"], "plain_ms": timing["depth"]["plain_ms"],
         "shape": "(49, 5, 9216, 9216, 64)"},
        *_int8_entries(runs, int8_err, int8_timing),
    ]}), flush=True)
    log(f"chip smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
