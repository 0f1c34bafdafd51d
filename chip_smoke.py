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
     that must also reject planted faults (the bf16 attention kernels also
     at ragged lengths and on strided views); then each kernel, its plain
     version and the one PyTorch call that computes the same function (the
     "library" call: flash SDPA for attention, ``torch._int_mm`` for the
     int8 GEMM's product; the port never calls it) and, for the int8 GEMMs,
     the bf16 ``F.linear`` they replace, timed at full shape, in turns (K1
     at the DiT's, the Perceiver's and the depth UNet's two shapes); each
     kernel's bound (the least time the card could take for the same work)
     computed from the data sheet, and its TFLOP/s;
  4. the attention variants (K5 ``flash_lse``, K1b ``flash_exp2``, K6
     ``flash_pv8``, K7 ``int8_flash_attention``) the same way, at the
     attention bench's DiT shape and the main path's shapes (K7 also at
     head dim 128, ``K7_D128_SHAPE``);
  4b. the attention backward (``flash_attention_bwd_dkv``, K4-dkv, and
     ``flash_attention_bwd_dq``, K4-dq, csrc/flash_attention_bwd.cu) against
     ``attention_backward_reference`` at the training shapes (the DiT's (1,
     48, 13,330^2, 64), the Perceiver's (1, 16, 13,104 x 3,024, 128)), a
     ragged shape, the ragged edges and strided views, within
     ``attention_backward_error`` (per element 2^-6 of the gradient's sum of
     magnitudes, per head a relative L2 error of 2^-6), which must reject di
     left out, the last quarter of the 64-query tiles skipped in dK/dV and
     of the 128-key tiles in dQ (the kernels' own tiles); then each timed at
     full shape in turns with the plain version and flash SDPA's backward,
     beside its bound;
  5. main path: ``TrajCrafter.infer_gradual`` at the deployed widths (random
     weights from a seed; T5-XXL prompt encode; the DepthCrafter depth
     stage, 5 Euler steps over one 49-frame window at 576x1024; 2 denoise
     steps, diffusion at 384x672), four times on one set of weights, A on
     the deployed 49 frames, B-D on 25 (``CUT_FRAMES``):
     A, the default: int8 DiT (``--quant int8``, unfused feed-forward),
       bf16 depth UNet, depth attention ``flash_stock``;
     B: int8 DiT with the fused int8 feed-forward, ``--quant_depth int8``,
       ``TRAJCRAFTER_DEPTH_ATTN=flash_max``;
     C: ``--quant none``, the bf16 DiT and UNet, ``flash_stock``;
     D: run A with the DiT's ``attention_impl="flash_pv8"`` and
       ``TRAJCRAFTER_DEPTH_ATTN=flash_pv8``: every large attention on K6;
     the int8 models are quantizations of the bf16 models' own weights.
     Each kernel's launches are counted per stage and held to counts derived
     from the modules; the PSNR and SSIM of D's video against C's, and the
     depth of B and D against C's, are printed as information;
  5b. modes and samplers, on run A's models at 25 frames (``CUT_FRAMES``,
     as every later run but L, M and P): run E ``infer_direct`` with
     DPM++ at 3 steps (step 1 second order; the mp4s drop the fly-in,
     clamped to 12 frames: 13, 13, 13, 13 and 25 frames), run F ``infer_bullet`` with
     Euler A at 2 steps, run G ``infer_zoom`` with PNDM at 4 steps (13 DiT
     forwards: 12 pseudo-RK calls and one PLMS call), each through
     ``TrajCrafter``'s entry point with the sampler set in the config and
     the pipeline's scheduler built from the registry; then Euler and
     DDIM_Cog at 2 steps through the pipeline on the conditions recorded
     from run E; launches held to the counts derived from the modules and
     the scheduler's loop length, stage times and peak memory logged; then
     one step of each of the six samplers on the card against the same step
     on the CPU (``SAMPLER_STEP_TOL``);
  5c. the long-trajectory and known-camera paths, on run A's models: run H
     ``TrajCrafterAutoregressive.infer_autoregressive`` (v1: segments of 25
     frames, 42 poses in two windows sharing 8, 2 depth stages, 2
     diffusions, 42 frames), run I
     ``TrajCrafterGlobalPointCloud.infer_autoregressive`` (v2 at its
     segments of 25 frames, the clip lifted into a 14.7 M-point cloud on
     the card, 50 z-buffer renders, the merged 29.5 M-point cloud
     downsampled to 4 M, the PLY / COLMAP / HTML scene), run J
     ``CameraPoseTrajCrafter.infer_camera_poses_smooth``
     between two Panoptic-style cameras with a held-out target video
     (``metrics.json``); each with its launches held to one depth stage's
     and one diffusion's derived counts times its stages, finite output in
     [0, 1] counted in frames, stage times and peak memory logged; then the
     tiled VAE decode at 17 frames of 576x1024: one tile bit-equal to
     ``vae_decode``, the JAX default tile and the auto route's strips finite
     and of the right shape, each timed beside the one-shot decode;
  5d. the consistent-depth path and the Gradio callback, on run A's
     models: run M ``TrajCrafterConsistentDepth.infer_autoregressive`` with
     a seeded Video-Depth-Anything vitl (fp32; 2 segments of 49 frames at
     576x1024; the first segment's depth from 2 VDA windows of 32 frames
     at 588x1036; the second stage's alignment renders sparse depth from
     the per-frame clouds and trains a visual prompt through the VDA at
     280x504 over all 49 frames, 2 epochs of the deployed 50, VP mode), run
     N the same without a VDA (DepthCrafter and ``align_window``) on
     25-frame segments, run O the Gradio callback ``run_pipeline`` with the
     "Orbit Left" preset at 2 steps; launches held to the derived counts
     (the VDA and the trainer launch none), the joined video (M's 98 x 384
     x 672), the aligned depth finite
     and positive on the sparse mask, M's prompt non-zero, the VDA's
     seconds per window and the trainer stage's seconds per epoch and peak
     memory logged;
  5e. run P, LoRA training (after phases 6 and 7, on the bundle's bf16
     DiT): a SceneFlow-layout tree of 3 scenes x 49 frames at 960x540
     (PNG, .pfm disparities, camera_data.txt) turned into 3 .npz samples
     at 384x672 by ``datagen.generate_dataset`` (the bundle's VAE, the
     T5-XXL prompt embedding); 3 training steps of the full-width DiT (42
     blocks, B = 1, 13,330 joint tokens) with rank-8 adapters on its 316
     target layers, ``remat``, ``flash_stock``, v-prediction, dropout 0.1:
     finite losses, grad_norm > 0, every B moved at step 1 and every A at
     step 2, K5 and the backward kernels launched as derived from the
     modules, seconds per step and peak memory logged; then one step's
     adapter gradients on the kernels against the plain versions on the DiT
     cut to 4 blocks (``GRAD_MEDIAN_TOL``, ``GRAD_MAX_TOL``);
  6. whole models: the bf16 and int8 DiT (unfused and fused), the DiT on
     ``flash_pv8``, and the bf16 and int8 depth UNet at full width on small
     inputs, kernels against the plain versions;
  7. the attention bench (``python -m trajectorycrafter_tpu_torch.
     bench_attention``), once;
  8. checkpoints: once the random bundle's compute is done, its seeded
     weights are written as an HF-layout checkpoint tree on the local disk
     (the DiT cut to 6 layers by its config.json, T5-XXL in two shards, the
     CogVideoX VAE, SVD UNet, SVD VAE and CLIP-H whole, BLIP-2 at full width
     cut to 4 vision / 2 Q-Former / 4 OPT layers, a 32,000-piece Unigram
     ``spiece.model``, a byte-level BPE vocabulary of OPT's size), a
     per-tensor checksum of every written tensor taken, and the random bundle
     freed; the tree is then loaded through the normal entry point
     (``TrajCrafter(parse_config(argv))``, no ``--allow_dev_stubs``) and run
     with no ``--prompt`` (BLIP-2 captions the middle frame), ``--mask`` and
     the default ``--quant int8``: every loaded tensor must be bit-equal to
     the written one (the int8 DiT to ``quantize_dense`` of it), two damaged
     DiT trees must fail in ``verify_state_dict`` before any model computes,
     the caption must be the decode of the greedy ids, T5 must read the
     tokenizer's ids, ``--mask`` must leave fewer known pixels than run A,
     and K1, K2a and K2b must launch the counts derived from the 6-layer DiT;
     the load seconds per family, GB/s, peak memory and the ``caption``
     stage are logged; then BLIP-2 at full depth (39 / 12 / 32 layers,
     seeded on the card) captions one frame; then each entry point of
     ``trajectorycrafter_tpu_torch/scripts/`` once through ``main(argv)`` on
     the tree at 9 frames (``inference_autoregressive`` and
     ``autoregressive_global`` with 2 windows, ``run_w_cam_poses --smooth
     --target_video``,
     ``inference_orbits --test_run``), each with its launches held to run
     L's per depth stage and diffusion and its outputs counted; then
     ``inference_alignment`` with a vitl ``.pth`` written beside the tree
     (``load_vda``'s key check; the same file under ``--vda_encoder vits``
     refused first), 2 segments of 9 frames; then
     ``scripts/train_lora.main(argv)`` on the tree's 6-layer DiT and run P's
     samples (2 steps, validation and a checkpoint after each), then
     ``--resume_from_checkpoint latest`` for a third step;
  9. a JSON line of kernel results, and a final JSON line with the device.

Imports nothing of JAX and nothing of the JAX package: the port holds its
own config, CLI and video I/O.
"""

import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
# ``int8_gemm`` and ``int8_gemm_gscale`` (the `wgmma` main loop of
# csrc/int8_gemm_hopper.cuh) within one bf16 ulp of theirs
# (``gemm_error``), ``int8_gemm_gelu_quant`` within ``gelu_quant_error``
# (trajectorycrafter_tpu_torch/ops/int8_matmul.py states the reasons).  At
# the feed-forward shapes each bound must reject two planted faults, made
# with the sound kernels: a K step of 32 skipped (the last 32 of K zeroed)
# and the bias dropped or the column scales shifted by one (K2b, K3b); a
# group of 512 columns in place of 1,024 and the gelu dropped (K3a).

# The attention variants (ops/attention.py): K5's output by
# ``attention_error`` and its logsumexp by ``lse_error`` (2^-12 (1 + |lse|));
# K1b by ``output_error`` against its own plain version (bf16 weights on
# both sides); K6 and K7 by ``quantized_error`` against theirs (per row 2^-5,
# at most 2^-10 of the elements outside the per-element bound: their integer
# codes flip where a score sits on a rounding boundary).  The planted faults:
# a row sum off by 10% and the last quarter of the key blocks skipped (all
# four); an lse in base 2 (K5); the clamp dropped at scores above 110 (K1b);
# zero-padded keys passed as real keys at a ragged shape where every score
# is negative (K6, K7).

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
                  "int8_gemm.cu", "int8_gemm_gelu_quant.cu", "int8_gemm_gscale.cu",
                  "flash_pv8.cu", "int8_flash_attention.cu", "flash_attention_bwd.cu")
INT8_KERNELS = ("int8_quantize_rows", "int8_gemm", "int8_gemm_gelu_quant", "int8_gemm_gscale")
VARIANTS = ("flash_exp2", "flash_lse", "flash_pv8", "int8_flash_attention")
BACKWARD = ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")
KERNELS = ("flash_attention", "flash_maxpass", *INT8_KERNELS, *VARIANTS, *BACKWARD)
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
    "flash_exp2": "trajectorycrafter_tpu/ops/pallas/flash_exp2.py:83",
    "flash_lse": "trajectorycrafter_tpu/ops/pallas/flash_lse.py:68",
    "flash_pv8": "trajectorycrafter_tpu/ops/pallas/flash_pv8.py:98",
    "int8_flash_attention": "trajectorycrafter_tpu/ops/pallas/int8_flash_attention.py:116",
    # JAX's library flash attention, whose custom_vjp jax.grad reaches through
    # trajectorycrafter_tpu/ops/attention.py:39 _flash_attention
    "flash_attention_bwd_dkv": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
    "flash_attention_bwd_dq": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
}
# the entry points of csrc/flash_attention.cu besides its own, and of
# csrc/flash_attention_bwd.cu
SOURCE_OF = {"flash_exp2": "flash_attention", "flash_lse": "flash_attention",
             "flash_attention_bwd_dkv": "flash_attention_bwd",
             "flash_attention_bwd_dq": "flash_attention_bwd"}
# the attention bench's DiT shape: 226 text + 13 x 36 x 64 video tokens,
# zero-padded to 30,720 (bench_attention.py)
BENCH_DIT = (2, 48, 30178, 30720, 64)  # (B, H, real tokens, padded, D)
DIT_SHAPE = (2, 48, 13330, 64)  # the main path's joint attention (B, H, S, D)
# the Perceiver's cross-attention (B, H, Sq, Skv, D): 2 x 13,104 video
# tokens against 2 x 3,024 reference tokens, 16 heads of 128
PERCEIVER_SHAPE = (2, 16, 13104, 3024, 128)
# K7 (bench only) is also checked and timed at head dim 128, at a
# self-attention shape (B, H, Sq, Skv, D)
K7_D128_SHAPE = (1, 16, 4096, 4096, 128)
# ragged lengths around the bf16 attention kernels' 64-row boxes and 128-key
# tiles, checked on the query and on the key side
EDGE_LENGTHS = (1, 63, 65, 127, 129, 777, 1000)
# the training shapes of the attention backward (B = 1, one sample a step):
# the DiT's joint self-attention and the Perceiver's cross-attention
TRAIN_DIT_SHAPE = (1, 48, 13330, 13330, 64)  # (B, H, Sq, Skv, D)
TRAIN_PERCEIVER_SHAPE = (1, 16, 13104, 3024, 128)

# Data-sheet rates of an H100 SXM (dense): bf16 989 TFLOP/s, int8 1,979
# TOP/s, 3.35 TB/s of device memory; the SFU's 16 exp2 per clock per SM x
# 132 SMs at the card's maximum SM clock (nvidia-smi clocks.max.sm).
BF16_OPS, INT8_OPS, MEM_BYTES = 989e12, 1979e12, 3.35e12
SFU_EXP_PER_CLOCK = 16 * 132


DEVICE = {}  # the card's max SM clock, read in phase_device
T_START = time.perf_counter()  # every log line carries the seconds since here
PHASE_SECONDS = {}  # wall seconds of each phase of main(), logged at the end


def log(msg: str) -> None:
    print(f"[chip_smoke {time.perf_counter() - T_START:7.1f} s] {msg}", flush=True)


def run_phase(name: str, fn, *args):
    """Run one phase of main() and keep its wall seconds under ``name``."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = round(time.perf_counter() - t0, 1)
    log(f"phase {name}: {PHASE_SECONDS[name]:.1f} s")
    return out


def bound(ops_bf16: float = 0.0, ops_int8: float = 0.0, nbytes: float = 0.0,
          exps: float = 0.0) -> dict:
    """The least time the card could take for a function's work: the larger
    of its tensor-core operations over the data-sheet peaks and its bytes
    (each input read once, each output written once) over the memory rate;
    with ``exps``, also the exp count over the SFU rate (``sfu_ms``)."""
    op_ms = (ops_bf16 / BF16_OPS + ops_int8 / INT8_OPS) * 1e3
    byte_ms = nbytes / MEM_BYTES * 1e3
    out = {"bound_ms": max(op_ms, byte_ms),
           "bound_by": "operations" if op_ms >= byte_ms else "bytes"}
    if exps:
        out["sfu_ms"] = exps / (SFU_EXP_PER_CLOCK * DEVICE["sm_clock_hz"]) * 1e3
    return out


def attention_bound(b, h, sq, skv, d, pv_int8=False, qk_int8=False, in_bytes=2,
                    extra_bytes=0) -> dict:
    """``bound`` of one attention call over the keys it needs: two products of
    2 B H Sq Skv D operations (bf16, or int8 where the kernel computes them
    in int8), B H Sq Skv exps, q, k, v read (``in_bytes`` per element) and a
    bf16 output written, plus ``extra_bytes``."""
    prod = 2.0 * b * h * sq * skv * d
    ops = {"ops_bf16": prod * ((not pv_int8) + (not qk_int8)),
           "ops_int8": prod * (pv_int8 + qk_int8)}
    nbytes = in_bytes * b * h * d * (sq + 2 * skv) + 2 * b * h * sq * d + extra_bytes
    return bound(**ops, nbytes=nbytes, exps=float(b * h * sq * skv))


def cuda_ms(fn, iters: int, warm_up: bool = True) -> float:
    """Mean milliseconds per call over ``iters`` calls, after one warm-up
    call unless ``warm_up`` is false (for the slow plain versions, timed
    after their check has run them)."""
    import torch

    if warm_up:
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
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    DEVICE["sm_clock_hz"] = float(clock) * 1e6
    log(f"max SM clock {clock} MHz: the SFU bound takes {SFU_EXP_PER_CLOCK} exp2 per clock")
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
            # C75xx: ptxas notes on `wgmma`, e.g. products serialized
            if "registers" in line or "spill" in line or "C75" in line:
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
    from trajectorycrafter_tpu_torch.ops.kernels import ATTENTION_KEY_TILE

    q = (randn(b, sq, h, d) * gain).bfloat16()
    k, v = randn(b, skv, h, d).bfloat16(), randn(b, skv, h, d).bfloat16()
    scale = d ** -0.5
    out = kernel(q, k, v, scale)
    torch.cuda.synchronize()
    sound = kernel_error(kernel, out, q, k, v, scale)
    # the key tiles of the kernel under test (both run ATTENTION_KEY_TILE)
    keep = _skip_last_quarter(skv, ATTENTION_KEY_TILE)
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

    from trajectorycrafter_tpu_torch.ops.attention import (
        ATTN_ROW_TOL,
        attention_reference,
        kernel_error,
    )
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
    # the ragged edges and strided views, sound answers only (a run on one
    # key tile has no quarter to skip)
    for kernel in (flash_attention, flash_maxpass):
        rows = []
        for name, q, k, v in edge_inputs(randn):
            d = q.shape[-1]
            r = kernel_error(kernel, kernel(q, k, v, d ** -0.5), q, k, v, d ** -0.5)
            if not r["ok"]:
                raise AssertionError(f"{kernel.__name__} {name} disagrees with its plain "
                                     f"version: {r}")
            rows.append(r["max_row_rel_err"])
            max_err[kernel.__name__] = max(max_err[kernel.__name__], r["max_abs_err"])
        log(f"{kernel.__name__} at {len(rows)} ragged and strided shapes: max row rel err "
            f"{max(rows):.3e} (limit {ATTN_ROW_TOL:.3e})")

    from trajectorycrafter_tpu_torch.bench_attention import sdpa_flash

    timing = {}
    # the DiT shape, in turns: plain, kernel, library, library, kernel, plain
    b, h, s, d = DIT_SHAPE
    q, k, v = (randn(b, s, h, d).bfloat16() for _ in range(3))
    t = in_turns({"plain_ms": lambda: attention_reference(q, k, v, d ** -0.5),
                  "ms": lambda: flash_attention(q, k, v, d ** -0.5),
                  "library_ms": lambda: sdpa_flash(q, k, v, d ** -0.5)},
                 {"plain_ms": 2, "ms": 10, "library_ms": 10})
    timing["dit"] = {**t, **attention_bound(b, h, s, s, d)}
    flop = 4 * b * h * s * s * d
    log(f"dit_self_full {(b, h, s, s, d)}: flash_attention {t['ms']:.2f} ms "
        f"({flop / t['ms'] / 1e9:.1f} TFLOP/s), plain {t['plain_ms']:.2f} ms, flash SDPA "
        f"{t['library_ms']:.2f} ms ({flop / t['library_ms'] / 1e9:.1f} TFLOP/s); bound "
        f"{timing['dit']['bound_ms']:.2f} ms "
        f"({timing['dit']['bound_by']}), SFU {timing['dit']['sfu_ms']:.2f} ms")
    del q, k, v
    torch.cuda.empty_cache()

    # the depth UNet's level-0 shape at 49 frames, in turns: plain, K4, K4b,
    # library and back (the plain version is the same function for both)
    b, h, s, d = DEPTH_SHAPES["depth_9216"]
    q = (randn(b, s, h, d) * 4.0).bfloat16()
    k, v = randn(b, s, h, d).bfloat16(), randn(b, s, h, d).bfloat16()
    t = in_turns({"plain_ms": lambda: attention_reference(q, k, v, d ** -0.5),
                  "flash_attention": lambda: flash_attention(q, k, v, d ** -0.5),
                  "flash_maxpass": lambda: flash_maxpass(q, k, v, d ** -0.5),
                  "library_ms": lambda: sdpa_flash(q, k, v, d ** -0.5)},
                 {"plain_ms": 2, "flash_attention": 5, "flash_maxpass": 5, "library_ms": 5})
    timing["depth"] = {**t, **attention_bound(b, h, s, s, d)}
    flop = 4 * b * h * s * s * d
    log(f"depth_9216_full {(b, h, s, s, d)}: flash_attention {t['flash_attention']:.2f} ms "
        f"({flop / t['flash_attention'] / 1e9:.1f} TFLOP/s), flash_maxpass "
        f"{t['flash_maxpass']:.2f} ms ({1.5 * flop / t['flash_maxpass'] / 1e9:.1f} TFLOP/s "
        f"of its 1.5x products), plain {t['plain_ms']:.2f} ms, flash SDPA "
        f"{t['library_ms']:.2f} ms ({flop / t['library_ms'] / 1e9:.1f} TFLOP/s); bound "
        f"{timing['depth']['bound_ms']:.2f} ms "
        f"({timing['depth']['bound_by']}), SFU {timing['depth']['sfu_ms']:.2f} ms")
    del q, k, v
    torch.cuda.empty_cache()

    # K1 at the Perceiver's shape and K4 at the depth UNet's 2,304-token level
    b, h, s, d = DEPTH_SHAPES["depth_2304"]
    for name, (b, h, sq, skv, d) in (("perceiver", PERCEIVER_SHAPE),
                                     ("depth_2304", (b, h, s, s, d))):
        q = (randn(b, sq, h, d) * 4.0).bfloat16()  # no QK-norm at either: peaked rows
        k, v = randn(b, skv, h, d).bfloat16(), randn(b, skv, h, d).bfloat16()
        t = in_turns({"plain_ms": lambda: attention_reference(q, k, v, d ** -0.5),
                      "ms": lambda: flash_attention(q, k, v, d ** -0.5),
                      "library_ms": lambda: sdpa_flash(q, k, v, d ** -0.5)},
                     {"plain_ms": 2, "ms": 10, "library_ms": 10})
        timing[name] = {**t, **attention_bound(b, h, sq, skv, d),
                        "shape": str((b, h, sq, skv, d))}
        flop = 4 * b * h * sq * skv * d
        log(f"{name} {(b, h, sq, skv, d)}: flash_attention {t['ms']:.3f} ms "
            f"({flop / t['ms'] / 1e9:.1f} TFLOP/s), plain {t['plain_ms']:.2f} ms, flash SDPA "
            f"{t['library_ms']:.3f} ms ({flop / t['library_ms'] / 1e9:.1f} TFLOP/s); bound "
            f"{timing[name]['bound_ms']:.3f} ms ({timing[name]['bound_by']}), SFU "
            f"{timing[name]['sfu_ms']:.3f} ms")
        del q, k, v
        torch.cuda.empty_cache()
    return max_err, timing


def edge_inputs(randn):
    """(name, q, k, v) at the ragged lengths around the bf16 kernels' 64-row
    boxes and 128-key tiles (``EDGE_LENGTHS`` paired with themselves
    reversed, d 64 and 128), and as strided views: k and v the halves of one
    projection and q a slice of a wider one (the Perceiver's layout), and
    (B, H, S, D) tensors seen as (B, S, H, D)."""
    out = []
    for sq, skv in zip(EDGE_LENGTHS, reversed(EDGE_LENGTHS)):
        for d in (64, 128):
            q = (randn(1, sq, 2, d) * 2.0).bfloat16()
            k, v = randn(1, skv, 2, d).bfloat16(), randn(1, skv, 2, d).bfloat16()
            out.append((f"ragged {(1, 2, sq, skv, d)}", q, k, v))
    b, s, h, d = 2, 300, 4, 128
    k, v = (x.unflatten(-1, (h, d)) for x in randn(b, s, 2 * h * d).bfloat16().chunk(2, dim=-1))
    q = randn(b, 77, 3 * h * d).bfloat16()[..., h * d:2 * h * d].unflatten(-1, (h, d))
    out.append(("strided, the Perceiver's k / v halves", q, k, v))
    d = 64
    q, k, v = (randn(b, h, n, d).bfloat16().transpose(1, 2) for n in (77, s, s))
    out.append(("strided, (B, H, S, D) seen as (B, S, H, D)", q, k, v))
    return out


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


def in_turns(fns: dict, iters: dict, cold: tuple = ()) -> dict:
    """Mean ms per call of each function, timed in the order given and then
    in reverse (plain, kernel, ..., kernel, plain); the two readings averaged.
    The functions named in ``cold`` get no warm-up call (slow plain versions
    whose check has run them already)."""
    ms = lambda name, fn: cuda_ms(fn, iters[name], warm_up=name not in cold)
    first = {name: ms(name, fn) for name, fn in fns.items()}
    second = {name: ms(name, fn) for name, fn in reversed(list(fns.items()))}
    return {name: (first[name] + second[name]) / 2 for name in fns}


def _skip_last_quarter(n: int, block: int) -> int:
    """Keys kept when the last quarter (rounded up) of the ``block``-key
    blocks over ``n`` keys is skipped."""
    blocks = -(-n // block)
    return (blocks - -(-blocks // 4)) * block


def _all_negative(randn, b, s, h, d):
    """q along +u, k along -80 u (|u| = 1): every score q.k / sqrt(d) near
    -10 at d = 64, so zero-padded keys (score 0) would win every block max."""
    import torch

    u = torch.full((d,), d ** -0.5, device="cuda")
    q = (u + 0.3 * randn(b, s, h, d) * d ** -0.5).bfloat16()
    k = (-80.0 * u + randn(b, s, h, d) * d ** -0.5).bfloat16()
    return q, k, randn(b, s, h, d).bfloat16()


def phase_variants():
    """K5, K1b, K6 and K7 against their plain versions at their paths'
    shapes with the planted faults; then each timed at full shape in turns
    with its plain version and the library call."""
    import math

    import torch

    from trajectorycrafter_tpu_torch.bench_attention import sdpa_flash
    from trajectorycrafter_tpu_torch.ops import attention_variants as av
    from trajectorycrafter_tpu_torch.ops.attention import (
        attention_reference,
        lse_error,
        output_error,
        plain_refs,
        quantized_error,
    )
    from trajectorycrafter_tpu_torch.ops.kernels import (
        ATTENTION_KEY_TILE,
        flash_exp2,
        flash_lse,
        flash_pv8,
        int8_flash_attention,
    )

    gen = torch.Generator(device="cuda").manual_seed(3)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    max_err = dict.fromkeys(VARIANTS, 0.0)

    def judge(kern, label, readings, faults):
        check_readings(f"{kern} {label}", readings, faults)
        max_err[kern] = max(max_err[kern], readings["max_abs_err"])

    # K5 and K1b: the bench's DiT shape with its heads cut (keys past 30,178
    # zero, as the bench gives them; K5 attends to all it is given, K1b masks
    # them by kv_valid), and a ragged shape
    _, _, s_real, s_pad, d = BENCH_DIT
    scale = d ** -0.5
    for label, (b, h, sq, skv, real) in {"bench_dit_heads4": (1, 4, s_pad, s_pad, s_real),
                                         "ragged": (1, 2, 1000, 777, 700)}.items():
        valid = (torch.arange(skv, device="cuda") < real).float()
        q = randn(b, sq, h, d).bfloat16()
        k, v = ((randn(b, skv, h, d) * valid[None, :, None, None]).bfloat16() for _ in range(2))
        keep = _skip_last_quarter(skv, ATTENTION_KEY_TILE)
        out, lse = flash_lse(q, k, v, scale)
        refs = plain_refs(lambda x: attention_reference(q, k, x, scale), v)
        judge("flash_lse", f"{label} {(b, h, sq, skv, d)}", output_error(out, *refs), {
            "row_sum_x1.1": output_error((out.float() / 1.1).bfloat16(), *refs),
            "last_quarter_of_key_tiles_skipped": output_error(
                flash_lse(q, k[:, :keep], v[:, :keep], scale)[0], *refs)})
        check_readings(f"flash_lse {label} logsumexp", lse_error(lse, q, k, scale),
                       {"lse_in_base_2": lse_error(lse / math.log(2.0), q, k, scale)})
        del refs
        out = flash_exp2(q, k, v, scale, valid)
        refs = plain_refs(lambda x: av.exp2_attention_reference(q, k, x, scale, valid), v)
        judge("flash_exp2", f"{label} {(b, h, sq, skv, d)}, {real} valid keys",
              output_error(out, *refs), {
                  "row_sum_x1.1": output_error((out.float() / 1.1).bfloat16(), *refs),
                  "last_quarter_of_key_tiles_skipped": output_error(
                      flash_exp2(q, k[:, :keep], v[:, :keep], scale, valid[:keep]), *refs)})
        del q, k, v, refs
        torch.cuda.empty_cache()
    # the clamp: q x 20 puts scores above 110 (exp2 domain) at a ragged shape
    q, k, v = (randn(1, 1000, 2, d) * 20.0).bfloat16(), *(randn(1, 777, 2, d).bfloat16()
                                                         for _ in range(2))
    refs = plain_refs(lambda x: av.exp2_attention_reference(q, k, x, scale), v)
    judge("flash_exp2", "ragged, scores above 110", output_error(flash_exp2(q, k, v, scale), *refs),
          {"clamp_dropped": output_error(flash_exp2(q, k, v, scale, clamp=False), *refs)})
    del q, k, v, refs
    # the ragged edges and strided views (sound answers only): K5's output
    # and lse; K1b with the last fifth of the keys masked by kv_valid
    rows = {"flash_lse": [], "flash_exp2": []}
    for name, q, k, v in edge_inputs(randn):
        scale = q.shape[-1] ** -0.5
        out, lse = flash_lse(q, k, v, scale)
        readings = output_error(out, *plain_refs(lambda x: attention_reference(q, k, x, scale), v))
        check = lse_error(lse, q, k, scale)
        if not (readings["ok"] and check["ok"]):
            raise AssertionError(f"flash_lse {name} disagrees with its plain version: "
                                 f"{readings}, lse {check}")
        rows["flash_lse"].append(readings["max_row_rel_err"])
        max_err["flash_lse"] = max(max_err["flash_lse"], readings["max_abs_err"])
        skv = k.shape[1]
        valid = (torch.arange(skv, device="cuda") < skv - skv // 5).float()
        readings = output_error(flash_exp2(q, k, v, scale, valid), *plain_refs(
            lambda x: av.exp2_attention_reference(q, k, x, scale, valid), v))
        if not readings["ok"]:
            raise AssertionError(f"flash_exp2 {name} disagrees with its plain version: "
                                 f"{readings}")
        rows["flash_exp2"].append(readings["max_row_rel_err"])
        max_err["flash_exp2"] = max(max_err["flash_exp2"], readings["max_abs_err"])
    for kern, r in rows.items():
        log(f"{kern} at {len(r)} ragged and strided shapes: max row rel err {max(r):.3e}")

    # K6 and K7 at the main path's shapes (heads or frames cut)
    runs = {"flash_pv8": (av.pv8_attention, av.pv8_reference, av.pv8_block_k),
            "int8_flash_attention": (av.int8_attention, av.int8_attention_reference,
                                     av.int8_block_k)}
    cases = [("flash_pv8", "dit_self_heads8", 1, 8, 13330, 13330, 64, 1.0),
             ("flash_pv8", "perceiver_cross", 2, 16, 13104, 3024, 128, 4.0),
             ("flash_pv8", "depth_9216_frames2", 2, 5, 9216, 9216, 64, 4.0),
             ("flash_pv8", "depth_2304_frames8", 8, 10, 2304, 2304, 64, 4.0),
             ("int8_flash_attention", "dit_self_heads8", 1, 8, 13330, 13330, 64, 1.0),
             ("int8_flash_attention", "self_d128", *K7_D128_SHAPE, 1.0)]
    for kern, label, b, h, sq, skv, d, gain in cases:
        run, plain, block_of = runs[kern]
        block_k, scale = block_of(sq), d ** -0.5
        q = (randn(b, sq, h, d) * gain).bfloat16()
        k, v = randn(b, skv, h, d).bfloat16(), randn(b, skv, h, d).bfloat16()
        out = run(q, k, v, scale, block_k)
        refs = plain_refs(lambda x: plain(q, k, x, scale, block_k), v)
        keep = _skip_last_quarter(skv, block_k)
        judge(kern, f"{label} {(b, h, sq, skv, d)} q x {gain:g}, key blocks of {block_k}",
              quantized_error(out, *refs), {
                  "row_sum_x1.1": quantized_error((out.float() / 1.1).bfloat16(), *refs),
                  "last_quarter_of_key_blocks_skipped": quantized_error(
                      run(q, k[:, :keep], v[:, :keep], scale, block_k), *refs)})
        del q, k, v, refs, out
        torch.cuda.empty_cache()
    for kern, (run, plain, block_of) in runs.items():
        s, d = 1000, 64
        block_k, scale = block_of(s), d ** -0.5
        q, k, v = _all_negative(randn, 1, s, 2, d)
        refs = plain_refs(lambda x: plain(q, k, x, scale, block_k), v)
        pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, block_k - s))
        judge(kern, f"ragged all-negative (1, 2, {s}, {s}, {d})",
              quantized_error(run(q, k, v, scale, block_k), *refs),
              {"zero_padded_keys_as_real": quantized_error(
                  run(q, pad(k), pad(v), scale, block_k), *refs)})

    # timing at full shape: K5 and K1b at the bench's, K6 and K7 at the DiT's
    timing = {}
    b, h, s_real, s_pad, d = BENCH_DIT
    scale = d ** -0.5
    valid = (torch.arange(s_pad, device="cuda") < s_real).float()
    q, k, v = ((randn(b, s_pad, h, d) * valid[None, :, None, None]).bfloat16() for _ in range(3))
    bshd = lambda x: x.transpose(1, 2)
    timing["flash_lse"] = {**in_turns(
        {"plain_ms": lambda: (attention_reference(q, k, v, scale, chunk=512),
                              av.lse_reference(q, k, scale, chunk=512)),
         "ms": lambda: flash_lse(q, k, v, scale),
         "library_ms": lambda: torch.ops.aten._scaled_dot_product_flash_attention(
             bshd(q), bshd(k), bshd(v), scale=scale)},
        {"plain_ms": 1, "ms": 3, "library_ms": 3}, cold=("plain_ms",)),
        **attention_bound(b, h, s_pad, s_pad, d, extra_bytes=4 * b * h * s_pad),
        "flop": 4.0 * b * h * s_pad * s_pad * d, "shape": str((b, h, s_pad, s_pad, d)),
        "library": "aten._scaled_dot_product_flash_attention (returns the logsumexp too)"}
    timing["flash_exp2"] = {**in_turns(
        {"plain_ms": lambda: av.exp2_attention_reference(q, k, v, scale, valid, chunk=512),
         "ms": lambda: flash_exp2(q, k, v, scale, valid),
         "library_ms": lambda: sdpa_flash(q, k[:, :s_real], v[:, :s_real], scale)},
        {"plain_ms": 1, "ms": 3, "library_ms": 3}, cold=("plain_ms",)),
        **attention_bound(b, h, s_pad, s_real, d, extra_bytes=s_pad),
        "flop": 4.0 * b * h * s_pad * s_real * d,
        "shape": f"{(b, h, s_pad, s_pad, d)}, {s_real} valid keys",
        "library": "flash SDPA over the valid keys (no clamp)"}
    del q, k, v
    torch.cuda.empty_cache()

    b, h, s, d = DIT_SHAPE
    scale = d ** -0.5
    q, k, v = (randn(b, s, h, d).bfloat16() for _ in range(3))
    v8, vs = av.quantize_per_head(v)
    v8t, vs = av.pv8_keys_last(v8), vs.reshape(-1)  # K6's and K7's V^T
    q8, k8, _, logit, v127 = av.int8_operands(q, k, v, scale)
    pv8_block, int8_block = av.pv8_block_k(s), av.int8_block_k(s)
    yardstick = "flash SDPA: the exact attention the kernel approximates (a yardstick, not the same function)"
    timing["flash_pv8"] = {**in_turns(
        {"plain_ms": lambda: av.pv8_reference(q, k, v, scale, pv8_block),
         "ms": lambda: flash_pv8(q, k, v8t, vs, scale * av.LOG2E, pv8_block),
         "with_quantization_ms": lambda: av.pv8_attention(q, k, v, scale, pv8_block),
         "library_ms": lambda: sdpa_flash(q, k, v, scale)},
        {"plain_ms": 1, "ms": 3, "with_quantization_ms": 3, "library_ms": 3}, cold=("plain_ms",)),
        **attention_bound(b, h, s, s, d, pv_int8=True), "shape": str((b, h, s, s, d)),
        "flop": 4.0 * b * h * s * s * d, "library": yardstick}
    timing["int8_flash_attention"] = {**in_turns(
        {"plain_ms": lambda: av.int8_attention_reference(q, k, v, scale, int8_block),
         "ms": lambda: int8_flash_attention(q8, k8, v8t, logit, v127, int8_block),
         "with_quantization_ms": lambda: av.int8_attention(q, k, v, scale, int8_block),
         "library_ms": lambda: sdpa_flash(q, k, v, scale)},
        {"plain_ms": 1, "ms": 3, "with_quantization_ms": 3, "library_ms": 3}, cold=("plain_ms",)),
        **attention_bound(b, h, s, s, d, pv_int8=True, qk_int8=True, in_bytes=1),
        "flop": 4.0 * b * h * s * s * d, "shape": str((b, h, s, s, d)), "library": yardstick}
    del q, k, v, v8, v8t, q8, k8
    torch.cuda.empty_cache()

    # K7 also at head dim 128, a self-attention shape: "d128_*" keys of its entry
    b, h, sq, skv, d = K7_D128_SHAPE
    scale, block_k = d ** -0.5, av.int8_block_k(sq)
    q, k, v = (randn(b, sq, h, d).bfloat16() for _ in range(3))
    q8, k8, v8, logit, v127 = av.int8_operands(q, k, v, scale)
    v8t = av.pv8_keys_last(v8)
    t = in_turns({"plain_ms": lambda: av.int8_attention_reference(q, k, v, scale, block_k),
                  "ms": lambda: int8_flash_attention(q8, k8, v8t, logit, v127, block_k),
                  "library_ms": lambda: sdpa_flash(q, k, v, scale)},
                 {"plain_ms": 1, "ms": 5, "library_ms": 5})
    bnd = attention_bound(b, h, sq, skv, d, pv_int8=True, qk_int8=True, in_bytes=1)
    timing["int8_flash_attention"].update({
        "d128_shape": str((b, h, sq, skv, d)), "d128_ms": t["ms"], "d128_plain_ms": t["plain_ms"],
        "d128_library_ms": t["library_ms"], "d128_bound_ms": bnd["bound_ms"],
        "d128_sfu_ms": bnd["sfu_ms"]})
    log(f"int8_flash_attention timed at {(b, h, sq, skv, d)}: {t['ms']:.3f} ms, plain "
        f"{t['plain_ms']:.2f} ms, library {t['library_ms']:.3f} ms; bound {bnd['bound_ms']:.3f} ms, "
        f"SFU {bnd['sfu_ms']:.3f} ms")
    del q, k, v, q8, k8, v8, v8t
    torch.cuda.empty_cache()

    # K6 also carries the Perceiver (d 128) and the depth UNet's two kernel
    # levels in run D: "perceiver_*", "depth_*" (9,216 tokens) and
    # "depth_2304_*" keys of its entry
    other = {"perceiver": PERCEIVER_SHAPE,
             "depth": (*DEPTH_SHAPES["depth_9216"][:3], *DEPTH_SHAPES["depth_9216"][2:]),
             "depth_2304": (*DEPTH_SHAPES["depth_2304"][:3], *DEPTH_SHAPES["depth_2304"][2:])}
    for name, (b, h, sq, skv, d) in other.items():
        scale = d ** -0.5
        q = (randn(b, sq, h, d) * 4.0).bfloat16()  # no QK-norm at any of them: peaked rows
        k, v = randn(b, skv, h, d).bfloat16(), randn(b, skv, h, d).bfloat16()
        v8, vs = av.quantize_per_head(v)
        v8t, vs = av.pv8_keys_last(v8), vs.reshape(-1)
        block_k = av.pv8_block_k(sq)
        t = in_turns({"plain_ms": lambda: av.pv8_reference(q, k, v, scale, block_k),
                      "ms": lambda: flash_pv8(q, k, v8t, vs, scale * av.LOG2E, block_k),
                      "library_ms": lambda: sdpa_flash(q, k, v, scale)},
                     {"plain_ms": 1, "ms": 5, "library_ms": 5})
        bnd = attention_bound(b, h, sq, skv, d, pv_int8=True)
        timing["flash_pv8"].update({f"{name}_shape": str((b, h, sq, skv, d)),
                                    f"{name}_ms": t["ms"], f"{name}_plain_ms": t["plain_ms"],
                                    f"{name}_library_ms": t["library_ms"],
                                    f"{name}_bound_ms": bnd["bound_ms"],
                                    f"{name}_sfu_ms": bnd["sfu_ms"]})
        flop = 4.0 * b * h * sq * skv * d
        log(f"flash_pv8 timed at the {name} shape {(b, h, sq, skv, d)}: {t['ms']:.3f} ms "
            f"({flop / t['ms'] / 1e9:.1f} TFLOP/s), plain {t['plain_ms']:.2f} ms, "
            f"library {t['library_ms']:.3f} ms "
            f"({flop / t['library_ms'] / 1e9:.1f} TFLOP/s); bound {bnd['bound_ms']:.3f} ms, SFU "
            f"{bnd['sfu_ms']:.3f} ms")
        del q, k, v, v8, v8t
        torch.cuda.empty_cache()
    for kern, t in timing.items():
        log(f"{kern} timed at {t['shape']}: {t['ms']:.2f} ms ({t['flop'] / t['ms'] / 1e9:.1f} "
            f"TFLOP/s), plain {t['plain_ms']:.2f} ms, library {t['library_ms']:.2f} ms "
            f"({t['flop'] / t['library_ms'] / 1e9:.1f} TFLOP/s); bound {t['bound_ms']:.2f} ms "
            f"({t['bound_by']}),"
            f" SFU {t['sfu_ms']:.2f} ms"
            + (f"; with its quantization pass {t['with_quantization_ms']:.2f} ms"
               if "with_quantization_ms" in t else ""))
    return max_err, timing


def _backward_inputs(randn, b, h, sq, skv, d, gain):
    """q, k, v, K5's (out, lse), a random dout and its di."""
    from trajectorycrafter_tpu_torch.ops.attention import attention_di
    from trajectorycrafter_tpu_torch.ops.kernels import flash_lse

    q = (randn(b, sq, h, d) * gain).bfloat16()
    k, v = randn(b, skv, h, d).bfloat16(), randn(b, skv, h, d).bfloat16()
    out, lse = flash_lse(q, k, v, d ** -0.5)
    dout = randn(b, sq, h, d).bfloat16()
    return q, k, v, out, lse, dout, attention_di(out, dout)


def _backward_grads(q, k, v, dout, lse, di, scale) -> dict:
    from trajectorycrafter_tpu_torch.ops.kernels import (
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )

    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, di, scale)
    return {"dq": flash_attention_bwd_dq(q, k, v, dout, lse, di, scale), "dk": dk, "dv": dv}


def _backward_bound(b, h, sq, skv, d) -> dict:
    """``bound`` of each backward kernel: dK/dV recomputes s and dp and forms
    dV and dK (8 B H Sq Skv D operations), dQ recomputes s and dp and forms
    dQ (6 B H Sq Skv D); both read q, k, v, dout (bf16) and lse, di (fp32)
    and take one exp per score; dK/dV writes dk, dv and dQ writes dq."""
    prod = 2.0 * b * h * sq * skv * d
    inputs = 2 * b * h * d * (2 * sq + 2 * skv) + 8 * b * h * sq
    exps = float(b * h * sq * skv)
    return {"flash_attention_bwd_dkv": bound(ops_bf16=4 * prod, exps=exps,
                                             nbytes=inputs + 4 * b * h * skv * d),
            "flash_attention_bwd_dq": bound(ops_bf16=3 * prod, exps=exps,
                                            nbytes=inputs + 2 * b * h * sq * d)}


def phase_backward_kernels():
    """The attention backward's two kernels (K4-dkv, K4-dq) against the plain
    version at the training shapes, ragged lengths and strided views, with
    planted faults; then timed at full shape in turns with the plain version
    and flash SDPA's backward (one PyTorch call giving dq, dk and dv: the
    yardstick of the two kernels' sum)."""
    import torch

    from trajectorycrafter_tpu_torch.bench_attention import sdpa_flash
    from trajectorycrafter_tpu_torch.ops.attention import (
        BWD_HEAD_TOL,
        attention_backward_error,
        attention_backward_reference,
        attention_di,
    )
    from trajectorycrafter_tpu_torch.ops.kernels import (
        BWD_DKV_QUERY_TILE,
        BWD_DQ_KEY_TILE,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_lse,
    )

    gen = torch.Generator(device="cuda").manual_seed(4)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    max_err = dict.fromkeys(BACKWARD, 0.0)
    # (label, shape, q gain, planted faults): the DiT's flat rows at init
    # (QK-normed scores ~ N(0, 1)), peaked ones (a trained model's; there
    # di carries weight), the Perceiver's unbounded scores, a ragged shape
    cases = [("dit", TRAIN_DIT_SHAPE, 1.0, ("query_tiles", "key_tiles")),
             ("dit_heads8_peaked", (1, 8, *TRAIN_DIT_SHAPE[2:]), 4.0,
              ("di", "query_tiles", "key_tiles")),
             ("perceiver", TRAIN_PERCEIVER_SHAPE, 4.0, ("di", "query_tiles", "key_tiles")),
             ("ragged", (1, 2, 1000, 777, 64), 2.0, ("di", "query_tiles", "key_tiles"))]
    for label, (b, h, sq, skv, d), gain, planted in cases:
        scale = d ** -0.5
        q, k, v, out, lse, dout, di = _backward_inputs(randn, b, h, sq, skv, d, gain)
        held = lambda grads: attention_backward_error(grads, q, k, v, out, lse, dout, scale)
        grads = _backward_grads(q, k, v, dout, lse, di, scale)
        torch.cuda.synchronize()
        faults = {}
        if "di" in planted:
            faults["di_left_out"] = held(_backward_grads(q, k, v, dout, lse,
                                                         torch.zeros_like(di), scale))
        if "query_tiles" in planted:
            n = _skip_last_quarter(sq, BWD_DKV_QUERY_TILE)
            dk, dv = flash_attention_bwd_dkv(q[:, :n], k, v, dout[:, :n],
                                             lse[..., :n].contiguous(),
                                             di[..., :n].contiguous(), scale)
            faults["dkv_last_quarter_of_query_tiles_skipped"] = held({"dk": dk, "dv": dv})
        if "key_tiles" in planted:
            n = _skip_last_quarter(skv, BWD_DQ_KEY_TILE)
            faults["dq_last_quarter_of_key_tiles_skipped"] = held(
                {"dq": flash_attention_bwd_dq(q, k[:, :n], v[:, :n], dout, lse, di, scale)})
        readings = held(grads)
        check_readings(f"attention backward {label} {(b, h, sq, skv, d)} q x {gain:g}",
                       readings, faults)
        for name, key in zip(BACKWARD, ("dk", "dq")):
            err = max(readings[f"{key}_max_abs_err"],
                      readings["dv_max_abs_err"] if key == "dk" else 0.0)
            max_err[name] = max(max_err[name], err)
        del q, k, v, out, lse, dout, di, grads, faults
        torch.cuda.empty_cache()
    # the ragged edges and strided views, sound answers only
    rows = []
    for name, q, k, v in edge_inputs(randn):
        d = q.shape[-1]
        out, lse = flash_lse(q, k, v, d ** -0.5)
        dout = randn(*q.shape).bfloat16()
        if name.startswith("strided"):  # dout a strided view too
            dout = randn(q.shape[0], q.shape[2], q.shape[1], d).bfloat16().transpose(1, 2)
        di = attention_di(out, dout)
        readings = attention_backward_error(_backward_grads(q, k, v, dout, lse, di, d ** -0.5),
                                            q, k, v, out, lse, dout, d ** -0.5)
        if not readings["ok"]:
            raise AssertionError(f"attention backward {name} disagrees with its plain "
                                 f"version: {readings}")
        rows.append(max(readings[f"{g}_max_head_rel_err"] for g in ("dq", "dk", "dv")))
    log(f"attention backward at {len(rows)} ragged and strided shapes: max head rel err "
        f"{max(rows):.3e} (limit {BWD_HEAD_TOL:.3e})")

    # timing at full shape, in turns: plain, dK/dV, dQ, SDPA's backward and back
    timing = {}
    for label, (b, h, sq, skv, d) in (("dit", TRAIN_DIT_SHAPE),
                                      ("perceiver", TRAIN_PERCEIVER_SHAPE)):
        scale = d ** -0.5
        gain = 1.0 if label == "dit" else 4.0
        q, k, v, out, lse, dout, di = _backward_inputs(randn, b, h, sq, skv, d, gain)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        with torch.enable_grad():
            sdpa_out = sdpa_flash(*leaves, scale)
        sdpa_dout = dout.transpose(1, 2)
        t = in_turns({
            "plain_ms": lambda: attention_backward_reference(q, k, v, out, lse, dout, scale),
            "flash_attention_bwd_dkv": lambda: flash_attention_bwd_dkv(q, k, v, dout, lse, di,
                                                                       scale),
            "flash_attention_bwd_dq": lambda: flash_attention_bwd_dq(q, k, v, dout, lse, di,
                                                                     scale),
            "library_ms": lambda: torch.autograd.grad(sdpa_out, leaves, sdpa_dout,
                                                      retain_graph=True)},
            {"plain_ms": 2, "flash_attention_bwd_dkv": 10, "flash_attention_bwd_dq": 10,
             "library_ms": 10})
        bounds = _backward_bound(b, h, sq, skv, d)
        timing[label] = {"shape": str((b, h, sq, skv, d)), **t, "bounds": bounds}
        flop = 2.0 * b * h * sq * skv * d
        dkv, dq = t["flash_attention_bwd_dkv"], t["flash_attention_bwd_dq"]
        log(f"attention backward {label} {(b, h, sq, skv, d)}: dK/dV {dkv:.3f} ms "
            f"({4 * flop / dkv / 1e9:.1f} TFLOP/s; bound "
            f"{bounds['flash_attention_bwd_dkv']['bound_ms']:.3f} ms, SFU "
            f"{bounds['flash_attention_bwd_dkv']['sfu_ms']:.3f}), dQ {dq:.3f} ms "
            f"({3 * flop / dq / 1e9:.1f} TFLOP/s; bound "
            f"{bounds['flash_attention_bwd_dq']['bound_ms']:.3f} ms), both {dkv + dq:.3f} ms; "
            f"flash SDPA backward {t['library_ms']:.3f} ms; plain {t['plain_ms']:.2f} ms")
        del q, k, v, out, lse, dout, di, leaves, sdpa_out
        torch.cuda.empty_cache()
    return max_err, timing


def _backward_entries(err: dict, timing: dict, launches: dict) -> list:
    """The two backward kernels' entries of the kernels JSON line: times at
    the DiT's training shape, the Perceiver's beside them; ``launches`` those
    of one training step of run P."""
    entries = []
    for name in BACKWARD:
        if not launches[name]:
            raise AssertionError(f"run P's training step launched no {name}")
        dit, per = timing["dit"], timing["perceiver"]
        t = {"ms": dit[name], "plain_ms": dit["plain_ms"], "library_ms": dit["library_ms"],
             **dit["bounds"][name], "shape": dit["shape"],
             "library": "flash SDPA backward: dq, dk and dv in one call (the yardstick of "
                        "the two kernels' sum); plain_ms: the plain version's dq, dk and dv",
             "perceiver_shape": per["shape"], "perceiver_ms": per[name],
             "perceiver_plain_ms": per["plain_ms"], "perceiver_library_ms": per["library_ms"],
             "perceiver_bound_ms": per["bounds"][name]["bound_ms"]}
        entries.append(_attention_entry(
            name, t, launches=launches[name],
            launches_run="P (one training step of the full-width DiT)",
            also_replaces="trajectorycrafter_tpu/ops/attention.py:39 (its custom_vjp)",
            redesigned="from mma.sync to wgmma, TMA and a producer-fed ring",
            max_abs_err=err[name]))
    return entries


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
    max_err = dict.fromkeys(INT8_KERNELS, 0.0)
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
               "int_mm_ms": lambda: torch._int_mm(xq, wq.t()),
               "bf16_linear_ms": lambda: F.linear(x, w, b)}
        iters = {"plain_ms": 2, "quantize_plain_ms": 3, "quantize_ms": 10, "gemm_ms": 10,
                 "int_mm_ms": 10, "bf16_linear_ms": 10}

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
        rate = lambda key: f"{t[key]:.3f} ms ({ops / t[key] / 1e9:.1f} TOP/s)"
        bounds = _int8_bounds(name, group)
        line = (f"{name} timed: int8_gemm {rate('gemm_ms')}, torch._int_mm {rate('int_mm_ms')}, "
                f"bf16 F.linear {t['bf16_linear_ms']:.3f} ms "
                f"({ops / t['bf16_linear_ms'] / 1e9:.1f} TFLOP/s); int8_gemm bound "
                f"{bounds['int8_gemm']['bound_ms']:.3f} ms ({bounds['int8_gemm']['bound_by']}), "
                f"plain {t['plain_ms']:.3f} ms; int8_quantize_rows {t['quantize_ms']:.3f} ms "
                f"(plain {t['quantize_plain_ms']:.3f})")
        if "fused_ms" in t:
            fused = "int8_gemm_gelu_quant" if name == "dit_ff1" else "int8_gemm_gscale"
            line += (f"; {fused} {rate('fused_ms')}, bound {bounds[fused]['bound_ms']:.3f} ms, "
                     f"plain {t['fused_plain_ms']:.3f} ms")
        log(line)
        del x, w, wq, ws, b, xq, xs, fns
        torch.cuda.empty_cache()
    return max_err, per_shape


def _int8_bounds(name: str, group: int) -> dict:
    """``bound`` of each int8 kernel at INT8_SHAPES[name]: K2a reads x (bf16)
    and writes codes and row scales; the GEMMs read the codes, the scales
    and the bias (fp32 once converted) and write their outputs."""
    m, k, n, bias = INT8_SHAPES[name]
    gemm_in = m * k + n * k + 4 * m + 4 * n + (4 * n if bias else 0)
    ops = 2.0 * m * k * n
    return {
        "int8_quantize_rows": bound(nbytes=2 * m * k + m * k + 4 * m),
        "int8_gemm": bound(ops_int8=ops, nbytes=gemm_in + 2 * m * n),
        "int8_gemm_gelu_quant": bound(ops_int8=ops, nbytes=gemm_in + m * n + 4 * m * n / group),
        "int8_gemm_gscale": bound(ops_int8=ops, nbytes=gemm_in - 4 * m + 4 * m * k / group
                                  + 2 * m * n),
    }


def _launches_per_path(runs: dict, kern: str) -> dict:
    """A kernel's launches in each stage of each main-path run."""
    return {f"run {r} {p}": runs[r]["per_path"][p][kern]
            for r in runs for p in ("depth", "denoise")}


def _run_launches(runs: dict, run: str, kern: str) -> int:
    return sum(runs[run]["per_path"][p][kern] for p in ("depth", "denoise"))


def _int8_entries(runs: dict, max_err: dict, per_shape: dict) -> list:
    """The int8 kernels' entries of the kernels JSON line."""
    from trajectorycrafter_tpu_torch.ops.int8_matmul import FF_GROUP

    src = "trajectorycrafter_tpu_torch/csrc/"
    shape = lambda name: "(M {}, K {}, N {})".format(*INT8_SHAPES[name][:3])
    entry = lambda kern, run, **kw: {
        "name": kern, "route": "cuda", "source": f"{src}{kern}.cu",
        "replaces": TPU_KERNELS[kern], "launches": _run_launches(runs, run, kern),
        "launches_run": run, "launches_per_path": _launches_per_path(runs, kern),
        "max_abs_err": max_err[kern], **kw}
    ff1, ff2, qkvo = per_shape["dit_ff1"], per_shape["dit_ff2"], per_shape["dit_qkvo"]
    return [
        entry("int8_quantize_rows", "A", ms=qkvo["quantize_ms"],
              plain_ms=qkvo["quantize_plain_ms"], library_ms=None,
              **_int8_bounds("dit_qkvo", FF_GROUP)["int8_quantize_rows"],
              bf16_linear_ms=qkvo["bf16_linear_ms"],
              shape=f"x {shape('dit_qkvo')} (bf16_linear_ms: the q/k/v/out linear it feeds)"),
        entry("int8_gemm", "A", ms=ff1["gemm_ms"], plain_ms=ff1["plain_ms"],
              library_ms=ff1["int_mm_ms"],
              library="torch._int_mm: the int32 product only, no dequantizing epilogue",
              **_int8_bounds("dit_ff1", FF_GROUP)["int8_gemm"],
              bf16_linear_ms=ff1["bf16_linear_ms"], shape=shape("dit_ff1"),
              per_shape={name: {**{key: t[key] for key in
                                   ("quantize_ms", "gemm_ms", "plain_ms", "int_mm_ms",
                                    "bf16_linear_ms")},
                                **_int8_bounds(name, FF_GROUP)["int8_gemm"]}
                         for name, t in per_shape.items()}),
        entry("int8_gemm_gelu_quant", "B", ms=ff1["fused_ms"], plain_ms=ff1["fused_plain_ms"],
              library_ms=None, **_int8_bounds("dit_ff1", FF_GROUP)["int8_gemm_gelu_quant"],
              bf16_linear_ms=ff1["bf16_linear_ms"], shape=shape("dit_ff1")),
        entry("int8_gemm_gscale", "B", ms=ff2["fused_ms"], plain_ms=ff2["fused_plain_ms"],
              library_ms=None, **_int8_bounds("dit_ff2", FF_GROUP)["int8_gemm_gscale"],
              bf16_linear_ms=ff2["bf16_linear_ms"], shape=shape("dit_ff2")),
    ]


def _kernel_counters():
    from trajectorycrafter_tpu_torch.ops import kernels

    return [getattr(kernels, name) for name in KERNELS]


def _mp4_frames(path) -> int:
    import cv2

    path = Path(path)
    if not path.is_file() or path.stat().st_size == 0:
        raise AssertionError(f"missing or empty output {path}")
    cap = cv2.VideoCapture(str(path))
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return n


def mp4_frame_counts(save_dir) -> tuple:
    return tuple(_mp4_frames(Path(save_dir) / name) for name in MP4S)


def save_scheme_counts(n: int, save_skip: int = 0) -> tuple:
    """Frames of input, render, mask, gen and viz (a boomerang) under the
    save scheme of ``_diffuse_and_save``."""
    kept = n - save_skip
    return (kept, kept, kept, kept, 2 * kept - 1)


def run_mode(tc, run: str, depth_attn: str, dit_attn: str, mode: str = "gradual",
             save_skip: int = 0) -> dict:
    """One ``infer_<mode>`` (``infer_gradual`` unless ``mode`` says otherwise)
    with ``TRAJCRAFTER_DEPTH_ATTN=depth_attn``; the kernel launches of the
    run, split into the depth stage and the rest (the denoise: no other
    stage launches a kernel).  The five mp4s must hold the frame counts of
    the save scheme with ``save_skip``."""
    import numpy as np
    import torch

    from trajectorycrafter_tpu_torch import orchestrator

    counters = _kernel_counters()
    depth_infer = tc.models.depth_infer
    warp = orchestrator.forward_warp_batch
    seen = {}

    def recorded_warp(*args, **kwargs):
        out = warp(*args, **kwargs)
        seen["mask"] = out[1]
        return out

    def counted_depth(*args, **kwargs):
        before = [kern.launches for kern in counters]
        seen["depth"] = depth_infer(*args, **kwargs)
        seen["depth_launches"] = {kern.__name__: kern.launches - b0
                                  for kern, b0 in zip(counters, before)}
        return seen["depth"]

    os.environ["TRAJCRAFTER_DEPTH_ATTN"] = depth_attn
    tc.models.depth_infer = counted_depth
    orchestrator.forward_warp_batch = recorded_warp
    tc.timer.seconds.clear()
    torch.cuda.reset_peak_memory_stats()
    for kern in counters:
        kern.launches = 0
    t0 = time.perf_counter()
    try:
        gen = getattr(tc, f"infer_{mode}")()
        torch.cuda.synchronize()
    finally:
        tc.models.depth_infer = depth_infer
        orchestrator.forward_warp_batch = warp
        del os.environ["TRAJCRAFTER_DEPTH_ATTN"]
    total = time.perf_counter() - t0
    known_share = seen.pop("mask").float().mean().item()
    launches = {kern.__name__: kern.launches for kern in counters}
    log(f"run {run}: infer_{mode}, --sampler_name {tc.cfg.diffusion.sampler_name} at "
        f"{tc.cfg.diffusion.num_inference_steps} steps, --quant {tc.cfg.diffusion.quant}, "
        f"--quant_depth {tc.cfg.depth.quant}, DiT attention {dit_attn}, depth attention "
        f"{depth_attn}: "
        f"{total:.3f} s, peak device "
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
    counts = mp4_frame_counts(cfg.save_dir)
    if counts != save_scheme_counts(cfg.video_length, save_skip):
        raise AssertionError(f"mp4 frame counts {dict(zip(MP4S, counts))}, expected "
                             f"{save_scheme_counts(cfg.video_length, save_skip)}")
    expected_shape = (cfg.video_length, *cfg.diffusion.sample_size, 3)
    if gen.shape != expected_shape:
        raise AssertionError(f"gen shape {gen.shape}, expected {expected_shape}")
    if not np.isfinite(gen).all() or gen.min() < 0.0 or gen.max() > 1.0:
        raise AssertionError("gen is not finite in [0, 1]")
    if gen.max() == gen.min():
        raise AssertionError("gen is constant")
    log(f"  gen {gen.shape} in [{gen.min():.4f}, {gen.max():.4f}], std {gen.std():.4f}; "
        f"five mp4s in {cfg.save_dir} of {dict(zip(MP4S, counts))} frames; known share of "
        f"the warp {known_share:.6f}")
    return {"seconds": total, "per_path": per_path, "depth": depth, "gen": gen,
            "known_share": known_share, "stages": dict(tc.timer.seconds)}


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


def dit_forwards(scheduler, steps: int) -> int:
    """DiT forwards of one denoise at strength 1, as every ``infer_*`` runs
    it: the scheduler's loop length (PNDM: 12 RK calls + S - 3)."""
    return scheduler.num_loop_steps(steps)


def _denoise_launches(dit, dit_kernel: str, forwards: int) -> dict:
    """{kernel: launches} of ``forwards`` DiT forwards (the CFG pair as a
    batch of 2), each launching ``dit_kernel`` once per block and once per
    Perceiver of ``dit``."""
    denoise = {name: 0 for name in KERNELS}
    denoise[dit_kernel] = forwards * (len(dit.transformer_blocks)
                                      + len(dit.perceiver_cross_attention or ()))
    for name, n in _int8_launches_per_forward(dit).items():
        denoise[name] = n * forwards
    return denoise


def _expected_launches(cfg, scheduler, dit, unet, depth_kernel: str, dit_kernel: str) -> dict:
    """{stage: {kernel: launches}} of one ``infer_*``: one UNet forward per
    Euler step and window, and ``dit_forwards`` DiT forwards."""
    from trajectorycrafter_tpu_torch.pipelines.depth import window_starts

    windows = len(window_starts(cfg.video_length, cfg.depth.window_size, cfg.depth.overlap))
    unet_forwards = cfg.depth.num_inference_steps * windows
    depth = {name: 0 for name in KERNELS}
    depth[depth_kernel] = DEPTH_KERNEL_LAUNCHES_PER_FORWARD * unet_forwards
    for name, n in _int8_launches_per_forward(unet).items():
        depth[name] = n * unet_forwards
    forwards = dit_forwards(scheduler, cfg.diffusion.num_inference_steps)
    return {"depth": depth, "denoise": _denoise_launches(dit, dit_kernel, forwards)}


def _set_fuse(dit, fuse) -> None:
    for block in dit.transformer_blocks:
        block.ff.fuse = fuse


def set_impl(model, attention, int8="auto") -> None:
    """Set every ``attention_impl`` and ``int8_impl`` of ``model``."""
    for m in model.modules():
        if hasattr(m, "attention_impl"):
            m.attention_impl = attention
        if hasattr(m, "int8_impl"):
            m.int8_impl = int8


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

    # run: (DiT, FF fused, DiT attention and its kernel, UNet, --quant,
    # --quant_depth, depth attention and its kernel)
    plans = {
        "A": (dit8, None, "auto", "flash_attention", unet, "int8", "none", "flash_stock",
              "flash_attention"),
        "B": (dit8, True, "auto", "flash_attention", unet8, "int8", "int8", "flash_max",
              "flash_maxpass"),
        "C": (dit, None, "auto", "flash_attention", unet, "none", "none", "flash_stock",
              "flash_attention"),
        "D": (dit8, None, "flash_pv8", "flash_pv8", unet, "int8", "none", "flash_pv8",
              "flash_pv8"),
    }
    pipe = tc.models.depth_infer.__self__.pipe
    runs = {}
    frames = cfg.video_length  # tc.cfg is cfg
    for run, (model, fuse, dit_attn, dit_kernel, depth_unet, quant, quant_depth, depth_attn,
              depth_kernel) in plans.items():
        tc.models.pipeline.transformer, pipe.unet = model, depth_unet
        tc.cfg.diffusion.quant, tc.cfg.depth.quant = quant, quant_depth
        # A drives the deployed clip, B-D the cut one
        tc.cfg.video_length = frames if run == "A" else CUT_FRAMES
        _set_fuse(model, fuse)
        set_impl(model, dit_attn)
        try:
            want = _expected_launches(tc.cfg, tc.models.pipeline.scheduler, model, depth_unet,
                                      depth_kernel, dit_kernel)
            runs[run] = run_mode(tc, run, depth_attn, dit_attn)
        finally:
            _set_fuse(model, None)
            set_impl(model, "auto")
        if runs[run]["per_path"] != want:
            raise AssertionError(f"run {run}: kernel launches per stage "
                                 f"{runs[run]['per_path']}, expected {want}")
    tc.models.pipeline.transformer, pipe.unet = dit, unet
    tc.cfg.diffusion.quant, tc.cfg.depth.quant = cfg.diffusion.quant, cfg.depth.quant
    tc.cfg.video_length = frames

    # B-D on one clip: C's depth is A's route (the bf16 UNet on flash_stock)
    for run, what in (("B", "int8 UNet, flash_max"), ("D", "flash_pv8")):
        rel = np.abs(np.log(runs[run]["depth"] / runs["C"]["depth"]))
        log(f"depth of runs {run} ({what}) and C (bf16 UNet, flash_stock; information): "
            f"median |log ratio| {np.median(rel):.3e}, max {rel.max():.3e}")
    quality = video_quality(runs["C"]["gen"] * 255.0, runs["D"]["gen"] * 255.0)
    log(f"gen of run C (bf16 DiT) against run D (int8 DiT on flash_pv8), information only "
        f"(random weights, 2 steps): {json.dumps(quality)}")
    return tc, runs, (dit8, unet8)


# Runs E-G of the modes phase: run -> (mode, sampler, denoise steps, save_skip).
# PNDM needs 4 steps (its pseudo-RK warm-up takes the last 4 timesteps): 13
# DiT forwards.  DPM++ at 3 steps takes step 1 second order.
MODE_RUNS = {
    "E": ("direct", "DPM++", 3, 20),
    "F": ("bullet", "Euler A", 2, 0),
    "G": ("zoom", "PNDM", 4, 0),
}
# the samplers driven through the pipeline alone, on run E's conditions: steps
PIPELINE_SAMPLERS = {"Euler": 2, "DDIM_Cog": 2}
# one sampler step, card vs CPU, fp32: relative to the largest magnitude
# (the card may fuse a multiply-add or divide by a scalar's reciprocal)
SAMPLER_STEP_TOL = 1e-5
LATENT_SHAPE = (1, 13, 48, 84, 16)  # the main path's latents at 384x672


class _RecordedPipeline:
    """The pipeline, with the arguments of each call kept."""

    def __init__(self, pipeline):
        self.pipeline, self.calls = pipeline, []

    def __getattr__(self, name):
        return getattr(self.pipeline, name)

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        return self.pipeline(*args, **kwargs)


def sampler_step(name: str, device: str, draws: list):
    """One step of sampler ``name`` (entry 3 of 6 steps: DPM++ second order,
    PNDM the last call of its first RK step) -> every tensor it returns,
    concatenated."""
    import torch

    from trajectorycrafter_tpu_torch.schedulers import SCHEDULER_REGISTRY
    from trajectorycrafter_tpu_torch.schedulers.pndm import PNDMLoopState

    sched = SCHEDULER_REGISTRY[name]()
    state, i = sched.set_timesteps(6), 3
    sample, out, extra, ets = (x.to(device) for x in draws)
    if name == "Euler A":
        return sched.step(state, out, i, sample, noise=extra)
    if name == "DPM++":
        return torch.cat(sched.step(state, out, i, sample, prev_x0=extra, num_steps=6))
    if name == "PNDM":
        new, loop = sched.step(state, out, i, sample, PNDMLoopState(ets, i, extra, extra))
        return torch.cat([new, loop.ets.flatten(0, 1), loop.cur_sample, loop.acc])
    return sched.step(state, out, i, sample)


def sampler_step_draws() -> list:
    """The seeded fp32 inputs of ``sampler_step``, on the CPU."""
    import torch

    gen = torch.Generator().manual_seed(0)
    draws = [torch.randn(LATENT_SHAPE, generator=gen) for _ in range(3)]
    draws.append(torch.randn((4, *LATENT_SHAPE), generator=gen))
    return draws


def sampler_step_error(name: str, draws: list) -> tuple:
    """``sampler_step`` of ``name`` on the card against the CPU -> (max abs
    error, scale); the card's step agrees when the error is at most
    ``SAMPLER_STEP_TOL`` x scale, the largest magnitude involved."""
    want = sampler_step(name, "cpu", draws)
    got = sampler_step(name, "cuda", draws)
    if not got.is_cuda or got.dtype != want.dtype:
        raise AssertionError(f"sampler {name}: the card's step gave {got.device} {got.dtype}")
    scale = max(1.0, max(x.abs().max().item() for x in draws), want.abs().max().item())
    return (got.cpu() - want).abs().max().item(), scale


def phase_modes(tc, dit8, runs: dict) -> None:
    """Runs E-G: ``infer_direct`` (DPM++), ``infer_bullet`` (Euler A) and
    ``infer_zoom`` (PNDM) through ``TrajCrafter``'s entry points on run A's
    models (the int8 DiT, the bf16 UNet on ``flash_stock``), each with its
    sampler set in the config and the pipeline's scheduler built from the
    registry; then Euler and DDIM_Cog through the pipeline on the
    conditions recorded from run E (no second depth stage); each with its
    kernel launches held to the counts derived from the modules and the
    scheduler's loop length.  Then one step of each of the six samplers on
    the card against the same step on the CPU.  The runs join ``runs``."""
    import numpy as np
    import torch

    from trajectorycrafter_tpu_torch.schedulers import SCHEDULER_REGISTRY

    cfg = tc.cfg
    pipeline = tc.models.pipeline
    unet = tc.models.depth_infer.__self__.pipe.unet
    saved = (pipeline.transformer, pipeline.scheduler, cfg.diffusion.sampler_name,
             cfg.diffusion.num_inference_steps, cfg.video_length)
    pipeline.transformer = dit8
    cfg.video_length = CUT_FRAMES
    recorder = _RecordedPipeline(pipeline)
    try:
        for run, (mode, sampler, steps, cut) in MODE_RUNS.items():
            cut = max(0, min(cut, cfg.video_length // 2))  # infer_direct's clamp
            cfg.diffusion.sampler_name, cfg.diffusion.num_inference_steps = sampler, steps
            pipeline.scheduler = SCHEDULER_REGISTRY[cfg.diffusion.sampler_name]()
            want = _expected_launches(cfg, pipeline.scheduler, dit8, unet, "flash_attention",
                                      "flash_attention")
            if run == "E":
                tc.models.pipeline = recorder
            try:
                runs[run] = run_mode(tc, run, "flash_stock", "auto", mode=mode,
                                     save_skip=cut)
            finally:
                tc.models.pipeline = pipeline
            runs[run].pop("gen")
            if runs[run]["per_path"] != want:
                raise AssertionError(f"run {run}: kernel launches per stage "
                                     f"{runs[run]['per_path']}, expected {want}")
            log(f"  run {run}: {dit_forwards(pipeline.scheduler, steps)} DiT forwards "
                f"({sampler}, {steps} steps), launches as derived")

        (args, kwargs), = recorder.calls
        counters = _kernel_counters()
        for sampler, steps in PIPELINE_SAMPLERS.items():
            cfg.diffusion.sampler_name = sampler
            pipeline.scheduler = SCHEDULER_REGISTRY[cfg.diffusion.sampler_name]()
            pipeline.timer.seconds.clear()
            torch.cuda.reset_peak_memory_stats()
            for kern in counters:
                kern.launches = 0
            t0 = time.perf_counter()
            out = pipeline(*args, **{**kwargs, "num_inference_steps": steps,
                                     "generator": torch.Generator(device="cuda").manual_seed(
                                         cfg.seed)})
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            launches = {kern.__name__: kern.launches for kern in counters}
            want = _denoise_launches(dit8, "flash_attention",
                                     dit_forwards(pipeline.scheduler, steps))
            log(f"{sampler} through the pipeline on run E's conditions, {steps} steps: "
                f"{total:.3f} s, peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            for stage, sec in pipeline.timer.seconds.items():
                log(f"  stage {stage}: {sec:.3f} s")
            log(f"  kernel launches: {json.dumps(launches)}")
            if launches != want:
                raise AssertionError(f"{sampler}: kernel launches {launches}, expected {want}")
            shape = (1, cfg.video_length, *cfg.diffusion.sample_size, 3)
            if tuple(out.shape) != shape or not torch.isfinite(out).all() or \
                    out.min() < 0.0 or out.max() > 1.0 or out.max() == out.min():
                raise AssertionError(f"{sampler}: output {tuple(out.shape)} is not a finite, "
                                     f"non-constant {shape} video in [0, 1]")
            log(f"  video {tuple(out.shape)} in [{out.min().item():.4f}, "
                f"{out.max().item():.4f}], std {out.float().std().item():.4f}")
            runs[sampler] = {"seconds": total, "stages": dict(pipeline.timer.seconds),
                             "per_path": {"depth": {name: 0 for name in KERNELS},
                                          "denoise": launches}}
        del args, kwargs, out
        recorder.calls.clear()
    finally:
        (pipeline.transformer, pipeline.scheduler, cfg.diffusion.sampler_name,
         cfg.diffusion.num_inference_steps, cfg.video_length) = saved

    draws = sampler_step_draws()
    for name in SCHEDULER_REGISTRY:
        err, scale = sampler_step_error(name, draws)
        log(f"sampler {name}: one step on {LATENT_SHAPE}, card vs CPU: max abs err {err:.3e} "
            f"(limit {SAMPLER_STEP_TOL} x {scale:.3f})")
        if not np.isfinite(err) or err > SAMPLER_STEP_TOL * scale:
            raise AssertionError(f"sampler {name}: the card's step disagrees with the CPU's")


# The clip length of runs B-J, N and O: runs A, L, M and P drive the
# deployed 49 frames (13 latent frames, the DiT's 13,330 joint tokens); the
# others read 25 (7 latent frames).  The launches per depth stage and per
# DiT forward do not depend on the frame count (one depth window either
# way), and phases 3-4b hold every kernel at the full shapes.  The cut keeps
# the smoke near 500 s on one H100 (653 s with these runs at 49 frames).
CUT_FRAMES = 25
# Runs H-J of phase 5c (the long-trajectory and known-camera paths), on run
# A's models: 2 segments sharing 8 frames, so 2 depth stages and 2
# diffusions each, at segments of ``CUT_FRAMES`` (42 poses).  J reads
# ``CUT_FRAMES``.
LONG_RUN = dict(n_splits=2, overlap_frames=8, theta=30.0)
LONG_SEGMENTS = {"H": CUT_FRAMES, "I": CUT_FRAMES}
MAX_POINTS = 4_000_000  # v2's default cloud limit
# Phase 8's scripts read 9 frames of the clip (one depth window still; the
# launches per depth stage and per DiT forward do not depend on the frame
# count): runs I, J, M and N drive the same classes on longer clips.
SCRIPT_FRAMES = 9
# run J's two Panoptic-style cameras (t in cm), at the warp size's intrinsics
PANOPTIC_CAMERAS = [
    {"name": "00_00", "K": [[500.0, 0.0, 512.0], [0.0, 500.0, 288.0], [0.0, 0.0, 1.0]],
     "R": [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], "t": [[0.0], [0.0], [0.0]],
     "distCoef": [0.0, 0.0, 0.0, 0.0, 0.0]},
    {"name": "00_01", "K": [[520.0, 0.0, 500.0], [0.0, 520.0, 290.0], [0.0, 0.0, 1.0]],
     "R": [[0.98481, 0.0, 0.17365], [0.0, 1.0, 0.0], [-0.17365, 0.0, 0.98481]],
     "t": [[30.0], [0.0], [5.0]], "distCoef": [0.0, 0.0, 0.0, 0.0, 0.0]},
]
# the tiled-decode check: the latents of 17 frames at 576x1024 (the tiles are
# spatial; 5 latent frames keep the VAE's chunking of 13: a first chunk of 3,
# then chunks of 2), and the tilings -- one tile as large as the frame (no
# overlap), the JAX default tile, the auto route's strips; the auto route's
# choice is read at the latents of 49 frames, ``DEPLOYED_LATENTS``
TILED_LATENTS = (1, 5, 72, 128, 16)
DEPLOYED_LATENTS = (1, 13, 72, 128, 16)
TILINGS = {"one_tile": (72, 128, 0.0, 0.0), "jax_default": (30, 45, 1.0 / 6.0, 1.0 / 5.0),
           "strips": (24, 128, 1.0 / 7.0, 0.0)}


@contextlib.contextmanager
def counted_depth(models=None):
    """Within the block, each depth stage's kernel launches add into the
    yielded {kernel: launches} and its outputs join ``["outputs"]``: through
    ``models.depth_infer`` when ``models`` is given, else through every
    ``DepthCrafterDemo`` built inside the block."""
    import numpy as np

    from trajectorycrafter_tpu_torch.pipelines.depth import DepthCrafterDemo

    counters = _kernel_counters()
    seen = {"launches": {kern.__name__: 0 for kern in counters}, "outputs": []}

    def wrap(infer):
        def counted(*args, **kwargs):
            before = [kern.launches for kern in counters]
            out = infer(*args, **kwargs)
            for kern, b0 in zip(counters, before):
                seen["launches"][kern.__name__] += kern.launches - b0
            seen["outputs"].append((out.shape, float(out.min()), float(out.max()),
                                    bool(np.isfinite(out).all())))
            return out
        return counted

    if models is not None:
        infer = models.depth_infer
        models.depth_infer = wrap(infer)
    else:
        infer = DepthCrafterDemo.infer
        DepthCrafterDemo.infer = lambda self, *a, **kw: wrap(infer.__get__(self))(*a, **kw)
    try:
        yield seen
    finally:
        if models is not None:
            models.depth_infer = infer
        else:
            DepthCrafterDemo.infer = infer


def drive(run: str, fn, models=None) -> dict:
    """Run ``fn()`` with every kernel count set to 0 just before and read just
    after, split into the depth stages (``counted_depth``) and the rest (the
    denoise: no other stage launches a kernel) -> {"out", "seconds",
    "per_path", "depth_outputs", "peak_gib"}."""
    import torch

    counters = _kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    with counted_depth(models) as seen:
        for kern in counters:
            kern.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {kern.__name__: kern.launches for kern in counters}
    depth = seen["launches"]
    per_path = {"depth": depth, "denoise": {n: launches[n] - depth[n] for n in launches}}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"run {run}: {seconds:.3f} s, peak device memory {peak:.2f} GiB")
    log(f"  kernel launches per stage: {json.dumps(per_path)}")
    return {"out": out, "seconds": seconds, "per_path": per_path,
            "depth_outputs": seen["outputs"], "peak_gib": peak}


def _times(launches: dict, k: int) -> dict:
    return {stage: {name: n * k for name, n in per.items()} for stage, per in launches.items()}


def _check_depths(run: str, outputs: list, count: int, cfg) -> None:
    want = (cfg.video_length, 1, *cfg.warp_size)
    if len(outputs) != count or any(
            shape != want or not finite or lo < cfg.render.near or hi > cfg.render.far
            for shape, lo, hi, finite in outputs):
        raise AssertionError(f"run {run}: depth stages {outputs}, expected {count} of {want} "
                             f"finite in [near, far]")


def _check_video(run: str, video, frames: int, size) -> None:
    import numpy as np

    shape = (frames, *size, 3)
    if video.shape != shape or not np.isfinite(video).all() or video.min() < 0.0 or \
            video.max() > 1.0 or video.max() == video.min():
        raise AssertionError(f"run {run}: output {video.shape} is not a finite, non-constant "
                             f"{shape} video in [0, 1]")
    log(f"  output {video.shape} in [{video.min():.4f}, {video.max():.4f}], "
        f"std {video.std():.4f}")


def ply_vertices(path) -> int:
    with open(path) as f:
        for line in f:
            if line.startswith("element vertex"):
                return int(line.split()[-1])
    raise AssertionError(f"{path} has no vertex count")


def _check_scene(run: str, scene: Path, vertices: int, cameras: int) -> None:
    got = ply_vertices(scene / "points.ply")
    cams = len((scene / "cameras.txt").read_text().splitlines()) - 1
    if got != vertices or cams != cameras or not (scene / "viewer.html").stat().st_size or \
            not (scene / "points3D.txt").stat().st_size:
        raise AssertionError(f"run {run}: scene of {got} points and {cams} cameras, expected "
                             f"{vertices} and {cameras}, with the viewer and points3D.txt")
    log(f"  scene: {got} points (the merged cloud downsampled), {cams} cameras, "
        f"points.ply {(scene / 'points.ply').stat().st_size / 1e6:.1f} MB, viewer.html "
        f"{(scene / 'viewer.html').stat().st_size / 1e6:.1f} MB")


def phase_long_paths(tc, dit8, runs: dict) -> None:
    """Runs H-J on run A's models (the int8 DiT, the bf16 UNet on
    ``flash_stock``): H ``TrajCrafterAutoregressive.infer_autoregressive``, I
    ``TrajCrafterGlobalPointCloud.infer_autoregressive`` (the default
    ``max_points``), J ``CameraPoseTrajCrafter.infer_camera_poses_smooth``
    between two Panoptic-style cameras with a held-out target video; each
    with its launches held to the counts of one depth stage and one
    diffusion (``_expected_launches``) times its depth stages and diffusions.
    Then the tiled VAE decode at 576x1024.  The runs join ``runs``."""
    import dataclasses

    import numpy as np
    import torch

    from trajectorycrafter_tpu_torch.autoregressive import (
        TrajCrafterAutoregressive,
        TrajCrafterGlobalPointCloud,
    )
    from trajectorycrafter_tpu_torch.known_poses import CameraPoseTrajCrafter, panoptic_to_camera

    cfg = tc.cfg
    pipeline = tc.models.pipeline
    unet = tc.models.depth_infer.__self__.pipe.unet
    saved = pipeline.transformer
    pipeline.transformer = dit8
    os.environ["TRAJCRAFTER_DEPTH_ATTN"] = "flash_stock"
    one = _expected_launches(cfg, pipeline.scheduler, dit8, unet, "flash_attention",
                             "flash_attention")
    try:
        for run, cls in (("H", TrajCrafterAutoregressive), ("I", TrajCrafterGlobalPointCloud)):
            segment = LONG_SEGMENTS[run]
            frames = 2 * (segment - LONG_RUN["overlap_frames"]) + LONG_RUN["overlap_frames"]
            run_cfg = dataclasses.replace(cfg, save_dir=os.path.join(cfg.out_dir, f"long_{run}"),
                                          video_length=segment)
            variant = cls(run_cfg, models=tc.models)
            variant.timer.seconds.clear()
            log(f"run {run}: {cls.__name__}.infer_autoregressive({LONG_RUN}), "
                f"{frames} poses in 2 windows of {segment}")
            r = drive(run, lambda: variant.infer_autoregressive(**LONG_RUN), tc.models)
            for stage, sec in variant.timer.seconds.items():
                log(f"  stage {stage}: {sec:.3f} s")
            _check_depths(run, r["depth_outputs"], 2, run_cfg)
            _check_video(run, r.pop("out"), frames, cfg.diffusion.sample_size)
            counts = mp4_frame_counts(run_cfg.save_dir)
            if counts != save_scheme_counts(segment):
                raise AssertionError(f"run {run}: mp4 frame counts {counts}")
            if run == "I":
                _check_scene(run, Path(run_cfg.save_dir) / "scene", MAX_POINTS, frames)
            runs[run] = {**r, "stages": dict(variant.timer.seconds)}
            if r["per_path"] != _times(one, 2):
                raise AssertionError(f"run {run}: kernel launches per stage {r['per_path']}, "
                                     f"expected {_times(one, 2)}")

        # J: the smooth camera fly between two calibrated cameras
        run_cfg = dataclasses.replace(cfg, save_dir=os.path.join(cfg.out_dir, "known_J"),
                                      video_length=CUT_FRAMES)
        variant = CameraPoseTrajCrafter(run_cfg, models=tc.models)
        variant.timer.seconds.clear()
        src, tgt = (panoptic_to_camera(c) for c in PANOPTIC_CAMERAS)
        frames = variant._load_frames()
        held_out = np.ascontiguousarray(frames[:, :, ::-1])  # a stand-in target view
        log("run J: CameraPoseTrajCrafter.infer_camera_poses_smooth between two Panoptic "
            "cameras, depth estimated, a held-out target video")
        r = drive("J", lambda: variant.infer_camera_poses_smooth(
            frames, None, src, tgt, target_frames=held_out), tc.models)
        for stage, sec in variant.timer.seconds.items():
            log(f"  stage {stage}: {sec:.3f} s")
        gen, metrics = r.pop("out")
        _check_depths("J", r["depth_outputs"], 1, run_cfg)
        _check_video("J", gen, run_cfg.video_length, cfg.diffusion.sample_size)
        written = json.loads((Path(run_cfg.save_dir) / "metrics.json").read_text())
        if written["metrics"] != metrics["metrics"] or not all(
                np.isfinite(v) for v in metrics["metrics"].values()):
            raise AssertionError(f"run J: metrics {metrics['metrics']}, written {written}")
        log(f"  metrics.json (information, random weights): {json.dumps(metrics['metrics'])}")
        runs["J"] = {**r, "stages": dict(variant.timer.seconds)}
        if r["per_path"] != one:
            raise AssertionError(f"run J: kernel launches per stage {r['per_path']}, "
                                 f"expected {one}")
    finally:
        pipeline.transformer = saved
        del os.environ["TRAJCRAFTER_DEPTH_ATTN"]
    phase_tiled_decode(pipeline.vae)


def phase_tiled_decode(vae) -> None:
    """The tiled VAE decode at 17 frames of 576x1024 on the card: one tile as
    large as the frame bit-equal to ``vae_decode``, the JAX default tile and
    the auto route's strips finite and of the decode's shape; each decode's
    time and peak memory beside the one-shot decode's, and the auto route's
    choice on this card at 49 frames."""
    import torch

    from trajectorycrafter_tpu_torch.models.vae import (
        decode_is_tiled,
        decode_memory_bytes,
        vae_decode,
        vae_decode_tiled,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    latents = torch.randn(TILED_LATENTS, generator=gen, device="cuda").to(
        next(vae.parameters()).dtype)
    memory = decode_memory_bytes("cuda")
    tiled = decode_is_tiled(DEPLOYED_LATENTS, memory)
    log(f"tiled decode at {TILED_LATENTS}; at {DEPLOYED_LATENTS} vae_decode_auto on this card "
        f"({memory / 1e9:.1f} GB) picks {'strips' if tiled else 'the one-shot decode'}")
    if tiled:
        raise AssertionError("vae_decode_auto tiles 49 frames at 576x1024 on an 80 GB card")

    def timed(label, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        log(f"  {label}: {seconds:.3f} s, peak {peak:.2f} GiB above the "
            f"{base / 2**30:.2f} GiB resident")
        return out

    want = timed("one-shot vae_decode", lambda: vae_decode(vae, latents).float())
    shape = (1, 1 + 4 * (TILED_LATENTS[1] - 1), 576, 1024, 3)
    if tuple(want.shape) != shape or not torch.isfinite(want).all():
        raise AssertionError(f"one-shot decode {tuple(want.shape)}")
    for label, tiling in TILINGS.items():
        got = timed(f"vae_decode_tiled {label} {tiling}",
                    lambda: vae_decode_tiled(vae, latents, *tiling))
        if tuple(got.shape) != shape or not torch.isfinite(got).all():
            raise AssertionError(f"tiled decode {label}: {tuple(got.shape)}, not finite")
        if label == "one_tile" and not torch.equal(got, want):
            raise AssertionError("the tiled decode at one tile is not the one-shot decode")
        log(f"    max |tiled - one-shot| {(got - want).abs().max().item():.4f} "
            f"(one tile: bit-equal required)")
        del got
    del want, latents
    torch.cuda.empty_cache()


# Runs M-O of phase 5d (the consistent-depth path and the Gradio callback),
# on run A's models: M and N, two segments each with 2 alignment epochs (of
# the deployed 50), M with the seeded vitl VDA in VP mode, N with
# DepthCrafter and ``align_window``; O, the Gradio callback with the "Orbit
# Left" preset at 2 steps on ``CUT_FRAMES``.
CONSISTENT_RUN = dict(n_splits=2, theta=30.0)
# M's segments keep the clip's 49 frames (the VDA's two 32-frame windows);
# N's read ``CUT_FRAMES``
CONSISTENT_SEGMENTS = {"M": 49, "N": CUT_FRAMES}
ALIGN_EPOCHS = 2
VDA_SEED = 7
# The seeded VDA's last convolution (``head.scratch.output_conv2.2``): with
# torch's default initialisation its output varies by ~0.015 about ~0.01, and
# the head ends in a ReLU, so its inverse depth would be ~0 everywhere and
# DEPTH_SCALE / inverse depth degenerate.  Its weight x 40,000 and a bias of
# 3,000 put the inverse depth near 2,000-5,000, which DEPTH_SCALE 10,000
# turns into metric depths of 2-5 units as a real clip's, varying enough for
# the closed-form scale and shift to be well posed.  The module is unchanged.
VDA_HEAD_GAIN, VDA_HEAD_BIAS = 4.0e4, 3000.0
# the alignment's working size at resize_factor 2: 576 x 1024 -> 280 x 504
ALIGN_HW = (280, 504)


def seeded_vda():
    """The vitl VDA on the card, fp32: torch's default initialisation from
    ``VDA_SEED``, the last convolution set as ``VDA_HEAD_GAIN`` / ``_BIAS``
    say."""
    import torch

    from trajectorycrafter_tpu_torch.models.vda import VideoDepthAnything, vda_vitl_config

    torch.manual_seed(VDA_SEED)
    with torch.device("cuda"):
        vda = VideoDepthAnything(vda_vitl_config()).eval()
    with torch.no_grad():
        last = vda.head.scratch.output_conv2[2]
        last.weight.mul_(VDA_HEAD_GAIN)
        last.bias.fill_(VDA_HEAD_BIAS)
    return vda


@contextlib.contextmanager
def recorded(module, name: str, calls: list):
    """Within the block, each call of ``module.<name>`` appends (args,
    kwargs, result) to ``calls``."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def _check_aligned(run: str, calls: list, mask_arg: int) -> None:
    """Each recorded alignment's depth finite everywhere and positive where
    its sparse mask (positional argument ``mask_arg``) is set."""
    import numpy as np

    if len(calls) != 1:
        raise AssertionError(f"run {run}: {len(calls)} alignment stages, expected 1")
    for args, _, aligned in calls:
        mask = np.asarray(args[mask_arg]) > 0.5
        if not np.isfinite(aligned).all() or not mask.any() or (aligned[mask] <= 0).any():
            raise AssertionError(f"run {run}: the aligned depth is not finite, or not positive "
                                 f"on the sparse mask ({mask.mean():.4f} of the pixels)")
        log(f"  aligned depth {aligned.shape} in [{aligned.min():.4f}, {aligned.max():.4f}], "
            f"on the sparse mask ({mask.mean():.4f} of the pixels) "
            f"[{aligned[mask].min():.4f}, {aligned[mask].max():.4f}]")


def phase_consistent(tc, dit8, runs: dict) -> None:
    """Runs M-O on run A's models (the int8 DiT, the bf16 UNet on
    ``flash_stock``, DDIM_Origin at 2 steps): M
    ``TrajCrafterConsistentDepth.infer_autoregressive`` with the seeded vitl
    VDA (VP mode, ``ALIGN_EPOCHS``), N the same without a VDA (DepthCrafter
    and ``align_window``), O the Gradio callback ``run_pipeline`` with the
    "Orbit Left" preset.  The VDA and the trainer launch no kernel: M's
    launches are two diffusions', N's also two depth stages', O's one
    ``infer_gradual``'s.  M also records the VDA's seconds per window, the
    trainer stage's seconds per epoch and peak memory, and checks the
    aligned depth and the prompt.  The runs join ``runs``."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from trajectorycrafter_tpu_torch import consistent_autoregressive as cons
    from trajectorycrafter_tpu_torch.orchestrator import TrajCrafter
    from trajectorycrafter_tpu_torch.scripts.gradio_app import TRAJ_PRESETS, run_pipeline

    cfg = tc.cfg
    pipeline = tc.models.pipeline
    unet = tc.models.depth_infer.__self__.pipe.unet
    saved = pipeline.transformer
    pipeline.transformer = dit8
    os.environ["TRAJCRAFTER_DEPTH_ATTN"] = "flash_stock"
    one = _expected_launches(cfg, pipeline.scheduler, dit8, unet, "flash_attention",
                             "flash_attention")
    no_depth = {name: 0 for name in KERNELS}
    t0 = time.perf_counter()
    vda = seeded_vda()
    torch.cuda.synchronize()
    log(f"seeded the vitl VDA on the card in {time.perf_counter() - t0:.2f} s "
        f"({sum(p.numel() for p in vda.parameters()) / 1e6:.1f} M parameters, fp32)")
    try:
        for run, model in (("M", vda), ("N", None)):
            run_cfg = dataclasses.replace(cfg, save_dir=os.path.join(cfg.out_dir, f"cons_{run}"),
                                          video_length=CONSISTENT_SEGMENTS[run])
            frames = CONSISTENT_RUN["n_splits"] * run_cfg.video_length
            variant = cons.TrajCrafterConsistentDepth(run_cfg, models=tc.models, vda=model,
                                                      align_epochs=ALIGN_EPOCHS)
            variant.timer.seconds.clear()
            windows, trainer, hooks = [], {}, []
            if model is not None:
                # the VDA's forwards without gradients, timed to the device
                def before(mod, args):
                    if not torch.is_grad_enabled():
                        torch.cuda.synchronize()
                        windows.append([tuple(args[0].shape), time.perf_counter()])

                def after(mod, args, out):
                    if not torch.is_grad_enabled():
                        torch.cuda.synchronize()
                        windows[-1][1] = time.perf_counter() - windows[-1][1]

                hooks = [model.register_forward_pre_hook(before),
                         model.register_forward_hook(after)]
                train = variant.trainer.train

                def measured_train(*args, **kwargs):
                    torch.cuda.synchronize()
                    trainer["before_gib"] = torch.cuda.max_memory_allocated() / 2**30
                    torch.cuda.reset_peak_memory_stats()
                    start = time.perf_counter()
                    out = train(*args, **kwargs)
                    torch.cuda.synchronize()
                    trainer.update(seconds=time.perf_counter() - start,
                                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                                   frames=tuple(args[0].shape))
                    return out
                variant.trainer.train = measured_train
            log(f"run {run}: TrajCrafterConsistentDepth.infer_autoregressive({CONSISTENT_RUN}), "
                f"align_epochs {ALIGN_EPOCHS}, " + ("the seeded vitl VDA, VP mode" if model
                                                    else "DepthCrafter and align_window"))
            aligner = ("estimate_depth_with_prompt_alignment" if model is not None
                       else "estimate_depth_with_alignment")
            try:
                with recorded(cons, aligner, []) as calls:
                    r = drive(run, lambda: variant.infer_autoregressive(**CONSISTENT_RUN),
                              tc.models)
            finally:
                for hook in hooks:
                    hook.remove()
            for stage, sec in variant.timer.seconds.items():
                log(f"  stage {stage}: {sec:.3f} s")
            video = r.pop("out")
            _check_video(run, video, frames, cfg.diffusion.sample_size)
            _check_aligned(run, calls, 2)
            for stage in range(CONSISTENT_RUN["n_splits"]):
                stage_dir = Path(run_cfg.save_dir) / f"stage_{stage:02d}"
                counts = mp4_frame_counts(stage_dir)
                cams = [np.load(stage_dir / f"c2ws_{k}.npy").shape
                        for k in ("target", "source")]
                if counts != save_scheme_counts(run_cfg.video_length) or \
                        cams != [(run_cfg.video_length, 4, 4)] * 2:
                    raise AssertionError(f"run {run}: {stage_dir} holds mp4s of {counts} frames "
                                         f"and cameras {cams}")
            if model is None:
                want = _times(one, 2)
                _check_depths(run, r["depth_outputs"], 2, run_cfg)
            else:
                want = {"depth": no_depth, "denoise": _times(one, 2)["denoise"]}
                if r["depth_outputs"]:
                    raise AssertionError(f"run {run}: DepthCrafter ran with a VDA")
                # the first segment's windows: 49 frames in 2 of 32, at 588 x 1036
                per_window = [sec for shape, sec in windows if shape[-2:] == (588, 1036)]
                if [shape for shape, _ in windows if shape[-2:] == (588, 1036)] != \
                        [(1, 32, 3, 588, 1036)] * 2:
                    raise AssertionError(f"run {run}: VDA forwards {windows}")
                prompt = variant.trainer.last_prompt
                epochs = variant.trainer.epoch_seconds
                if len(epochs) != ALIGN_EPOCHS or trainer.get("frames") != \
                        (run_cfg.video_length, 3, *ALIGN_HW):
                    raise AssertionError(f"run {run}: trainer ran {len(epochs)} epochs on "
                                         f"{trainer.get('frames')}")
                if not torch.isfinite(prompt).all() or not prompt.abs().max() > 0:
                    raise AssertionError(f"run {run}: the visual prompt is zero or not finite")
                if not np.isfinite(variant.trainer.last_losses).all():
                    raise AssertionError(f"run {run}: losses {variant.trainer.last_losses}")
                log(f"  VDA windows (no grad): {len(per_window)}, seconds "
                    f"{[round(w, 3) for w in per_window]}")
                log(f"  trainer stage on {trainer['frames']}: {trainer['seconds']:.3f} s, "
                    f"epochs {[round(e, 3) for e in epochs]} s, peak device memory "
                    f"{trainer['peak_gib']:.2f} GiB; losses "
                    f"{[float(x) for x in variant.trainer.last_losses]}; prompt max |p| "
                    f"{prompt.abs().max().item():.3e}")
                # drive() read the peak since the trainer's reset: the run's is the larger
                r["peak_gib"] = max(r["peak_gib"], trainer["before_gib"])
                log(f"  run {run}: peak device memory {r['peak_gib']:.2f} GiB")
                r.update(vda_window_s=per_window, epoch_s=epochs, trainer=trainer)
            runs[run] = {**r, "stages": dict(variant.timer.seconds)}
            if r["per_path"] != want:
                raise AssertionError(f"run {run}: kernel launches per stage {r['per_path']}, "
                                     f"expected {want}")
            gc.collect()
            torch.cuda.empty_cache()
        del vda

        # O: the Gradio callback on the same models
        o_cfg = copy.deepcopy(cfg)
        o_cfg.save_dir = os.path.join(cfg.out_dir, "gradio_O")
        o_cfg.video_length = CUT_FRAMES
        o_tc = TrajCrafter(o_cfg, models=tc.models)
        o_tc.timer.seconds.clear()
        log(f"run O: gradio run_pipeline, preset Orbit Left ({TRAJ_PRESETS['Orbit Left']}), "
            f"2 steps, seed 43")
        r = drive("O", lambda: run_pipeline(MAIN_ARGV[1], 1, 1.0, TRAJ_PRESETS["Orbit Left"], 2,
                                            43, o_cfg, o_tc), tc.models)
        for stage, sec in o_tc.timer.seconds.items():
            log(f"  stage {stage}: {sec:.3f} s")
        viz = Path(r.pop("out"))
        if viz.parent.parent != Path(o_cfg.save_dir) or o_cfg.render.target_pose != \
                (0.0, -30.0, 0.0, 0.0, 0.0) or mp4_frame_counts(viz.parent) != \
                save_scheme_counts(o_cfg.video_length):
            raise AssertionError(f"run O: {viz}, pose {o_cfg.render.target_pose}")
        _check_depths("O", r["depth_outputs"], 1, o_cfg)
        runs["O"] = {**r, "stages": dict(o_tc.timer.seconds)}
        if r["per_path"] != one:
            raise AssertionError(f"run O: kernel launches per stage {r['per_path']}, "
                                 f"expected {one}")
        log(f"  viz.mp4 of {_mp4_frames(viz)} frames in {viz.parent}")
    finally:
        pipeline.transformer = saved
        del os.environ["TRAJCRAFTER_DEPTH_ATTN"]


def phase_whole_models(tc, dit8, unet8):
    """The whole DiT and the whole depth UNet, bf16 and int8, at full width on
    small inputs: kernels against the plain versions."""
    import torch

    from trajectorycrafter_tpu_torch.ops.kernels import flash_attention, flash_maxpass, flash_pv8

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
        # the DiT on flash_pv8: K6 against its plain version (flash_pv8_reference)
        model = tc.models.pipeline.transformer
        outs = {}
        for impl in ("flash_pv8", "flash_pv8_reference"):
            set_impl(model, impl)
            before = flash_pv8.launches
            outs[impl] = model(*args, **kwargs).float()
            torch.cuda.synchronize()
            expected = DIT_LAYERS + DIT_LAYERS // PERCEIVER_INTERVAL if impl == "flash_pv8" else 0
            if flash_pv8.launches - before != expected:
                raise AssertionError(f"bf16 DiT with {impl}: {flash_pv8.launches - before} "
                                     f"flash_pv8 launches, expected {expected}")
        set_impl(model, "auto")
        held(f"bf16 DiT on flash_pv8, {DIT_LAYERS} layers on {(b, f, h, w)}: kernel vs plain",
             outs["flash_pv8"], outs["flash_pv8_reference"], DIT_REL_TOL)

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


# Run P (phase 5e): LoRA training of the full-width bf16 DiT.  The data: a
# SceneFlow-layout tree the smoke writes (TRAIN_SCENES scenes of
# TRAIN_FRAMES 960 x 540 PNG frames, .pfm disparities, camera_data.txt; the
# camera moves 0.25 units a frame, so the clips pass the motion filter)
# turned into .npz samples at 384 x 672 by ``datagen.generate_dataset`` on
# the smoke's VAE, with the T5-XXL embedding of the prompt.  The training:
# TRAIN_STEPS steps at B = 1, rank 8, v-prediction, dropout 0.1, remat and
# ``flash_stock``.  Then one step's adapter gradients on the kernels against
# the plain versions on the DiT cut to GRAD_CHECK_LAYERS blocks (the plain
# backward of the full sequence would not fit: 48 x 13,330^2 fp32 scores a
# layer), at GRAD_CHECK_LATENTS (F, h, w) latents: the relative L2 error of
# each adapter's gradient, median at most GRAD_MEDIAN_TOL and largest at most
# GRAD_MAX_TOL.  Both sides run bf16 models (the plain attention rounds its
# weights and their gradients to bf16 too), and a few blocks carry the
# per-call differences into every gradient; the adapters whose gradients
# cancel most (the QK-normed to_q / to_k) read the largest (an H100 80GB HBM3
# at 700 W read a median of 3.4e-3 and 3.8e-2 on a to_q).
TRAIN_SCENES = 3
TRAIN_FRAMES = 49
SCENEFLOW_HW = (540, 960)
SCENEFLOW_STEP = 0.25
TRAIN_STEPS = 3
TRAIN_RANK = 8
TRAIN_LR = 1e-4
TRAIN_DROPOUT = 0.1
LATENT_SHAPES = {"gt_latents": (13, 48, 84, 16), "inpaint_latents": (13, 48, 84, 17),
                 "ref_latents": (3, 48, 84, 16), "prompt_embeds": (226, 4096)}
GRAD_CHECK_LAYERS = 4
GRAD_CHECK_LATENTS = (5, 32, 56)
GRAD_MEDIAN_TOL = 2.0 ** -6
GRAD_MAX_TOL = 2.0 ** -3


def _write_pfm(path: Path, img) -> None:
    """A little-endian one-channel PFM (rows bottom to top)."""
    import numpy as np

    h, w = img.shape
    path.write_bytes(f"Pf\n{w} {h}\n-1.0\n".encode()
                     + np.ascontiguousarray(np.flipud(img)).astype("<f4").tobytes())


def write_sceneflow_tree(root: Path, scenes: int, frames: int, seed: int = 0) -> list:
    """<root>/frames_cleanpass/<scene>/left/NNNN.png, disparity/<scene>/left/
    NNNN.pfm and camera_data/<scene>/camera_data.txt at 960 x 540: textured
    frames that drift with the camera, disparities of 20-60 px (depth 17-52
    at f = 1050), the left camera's c2w moving SCENEFLOW_STEP along x and
    turning 0.002 rad a frame.  Returns the scene names."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = SCENEFLOW_HW
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    names = []
    for sc in range(scenes):
        name = f"scene_{sc}"
        names.append(name)
        for sub in (f"frames_cleanpass/{name}/left", f"disparity/{name}/left",
                    f"camera_data/{name}"):
            (root / sub).mkdir(parents=True, exist_ok=True)
        phase = rng.uniform(0, 6.28, 3)
        disp = (20.0 + 40.0 * yy / h + 2.0 * np.sin(xx / 37.0 + sc)).astype(np.float32)
        lines = []
        for i in range(frames):
            shift = xx + 4.0 * i
            rgb = np.stack([127 + 100 * np.sin(shift / (23.0 + 7 * c) + yy / (31.0 + 5 * c)
                                               + phase[c]) for c in range(3)], -1)
            rgb += rng.normal(0, 8, rgb.shape)
            cv2.imwrite(str(root / f"frames_cleanpass/{name}/left/{i:04d}.png"),
                        np.clip(rgb, 0, 255).astype(np.uint8))
            _write_pfm(root / f"disparity/{name}/left/{i:04d}.pfm", disp)
            a = 0.002 * i
            c2w = np.array([[np.cos(a), 0, np.sin(a), SCENEFLOW_STEP * i], [0, 1, 0, 0],
                            [-np.sin(a), 0, np.cos(a), 0], [0, 0, 0, 1]])
            right = c2w.copy()
            right[0, 3] += 1.0
            lines += [f"Frame {i}", "L " + " ".join(f"{v:.9g}" for v in c2w.flatten()),
                      "R " + " ".join(f"{v:.9g}" for v in right.flatten()), ""]
        (root / f"camera_data/{name}/camera_data.txt").write_text("\n".join(lines))
    return names


def _training_launches(dit, steps: int = 1, val_forwards: int = 0) -> dict:
    """{kernel: launches} of ``steps`` training steps of ``dit`` with
    ``flash_stock`` and of ``val_forwards`` forwards without gradients, from
    its modules: a step's forward launches K5 once per block and Perceiver,
    the recomputation under ``remat`` once more per block (the Perceivers
    keep their activations, as JAX's ``nn.remat`` wraps the blocks only), the
    backward each backward kernel once per block and Perceiver; a forward
    without gradients launches K1 once per block and Perceiver."""
    blocks = len(dit.transformer_blocks)
    layers = blocks + len(dit.perceiver_cross_attention or ())
    out = {name: 0 for name in KERNELS}
    out["flash_lse"] = steps * (layers + (blocks if dit.remat else 0))
    out["flash_attention_bwd_dkv"] = out["flash_attention_bwd_dq"] = steps * layers
    out["flash_attention"] = val_forwards * layers
    return out


def _launch_counts() -> dict:
    return {kern.__name__: kern.launches for kern in _kernel_counters()}


def phase_training(tc, data_root: Path) -> dict:
    """Run P: the training data from a SceneFlow tree, TRAIN_STEPS LoRA steps
    of the full-width bf16 DiT, then the adapter gradients on the kernels
    against the plain versions.  Returns the launches of one step."""
    import numpy as np
    import torch

    from trajectorycrafter_tpu_torch import datagen
    from trajectorycrafter_tpu_torch.schedulers import CogVideoXDDIMScheduler
    from trajectorycrafter_tpu_torch.training import (
        TrainState,
        init_lora_params,
        lora_target_paths,
        make_train_step,
    )
    from trajectorycrafter_tpu_torch.training.data import LatentsDataset
    from trajectorycrafter_tpu_torch.training.lora import remove_lora
    from trajectorycrafter_tpu_torch.training.step import make_loss_fn, make_optimizer

    cfg = tc.cfg
    # -- the data --
    t0 = time.perf_counter()
    scenes = write_sceneflow_tree(data_root / "sceneflow", TRAIN_SCENES, TRAIN_FRAMES)
    t_tree = time.perf_counter() - t0
    pe, _ = tc.models.encode_prompt("a scene", cfg.diffusion.negative_prompt)
    prompt = pe[0].float().cpu().numpy()
    vae = tc.models.pipeline.vae
    t0 = time.perf_counter()
    clips = datagen.clips_from_dataset(
        datagen.load_sceneflow_clip(str(data_root / "sceneflow"), name) for name in scenes)
    out_dir = datagen.generate_dataset(vae, str(data_root / "latents"), clips, prompt,
                                       sample_size=tuple(cfg.diffusion.sample_size))
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    data = LatentsDataset(out_dir)
    if len(data) != TRAIN_SCENES:
        raise AssertionError(f"datagen wrote {len(data)} samples, expected {TRAIN_SCENES}")
    for i in range(len(data)):
        sample = data[i]
        shapes = {k: v.shape for k, v in sample.items()}
        if shapes != LATENT_SHAPES or not all(np.isfinite(v).all() for v in sample.values()):
            raise AssertionError(f"sample {i}: shapes {shapes} (expected {LATENT_SHAPES}) "
                                 "or values not finite")
    log(f"run P data: SceneFlow tree of {TRAIN_SCENES} x {TRAIN_FRAMES} frames at "
        f"{SCENEFLOW_HW[1]}x{SCENEFLOW_HW[0]} written in {t_tree:.2f} s; generate_dataset "
        f"{t_data:.2f} s for {len(data)} samples of {json.dumps(shapes)}; inpaint mask "
        f"channel mean {float(sample['inpaint_latents'][..., 0].mean()):.4f}")

    # -- the training steps --
    dit = tc.models.pipeline.transformer
    scheduler = CogVideoXDDIMScheduler()  # the training scheduler of train_lora
    sch_state = scheduler.set_timesteps(50)
    dit.remat = True
    set_impl(dit, "flash_stock")
    gen = torch.Generator(device="cuda").manual_seed(0)
    try:
        lora = init_lora_params(gen, dit, rank=TRAIN_RANK)
        targets = lora_target_paths(dit)
        adapted = sum(dit.get_submodule(n).weight.numel() for n in targets)
        log(f"run P: rank {TRAIN_RANK} adapters on {len(targets)} layers ({adapted / 1e9:.3f} B "
            f"of the DiT's {sum(p.numel() for p in dit.parameters()) / 1e9:.3f} B parameters; "
            f"{sum(v.numel() for v in lora.values()) / 1e6:.2f} M trainable)")
        if len(targets) != 316:
            raise AssertionError(f"{len(targets)} LoRA targets, expected JAX's 316")
        opt = make_optimizer(lr=TRAIN_LR)
        step_fn = make_train_step(dit, scheduler, sch_state, opt,
                                  cfg_dropout_prob=TRAIN_DROPOUT, lora_rank=TRAIN_RANK)
        state = TrainState(lora, opt.init(lora), 0)
        batches = data.iter_batches(1, seed=0)
        step_launches = _training_launches(dit)
        seconds, peaks = [], []
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        names = list(lora)
        initial = {k: v.detach().clone() for k, v in lora.items()}
        # the largest |gradient| of each adapter at each step, as the step hands
        # its gradients to the optimizer
        grad_max, update = [], opt.update
        opt.update = lambda grads, st: (grad_max.append(
            dict(zip(names, torch.stack([g.abs().max() for g in grads]).tolist()))),
            update(grads, st))[1]
        for i in range(TRAIN_STEPS):
            batch = next(batches)
            before = {k: v.detach().clone() for k, v in lora.items()}
            for kern in _kernel_counters():
                kern.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch, gen)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated() / 2**30)
            got = _launch_counts()
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            log(f"run P step {i + 1}: loss {loss:.5f}, grad_norm {gnorm:.5f}, "
                f"{seconds[-1]:.3f} s, peak {peaks[-1]:.2f} GiB ({base_mem / 2**30:.2f} GiB "
                f"resident before the steps); launches {json.dumps(got)}")
            if got != step_launches:
                raise AssertionError(f"run P step {i + 1}: launches {got}, expected "
                                     f"{step_launches}")
            if not (np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0):
                raise AssertionError(f"run P step {i + 1}: loss {loss}, grad_norm {gnorm}")
            moved = {k: (v.detach() - before[k]).abs().max().item() for k, v in lora.items()}
            grads = grad_max[-1]
            if i == 0:
                # B = 0 at init: dA is exactly 0, every dB is not, and every B moves
                wrong = [k for k in names if (grads[k] == 0.0) != k.endswith("lora_A")
                         or (k.endswith("lora_B") and moved[k] == 0.0)]
                if wrong:
                    raise AssertionError(f"run P step 1: {len(wrong)} adapters with dA != 0, "
                                         f"dB = 0 or B unchanged: {wrong[:3]}")
            if i == 1:
                # now B != 0: every dA is nonzero.  Adam moves a value by lr g / (|g|
                # + 1e-8), so an A whose gradient the random weights keep far below
                # 1e-8 moves by less than its rounding beyond the weight decay
                decayed = {k: before[k] * (1 - TRAIN_LR * opt.weight_decay) for k in names}
                beyond = [k for k in names if k.endswith("lora_A")
                          and (lora[k].detach() - decayed[k]).abs().max().item() > 0]
                zero = [k for k in names if k.endswith("lora_A") and grads[k] == 0.0]
                if zero:
                    raise AssertionError(f"run P step 2: {len(zero)} A with a zero gradient: "
                                         f"{zero[:3]}")
                log(f"run P step 2: every dA nonzero (largest |dA| per adapter: min "
                    f"{min(grads[k] for k in names if k.endswith('lora_A')):.3e}, median "
                    f"{float(np.median([grads[k] for k in names if k.endswith('lora_A')])):.3e}); "
                    f"{len(beyond)} of {len(names) // 2} A moved beyond their weight decay")
        unchanged = [k for k in names if torch.equal(lora[k].detach(), initial[k])]
        if unchanged:
            raise AssertionError(f"run P: {len(unchanged)} adapters never changed: {unchanged[:3]}")
        log(f"run P: {TRAIN_STEPS} steps, seconds per step {[round(x, 3) for x in seconds]}, "
            f"peak {max(peaks):.2f} GiB; dA 0 and every dB nonzero at step 1, every B moved at "
            f"step 1, every dA nonzero at step 2, every adapter changed; launches per step as "
            f"derived ({json.dumps({k: v for k, v in step_launches.items() if v})})")
        del state, lora, opt, step_fn, batches, initial
    finally:
        remove_lora(dit)
        dit.remat = False
        set_impl(dit, "auto")
    gc.collect()
    torch.cuda.empty_cache()

    # -- the gradients on the kernels against the plain versions --
    blocks, perceivers = dit.transformer_blocks, dit.perceiver_cross_attention
    dit.transformer_blocks = blocks[:GRAD_CHECK_LAYERS]
    dit.perceiver_cross_attention = perceivers[:GRAD_CHECK_LAYERS // PERCEIVER_INTERVAL]
    dit.remat = True
    try:
        g = torch.Generator(device="cuda").manual_seed(5)
        lora = init_lora_params(g, dit, rank=TRAIN_RANK)
        with torch.no_grad():
            for k, v in lora.items():
                if k.endswith("lora_B"):
                    v.normal_(0.0, 0.02, generator=g)
        f, h, w = GRAD_CHECK_LATENTS
        rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda")
        batch = {"gt_latents": rnd(1, f, h, w, 16), "prompt_embeds": rnd(1, 226, 4096),
                 "ref_latents": rnd(1, 1, h, w, 16), "inpaint_latents": rnd(1, f, h, w, 17),
                 "noise": rnd(1, f, h, w, 16), "timesteps": torch.tensor([400], device="cuda")}
        grads = {}
        for impl in ("flash_stock", "reference"):
            set_impl(dit, impl)
            loss_fn = make_loss_fn(dit, scheduler, sch_state, cfg_dropout_prob=0.0,
                                   lora_rank=TRAIN_RANK)
            for kern in _kernel_counters():
                kern.launches = 0
            loss = loss_fn(lora, batch, 0)
            grads[impl] = dict(zip(lora, torch.autograd.grad(loss, list(lora.values()))))
            torch.cuda.synchronize()
            got = _launch_counts()
            expected = _training_launches(dit) if impl == "flash_stock" else \
                {name: 0 for name in KERNELS}
            if got != expected:
                raise AssertionError(f"run P gradient check, {impl}: launches {got}, "
                                     f"expected {expected}")
            log(f"run P gradient check, attention {impl}: loss {loss.item():.6f}")
        rel = {k: ((grads["flash_stock"][k] - grads["reference"][k]).norm()
                   / grads["reference"][k].norm().clamp_min(1e-30)).item() for k in lora}
        worst = max(rel, key=rel.get)
        median = float(np.median(list(rel.values())))
        log(f"run P gradient check, {GRAD_CHECK_LAYERS} blocks on latents {GRAD_CHECK_LATENTS}: "
            f"adapter gradients on the kernels vs plain, relative L2 median {median:.3e} (limit "
            f"{GRAD_MEDIAN_TOL:.3e}), max {rel[worst]:.3e} ({worst}; limit {GRAD_MAX_TOL:.3e})")
        if not all(np.isfinite(v) for v in rel.values()) or median > GRAD_MEDIAN_TOL \
                or rel[worst] > GRAD_MAX_TOL:
            raise AssertionError(f"run P gradient check: median {median:.3e}, {worst} off by "
                                 f"{rel[worst]:.3e}")
        del lora, grads
    finally:
        remove_lora(dit)
        dit.transformer_blocks, dit.perceiver_cross_attention = blocks, perceivers
        dit.remat = False
        set_impl(dit, "auto")
    gc.collect()
    torch.cuda.empty_cache()
    return step_launches


def phase_train_script(tree: dict, data_dir: str) -> None:
    """``scripts/train_lora.main(argv)`` on the tree's 6-layer DiT and run P's
    samples: 2 steps with validation and a checkpoint after each, then
    ``--resume_from_checkpoint latest`` for one more; launches derived from
    the loaded model (``_training_launches``)."""
    import numpy as np
    import torch

    from trajectorycrafter_tpu_torch.scripts import train_lora

    out = tree["root"] / "lora_out"
    argv = ["--data_dir", data_dir, "--output_dir", str(out), "--transformer_path",
            str(tree["dirs"]["dit"]), "--log_every", "1", "--checkpointing_steps", "1",
            "--seed", "0"]
    for label, extra, steps, vals in (
            ("train", ["--train_steps", "2", "--validate_every", "1", "--val_fraction", "0.34"],
             2, 2),
            ("resume", ["--train_steps", "3", "--resume_from_checkpoint", "latest"], 1, 0)):
        for kern in _kernel_counters():
            kern.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = train_lora.main(argv + extra)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = _launch_counts()
        log(f"script train_lora ({label}): python -m trajectorycrafter_tpu_torch.scripts."
            f"train_lora {' '.join(extra)} on the tree: {seconds:.2f} s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {json.dumps(got)}")
        if label == "train":
            with torch.device("meta"):
                from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel

                cut = CrossTransformer3DModel(num_layers=TREE_DIT_LAYERS, remat=True)
            # one held-out sample (a third of 3) at each of the 2 validations
            want = _training_launches(cut, steps, vals)
            first = {k: v.detach().clone() for k, v in state.lora.items()}
        else:
            want = _training_launches(cut, steps, 0)
        if got != want:
            raise AssertionError(f"train_lora ({label}): launches {got}, expected {want}")
        expected_step = 2 if label == "train" else 3
        if state.step != expected_step or not (out / f"ckpt_{expected_step:07d}").is_dir():
            raise AssertionError(f"train_lora ({label}): step {state.step}, checkpoints "
                                 f"{sorted(os.listdir(out))}")
    recs = [json.loads(line) for line in open(out / "metrics.jsonl")]
    losses = [r["loss"] for r in recs if "loss" in r]
    vals = [r["val_loss"] for r in recs if "val_loss" in r]
    if [r["step"] for r in recs if "loss" in r] != [1, 2, 3] or len(vals) != 2 or \
            not np.isfinite(losses + vals).all():
        raise AssertionError(f"train_lora metrics {recs}")
    moved = max((state.lora[k].detach() - first[k]).abs().max().item() for k in first)
    if not 0 < moved <= 1e-4 * 1.01:
        raise AssertionError(f"train_lora resume: the adapters moved {moved} from step 2's")
    log(f"script train_lora: losses {[round(x, 5) for x in losses]}, val_loss "
        f"{[round(x, 5) for x in vals]}; resumed at step 2 from ckpt_0000002 and moved by "
        f"{moved:.3e} (one AdamW step of lr 1e-4); {sorted(os.listdir(out))}")


def phase_bench() -> dict:
    """The attention bench, once, through its entry point; returns each
    kernel's launches in that run (the counts set to 0 just before it)."""
    from trajectorycrafter_tpu_torch import bench_attention

    counters = _kernel_counters()
    for kern in counters:
        kern.launches = 0
    t0 = time.perf_counter()
    bench_attention.main([])
    launches = {kern.__name__: kern.launches for kern in counters}
    log(f"attention bench: {time.perf_counter() - t0:.1f} s; kernel launches "
        f"{json.dumps(launches)}")
    idle = [name for name in ("flash_attention", "flash_maxpass", *VARIANTS) if not launches[name]]
    if idle:
        raise AssertionError(f"the attention bench launched no {idle}")
    return launches


# The checkpoint tree of phase 8: the directories the config defaults name,
# under one temporary root on the local disk.  The DiT is cut to 6 layers by
# its config.json (3 Perceivers), BLIP-2 by its config.json; the rest whole.
TREE_DIRS = {
    "vae": "CogVideoX-Fun-V1.1-5b-InP/vae",
    "text_encoder": "CogVideoX-Fun-V1.1-5b-InP/text_encoder",
    "tokenizer": "CogVideoX-Fun-V1.1-5b-InP/tokenizer",
    "dit": "TrajectoryCrafter",
    "svd_unet": "DepthCrafter",
    "svd_vae": "stable-video-diffusion-img2vid/vae",
    "clip": "stable-video-diffusion-img2vid/image_encoder",
    "blip2": "blip2-opt-2.7b",
}
TREE_DIT_LAYERS = 6
TREE_BLIP2_LAYERS = {"vision": 4, "qformer": 2, "opt": 4}
TREE_FREE_GB = 24.0  # the tree is 17.90 GB; the damaged DiT copies link to it
SPIECE_PIECES = 32000
BPE_MERGES = 50005  # + 256 bytes + 4 specials: OPT's 50,265-entry vocab.json
DIT_HEAD_KEYS = ("norm_final.", "norm_out.", "proj_out.")  # the DiT's second shard


def bits_checksum(t) -> tuple:
    """A checksum of a tensor's raw bits, on its device: the sum of its words
    (as int64) and their sum weighted by position, with dtype and shape."""
    import torch

    flat = t.detach().contiguous().reshape(-1)
    words = flat.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                       8: torch.int64}[flat.element_size()])
    total = weighted = 0
    chunk = 1 << 26
    for start in range(0, words.numel(), chunk):
        w = words[start:start + chunk].to(torch.int64)
        idx = torch.arange(start, start + w.numel(), device=w.device) % 65521 + 1
        total += int(w.sum())
        weighted += int((w * idx).sum())
    return str(t.dtype), tuple(t.shape), total, weighted


def _pb_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte, n = n & 0x7F, n >> 7
        out.append(byte | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _pb_field(number: int, wire: int, payload: bytes) -> bytes:
    if wire == 2:
        payload = _pb_varint(len(payload)) + payload
    return _pb_varint(number << 3 | wire) + payload


def spiece_model_bytes(n_pieces: int = SPIECE_PIECES, seed: int = 0) -> bytes:
    """A serialized sentencepiece Unigram ``ModelProto``: T5's control pieces
    (<pad> 0, </s> 1, <unk> 2), "▁", every printable ASCII character with
    and without "▁", then seeded lowercase words up to ``n_pieces``."""
    import random
    import string
    import struct

    rng = random.Random(seed)
    chars = string.ascii_letters + string.digits + string.punctuation
    pieces = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2), ("▁", -2.0, 1)]
    pieces += [(p + c, -8.0 - 0.01 * i, 1) for p in ("", "▁") for i, c in enumerate(chars)]
    seen = {p for p, _, _ in pieces}
    while len(pieces) < n_pieces:
        word = "".join(rng.choice(string.ascii_lowercase) for _ in range(rng.randint(2, 8)))
        word = ("▁" if rng.random() < 0.6 else "") + word
        if word not in seen:
            seen.add(word)
            pieces.append((word, -rng.uniform(3.0, 14.0), 1))
    body = b"".join(_pb_field(1, 2, _pb_field(1, 2, p.encode()) + _pb_field(2, 5, struct.pack("<f", s))
                                  + _pb_field(3, 0, _pb_varint(kind)))
                    for p, s, kind in pieces)
    trainer = _pb_field(3, 0, _pb_varint(1)) + _pb_field(40, 0, _pb_varint(2))  # Unigram, unk 2
    return body + _pb_field(2, 2, trainer)


def write_bpe_files(path: Path) -> None:
    """A byte-level BPE vocabulary of OPT's size: the 4 OPT specials, the 256
    byte characters, and one merge per pair of byte characters up to
    ``BPE_MERGES``."""
    from trajectorycrafter_tpu_torch.utils.bpe import bytes_to_unicode

    byte_chars = list(bytes_to_unicode().values())
    vocab = {t: i for i, t in enumerate(["<s>", "<pad>", "</s>", "<unk>", *byte_chars])}
    merges = []
    for a in byte_chars:
        for b in byte_chars:
            if len(merges) == BPE_MERGES:
                break
            merges.append(f"{a} {b}")
            vocab[a + b] = len(vocab)
    (path / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n",
                                     encoding="utf-8")
    (path / "special_tokens_map.json").write_text(json.dumps(
        {"bos_token": "</s>", "eos_token": "</s>", "unk_token": "<unk>", "pad_token": "<pad>"}))


def _save(sd: dict, path: Path, name: str = "model.safetensors") -> int:
    """Write ``sd`` (device tensors) as one safetensors file; its bytes."""
    from safetensors.torch import save_file

    path.mkdir(parents=True, exist_ok=True)
    cpu = {k: v.detach().contiguous().cpu() for k, v in sd.items()}
    save_file(cpu, str(path / name))
    return sum(v.numel() * v.element_size() for v in cpu.values())


def write_checkpoint_tree(tc, root: Path) -> dict:
    """Write the random bundle's seeded weights (and a cut BLIP-2 seeded on
    the card) as an HF-layout tree under ``root``; return {"sums": {family:
    {key: checksum}} of what each loaded module must hold, "dit_keys",
    "damaged": {kind: transformer dir}}."""
    import shutil

    import torch

    from trajectorycrafter_tpu_torch.models.blip2 import Blip2Captioner, Blip2Config
    from trajectorycrafter_tpu_torch.ops.int8 import DIT_BLOCK_INT8, DIT_PERCEIVER_INT8, quantize_dense
    from trajectorycrafter_tpu_torch.orchestrator import _on_device, random_init_

    free = shutil.disk_usage(root).free / 1e9
    if free < TREE_FREE_GB:
        raise AssertionError(f"the checkpoint tree needs {TREE_FREE_GB:.0f} GB free under {root}, "
                             f"which has {free:.1f} GB")
    log(f"checkpoint tree under {root} ({free:.1f} GB free)")
    t0 = time.perf_counter()
    written = 0
    sums = {}
    pipe = tc.models.depth_infer.__self__.pipe
    d = {name: root / rel for name, rel in TREE_DIRS.items()}

    def family(label, sd, path, skipped=None, shards=1):
        nonlocal written
        sums[label] = {k: bits_checksum(v) for k, v in sd.items()}
        full = {**sd, **(skipped or {})}
        keys = list(full)
        per = -(-len(keys) // shards)
        for i in range(shards):
            part = {k: full[k] for k in keys[i * per:(i + 1) * per]}
            name = (f"model-{i + 1:05d}-of-{shards:05d}.safetensors" if shards > 1
                    else "model.safetensors")
            written += _save(part, path, name)

    family("vae", tc.models.pipeline.vae.state_dict(), d["vae"])
    t5 = tc.models.encode_prompt.t5
    family("t5", t5.state_dict(), d["text_encoder"],
           {"encoder.embed_tokens.weight": t5.shared.weight}, shards=2)
    family("svd_unet", pipe.unet.state_dict(), d["svd_unet"])
    family("svd_vae", pipe.vae.state_dict(), d["svd_vae"])
    clip = pipe.image_encoder
    n_pos = clip.vision_model.embeddings.position_embedding.weight.shape[0]
    family("clip", clip.state_dict(), d["clip"],
           {"vision_model.embeddings.position_ids": torch.arange(n_pos, device="cuda")[None]})

    # the DiT: its first 6 blocks and 3 Perceivers, in two shards (the head
    # keys second), with a config.json that says 6 layers
    dit = tc.models.pipeline.transformer

    def kept(key):
        parts = key.split(".")
        if parts[0] == "transformer_blocks":
            return int(parts[1]) < TREE_DIT_LAYERS
        if parts[0] == "perceiver_cross_attention":
            return int(parts[1]) < TREE_DIT_LAYERS // PERCEIVER_INTERVAL
        return True

    dit_sd = {k: v for k, v in dit.state_dict().items() if kept(k)}
    head = {k: v for k, v in dit_sd.items() if k.startswith(DIT_HEAD_KEYS)}
    body = {k: v for k, v in dit_sd.items() if k not in head}
    written += _save(body, d["dit"], "diffusion_pytorch_model-00001-of-00002.safetensors")
    written += _save(head, d["dit"], "diffusion_pytorch_model-00002-of-00002.safetensors")
    dit_config = {"num_attention_heads": 48, "attention_head_dim": 64,
                  "num_layers": TREE_DIT_LAYERS, "in_channels": 33, "out_channels": 16,
                  "use_rotary_positional_embeddings": True,
                  "cross_attn_interval": PERCEIVER_INTERVAL, "cross_attn_dim_head": 128,
                  "cross_attn_num_heads": 16, "time_embed_dim": 512, "text_embed_dim": 4096,
                  "max_text_seq_length": 226}
    (d["dit"] / "config.json").write_text(json.dumps(dit_config))
    int8 = {f"transformer_blocks.{i}.{p}" for i in range(TREE_DIT_LAYERS) for p in DIT_BLOCK_INT8}
    int8 |= {f"perceiver_cross_attention.{i}.{p}"
             for i in range(TREE_DIT_LAYERS // PERCEIVER_INTERVAL) for p in DIT_PERCEIVER_INT8}
    dit_sums = {}
    for k, v in dit_sd.items():
        prefix = k[:-len(".weight")]
        if k.endswith(".weight") and prefix in int8:  # --quant int8 loads the codes
            wq, ws = quantize_dense(v)
            dit_sums[prefix + ".weight_q"], dit_sums[prefix + ".weight_scale"] = \
                bits_checksum(wq), bits_checksum(ws)
        else:
            dit_sums[k] = bits_checksum(v)
    sums["dit"] = dit_sums
    # two damaged copies: the big shard linked, the head shard one key short / over
    damaged = {}
    for kind, shard in (("missing", {k: v for k, v in head.items() if k != "proj_out.bias"}),
                        ("extra", {**head, "transformer_blocks.6.norm1.norm.weight":
                                   dit_sd["transformer_blocks.0.norm1.norm.weight"]})):
        path = root / f"TrajectoryCrafter_{kind}"
        path.mkdir()
        name = "diffusion_pytorch_model-00001-of-00002.safetensors"
        (path / name).symlink_to(d["dit"] / name)
        _save(shard, path, "diffusion_pytorch_model-00002-of-00002.safetensors")
        (path / "config.json").write_text(json.dumps(dit_config))
        damaged[kind] = path
    del dit_sd, head, body

    # BLIP-2 at its full widths and vocabulary, depth cut by its config.json
    cut = Blip2Config(vision_layers=TREE_BLIP2_LAYERS["vision"],
                      qformer_layers=TREE_BLIP2_LAYERS["qformer"],
                      opt_layers=TREE_BLIP2_LAYERS["opt"])
    blip = random_init_(_on_device(lambda: Blip2Captioner(cut), "cuda", torch.bfloat16), 6)
    family("blip2", blip.state_dict(), d["blip2"],
           {"language_model.lm_head.weight": blip.decoder.embed_tokens.weight})
    del blip
    (d["blip2"] / "config.json").write_text(json.dumps({
        "vision_config": {"hidden_size": cut.vision_hidden, "intermediate_size":
                          cut.vision_intermediate, "num_hidden_layers": cut.vision_layers,
                          "num_attention_heads": cut.vision_heads, "image_size": cut.image_size,
                          "patch_size": cut.patch_size},
        "qformer_config": {"hidden_size": cut.qformer_hidden, "num_hidden_layers":
                           cut.qformer_layers, "num_attention_heads": cut.qformer_heads,
                           "intermediate_size": cut.qformer_intermediate,
                           "cross_attention_frequency": cut.cross_attention_frequency},
        "text_config": {"vocab_size": cut.vocab_size, "hidden_size": cut.opt_hidden,
                        "num_hidden_layers": cut.opt_layers, "num_attention_heads": cut.opt_heads,
                        "ffn_dim": cut.opt_ffn, "max_position_embeddings": cut.max_positions,
                        "bos_token_id": cut.bos_token_id},
        "num_query_tokens": cut.num_query_tokens}))
    # blip2-opt-2.7b's generation config: stop at "\n", max_length 20 (19 new tokens)
    (d["blip2"] / "generation_config.json").write_text(
        json.dumps({"eos_token_id": 50118, "max_length": 20}))
    write_bpe_files(d["blip2"])
    d["tokenizer"].mkdir(parents=True, exist_ok=True)
    (d["tokenizer"] / "spiece.model").write_bytes(spiece_model_bytes())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    log(f"wrote the checkpoint tree: {written / 1e9:.2f} GB in {seconds:.1f} s "
        f"({written / 1e9 / seconds:.2f} GB/s, checksums included)")
    return {"root": root, "dirs": d, "sums": sums, "damaged": damaged, "gb": written / 1e9}


def _tree_argv(tree: dict, transformer_path=None) -> list:
    d = tree["dirs"]
    argv = [a for a in MAIN_ARGV if a not in ("--prompt", "a scene")]
    return argv + [
        "--mask", "--exp_name", "smoke_checkpoints",
        "--model_name", str(d["vae"].parent), "--transformer_path",
        str(transformer_path or d["dit"]), "--unet_path", str(d["svd_unet"]),
        "--pre_train_path", str(d["svd_vae"].parent), "--blip_path", str(d["blip2"])]


def phase_checkpoints(tree: dict, runs: dict) -> None:
    """Load the written tree through the normal entry point and run it."""
    import numpy as np
    import torch

    from trajectorycrafter_tpu_torch.cli import parse_config
    from trajectorycrafter_tpu_torch.models.blip2 import (
        Blip2Captioner,
        Blip2Config,
        generate_caption_ids,
        preprocess_frame,
    )
    from trajectorycrafter_tpu_torch.orchestrator import (
        TrajCrafter,
        _on_device,
        random_init_,
        stand_in_token_ids,
    )

    log(f"device memory before loading: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    # the damaged DiT trees fail in verify_state_dict before any model computes
    for kind, want in (("missing", "Missing: 1 keys (proj_out.bias). Unexpected: none."),
                       ("extra", "Missing: none. Unexpected: 1 keys "
                                 "(transformer_blocks.6.norm1.norm.weight).")):
        counters = _kernel_counters()
        for kern in counters:
            kern.launches = 0
        try:
            TrajCrafter(parse_config(_tree_argv(tree, tree["damaged"][kind])))
        except ValueError as e:
            if "dit: checkpoint key set does not match the expected dit contract" not in str(e) \
                    or want not in str(e):
                raise AssertionError(f"the DiT tree with a key {kind} failed with {e}") from e
            log(f"DiT tree with a key {kind}: refused by verify_state_dict: {e}")
        else:
            raise AssertionError(f"the DiT tree with a key {kind} loaded")
        if any(kern.launches for kern in counters):
            raise AssertionError(f"a kernel launched before the DiT tree with a key {kind} "
                                 "was refused")
    torch.cuda.empty_cache()

    cfg = parse_config(_tree_argv(tree))
    if cfg.diffusion.prompt is not None or not cfg.render.mask or cfg.allow_dev_stubs \
            or cfg.diffusion.quant != "int8":
        raise AssertionError("the checkpoint run must caption, mask and run int8 without stubs")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tc = TrajCrafter(cfg)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    stats = tc.models.load_stats
    total = sum(s["bytes"] for s in stats.values())
    log(f"loaded the tree through TrajCrafter(cfg): {total / 1e9:.2f} GB on the card in "
        f"{load_s:.2f} s ({total / 1e9 / load_s:.2f} GB/s), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for label, s in stats.items():
        log(f"  load {label}: {s['tensors']} tensors, {s['bytes'] / 1e9:.3f} GB in "
            f"{s['seconds']:.3f} s ({s['bytes'] / 1e9 / s['seconds']:.2f} GB/s)")
    if set(stats) != set(tree["sums"]):
        raise AssertionError(f"loaded families {sorted(stats)}, written {sorted(tree['sums'])}")

    models = tc.models
    pipe = models.depth_infer.__self__.pipe
    dit = models.pipeline.transformer
    loaded = {"vae": models.pipeline.vae, "t5": models.encode_prompt.t5, "svd_unet": pipe.unet,
              "svd_vae": pipe.vae, "clip": pipe.image_encoder, "dit": dit,
              "blip2": models.get_caption.model}
    for label, module in loaded.items():
        got = {k: bits_checksum(v) for k, v in module.state_dict().items()}
        if got != tree["sums"][label]:
            bad = sorted(k for k in set(got) | set(tree["sums"][label])
                         if got.get(k) != tree["sums"][label].get(k))
            raise AssertionError(f"{label}: {len(bad)} loaded tensors differ from the written "
                                 f"ones: {bad[:5]}")
        log(f"  {label}: {len(got)} tensors bit-equal to the written ones")
    if len(dit.transformer_blocks) != TREE_DIT_LAYERS or not _int8_launches_per_forward(dit)[
            "int8_gemm"]:
        raise AssertionError("the loaded DiT is not the 6-layer int8 model")

    # the run: caption, T5 on the tokenizer's ids, --mask, launches per stage
    captioner = models.get_caption
    seen = {}

    def caption(frame):
        seen["frame"] = frame
        seen["caption"] = captioner(frame)
        return seen["caption"]

    def record_ids(module, args):
        seen["ids"] = args[0].cpu()

    models.get_caption = caption
    hook = models.encode_prompt.t5.register_forward_pre_hook(record_ids)
    try:
        want = _expected_launches(cfg, tc.models.pipeline.scheduler, dit, pipe.unet,
                                  "flash_attention", "flash_attention")
        run = run_mode(tc, "L (the loaded tree)", "flash_stock", "auto")
    finally:
        hook.remove()
        models.get_caption = captioner
    if run["per_path"] != want:
        raise AssertionError(f"loaded run: kernel launches per stage {run['per_path']}, "
                             f"expected {want}")
    runs["L"] = {key: run[key] for key in ("seconds", "per_path", "stages")}
    ids = captioner.last_ids
    text = captioner.tokenizer.decode(ids.tolist()).strip()
    if not seen["caption"] or seen["caption"] != text:
        raise AssertionError(f"caption {seen['caption']!r} is not the decode {text!r} of {ids}")
    log(f"  caption stage {run['stages']['caption']:.3f} s: {len(ids)} greedy ids "
        f"{ids.tolist()} -> {seen['caption']!r}")
    prompt = seen["caption"] + cfg.diffusion.refine_prompt
    tokens = models.encode_prompt.tokenizer([prompt, cfg.diffusion.negative_prompt], 226)
    stand_in = stand_in_token_ids(prompt, 226, models.encode_prompt.t5.shared.num_embeddings)
    if not torch.equal(seen["ids"], tokens) or torch.equal(seen["ids"][:1], stand_in):
        raise AssertionError("T5 did not read the tokenizer's ids of the captioned prompt")
    log(f"  T5 read the tokenizer's ids: {int((tokens[0] != 0).sum())} and "
        f"{int((tokens[1] != 0).sum())} tokens of 226")
    if not run["known_share"] < runs["A"]["known_share"]:
        raise AssertionError(f"--mask known share {run['known_share']} is not below run A's "
                             f"{runs['A']['known_share']}")
    rel = np.abs(np.log(run["depth"] / runs["A"]["depth"]))
    log(f"  --mask: known share {run['known_share']:.6f} against run A's "
        f"{runs['A']['known_share']:.6f}; depth against run A's (the same UNet weights, "
        f"information): median |log ratio| {np.median(rel):.3e}, max {rel.max():.3e}")
    frame = seen["frame"]
    del tc, models, pipe, dit, loaded, captioner
    gc.collect()
    torch.cuda.empty_cache()

    # BLIP-2 at full depth and width, seeded on the card, captions one frame
    t0 = time.perf_counter()
    full = random_init_(_on_device(lambda: Blip2Captioner(Blip2Config()), "cuda",
                                   torch.bfloat16), 7)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in full.parameters())
    pixels = preprocess_frame(frame, device="cuda")
    with torch.no_grad():
        generate_caption_ids(full, pixels, max_new_tokens=19)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = generate_caption_ids(full, pixels, max_new_tokens=19)
        torch.cuda.synchronize()
    caption_s = time.perf_counter() - t0
    log(f"BLIP-2 at full depth (39 / 12 / 32 layers, {n_params / 1e9:.3f} B parameters, "
        f"built in {build_s:.2f} s): caption of the middle frame, 19 greedy steps, "
        f"{caption_s:.3f} s; ids {ids[0].tolist()}")
    del full
    torch.cuda.empty_cache()


def phase_scripts(tree: dict, runs: dict) -> None:
    """Each entry point of ``trajectorycrafter_tpu_torch/scripts/`` once,
    through ``main(argv)`` (its real argument parsing), on the written tree
    (the 6-layer DiT, BLIP-2 captions, ``--mask``): the launches held to run
    L's per depth stage and per diffusion times the script's stages, the
    outputs counted.  The orbit runner catches a variant's failure as the
    root script does, so its mp4s and launches are what fails it."""
    import numpy as np

    from trajectorycrafter_tpu_torch.scripts import (
        autoregressive_global,
        inference_autoregressive,
        inference_orbits,
        run_w_cam_poses,
    )

    per_l = runs["L"]["per_path"]
    frames = SCRIPT_FRAMES
    joined = 2 * (frames - 8) + 8
    root = tree["root"]
    # the Panoptic cameras at the clip's native 512 x 288 (the script scales
    # K to the warp size)
    calib = [{**c, "K": [[v / 2 for v in row] for row in c["K"][:2]] + [c["K"][2]]}
             for c in PANOPTIC_CAMERAS]
    (root / "calib.json").write_text(json.dumps({"cameras": calib}))
    long = ["--n_splits", "2", "--overlap_frames", "8", "--total_theta", "30"]
    cut = ["--video_length", str(frames)]
    scripts = {
        "inference_autoregressive": (inference_autoregressive, long, 2),
        "autoregressive_global": (autoregressive_global, long, 2),
        "run_w_cam_poses": (run_w_cam_poses, [
            "--calib_json", str(root / "calib.json"), "--source_cam", "00_00",
            "--target_cam", "00_01", "--smooth", "--target_video", MAIN_ARGV[1]], 1),
        "inference_orbits": (inference_orbits, ["--test_run"], 1),
    }
    for name, (module, extra, stages) in scripts.items():
        argv = _tree_argv(tree) + ["--exp_name", f"script_{name}"] + cut + extra
        log(f"script {name}: python -m trajectorycrafter_tpu_torch.scripts.{name} "
            f"{' '.join(extra)} on the tree")
        r = drive(f"script {name}", lambda: module.main(argv))
        save_dir = Path(MAIN_ARGV[MAIN_ARGV.index("--out_dir") + 1]) / f"script_{name}"
        out = r.pop("out")
        if name == "run_w_cam_poses":
            if json.loads((save_dir / "metrics.json").read_text())["metrics"] != \
                    out["metrics"] or not all(np.isfinite(v) for v in out["metrics"].values()):
                raise AssertionError(f"{name}: metrics {out}")
        elif name == "inference_orbits":
            if out != ["left30"]:
                raise AssertionError(f"{name}: variants {out}")
            save_dir = save_dir / "left30"
        else:
            _check_video(name, out, joined, (384, 672))
            video = save_dir / f"{name}.mp4"
            if name == "inference_autoregressive":
                video = save_dir / "autoregressive.mp4"
            if _mp4_frames(video) != joined:
                raise AssertionError(f"{name}: {video} has {_mp4_frames(video)} frames")
            if name == "autoregressive_global":
                _check_scene(name, save_dir / "scene", MAX_POINTS, joined)
        counts = mp4_frame_counts(save_dir)
        if counts != save_scheme_counts(frames):
            raise AssertionError(f"{name}: mp4 frame counts {counts} in {save_dir}")
        _check_depths(name, r["depth_outputs"], stages, _script_cfg(argv))
        if r["per_path"] != _times(per_l, stages):
            raise AssertionError(f"{name}: kernel launches per stage {r['per_path']}, expected "
                                 f"{_times(per_l, stages)}")
        log(f"  {name}: launches as derived from run L's, five mp4s in {save_dir}")
        runs[f"script {name}"] = {key: r[key] for key in ("seconds", "per_path")}
        gc.collect()


def phase_alignment_script(tree: dict, runs: dict) -> None:
    """``scripts/inference_alignment.main(argv)`` on the written tree with a
    vitl ``.pth`` written beside it (the seeded VDA of run M under the
    official keys): ``load_vda``'s key check on the card, 2 segments of
    ``SCRIPT_FRAMES``, ``ALIGN_EPOCHS``; its launches held to two of run L's
    diffusions and no depth stage, its outputs counted.  First the same file
    under ``--vda_encoder vits`` must be refused before any model is built or
    any kernel launched."""
    import torch

    from trajectorycrafter_tpu_torch.scripts import inference_alignment
    from trajectorycrafter_tpu_torch.utils.checkpoints import vda_official_state_dict

    root = tree["root"]
    ckpt = root / "video_depth_anything_vitl.pth"
    t0 = time.perf_counter()
    vda = seeded_vda()
    torch.save({k: v.detach().cpu() for k, v in vda_official_state_dict(vda.state_dict()).items()}, ckpt)
    del vda
    torch.cuda.empty_cache()
    log(f"wrote {ckpt.name} ({ckpt.stat().st_size / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.2f} s")
    frames = SCRIPT_FRAMES
    argv = _tree_argv(tree) + ["--exp_name", "script_inference_alignment", "--video_length",
                               str(frames), "--n_splits", "2", "--total_theta", "30",
                               "--align_epochs", str(ALIGN_EPOCHS), "--vda_ckpt", str(ckpt)]
    counters = _kernel_counters()
    for kern in counters:
        kern.launches = 0
    try:
        inference_alignment.main(argv + ["--vda_encoder", "vits"])
    except ValueError as e:
        if "vda_official" not in str(e) or any(kern.launches for kern in counters):
            raise
        log(f"script inference_alignment: the vitl file under --vda_encoder vits is refused: "
            f"{str(e)[:160]}...")
    else:
        raise AssertionError("inference_alignment ran a vitl checkpoint as vits")

    log("script inference_alignment: python -m trajectorycrafter_tpu_torch.scripts."
        "inference_alignment --vda_ckpt video_depth_anything_vitl.pth on the tree")
    r = drive("script inference_alignment", lambda: inference_alignment.main(argv))
    save_dir = Path(MAIN_ARGV[MAIN_ARGV.index("--out_dir") + 1]) / "script_inference_alignment"
    _check_video("inference_alignment", r.pop("out"), 2 * frames, (384, 672))
    if _mp4_frames(save_dir / "autoregressive_aligned.mp4") != 2 * frames:
        raise AssertionError("inference_alignment: autoregressive_aligned.mp4 frames")
    for stage in range(2):
        counts = mp4_frame_counts(save_dir / f"stage_{stage:02d}")
        if counts != save_scheme_counts(frames):
            raise AssertionError(f"inference_alignment: stage {stage} mp4 frame counts {counts}")
    if r["depth_outputs"]:
        raise AssertionError("inference_alignment: DepthCrafter ran with a VDA")
    want = {"depth": {name: 0 for name in KERNELS},
            "denoise": _times(runs["L"]["per_path"], 2)["denoise"]}
    if r["per_path"] != want:
        raise AssertionError(f"inference_alignment: kernel launches per stage {r['per_path']}, "
                             f"expected {want}")
    log("  inference_alignment: launches as derived from run L's, the joined video and each "
        f"stage's mp4s in {save_dir}")
    runs["script inference_alignment"] = {key: r[key] for key in ("seconds", "per_path")}
    ckpt.unlink()
    gc.collect()


def _script_cfg(argv):
    from trajectorycrafter_tpu_torch.cli import config_from_args, get_parser

    return config_from_args(get_parser().parse_known_args(argv)[0])


def _attention_entry(name: str, t: dict, **kw) -> dict:
    """An attention kernel's entry of the kernels JSON line."""
    src = "trajectorycrafter_tpu_torch/csrc/"
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "sfu_ms")
    return {"name": name, "route": "cuda", "source": f"{src}{SOURCE_OF.get(name, name)}.cu",
            "replaces": TPU_KERNELS[name], **kw, **{key: t[key] for key in keys},
            **{key: t[key] for key in t
               if key in ("shape", "library", "with_quantization_ms")
               or key.startswith(("depth_", "perceiver_", "d128_"))}}


def main() -> None:
    os.chdir(REPO)
    sys.path.insert(0, str(REPO))
    phase_device()
    run_phase("build", phase_build)
    max_err, timing = run_phase("3 kernels", phase_kernels)
    int8_err, int8_timing = run_phase("3 int8 kernels", phase_int8_kernels)
    variant_err, variant_timing = run_phase("4 variants", phase_variants)
    backward_err, backward_timing = run_phase("4b backward", phase_backward_kernels)
    tc, runs, (dit8, unet8) = run_phase("5 main path", phase_main_path)
    run_phase("5b modes", phase_modes, tc, dit8, runs)
    run_phase("5c long paths", phase_long_paths, tc, dit8, runs)
    run_phase("5d consistent", phase_consistent, tc, dit8, runs)
    run_phase("6 whole models", phase_whole_models, tc, dit8, unet8)
    bench = run_phase("7 bench", phase_bench)

    import torch

    del dit8, unet8
    gc.collect()
    torch.cuda.empty_cache()
    data_root = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_tree_"))
    try:
        # phase 5e: run P, LoRA training at full width
        step_launches = run_phase("5e training", phase_training, tc, data_root)
        # phase 8: write the random bundle's weights as a tree, free the
        # bundle, load the tree through the entry point
        tree = run_phase("8 tree write", write_checkpoint_tree, tc, root)
        del tc
        gc.collect()
        torch.cuda.empty_cache()
        run_phase("8 checkpoints", phase_checkpoints, tree, runs)
        run_phase("8 scripts", phase_scripts, tree, runs)
        run_phase("8 alignment script", phase_alignment_script, tree, runs)
        run_phase("8 train script", phase_train_script, tree, str(data_root / "latents"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(data_root, ignore_errors=True)

    per_path = lambda kern: _launches_per_path(runs, kern)
    run_launches = lambda run, kern: _run_launches(runs, run, kern)
    depth = timing["depth"]
    sdpa = "flash SDPA"
    # K1 at the Perceiver's shape and at the depth UNet's 2,304-token level
    other_shapes = {f"{name}_{key}": timing[name][key] for name in ("perceiver", "depth_2304")
                    for key in ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "sfu_ms")}
    kernels_line = [
        _attention_entry(
            "flash_attention", {**timing["dit"], "shape": "(2, 48, 13330, 13330, 64)",
                                "library": sdpa},
            also_replaces="trajectorycrafter_tpu/ops/attention.py:39",
            launches=run_launches("A", "flash_attention"), launches_run="A",
            launches_per_path=per_path("flash_attention"),
            bench_launches=bench["flash_attention"], max_abs_err=max_err["flash_attention"],
            depth_shape="(49, 5, 9216, 9216, 64)", depth_ms=depth["flash_attention"],
            depth_plain_ms=depth["plain_ms"], depth_library_ms=depth["library_ms"],
            depth_bound_ms=depth["bound_ms"], depth_sfu_ms=depth["sfu_ms"], **other_shapes),
        _attention_entry(
            "flash_maxpass", {**depth, "ms": depth["flash_maxpass"],
                              "shape": "(49, 5, 9216, 9216, 64)", "library": sdpa},
            launches=run_launches("B", "flash_maxpass"),
            launches_run="B (TRAJCRAFTER_DEPTH_ATTN=flash_max)",
            launches_per_path=per_path("flash_maxpass"), bench_launches=bench["flash_maxpass"],
            max_abs_err=max_err["flash_maxpass"]),
        *_int8_entries(runs, int8_err, int8_timing),
        *(_attention_entry(name, variant_timing[name], launches=bench[name],
                           launches_run="the attention bench", max_abs_err=variant_err[name])
          for name in ("flash_exp2", "flash_lse", "int8_flash_attention")),
        _attention_entry("flash_pv8", variant_timing["flash_pv8"],
                         launches=run_launches("D", "flash_pv8"),
                         launches_run="D (attention_impl and TRAJCRAFTER_DEPTH_ATTN flash_pv8)",
                         launches_per_path=per_path("flash_pv8"),
                         bench_launches=bench["flash_pv8"], max_abs_err=variant_err["flash_pv8"]),
        *_backward_entries(backward_err, backward_timing, step_launches),
    ]
    print(json.dumps({"kernels": kernels_line}), flush=True)
    log(f"chip smoke: {time.perf_counter() - T_START:.1f} s; by phase {json.dumps(PHASE_SECONDS)}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
