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
     at the DiT's, the Perceiver's and the depth UNet's two shapes, and whole
     at run R's 576x1024 shapes: (2, 48, 30,178^2, 64) and (2, 16, 29,952 x
     6,912, 128), and K4 at run S's per-rank shapes, a rank's query rows
     against the whole frame's keys (``run_s_depth_shapes``: (9, 5, 5,120 /
     4,096 x 9,216, 64) and (9, 10, 1,280 / 1,024 x 2,304, 64)); K2a and
     K2b also at run R's 60,356 rows and at run S's
     tensor-parallel shard shapes, and K2a's scale-taking entry at run S's
     row-parallel inputs, bit-equal to the codes of the whole row); each
     kernel's bound (the least time the card could take for the same work)
     computed from the data sheet, and its TFLOP/s;
  4. the attention variants (K5 ``flash_lse``, K1b ``flash_exp2``, K6
     ``flash_pv8``, K7 ``int8_flash_attention``) the same way, at the
     attention bench's DiT shape and the main path's shapes (K7 also at
     head dim 128, ``K7_D128_SHAPE``; K5 also at run S's per-rank shape,
     ``RUN_S_K5_SHAPE``, and at run T1's and T5's, ``RUN_T_K5_SHAPES``);
  4b. the attention backward (``flash_attention_bwd_dkv``, K4-dkv, and
     ``flash_attention_bwd_dq``, K4-dq, csrc/flash_attention_bwd.cu) against
     ``attention_backward_reference`` at the training shapes (the DiT's (1,
     48, 13,330^2, 64), the Perceiver's (1, 16, 13,104 x 3,024, 128)), at
     run T1's and T5's per-rank shapes (``RUN_T_K5_SHAPES``: T5's ring hop
     (1, 24, 1,625^2, 64), odd and no multiple of a tile), a ragged shape, the ragged edges and strided views, within
     ``attention_backward_error`` (per element 2^-6 of the gradient's sum of
     magnitudes, per head a relative L2 error of 2^-6), which must reject di
     left out, the last quarter of the 64-query tiles skipped in dK/dV and
     of the 128-key tiles in dQ (the kernels' own tiles); then each timed at
     full shape in turns with the plain version and flash SDPA's backward,
     beside its bound (also at run T1's and T5's shapes);
  5. main path: ``TrajCrafter.infer_gradual`` at the deployed widths (random
     weights from a seed; T5-XXL prompt encode; the DepthCrafter depth
     stage, 5 Euler steps over one 49-frame window at 576x1024; 2 denoise
     steps, diffusion at 384x672), five times on one set of weights, A on
     the deployed 49 frames, B-D and A9 on 9 (``CUT_FRAMES``) with 1 Euler step a
     depth window (``CUT_DEPTH_STEPS``):
     A, the default: int8 DiT (``--quant int8``, unfused feed-forward),
       bf16 depth UNet, depth attention ``flash_stock``;
     B: int8 DiT with the fused int8 feed-forward, ``--quant_depth int8``,
       ``TRAJCRAFTER_DEPTH_ATTN=flash_max``;
     C: ``--quant none``, the bf16 DiT and UNet, ``flash_stock``;
     D: run A with the DiT's ``attention_impl="flash_pv8"`` and
       ``TRAJCRAFTER_DEPTH_ATTN=flash_pv8``: every large attention on K6;
     A9: run A on 9 frames with 1 Euler step, run S's unsharded twin;
     the int8 models are quantizations of the bf16 models' own weights.
     Each kernel's launches are counted per stage and held to counts derived
     from the modules; the PSNR and SSIM of D's video against C's, and the
     depth of B and D against C's, are printed as information; each run's
     gen.mp4 is kept for the quality CLI, which then runs three times as a
     subprocess (``python -m trajectorycrafter_tpu_torch.utils.quality``): C
     against itself (rc 0, 99.0 dB), C against D (rc as its ``pass``), A
     (49 frames) against C (9: rc 1, frame count mismatch);
  5r. run R: run A with ``--sample_size 576 1024`` (the JAX bench's
     diffusion size, where the warp's render and mask already have the
     sample size): 49 frames, the DiT over 30,178 joint tokens, its
     Perceivers over 29,952 x 6,912, its int8 GEMMs on 60,356 rows; the
     launches per stage held to the derived counts, the five mp4s to 49
     frames of 576x1024, stage times and peak memory logged;
  5b. modes and samplers, on run A's models at 9 frames and 1 Euler step
     a depth window (``cut_runs``, as every later run but L, M, P and Q):
     run E ``infer_direct`` with
     DPM++ at 3 steps (step 1 second order; the mp4s drop the fly-in,
     clamped to 4 frames: 5, 5, 5, 5 and 9 frames), run F ``infer_bullet`` with
     Euler A at 2 steps, run G ``infer_zoom`` with PNDM at 4 steps (13 DiT
     forwards: 12 pseudo-RK calls and one PLMS call), each through
     ``TrajCrafter``'s entry point with the sampler set in the config and
     the pipeline's scheduler built from the registry; then Euler and
     DDIM_Cog at 2 steps through the pipeline on the conditions recorded
     from run E; launches held to the counts derived from the modules and
     the scheduler's loop length, stage times and peak memory logged; then
     one step of each of the six samplers on the card against the same step
     on the CPU (``SAMPLER_STEP_TOL``);
  5c. the tiled VAE decode at 17 frames of 576x1024: one tile bit-equal to
     ``vae_decode``, timed beside the one-shot decode (the JAX default tile,
     the strips, which run U holds, and runs H-J, the long-trajectory and
     known-camera classes in process, were cut for the smoke's clock: phase
     8's scripts and run U drive them);
  5d. the consistent-depth path and the Gradio callback, on run A's
     models: run M ``TrajCrafterConsistentDepth.infer_autoregressive`` with
     a seeded Video-Depth-Anything vitl (fp32; 2 segments of 32 frames at
     576x1024; the first segment's depth from one VDA window of 32 frames
     at 588x1036; the second stage's alignment renders sparse depth from
     the per-frame clouds and trains a visual prompt through the VDA at
     280x504 over all 32 frames, 2 epochs of the deployed 50, VP mode), run
     N the same without a VDA (DepthCrafter and ``align_window``) on
     9-frame segments, run O the Gradio callback ``run_pipeline`` with the
     "Orbit Left" preset at 2 steps; launches held to the derived counts
     (the VDA and the trainer launch none), the joined video (M's 98 x 384
     x 672), the aligned depth finite
     and positive on the sparse mask, M's prompt non-zero, the VDA's
     seconds per window and the trainer stage's seconds per epoch and peak
     memory logged;
  5e. run P, LoRA training (after phases 6 and 7, on the bundle's bf16
     DiT): a SceneFlow-layout tree of 2 scenes x 49 frames at 960x540
     (PNG, .pfm disparities, camera_data.txt) turned into 2 .npz samples
     at 384x672 by ``datagen.generate_dataset`` (the bundle's VAE, the
     T5-XXL prompt embedding); 2 training steps of the full-width DiT (42
     blocks, B = 1, 13,330 joint tokens) with rank-8 adapters on its 316
     target layers, ``remat``, ``flash_stock``, v-prediction, dropout 0.1:
     finite losses, grad_norm > 0, every B moved at step 1 and every A at
     step 2, K5 and the backward kernels launched as derived from the
     modules, seconds per step and peak memory logged; then one step's
     adapter gradients on the kernels against the plain versions on the DiT
     cut to 4 blocks (``GRAD_MEDIAN_TOL``, ``GRAD_MAX_TOL``); then run T1's
     data and twin: 2 samples of 9 frames (every 6th of the scenes' 49) by
     ``datagen``, and ``scripts/train_lora.main`` unsharded on them
     (``--batch_size 2``, ``RUN_T_STEPS`` steps) on the DiT cut to
     ``RUN_T_LAYERS`` blocks, its launches derived; and T5's twin, one
     unsharded step on the first sample;
  5f. run Q, DiT feature probing (after 5e, on the same bf16 DiT with the
     JAX default route ``auto``, no recomputation): ``probing.
     collect_activation_dataset`` over run P's 2 samples at timesteps 311
     and 811 and blocks 1 and 3 with the camera-motion filter on (the
     samples carry no poses: all kept), 4 forwards at B = 1 with K1 launched
     as derived from the modules (63 a forward), 8 finite (13,104, 3,072)
     feature files; a ConvProbe per (timestep, block) for 50 steps on the
     card, its loss falling; block 1's features of one sample on the kernels
     against the plain versions (``PROBE_REL_L2``, ``PROBE_MAX_REL``); the
     forward's seconds and the peak above the resident memory logged;
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
     run L's bundle of the tree (``SCRIPT_RUNS``; the scripts' own tree
     reloads were cut for the smoke's clock) at 9 frames
     (``inference_autoregressive`` and
     ``autoregressive_global`` with 2 windows, ``run_w_cam_poses --smooth
     --target_video``,
     ``inference_orbits --test_run``), each with its launches held to run
     L's per depth stage and diffusion and its outputs counted; then
     ``inference_alignment`` with a vitl ``.pth`` written beside the tree
     (``load_vda``'s key check; the same file under ``--vda_encoder vits``
     refused first), 2 segments of 9 frames; then
     ``scripts/train_lora.main(argv)`` on the tree's 6-layer DiT and run P's
     samples (2 steps, validation and a checkpoint after each), then
     ``--resume_from_checkpoint latest`` for a third step; then
     ``scripts/probe_depth.main(argv)`` on the same DiT and samples, directly
     (``--blocks 1 3 --steps 20``) and with ``--collect_dir ... --timesteps
     311 811 --motion_filter``: K1's launches as derived, a probe file per
     block or (timestep, block), every probe's loss falling;
  5s. run S, once this process holds no model: run A9 sharded over
     ``--mesh_dp 1 --mesh_sp 2 --mesh_tp 2``, four ranks started by
     torchrun (``chip_smoke.py --run-s-rank DIR --cut``) on the one card
     over gloo (``--dist_backend gloo``: the ranks share the card), through
     ``TrajCrafter.infer_gradual``: K5 on the ring, K1 on the Perceivers,
     K2a / its scale-taking entry / K2b at the tp shards; launches per rank
     as derived from the sharded modules, every rank's latents bit-equal
     after each step, the first sharded DiT forward against the unsharded
     int8 DiT on the same inputs (``RUN_S_REL_L2``, ``DIT_REL_TOL``); then,
     on the check weights (``check_weights_``) and the DiT cut to
     ``RUN_S_CHECK_LAYERS`` blocks, that forward sound and with each of
     ``RUN_S_FAULTS`` planted in every rank, the joint attention output of
     ``RUN_S_CHECK_BLOCKS`` against the unsharded: the sound one
     within the same limits, each wrong one outside them (the DiT's output
     reported beside); every rank's share of the warp (``shard_sizes`` of
     the frames over the 4 ranks) and its slab of the CogVideoX VAE's
     condition prep and decode (H on dp, W on sp), its halo and norm bytes;
     the sharded warp against the unsharded on the run's inputs
     (``RUN_S_WARP_MASK_MAX``, ``RUN_S_WARP_OFF_MAX``), the sharded
     condition latents and decoded frames against the unsharded VAE, over
     the whole tensor and on the seam band (``RUN_S_VAE_REL_TOL``), under
     the run's mesh, and under ``RUN_S_VAE_MESH`` on the VAE's check
     weights each of ``RUN_S_VAE_FAULTS`` at least
     ``RUN_S_VAE_FAULT_RATIO`` times the sound reading on the band; every
     rank's share of the depth stage (CLIP and the SVD encode on its whole
     frames, the UNet on its frames and latent rows, K4 at its query rows,
     the decode's whole chunks; launches per rank derived from the sharded
     modules, the models' bits equal on every rank), its raw disparity and
     first UNet forward against the unsharded stage's under the run's mesh
     (``RUN_S_DEPTH_REL_TOL``), and under ``RUN_S_VAE_MESH`` in fp32 on
     check weights each of ``RUN_S_DEPTH_FAULTS`` at least
     ``RUN_S_VAE_FAULT_RATIO`` times the sound reading on the band; the
     video against run A9's at the quality CLI's 35 dB gate; seconds and
     peaks per rank logged (not a speed figure: four ranks share one card
     and stage their hops through host memory); ``tools/run_s_uncut.py``
     runs it at 49 frames against run A;
  5t. run T, in run S's torchrun world once run S is done and its models
     freed (see RUN_T_MESH): T1 ``scripts/train_lora.main`` under
     ``--mesh_dp 2 --mesh_tp 2 --batch_size 2`` on the full-width bf16 DiT
     cut to ``RUN_T_LAYERS`` blocks over phase 5e's 9-frame samples,
     ``RUN_T_STEPS`` steps, against the twin; T2 the
     check of the check of the gradient reductions, three planted faults
     under dp 2 x tp 2 and three under dp 1 x sp 2 x tp 2;
     T3 GPipe over pp 3 at full depth on the int8 DiT against the
     sequential block loop; T4 GPipe with pp 2 x tp 2 on 4 layers, and a
     planted skipped hop; T5 one LoRA step with the token stream on sp
     (dp 1 x sp 2 x tp 2, the differentiable ring) against its twin;
     ``tools/run_t.py`` runs it alone;
  5u. run U, in the same torchrun world once run T's models are freed (see
     RUN_U_ARGV): phase 8's five scripts through ``main(argv)`` on the tree
     under run S's mesh, one bundle a rank: each leader's output against
     phase 8's unsharded one at the quality CLI's 35 dB gate, the frame
     counts, the followers' directories empty, every rank's latents
     bit-equal after each step, each rank's launches of K1, K2a (both
     entries), K2b, K4 and K5 as derived from its sharded modules; then the
     sharded strip decode of run S's latents against the unsharded strip
     decode (``RUN_S_VAE_REL_TOL``) and a planted fault (a strip seam's blend
     rows dropped on the leader, ``RUN_S_VAE_FAULT_RATIO``); seconds per
     stage and memory per rank logged;
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
INT8_KERNELS = ("int8_quantize_rows", "int8_quantize_rows_scaled", "int8_gemm",
                "int8_gemm_gelu_quant", "int8_gemm_gscale")
VARIANTS = ("flash_exp2", "flash_lse", "flash_pv8", "int8_flash_attention")
BACKWARD = ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")
KERNELS = ("flash_attention", "flash_maxpass", *INT8_KERNELS, *VARIANTS, *BACKWARD)
# depth attention shapes (B = frames, H, S, D) at 576x1024 and 49 frames
DEPTH_SHAPES = {"depth_9216": (49, 5, 9216, 64), "depth_2304": (49, 10, 2304, 64)}
# int8 GEMMs of the main path, (M, K, N, bias): the DiT's blocks at M = 2 x
# 13,330 tokens (the CFG pair, text + video) -- q/k/v/out and the feed-
# forward; its Perceivers (queries from 2 x 13,104 video tokens, keys and
# values from 2 x 3,024 reference tokens, no biases); the same at
# ``--sample_size 576 1024`` (run R: M = 2 x 30,178, the Perceivers' 2 x
# 29,952 and 2 x 6,912); the depth UNet's level 0 under --quant_depth int8
# (49 frames x 9,216 tokens, 320 channels: attention/proj and the GEGLU's
# first projection); run S's tensor-parallel shards at tp 2 ("tp2_*": a
# rank's 2 x 6,665 joint tokens, half of each layer's heads or hidden width;
# its Perceivers' queries from at most 2 x 6,665 video tokens); a small
# ragged M
INT8_SHAPES = {
    "dit_qkvo": (26660, 3072, 3072, True),
    "dit_ff1": (26660, 3072, 12288, True),
    "dit_ff2": (26660, 12288, 3072, True),
    "perceiver_to_q": (26208, 3072, 2048, False),
    "perceiver_to_kv": (6048, 3072, 4096, False),
    "perceiver_to_out": (26208, 2048, 3072, False),
    "dit576_qkvo": (60356, 3072, 3072, True),
    "dit576_ff1": (60356, 3072, 12288, True),
    "dit576_ff2": (60356, 12288, 3072, True),
    "perceiver576_to_q": (59904, 3072, 2048, False),
    "perceiver576_to_kv": (13824, 3072, 4096, False),
    "perceiver576_to_out": (59904, 2048, 3072, False),
    "tp2_qkv": (13330, 3072, 1536, True),
    "tp2_to_out": (13330, 1536, 3072, True),
    "tp2_ff1": (13330, 3072, 6144, True),
    "tp2_ff2": (13330, 6144, 3072, True),
    "tp2_perceiver_to_q": (13330, 3072, 1024, False),
    "tp2_perceiver_to_kv": (6048, 3072, 2048, False),
    "tp2_perceiver_to_out": (13330, 1024, 3072, False),
    "depth_320": (451584, 320, 320, True),
    "depth_geglu": (451584, 320, 2560, True),
    "ragged_small": (70, 256, 512, True),
}
TPU_KERNELS = {
    "flash_attention": "trajectorycrafter_tpu/ops/pallas/flash_exp2.py:212",
    "flash_maxpass": "trajectorycrafter_tpu/ops/pallas/flash_max.py:110",
    "int8_quantize_rows": "trajectorycrafter_tpu/ops/pallas/int8_matmul.py:363",
    # K2a's second entry: the quantization with the row scale given, for the
    # row-parallel layers under tp (XLA's under the JAX mesh)
    "int8_quantize_rows_scaled": "trajectorycrafter_tpu/ops/pallas/int8_matmul.py:363",
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
             "int8_quantize_rows_scaled": "int8_quantize_rows",
             "flash_attention_bwd_dkv": "flash_attention_bwd",
             "flash_attention_bwd_dq": "flash_attention_bwd"}
# the attention bench's DiT shape: 226 text + 13 x 36 x 64 video tokens,
# zero-padded to 30,720 (bench_attention.py)
BENCH_DIT = (2, 48, 30178, 30720, 64)  # (B, H, real tokens, padded, D)
DIT_SHAPE = (2, 48, 13330, 64)  # the main path's joint attention (B, H, S, D)
# the Perceiver's cross-attention (B, H, Sq, Skv, D): 2 x 13,104 video
# tokens against 2 x 3,024 reference tokens, 16 heads of 128
PERCEIVER_SHAPE = (2, 16, 13104, 3024, 128)
# run R, diffusion at 576x1024 (the JAX bench's size): the joint attention
# over 226 text + 13 x 36 x 64 video tokens (30,178 = 235 x 128 + 98, a
# ragged last key tile), the Perceiver over 2 x 29,952 video tokens against
# the 3 x 2,304 of the 10 reference frames' 3 latent frames
DIT576_SHAPE = (2, 48, 30178, 64)
PERCEIVER576_SHAPE = (2, 16, 29952, 6912, 128)
SAMPLE_576 = (576, 1024)
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

# Run S (phase 5s): run A sharded over a dp x sp x tp mesh of RUN_S_MESH,
# four rank processes started by torchrun that share the one card over gloo
# (NCCL refuses two ranks on one device): ``TrajCrafter.infer_gradual`` with
# run A's command line, seed and weights, the int8 DiT at full width (48
# heads x 64, 42 layers) at 384x672, 2 steps.  Each rank holds its
# tensor-parallel shard of the DiT (24 heads, 6,144 of the feed-forward)
# and half of the joint tokens (at 49 frames 6,665 of 13,330: the leader's
# 226 text and 6,439 video tokens, the other's 6,665 video tokens) and the
# VAE and the depth stage's models; every rank runs its share of the depth
# stage, warps its share of the frames and runs its slab of the VAE (below);
# the leader alone holds T5 and runs the poses and the prompt encode.  The
# checks: the first sharded DiT forward of the denoise
# against the unsharded int8 DiT (run A's weights, rebuilt in the main
# process) on the same inputs, by relative L2 error (RUN_S_REL_L2) and by
# the largest row error (one position's 16 channels) over the largest
# reference row (DIT_REL_TOL, the whole-DiT limit of phase 6: the ring's
# merges of bf16 partials and the tp sums of bf16 partials move activations
# by bf16 roundings, which flip int8 codes as a kernel-vs-plain run does);
# the video against its unsharded twin's through the quality CLI at its 35
# dB gate (the JAX bench_e2e --ab gate); the launches per rank as derived
# from the sharded modules; every rank's latents bit-equal after each step.
# Run S's seconds are not a speed figure: four ranks time-share one card
# and stage their hops through host memory.
RUN_S_MESH = (1, 2, 2)
RUN_S_ARGV = ["--mesh_dp", "1", "--mesh_sp", "2", "--mesh_tp", "2", "--dist_backend", "gloo",
              "--exp_name", "smoke_S", "--allow_dev_stubs"]
# The cut (the smoke's clock): run S reads CUT_FRAMES frames with
# CUT_DEPTH_STEPS Euler steps a depth window, as runs B-J do, against run
# A9, run A at the same cut; tools/run_s_uncut.py runs it at 49 frames
# against run A.  The four ranks move ~12 GB a rank a forward at 49 frames
# through host memory (the tp sums and the ring's hops), ~30 s a forward
# on an H100 80GB HBM3 at 700 W (~120 s a run S); at 9 frames a quarter.
RUN_S_REL_L2 = 2.0 ** -5
# The check of the check: after the run, every rank sets its shard to the
# check weights (``check_weights_``) and runs the first forward's inputs
# again on the DiT cut to its first RUN_S_CHECK_LAYERS blocks (since PR 20,
# for the smoke's clock: 42 before), sound and with each fault planted in
# every rank: (name, whether it is wrong).  The run's random weights hide a
# wrong shard: their LayerNorm
# weights of ~0.02 make every softmax uniform and their biases outweigh the
# rest, and the blocks' gates (~0.01-0.05) keep any branch small in the
# output.  So each forward is held against the unsharded DiT on the same
# check weights at the joint attention output of RUN_S_CHECK_BLOCKS,
# gathered over the mesh.  Its output is reported, not held: on these
# weights a sound run's bf16 and int8 rounding compounded over the 42 blocks
# to ~3.5e-2 relative L2 at the output (NVIDIA H100 80GB HBM3), so the
# output does not part sound from wrong there.  A ring that drops its
# visiting shard (sp 2: its one hop) and a tp sum that drops the last
# rank's partial are wrong and must fail the limits at an attention output.
# (Row-parallel layers that quantize with their own rows' max |x| are not
# wrong in value and are not rerun here: phase 3 holds K2a's scale-taking
# entry bit-equal to the whole row's codes.)
RUN_S_FAULTS = (("ring drops its visiting shard", True),
                ("tp sum drops the last rank's partial", True))
RUN_S_CHECK_LAYERS = 4
RUN_S_CHECK_BLOCKS = (0, RUN_S_CHECK_LAYERS - 1)
RUN_S_TIMEOUT = 900
# the per-rank shapes of run S's kernels: K5 over a rank's 6,665 joint tokens
# and 24 heads against each visiting shard of 6,665; the int8 GEMMs below
RUN_S_K5_SHAPE = (2, 24, 6665, 6665, 64)  # (B, H, Sq, Skv, D)
# the row-parallel layers' inputs (M, K of the rank, K of the whole row): the
# blocks' to_out and FF2, the Perceivers' to_out, which quantize their
# columns with the row's scale (K2a's scale-taking entry)
RUN_S_ROW_PARALLEL = {"tp2_to_out": (13330, 1536, 3072), "tp2_ff2": (13330, 6144, 12288),
                      "tp2_perceiver_to_out": (13330, 1024, 2048)}
# Run S's sharded warp and VAE: every rank warps its share of the frames
# (shard_sizes over the 4 ranks: 3 / 3 / 3 / 0 at 9 frames) and holds its
# (H/dp, W/sp) slab of the CogVideoX VAE's condition prep and decode
# (parallel/spatial.py).  After the run, on the run's inputs: the sharded
# warp against the unsharded warp (the leader reruns it whole), held to the
# float-atomic bounds of the warp parity (RUN_S_WARP_MASK_MAX of the pixels'
# masks may disagree, RUN_S_WARP_OFF_MAX of the known pixels may part by
# more than 1e-3); the run's sharded condition latents and decoded frames
# against the unsharded VAE's on the same inputs (the condition prep
# replays the run's generator from its state before the prep drew), by
# relative L2 over the whole tensor and on the seam band (the rows and
# columns within one latent, 8 pixels, of a seam), within
# RUN_S_VAE_REL_TOL (since PR 20 not rerun under RUN_S_VAE_MESH: the
# smoke's clock).  The check of the check, under RUN_S_VAE_MESH (H on dp
# too, from the same torchrun), where both axes exchange halos: on the VAE's check
# weights (``check_weights_``: GroupNorm weights 1, every bias 0; the
# run's weights keep every activation near its channel's bias, where a
# wrong halo hardly shows) each fault of RUN_S_VAE_FAULTS planted in every
# rank must read RUN_S_VAE_FAULT_RATIO times the sound reading on the seam
# band, at the encode of the run's rendered video's first
# RUN_S_VAE_CHECK_FRAMES frames, cropped to RUN_S_VAE_CHECK_CROP, and at the
# decode of the unsharded encode's latents (a picture's latents, whose slabs differ as the picture does: the
# final latents of random weights are noise alike in every slab, which a
# slab-local norm would barely move).  It runs in fp32 without TF32: on
# the check weights the bf16 roundings compound to ~2e-2 relative L2 in a
# sound run, off the seams as much as on them (NVIDIA H100 80GB HBM3, 700
# W), which left a slab-local norm's ~0.2 only 7.4x above.
RUN_S_VAE_MESH = (2, 2, 1)
# the check of the check's input: the encode's first chunk of the rendered
# video's top-left quarter (a seam on each axis still)
RUN_S_VAE_CHECK_FRAMES = 5
RUN_S_VAE_CHECK_CROP = (192, 336)
RUN_S_VAE_REL_TOL = 1e-2
RUN_S_VAE_FAULTS = ("zero halo", "local norm")
RUN_S_VAE_FAULT_RATIO = 10.0
RUN_S_WARP_MASK_MAX = 0.005
RUN_S_WARP_OFF_MAX = 0.03
# Run S's sharded depth stage: every rank runs its share (parallel/frames.py):
# CLIP and the SVD encode on its whole frames of the clip (``frames.deal``
# over the 4 ranks, the leader fewest), the UNet's window on its slab --
# frames on dp, latent rows on sp in whole blocks of 8, at 72 x 128 latents
# 40 / 32 rows, the same slab on both tp ranks -- and the decode's whole
# chunks; every rank gets the whole depth.  K4 runs at
# ``run_s_depth_shapes()``: a rank's query rows against the whole frame's
# keys.  Its launches per rank are derived from the sharded twin's modules
# (``_depth_kernel_attentions``); the depth models' bits are the same on
# every rank (a checksum over the ranks).  After the run, on the run's
# frames and seed: the depth stage on the leader, unsharded (since PR 20 no
# rerun under RUN_S_VAE_MESH: the smoke's clock); the run's raw disparity
# and first UNet forward against the unsharded ones by relative L2 over the
# whole tensor and on the seam band (latent rows within
# RUN_S_DEPTH_BAND_ROWS of a row seam, 8x as many pixel rows for the
# disparity; frames within RUN_S_DEPTH_BAND_FRAMES of a frame seam), within
# RUN_S_DEPTH_REL_TOL.  The check of the check, under RUN_S_VAE_MESH, in
# fp32 without TF32 (bf16 roundings on random weights compound off the
# seams as on them and can hide a fault, as the VAE's check above says): a
# UNet cut to one layer a block at the deployed widths
# (RUN_S_DEPTH_CHECK_UNET, the plain attention), seeded and set to the
# check weights, on the run's first UNet input cropped to
# RUN_S_DEPTH_CHECK_CROP latent rows x columns (three row blocks: 16 / 8
# over sp), sound and with each of RUN_S_DEPTH_FAULTS planted in every rank:
# each fault at least RUN_S_VAE_FAULT_RATIO times the sound reading on the
# band.
RUN_S_DEPTH_REL_TOL = 1e-2
RUN_S_DEPTH_BAND_ROWS, RUN_S_DEPTH_BAND_FRAMES = 2, 1
RUN_S_DEPTH_CHECK_UNET = dict(layers_per_block=1, attention_impl="reference")
RUN_S_DEPTH_CHECK_CROP = (24, 64)
RUN_S_DEPTH_FAULTS = ("zero row halo", "zero frame halo", "local norm", "local frame ids",
                      "K/V ungathered")
DEPTH_LATENTS = (72, 128)  # the depth stage's latents at 576x1024

# Data-sheet rates of an H100 SXM (dense): bf16 989 TFLOP/s, int8 1,979
# TOP/s, 3.35 TB/s of device memory; the SFU's 16 exp2 per clock per SM x
# 132 SMs at the card's maximum SM clock (nvidia-smi clocks.max.sm).
BF16_OPS, INT8_OPS, MEM_BYTES = 989e12, 1979e12, 3.35e12
SFU_EXP_PER_CLOCK = 16 * 132


def run_s_depth_shapes() -> dict:
    """K4's per-rank shapes in run S (B = frames, H, Sq, Skv, D): at the two
    levels that launch it (72 x 128 and 36 x 64 latents), each sp rank's
    query rows (whole blocks of 8 latent rows at level 0) against the whole
    frame's tokens, all ``CUT_FRAMES`` frames (dp 1)."""
    from trajectorycrafter_tpu_torch.parallel.frames import ROW_BLOCK
    from trajectorycrafter_tpu_torch.parallel.sharding import shard_sizes

    h, w = DEPTH_LATENTS
    frames = shard_sizes(CUT_FRAMES, RUN_S_MESH[0])[0]
    rows = [b * ROW_BLOCK for b in shard_sizes(h // ROW_BLOCK, RUN_S_MESH[1])]
    out = {}
    for level, heads in ((0, 5), (1, 10)):
        tokens = (h >> level) * (w >> level)
        for r in rows:
            out[f"run_s_depth_{tokens}_rows{r >> level}"] = (
                frames, heads, (r >> level) * (w >> level), tokens, 64)
    return out


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
        attention_reference,
        maxpass_reference,
        output_error,
        plain_refs,
    )
    from trajectorycrafter_tpu_torch.ops.kernels import ATTENTION_KEY_TILE, flash_maxpass

    q = (randn(b, sq, h, d) * gain).bfloat16()
    k, v = randn(b, skv, h, d).bfloat16(), randn(b, skv, h, d).bfloat16()
    scale = d ** -0.5
    out = kernel(q, k, v, scale)
    torch.cuda.synchronize()
    # the plain version of the kernel's own function (``kernel_error``), run
    # once for the sound answer and both faults
    plain = maxpass_reference if kernel is flash_maxpass else attention_reference
    refs = plain_refs(lambda x: plain(q, k, x, scale), v)
    sound = output_error(out, *refs)
    # the key tiles of the kernel under test (both run ATTENTION_KEY_TILE)
    keep = _skip_last_quarter(skv, ATTENTION_KEY_TILE)
    faults = {
        "row_sum_x1.1": output_error((out.float() / 1.1).bfloat16(), *refs),
        "last_quarter_of_key_tiles_skipped": output_error(
            kernel(q, k[:, :keep], v[:, :keep], scale), *refs),
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
    # with scores unbounded as it has no QK-norm; both whole at 576x1024 (run
    # R; 30,178 tokens leave a ragged last key tile); a small ragged shape;
    # the depth UNet's two kernel shapes cut in frames, peaked (no QK-norm
    # either)
    b, h, s, d = DIT576_SHAPE
    cases = [
        (flash_attention, "dit_self_heads8", 1, 8, 13330, 13330, 64, 1.0),
        (flash_attention, "perceiver_cross", 2, 16, 13104, 3024, 128, 4.0),
        (flash_attention, "dit576_self", b, h, s, s, d, 1.0),
        (flash_attention, "perceiver576_cross", *PERCEIVER576_SHAPE, 4.0),
        (flash_attention, "ragged_small", 1, 2, 1000, 1000, 64, 1.0),
    ]
    for kernel in (flash_attention, flash_maxpass):
        cases += [
            (kernel, "depth_9216_frames2", 2, 5, 9216, 9216, 64, 4.0),
            (kernel, "depth_2304_frames8", 8, 10, 2304, 2304, 64, 4.0),
        ]
    cases.append((flash_maxpass, "ragged_small", 1, 2, 1000, 777, 64, 4.0))
    # K4 at run S's per-rank shapes: a rank's query rows x the whole frame's keys
    cases += [(flash_attention, name, *shape, 4.0) for name, shape in run_s_depth_shapes().items()]
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

    # K1 at the Perceiver's shape, at run R's two shapes (576x1024), K4 at
    # the depth UNet's 2,304-token level and at run S's per-rank shapes:
    # (shape, q gain, plain iterations)
    b, h, s, d = DEPTH_SHAPES["depth_2304"]
    b5, h5, s5, d5 = DIT576_SHAPE
    other = {"perceiver": (PERCEIVER_SHAPE, 4.0, 2), "dit576": ((b5, h5, s5, s5, d5), 1.0, 1),
             "perceiver576": (PERCEIVER576_SHAPE, 4.0, 2),
             "depth_2304": ((b, h, s, s, d), 4.0, 2),
             **{name: (shape, 4.0, 2) for name, shape in run_s_depth_shapes().items()}}
    for name, ((b, h, sq, skv, d), gain, plain_iters) in other.items():
        q = (randn(b, sq, h, d) * gain).bfloat16()  # no QK-norm but the DiT's: peaked rows
        k, v = randn(b, skv, h, d).bfloat16(), randn(b, skv, h, d).bfloat16()
        t = in_turns({"plain_ms": lambda: attention_reference(q, k, v, d ** -0.5),
                      "ms": lambda: flash_attention(q, k, v, d ** -0.5),
                      "library_ms": lambda: sdpa_flash(q, k, v, d ** -0.5)},
                     {"plain_ms": plain_iters, "ms": 10, "library_ms": 10},
                     cold=("plain_ms",) if plain_iters == 1 else ())
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

    # K5 at run S's per-rank shape (the ring's inner step, a rank's queries
    # against one visiting shard of keys) and at run T1's (a rank's heads of
    # the joint self-attention and of the Perceiver); "run_s_*" / "run_t_*"
    # keys of its entry
    for prefix, shape in (("run_s", RUN_S_K5_SHAPE), *RUN_T_K5_SHAPES.items()):
        b, h, sq, skv, d = shape
        scale = d ** -0.5
        q, k, v = (randn(b, n, h, d).bfloat16() for n in (sq, skv, skv))
        if prefix.endswith("perceiver"):
            q = q * 4.0  # the Perceiver's scores are not QK-normed
        out, lse = flash_lse(q, k, v, scale)
        refs = plain_refs(lambda x: attention_reference(q, k, x, scale), v)
        judge("flash_lse", f"{prefix} {shape}", output_error(out, *refs), {
            "row_sum_x1.1": output_error((out.float() / 1.1).bfloat16(), *refs),
            "last_quarter_of_key_tiles_skipped": output_error(flash_lse(
                q, k[:, :_skip_last_quarter(skv, ATTENTION_KEY_TILE)],
                v[:, :_skip_last_quarter(skv, ATTENTION_KEY_TILE)], scale)[0], *refs)})
        check_readings(f"flash_lse {prefix} {shape} logsumexp", lse_error(lse, q, k, scale),
                       {"lse_in_base_2": lse_error(lse / math.log(2.0), q, k, scale)})
        del out, lse, refs
        t = in_turns(
            {"plain_ms": lambda: (attention_reference(q, k, v, scale, chunk=512),
                                  av.lse_reference(q, k, scale, chunk=512)),
             "ms": lambda: flash_lse(q, k, v, scale),
             "library_ms": lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                 bshd(q), bshd(k), bshd(v), scale=scale)},
            {"plain_ms": 1, "ms": 5, "library_ms": 5}, cold=("plain_ms",))
        bnd = attention_bound(b, h, sq, skv, d, extra_bytes=4 * b * h * sq)
        timing["flash_lse"].update({
            f"{prefix}_shape": str(shape), f"{prefix}_ms": t["ms"],
            f"{prefix}_plain_ms": t["plain_ms"], f"{prefix}_library_ms": t["library_ms"],
            f"{prefix}_bound_ms": bnd["bound_ms"], f"{prefix}_sfu_ms": bnd["sfu_ms"]})
        log(f"flash_lse timed at {prefix}'s per-rank shape {shape}: {t['ms']:.3f} ms, plain "
            f"{t['plain_ms']:.2f} ms, library {t['library_ms']:.3f} ms; bound "
            f"{bnd['bound_ms']:.3f} ms ({bnd['bound_by']}), SFU {bnd['sfu_ms']:.3f} ms")
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
             ("run_t_dit", RUN_T_K5_SHAPES["run_t_dit"], 1.0, ("query_tiles", "key_tiles")),
             ("run_t_perceiver", RUN_T_K5_SHAPES["run_t_perceiver"], 4.0,
              ("di", "query_tiles", "key_tiles")),
             ("run_t5_hop", RUN_T_K5_SHAPES["run_t5_hop"], 1.0, ("query_tiles", "key_tiles")),
             ("run_t5_perceiver", RUN_T_K5_SHAPES["run_t5_perceiver"], 4.0,
              ("di", "query_tiles", "key_tiles")),
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

    # timing at full shape, in turns: plain, dK/dV, dQ, SDPA's backward and
    # back; at run P's shapes and at run T1's per-rank shapes
    timing = {}
    for label, (b, h, sq, skv, d) in (("dit", TRAIN_DIT_SHAPE),
                                      ("perceiver", TRAIN_PERCEIVER_SHAPE),
                                      *RUN_T_K5_SHAPES.items()):
        scale = d ** -0.5
        gain = 1.0 if label.endswith(("dit", "hop")) else 4.0
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


def _backward_entries(err: dict, timing: dict, launches: dict, run_t: dict) -> list:
    """The two backward kernels' entries of the kernels JSON line: times at
    the DiT's training shape, the Perceiver's and run T1's per-rank shapes
    beside them; ``launches`` those of one training step of run P, ``run_t``
    run T's launches a rank."""
    entries = []
    for name in BACKWARD:
        if not launches[name]:
            raise AssertionError(f"run P's training step launched no {name}")
        dit = timing["dit"]
        t = {"ms": dit[name], "plain_ms": dit["plain_ms"], "library_ms": dit["library_ms"],
             **dit["bounds"][name], "shape": dit["shape"],
             "library": "flash SDPA backward: dq, dk and dv in one call (the yardstick of "
                        "the two kernels' sum); plain_ms: the plain version's dq, dk and dv"}
        for label in ("perceiver", *RUN_T_K5_SHAPES):
            other = timing[label]
            t.update({f"{label}_shape": other["shape"], f"{label}_ms": other[name],
                      f"{label}_plain_ms": other["plain_ms"],
                      f"{label}_library_ms": other["library_ms"],
                      f"{label}_bound_ms": other["bounds"][name]["bound_ms"]})
        entries.append(_attention_entry(
            name, t, launches=launches[name], launches_run_t_per_rank=run_t[name],
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
        int8_quantize_rows_scaled,
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
        if name in ("dit_ff1", "dit_ff2", "dit576_ff1", "dit576_ff2"):
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

    # K2a's scale-taking entry at run S's row-parallel inputs: a rank's
    # columns quantized with the scale of the whole row must be the whole
    # row's codes; the rank's own row max (planted) must not pass
    for name, (m, k, k_row) in RUN_S_ROW_PARALLEL.items():
        label = f"{name} (M {m}, K {k} of {k_row})"
        x_row = (randn(m, k_row) * randn(m, 1).abs().add(0.1)).bfloat16()
        xq_row, xs = int8_quantize_rows(x_row)
        x = x_row[:, :k].contiguous()
        xq = int8_quantize_rows_scaled(x, xs)
        plain = im.quantize_rows_scaled_reference(x, xs)
        own = int8_quantize_rows_scaled(x, im.row_scales(x.float().abs().amax(dim=1)))
        if not (torch.equal(xq, plain) and torch.equal(xq, xq_row[:, :k])):
            raise AssertionError(f"int8_quantize_rows_scaled {label}: "
                                 f"{(xq != plain).sum().item()} codes differ from its plain "
                                 f"version, {(xq != xq_row[:, :k]).sum().item()} from the row's")
        if torch.equal(own, plain):
            raise AssertionError(f"int8_quantize_rows_scaled {label}: the rank's own row max "
                                 "(planted) gives the row's codes")
        t = in_turns({"scaled_ms": lambda: int8_quantize_rows_scaled(x, xs),
                      "scaled_plain_ms": lambda: im.quantize_rows_scaled_reference(x, xs)},
                     {"scaled_ms": 10, "scaled_plain_ms": 3})
        t.update(bound(nbytes=2 * m * k + 4 * m + m * k))
        per_shape[name].update({f"scaled_{key}" if not key.startswith("scaled") else key: v
                                for key, v in t.items()})
        log(f"int8_quantize_rows_scaled {label}: bit-equal to its plain version and to the "
            f"row's codes (the rank's own max rejected); {t['scaled_ms']:.3f} ms, plain "
            f"{t['scaled_plain_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms ({t['bound_by']})")
        del x_row, xq_row, xs, x, xq, plain, own
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
    """A kernel's launches in each stage of each main-path run (run T,
    which has no such stages, apart)."""
    return {f"run {r} {p}": runs[r]["per_path"][p][kern]
            for r in runs if "per_path" in runs[r] for p in ("depth", "denoise")}


def _run_launches(runs: dict, run: str, kern: str) -> int:
    return sum(runs[run]["per_path"][p][kern] for p in ("depth", "denoise"))


def _int8_entries(runs: dict, max_err: dict, per_shape: dict) -> list:
    """The int8 kernels' entries of the kernels JSON line."""
    from trajectorycrafter_tpu_torch.ops.int8_matmul import FF_GROUP

    src = "trajectorycrafter_tpu_torch/csrc/"
    shape = lambda name: "(M {}, K {}, N {})".format(*INT8_SHAPES[name][:3])
    entry = lambda kern, run, **kw: {
        "name": kern, "route": "cuda", "source": f"{src}{SOURCE_OF.get(kern, kern)}.cu",
        "replaces": TPU_KERNELS[kern], "launches": _run_launches(runs, run, kern),
        "launches_run": run, "launches_per_path": _launches_per_path(runs, kern),
        "launches_576": _run_launches(runs, "R", kern),
        "launches_run_s": _run_launches(runs, "S", kern),
        "launches_run_s_per_rank": runs["S"]["per_rank"][kern],
        "launches_run_t_per_rank": runs["T"]["per_rank"][kern],
        "launches_run_u_per_rank": runs["U"]["per_rank"][kern],
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
        entry("int8_quantize_rows_scaled", "S", ms=per_shape["tp2_ff2"]["scaled_ms"],
              plain_ms=per_shape["tp2_ff2"]["scaled_plain_ms"], library_ms=None,
              bound_ms=per_shape["tp2_ff2"]["scaled_bound_ms"],
              bound_by=per_shape["tp2_ff2"]["scaled_bound_by"],
              shape="x (M 13330, K 6144) of a row of 12288 (run S's FF2 at tp 2)",
              per_shape={name: {key: per_shape[name][key] for key in
                                ("scaled_ms", "scaled_plain_ms", "scaled_bound_ms")}
                         for name in RUN_S_ROW_PARALLEL},
              note="K2a's entry taking the row scale: the row-parallel layers under tp"),
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
        # run A at the cut: run S's unsharded twin (phase 5s)
        "A9": (dit8, None, "auto", "flash_attention", unet, "int8", "none", "flash_stock",
               "flash_attention"),
    }
    pipe = tc.models.depth_infer.__self__.pipe
    runs = {}
    for run, (model, fuse, dit_attn, dit_kernel, depth_unet, quant, quant_depth, depth_attn,
              depth_kernel) in plans.items():
        tc.models.pipeline.transformer, pipe.unet = model, depth_unet
        tc.cfg.diffusion.quant, tc.cfg.depth.quant = quant, quant_depth
        _set_fuse(model, fuse)
        set_impl(model, dit_attn)
        # A drives the deployed clip and depth stage, B-D the cut ones
        try:
            with cut_runs(tc.cfg) if run != "A" else contextlib.nullcontext():
                want = _expected_launches(tc.cfg, tc.models.pipeline.scheduler, model,
                                          depth_unet, depth_kernel, dit_kernel)
                runs[run] = run_mode(tc, run, depth_attn, dit_attn)
        finally:
            _set_fuse(model, None)
            set_impl(model, "auto")
        if runs[run]["per_path"] != want:
            raise AssertionError(f"run {run}: kernel launches per stage "
                                 f"{runs[run]['per_path']}, expected {want}")
        QUALITY_DIR.mkdir(parents=True, exist_ok=True)
        shutil.copy(Path(tc.cfg.save_dir) / "gen.mp4", QUALITY_DIR / f"gen_{run}.mp4")
    tc.models.pipeline.transformer, pipe.unet = dit, unet
    tc.cfg.diffusion.quant, tc.cfg.depth.quant = cfg.diffusion.quant, cfg.depth.quant

    # B-D on one clip: C's depth is A's route (the bf16 UNet on flash_stock)
    for run, what in (("B", "int8 UNet, flash_max"), ("D", "flash_pv8")):
        rel = np.abs(np.log(runs[run]["depth"] / runs["C"]["depth"]))
        log(f"depth of runs {run} ({what}) and C (bf16 UNet, flash_stock; information): "
            f"median |log ratio| {np.median(rel):.3e}, max {rel.max():.3e}")
    quality = video_quality(runs["C"]["gen"] * 255.0, runs["D"]["gen"] * 255.0)
    log(f"gen of run C (bf16 DiT) against run D (int8 DiT on flash_pv8), information only "
        f"(random weights, 2 steps): {json.dumps(quality)}")
    return tc, runs, (dit8, unet8)


def mp4_frame_sizes(save_dir) -> tuple:
    """(height, width) of the frames of each of the five mp4s."""
    import cv2

    sizes = []
    for name in MP4S:
        cap = cv2.VideoCapture(str(Path(save_dir) / name))
        sizes.append((int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                      int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))))
        cap.release()
    return tuple(sizes)


def phase_sample_576(tc, dit8, runs: dict) -> None:
    """Run R: ``infer_gradual`` with ``--sample_size 576 1024``, the JAX
    bench's diffusion size, and the CLI's other defaults (``--quant int8``,
    DDIM_Origin at 2 steps, CFG 6.0) on run A's models and clip (49 frames):
    the warp already has the sample size, so the render and the mask go to
    the pipeline as they are; the DiT attends over 30,178 joint tokens, its
    Perceivers over 29,952 x 6,912, its int8 GEMMs take 60,356 rows.  The
    launches per stage are held to the counts derived from the modules, the
    five mp4s to 49 frames of 576x1024 (viz: the pair side by side); stage
    times and peak memory are logged.  The run joins ``runs``."""
    import torch

    from trajectorycrafter_tpu_torch.cli import parse_config
    from trajectorycrafter_tpu_torch.orchestrator import TrajCrafter

    # its depth stage takes CUT_DEPTH_STEPS Euler steps (run A keeps the 5 of
    # the default at the same frames and size; 5 here before run S's sharded
    # VAE took their seconds)
    cfg = parse_config(MAIN_ARGV + ["--sample_size", *map(str, SAMPLE_576),
                                    "--depth_inference_steps", str(CUT_DEPTH_STEPS),
                                    "--exp_name", "smoke_576"])
    if (tuple(cfg.diffusion.sample_size), tuple(cfg.warp_size), cfg.diffusion.quant,
            cfg.video_length) != (SAMPLE_576, SAMPLE_576, "int8", 49):
        raise AssertionError(f"--sample_size 576 1024 gave sample size "
                             f"{cfg.diffusion.sample_size}, warp size {cfg.warp_size}, "
                             f"--quant {cfg.diffusion.quant}, {cfg.video_length} frames")
    r_tc = TrajCrafter(cfg, models=tc.models)
    pipeline = tc.models.pipeline
    unet = tc.models.depth_infer.__self__.pipe.unet
    saved = pipeline.transformer
    pipeline.transformer = dit8
    resident = torch.cuda.memory_allocated() / 2**30
    try:
        want = _expected_launches(cfg, pipeline.scheduler, dit8, unet, "flash_attention",
                                  "flash_attention")
        runs["R"] = run_mode(r_tc, "R", "flash_stock", "auto")
    finally:
        pipeline.transformer = saved
    runs["R"].pop("gen")
    if runs["R"]["per_path"] != want:
        raise AssertionError(f"run R: kernel launches per stage {runs['R']['per_path']}, "
                             f"expected {want}")
    sizes = mp4_frame_sizes(cfg.save_dir)
    hs, ws = SAMPLE_576
    if sizes != ((hs, ws),) * 4 + ((hs, 2 * ws + 30),):
        raise AssertionError(f"run R: mp4 frame sizes {dict(zip(MP4S, sizes))}")
    stages = runs["R"]["stages"]
    log(f"  run R: launches as derived; mp4 frames {dict(zip(MP4S, sizes))}; "
        f"{stages['denoise'] / cfg.diffusion.num_inference_steps:.3f} s a denoise step; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, {resident:.2f} GiB resident")


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
             cfg.diffusion.num_inference_steps)
    pipeline.transformer = dit8
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
         cfg.diffusion.num_inference_steps) = saved

    draws = sampler_step_draws()
    for name in SCHEDULER_REGISTRY:
        err, scale = sampler_step_error(name, draws)
        log(f"sampler {name}: one step on {LATENT_SHAPE}, card vs CPU: max abs err {err:.3e} "
            f"(limit {SAMPLER_STEP_TOL} x {scale:.3f})")
        if not np.isfinite(err) or err > SAMPLER_STEP_TOL * scale:
            raise AssertionError(f"sampler {name}: the card's step disagrees with the CPU's")


# The clip length and the depth stage of the runs: A, L, P and R drive the
# deployed 49 frames (13 latent frames, the DiT's 13,330 or 30,178 joint
# tokens), M 32; the others read 9 (3 latent frames; H and I 9-frame
# segments).  Run A takes the default 5 Euler steps a depth window, every
# other run 1 (L, R and phase 8's scripts since run S's sharded VAE).
# The launches per DiT forward and per UNet forward do not depend on either
# (one depth window either way; K4's launches follow the step count), and
# phases 3-4b hold every kernel at the full shapes.  The cuts keep the smoke
# near 500 s on one H100 (653 s with these runs at 49 frames and 5 steps).
CUT_FRAMES = 9
CUT_DEPTH_STEPS = 1
# The long-trajectory and known-camera paths (v1, v2, the smooth fly
# between two cameras) run as phase 8's scripts on the tree; runs H-J drove
# the same classes in process on run A's models before PR 20 cut them for
# the smoke's clock.
# v2's cloud limit in phase 8's and run U's scripts: the merged cloud of two
# 9-frame windows (10.6 M points) downsampled to 1 M, a quarter of the
# default 4 M (the export of 4 M points took 7.6-7.9 s a run: cut for the
# smoke's clock)
MAX_POINTS = 1_000_000
# Phase 8's scripts read 9 frames of the clip (one depth window still; the
# launches per depth stage and per DiT forward do not depend on the frame
# count): runs M and N drive the consistent-depth class on longer clips.
SCRIPT_FRAMES = 9
# the run_w_cam_poses script's two Panoptic-style cameras (t in cm), at the warp
# size's intrinsics
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
# then chunks of 2), and one tile as large as the frame (no overlap), which
# must be the one-shot decode; the auto route's choice is read at the
# latents of 49 frames, ``DEPLOYED_LATENTS``.  The JAX default tile of 30 x
# 45, which no route of the port takes, and the auto route's strips, which
# run U holds sharded against unsharded on run S's latents, were cut for the
# smoke's clock.
TILED_LATENTS = (1, 5, 72, 128, 16)
DEPLOYED_LATENTS = (1, 13, 72, 128, 16)
TILINGS = {"one_tile": (72, 128, 0.0, 0.0)}


@contextlib.contextmanager
def cut_runs(cfg):
    """Within the block ``cfg`` reads ``CUT_FRAMES`` frames and its depth
    stage takes ``CUT_DEPTH_STEPS`` Euler steps a window (runs B-J, N, O)."""
    saved = cfg.video_length, cfg.depth.num_inference_steps
    cfg.video_length, cfg.depth.num_inference_steps = CUT_FRAMES, CUT_DEPTH_STEPS
    try:
        yield cfg
    finally:
        cfg.video_length, cfg.depth.num_inference_steps = saved


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


def phase_tiled_decode(vae) -> None:
    """The tiled VAE decode at 17 frames of 576x1024 on the card: one tile as
    large as the frame bit-equal to ``vae_decode``; each decode's
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
# M's segments read 32 frames, the VDA's whole window at its deployed shape
# (49 before run S's sharded VAE took their seconds, 33 with a second,
# stitched window before run U took them); N's read ``CUT_FRAMES``
CONSISTENT_SEGMENTS = {"M": 32, "N": CUT_FRAMES}
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
                # the first segment's window: its 32 frames at 588 x 1036
                per_window = [sec for shape, sec in windows if shape[-2:] == (588, 1036)]
                if [shape for shape, _ in windows if shape[-2:] == (588, 1036)] != \
                        [(1, 32, 3, 588, 1036)]:
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
TRAIN_SCENES = 2
TRAIN_FRAMES = 49
SCENEFLOW_HW = (540, 960)
SCENEFLOW_STEP = 0.25
# threads making and writing the SceneFlow frames (cv2 and numpy release the
# GIL: 11.0 s in one thread, 2.8 s in four on the H100 machine's host)
SCENEFLOW_WRITERS = 4
TRAIN_STEPS = 2
TRAIN_RANK = 8
TRAIN_LR = 1e-4
TRAIN_DROPOUT = 0.1
LATENT_SHAPES = {"gt_latents": (13, 48, 84, 16), "inpaint_latents": (13, 48, 84, 17),
                 "ref_latents": (3, 48, 84, 16), "prompt_embeds": (226, 4096)}
GRAD_CHECK_LAYERS = 4
GRAD_CHECK_LATENTS = (5, 32, 56)
GRAD_MEDIAN_TOL = 2.0 ** -6
GRAD_MAX_TOL = 2.0 ** -3

# Run T (phase 5s's torchrun world, after run S's checks once its models are
# freed): sharded LoRA training and the GPipe block stack, four ranks sharing
# the card over gloo.
#   T1: ``scripts/train_lora.main`` under RUN_T_MESH (``--mesh_dp 2
#     --mesh_tp 2 --batch_size 2``) on the full-width bf16 DiT cut to
#     RUN_T_LAYERS blocks (``run_t1_dit``; ``flash_stock``, ``remat``), each
#     rank drawing its shard unit by unit (``build_dit(..., tp=)``), over the
#     RUN_T_FRAMES-frame samples that phase 5e writes with ``datagen`` from
#     run P's SceneFlow tree (the clock: as run S reads 9 frames; 3 latent
#     frames, 3,024 video + 226 text = 3,250 joint tokens); RUN_T_STEPS steps
#     with a checkpoint after each.  Held: each step's loss and grad norm and
#     the adapters after the steps against the same steps unsharded on one
#     card (the twin: ``train_lora.main`` on the same DiT unsharded in phase
#     5e, the same batches and draws), by relative error within RUN_T_REL_L2 (run S's
#     limit); the adapters bit-equal on every rank after every step; K5,
#     K4-dkv and K4-dq launched a rank a step as derived from the shard's
#     modules (``_training_launches``: 2 x 6 + 3, 9, 9); rank 0 alone
#     writes the checkpoints.  Logged: resident and peak memory and bytes by
#     transport a rank.
#   T2: the check of the check, on the full-width DiT cut to RUN_T_CHECK_LAYERS
#     blocks (one Perceiver): one batch's adapter gradients reduced over
#     RUN_T_MESH against the unsharded model's, sound and with each of
#     RUN_T_FAULTS planted in every rank, then reduced over RUN_T_SP_MESH
#     with the token stream on sp (the ring's plain versions), sound and
#     with each of RUN_T_SP_FAULTS; each fault must read
#     RUN_S_VAE_FAULT_RATIO times the sound reading on the adapters it
#     touches.  As run S's VAE check does, it runs in fp32 without TF32 on
#     the check weights (``check_weights_``) with the plain attention: on
#     random bf16 weights the blocks' small gates keep the branches' share of
#     a gradient near its bf16 rounding, which a missing reduction would hide
#     behind.
#   T3: GPipe over pp RUN_T_PP on ranks 0-2 (rank 3 idle, under JAX's
#     warning) at full depth: 21 superblocks, 7 a stage; the int8 DiT (run
#     A's weights) on run S's first DiT call's inputs (run A9's 9-frame CFG
#     pair, B = 2) in RUN_T_MICROBATCHES microbatches, against the sequential
#     block loop of the whole model (the main process) within RUN_T_REL_L2,
#     bit equality reported; K1, K2a and K2b launched a stage as derived from
#     its modules (M x 7 x 3, M x 7 x 15, M x 7 x 15); each stage's resident
#     memory against the whole model's.
#   T4: GPipe with pp 2 x tp 2 (RUN_T_PP_TP) on all four ranks, the
#     full-width DiT cut to RUN_T_PP_TP_LAYERS layers (2 superblocks: no pp
#     that divides 21 fits four ranks beside tp 2 at full depth, and JAX's
#     own dry run composes pp x tp on 4 layers), on the same inputs, against
#     its sequential loop within RUN_T_REL_L2; a planted stage that skips its
#     hop (reads zeros) must read RUN_S_VAE_FAULT_RATIO times the sound
#     reading.
#   T5: LoRA training with the token stream on sp: the same four ranks as
#     RUN_T_SP_MESH (a second ``make_mesh``), one step of ``make_train_step``
#     (``_run_t5_step``) on T1's DiT (full width cut to RUN_T_LAYERS blocks,
#     bf16, ``flash_stock``, ``remat``; each rank its tp shard) on the first
#     of T1's samples (batch 1: 3,250 joint tokens, 1,625 a sp rank), every
#     block's joint self-attention on the differentiable ring (K5 a hop
#     forward, K4-dkv and K4-dq a hop backward).  Held: the loss, grad norm
#     and adapters after the step against its twin (the same step unsharded
#     in phase 5e, the same sample, adapters and draws) within RUN_T_REL_L2;
#     the adapters bit-equal on every rank; each rank's launches as derived
#     (``_training_launches(..., sp=2)``: K5 2 x 6 x 2 + 3 = 27, K4-dkv and
#     K4-dq 6 x 2 + 3 = 15).  T2 holds RUN_T_SP_FAULTS on the same mesh.
RUN_T_MESH = (2, 1, 2)  # (dp, sp, tp) of T1 and T2
RUN_T_SP_MESH = (1, 2, 2)  # (dp, sp, tp) of T5 and T2's sp check
RUN_T_FRAMES = CUT_FRAMES
RUN_T_STEPS = 1  # 2 until T5 came: the second step's time went to T5
# T1 and its twin run the full-width DiT cut to RUN_T_LAYERS blocks (and
# their Perceivers) before its weights are drawn: the full depth took 24-28
# s a rank for one step, gloo's pace, which the smoke's clock cut
RUN_T_LAYERS = 6
RUN_T_REL_L2 = 2.0 ** -5
RUN_T_LATENT_SHAPES = {"gt_latents": (3, 48, 84, 16), "inpaint_latents": (3, 48, 84, 17),
                       "ref_latents": (3, 48, 84, 16), "prompt_embeds": (226, 4096)}
# the kernels' per-rank shapes in T1 (B = 1 a dp rank; tp 2 halves the
# heads): the joint self-attention over 3,250 tokens, 24 heads of 64; the
# Perceiver's 3,024 video queries against the 3 reference latent frames'
# 3,024 tokens, 8 heads of 128
RUN_T_K5_SHAPES = {"run_t_dit": (1, 24, 3250, 3250, 64),
                   "run_t_perceiver": (1, 8, 3024, 3024, 128),
                   # T5's under sp 2 x tp 2: one ring hop of the joint
                   # self-attention (1,625 queries against a visiting shard
                   # of 1,625 keys), and the Perceiver of the rank holding
                   # video tokens alone (its 1,625 against the whole 3,024
                   # reference tokens; the other rank's 1,399)
                   "run_t5_hop": (1, 24, 1625, 1625, 64),
                   "run_t5_perceiver": (1, 8, 1625, 3024, 128)}
RUN_T_CHECK_LAYERS = 2
RUN_T_CHECK_LATENTS = (3, 32, 56)
RUN_T_CHECK_SEED = 7
RUN_T_FAULTS = ("column input's backward without its tp sum",
                "replicated proj_out adapter summed over tp", "dp gradients summed")
RUN_T_SP_FAULTS = ("adapter gradients not summed over sp",
                   "output gather's backward summed over sp",
                   "ring backward keeps only its own queries' dK/dV")
RUN_T5_SEED = 9  # T5's and its twin's adapters and draws
RUN_T_PP = 3
RUN_T_MICROBATCHES = 2
RUN_T_PP_TP = (1, 1, 2, 2)  # (dp, sp, tp, pp)
RUN_T_PP_TP_LAYERS = 4


def run_t1_dit(attention_impl: str):
    """T1's and its twin's DiT: the full-width model cut to RUN_T_LAYERS
    blocks and their Perceivers (built under ``torch.device("meta")`` by
    ``build_dit``, which then draws the cut model's weights)."""
    from trajectorycrafter_tpu_torch.orchestrator import full_scale_dit

    dit = full_scale_dit(attention_impl)
    dit.transformer_blocks = dit.transformer_blocks[:RUN_T_LAYERS]
    dit.perceiver_cross_attention = dit.perceiver_cross_attention[
        :RUN_T_LAYERS // PERCEIVER_INTERVAL]
    return dit


def _write_pfm(path: Path, img) -> None:
    """A little-endian one-channel PFM (rows bottom to top)."""
    import numpy as np

    h, w = img.shape
    path.write_bytes(f"Pf\n{w} {h}\n-1.0\n".encode()
                     + np.ascontiguousarray(np.flipud(img)).astype("<f4").tobytes())


def write_sceneflow_tree(root: Path, scenes: int, frames: int, seed: int = 0) -> list:
    """<root>/frames_cleanpass/<scene>/left/NNNN.png, disparity/<scene>/left/
    NNNN.pfm and camera_data/<scene>/camera_data.txt at 960 x 540: textured
    frames that drift with the camera (each frame's noise drawn from its own
    seed), disparities of 20-60 px (depth 17-52 at f = 1050), the left
    camera's c2w moving SCENEFLOW_STEP along x and turning 0.002 rad a
    frame.  ``SCENEFLOW_WRITERS`` threads make and write the frames.
    Returns the scene names."""
    from concurrent.futures import ThreadPoolExecutor

    import cv2
    import numpy as np

    h, w = SCENEFLOW_HW
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    def frame(name, sc, phase, disp, i):
        shift = xx + 4.0 * i
        rgb = np.stack([127 + 100 * np.sin(shift / (23.0 + 7 * c) + yy / (31.0 + 5 * c)
                                           + phase[c]) for c in range(3)], -1)
        rgb += np.random.default_rng([seed, sc, i]).normal(0, 8, rgb.shape)
        cv2.imwrite(str(root / f"frames_cleanpass/{name}/left/{i:04d}.png"),
                    np.clip(rgb, 0, 255).astype(np.uint8))
        _write_pfm(root / f"disparity/{name}/left/{i:04d}.pfm", disp)

    names, jobs = [], []
    with ThreadPoolExecutor(SCENEFLOW_WRITERS) as pool:
        for sc in range(scenes):
            name = f"scene_{sc}"
            names.append(name)
            for sub in (f"frames_cleanpass/{name}/left", f"disparity/{name}/left",
                        f"camera_data/{name}"):
                (root / sub).mkdir(parents=True, exist_ok=True)
            phase = np.random.default_rng([seed, sc]).uniform(0, 6.28, 3)
            disp = (20.0 + 40.0 * yy / h + 2.0 * np.sin(xx / 37.0 + sc)).astype(np.float32)
            jobs += [pool.submit(frame, name, sc, phase, disp, i) for i in range(frames)]
            lines = []
            for i in range(frames):
                a = 0.002 * i
                c2w = np.array([[np.cos(a), 0, np.sin(a), SCENEFLOW_STEP * i], [0, 1, 0, 0],
                                [-np.sin(a), 0, np.cos(a), 0], [0, 0, 0, 1]])
                right = c2w.copy()
                right[0, 3] += 1.0
                lines += [f"Frame {i}", "L " + " ".join(f"{v:.9g}" for v in c2w.flatten()),
                          "R " + " ".join(f"{v:.9g}" for v in right.flatten()), ""]
            (root / f"camera_data/{name}/camera_data.txt").write_text("\n".join(lines))
        for job in jobs:
            job.result()
    return names


def _training_launches(dit, steps: int = 1, val_forwards: int = 0, sp: int = 1) -> dict:
    """{kernel: launches} of ``steps`` training steps of ``dit`` with
    ``flash_stock`` and of ``val_forwards`` forwards without gradients, from
    its modules: a step's forward launches K5 once per block and Perceiver,
    the recomputation under ``remat`` once more per block (the Perceivers
    keep their activations, as JAX's ``nn.remat`` wraps the blocks only), the
    backward each backward kernel once per block and Perceiver; a forward
    without gradients launches K1 once per block and Perceiver.  With the
    tokens on ``sp`` ranks a block's ring launches each kernel once a hop,
    ``sp`` times (the Perceivers' keys are whole on every rank)."""
    blocks = len(dit.transformer_blocks)
    perceivers = len(dit.perceiver_cross_attention or ())
    layers = blocks + perceivers
    out = {name: 0 for name in KERNELS}
    out["flash_lse"] = steps * (sp * blocks * (2 if dit.remat else 1) + perceivers)
    out["flash_attention_bwd_dkv"] = out["flash_attention_bwd_dq"] = steps * (
        sp * blocks + perceivers)
    out["flash_attention"] = val_forwards * layers
    return out


def _launch_counts() -> dict:
    return {kern.__name__: kern.launches for kern in _kernel_counters()}


def phase_training(tc, data_root: Path, t_dir=None) -> dict:
    """Run P: the training data from a SceneFlow tree, TRAIN_STEPS LoRA steps
    of the full-width bf16 DiT, then the adapter gradients on the kernels
    against the plain versions; with ``t_dir``, run T1's samples and twin
    (``_run_t_twin``).  Returns the launches of one step."""
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
    if t_dir is not None:
        _run_t_twin(tc, data_root, t_dir, scenes)
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


# Run Q (phase 5f): DiT feature probing on the full-width bf16 DiT with the
# JAX default route (``attention_impl="auto"``: K1 for every joint self-
# attention and Perceiver, B = 1) and no recomputation.  The sweep of
# ``probing.collect_activation_dataset`` over run P's samples (no poses: the
# camera-motion filter keeps all) at PROBE_TIMESTEPS x PROBE_BLOCKS writes
# (13,104, 3,072) fp32 features; a ConvProbe trains PROBE_STEPS steps on each
# (timestep, block) slice (fp32; cuDNN runs its convolutions in TF32, torch's
# default, which the smoke leaves as it is).  Then the first sample's block-1
# features at t = 311 on the kernels against the plain versions on the DiT
# cut to 2 blocks (block 1's output does not depend on the later ones): two
# blocks and a Perceiver of bf16 arithmetic carry K1's per-call bf16
# differences (``attention_error``: 2^-6) into the residual stream, which
# they reach scaled down by the output projection; held to a relative L2
# error of PROBE_REL_L2 and a largest element error of PROBE_MAX_REL of the
# largest magnitude.
PROBE_TIMESTEPS = (311, 811)
PROBE_BLOCKS = (1, 3)
PROBE_STEPS = 50
PROBE_SCRIPT_STEPS = 20
PROBE_REL_L2 = 2.0 ** -7
PROBE_MAX_REL = 2.0 ** -5
QUALITY_DIR = REPO / "build" / "chip_smoke" / "quality"


def phase_probing(tc, data_root: Path) -> int:
    """Run Q: the activation sweep on the full-width bf16 DiT, a ConvProbe per
    (timestep, block), then block-1 features kernels vs plain.  Returns K1's
    launches in the sweep."""
    import numpy as np
    import torch

    from trajectorycrafter_tpu_torch import probing
    from trajectorycrafter_tpu_torch.schedulers import CogVideoXDDIMScheduler
    from trajectorycrafter_tpu_torch.scripts.probe_depth import depth_target
    from trajectorycrafter_tpu_torch.training.data import LatentsDataset

    t_phase = time.perf_counter()
    dit = tc.models.pipeline.transformer
    set_impl(dit, "auto")
    if dit.remat:
        raise AssertionError("run Q: the DiT still recomputes its blocks")
    data = LatentsDataset(str(data_root / "latents"))
    samples = [dict(data[i], name=f"sample_{i:04d}") for i in range(len(data))]
    scheduler = CogVideoXDDIMScheduler()  # the probe script's noising scheduler
    sch_state = scheduler.set_timesteps(50)
    out = data_root / "probe_features"
    seconds, recorded = [], {}
    collect = probing.collect_features

    def timed(model, blocks, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = collect(model, blocks, *args, **kwargs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if not recorded:  # the first sample at the first timestep
            recorded.update(args=args, kwargs=kwargs, feats=feats["transformer_block_1"])
        return feats

    for kern in _kernel_counters():
        kern.launches = 0
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    probing.collect_features = timed
    t0 = time.perf_counter()
    try:
        manifest = probing.collect_activation_dataset(
            dit, scheduler, sch_state, samples, PROBE_TIMESTEPS, PROBE_BLOCKS, str(out),
            motion_filter=probing.CameraMotionFilter())
    finally:
        probing.collect_features = collect
    t_sweep = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
    got = _launch_counts()
    forwards = len(samples) * len(PROBE_TIMESTEPS)
    want = _denoise_launches(dit, "flash_attention", forwards)
    log(f"run Q: collect_activation_dataset over {len(samples)} samples x timesteps "
        f"{list(PROBE_TIMESTEPS)} x blocks {list(PROBE_BLOCKS)} (attention auto, B = 1): "
        f"{t_sweep:.3f} s; {forwards} forwards of {[round(x, 3) for x in seconds]} s; peak "
        f"{peak:.2f} GiB above the {base_mem / 2**30:.2f} GiB resident; launches "
        f"{json.dumps({k: v for k, v in got.items() if v})}")
    if got != want:
        raise AssertionError(f"run Q: launches {got}, expected {want}")
    files = len(samples) * len(PROBE_TIMESTEPS) * len(PROBE_BLOCKS)
    if manifest["kept"] != [s["name"] for s in samples] or manifest["skipped"] or \
            manifest["files"] != files:
        raise AssertionError(f"run Q: manifest {manifest}, expected {len(samples)} kept and "
                             f"{files} files")

    # a ConvProbe per (timestep, block), on the card
    f, h, w, _ = samples[0]["gt_latents"].shape
    hp, wp = h // dit.patch_size, w // dit.patch_size
    targets = torch.stack([depth_target(s, (f, hp, wp)) for s in samples]).cuda()
    tokens_shape = (f * hp * wp, dit.inner_dim)
    t0 = time.perf_counter()
    for t in PROBE_TIMESTEPS:
        for block in PROBE_BLOCKS:
            tokens, _ = probing.ActivationDataset(str(out), t, block).stacked()
            if tokens.shape != (len(samples), *tokens_shape) or not np.isfinite(tokens).all():
                raise AssertionError(f"run Q t {t} block {block}: features {tokens.shape} "
                                     f"(expected {(len(samples), *tokens_shape)}) or not finite")
            tokens = torch.from_numpy(tokens).cuda()
            probe = probing.ConvProbe(frames=f, height=hp, width=wp)
            init_fn, step_fn = probing.make_probe_trainer(probe)
            state = init_fn(torch.Generator(device="cuda").manual_seed(0), tokens)
            losses = []
            for _ in range(PROBE_STEPS):
                state, loss = step_fn(state, tokens, targets)
                losses.append(loss)
            losses = torch.stack(losses).tolist()
            with torch.no_grad():
                pred = state.params(tokens)
            err = probing.relative_depth_error(pred.cpu().numpy(), targets.cpu().numpy())
            log(f"run Q probe t {t} block {block}: features {tuple(tokens.shape)} in "
                f"[{tokens.min().item():.3f}, {tokens.max().item():.3f}]; ConvProbe loss "
                f"{losses[0]:.5f} -> {losses[-1]:.5f} in {PROBE_STEPS} steps, relative depth "
                f"error {err:.4f}")
            if not (np.isfinite(losses).all() and losses[-1] < losses[0] and np.isfinite(err)):
                raise AssertionError(f"run Q t {t} block {block}: losses {losses[0]} -> "
                                     f"{losses[-1]}, relative depth error {err}")
            del tokens, state, probe, pred
    t_probes = time.perf_counter() - t0
    shutil.rmtree(out)

    # block-1 features of the first sample at t = 311: kernels against plain
    blocks, perceivers = dit.transformer_blocks, dit.perceiver_cross_attention
    dit.transformer_blocks = blocks[:2]
    dit.perceiver_cross_attention = perceivers[:1]
    try:
        set_impl(dit, "reference")
        for kern in _kernel_counters():
            kern.launches = 0
        plain = probing.collect_features(dit, [1], *recorded["args"],
                                         **recorded["kwargs"])["transformer_block_1"]
        if any(_launch_counts().values()):
            raise AssertionError(f"run Q: the plain route launched {_launch_counts()}")
    finally:
        dit.transformer_blocks, dit.perceiver_cross_attention = blocks, perceivers
        set_impl(dit, "auto")
    kern, plain = recorded["feats"].float(), plain.float()
    rel_l2 = ((kern - plain).norm() / plain.norm()).item()
    max_rel = ((kern - plain).abs().max() / plain.abs().max()).item()
    log(f"run Q: block-1 features (1, {tokens_shape[0]}, {tokens_shape[1]}) of sample 0 at "
        f"t {PROBE_TIMESTEPS[0]} on K1 vs the plain versions: relative L2 {rel_l2:.3e} (limit "
        f"{PROBE_REL_L2:.3e}), largest error {max_rel:.3e} of the largest magnitude (limit "
        f"{PROBE_MAX_REL:.3e})")
    if not (rel_l2 <= PROBE_REL_L2 and max_rel <= PROBE_MAX_REL):
        raise AssertionError(f"run Q: block-1 features kernels vs plain: relative L2 "
                             f"{rel_l2:.3e}, largest {max_rel:.3e}")
    del recorded, kern, plain
    gc.collect()
    torch.cuda.empty_cache()
    log(f"run Q: {time.perf_counter() - t_phase:.3f} s (sweep {t_sweep:.3f}, probes "
        f"{t_probes:.3f}); ConvProbe in fp32 with cuDNN's TF32 convolutions")
    return got["flash_attention"]


def phase_probe_script(tree: dict, data_dir: str) -> None:
    """``scripts/probe_depth.main(argv)`` on the tree's 6-layer DiT and run P's
    samples, directly and with ``--collect_dir``; K1's launches derived from
    the loaded model (``_denoise_launches``), every probe file written and
    every probe's loss falling."""
    import numpy as np
    import torch

    from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel
    from trajectorycrafter_tpu_torch.scripts import probe_depth

    with torch.device("meta"):
        cut = CrossTransformer3DModel(num_layers=TREE_DIT_LAYERS)
    samples = len([f for f in os.listdir(data_dir) if f.endswith(".npz")])
    root = tree["root"]
    base = ["--data_dir", data_dir, "--transformer_path", str(tree["dirs"]["dit"]),
            "--steps", str(PROBE_SCRIPT_STEPS)]
    blocks = [str(b) for b in PROBE_BLOCKS]
    timesteps = [str(t) for t in PROBE_TIMESTEPS]
    runs = {
        "direct": (["--blocks", *blocks], [f"block{b}" for b in blocks],
                   len(blocks) * samples),
        "collect": (["--collect_dir", str(root / "probe_features"), "--timesteps", *timesteps,
                     "--motion_filter"], [f"t{t}_block{b}" for t in timesteps for b in blocks],
                    len(timesteps) * samples),
    }
    for label, (extra, tags, forwards) in runs.items():
        out = root / f"probe_out_{label}"
        for kern in _kernel_counters():
            kern.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        results = probe_depth.main(base + extra + ["--output_dir", str(out)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = _launch_counts()
        losses = {t: [round(r["first_loss"], 5), round(r["last_loss"], 5)]
                  for t, r in results.items()}
        log(f"script probe_depth ({label}): python -m trajectorycrafter_tpu_torch.scripts."
            f"probe_depth {' '.join(extra)} on the tree: {seconds:.2f} s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
            f"{json.dumps({k: v for k, v in got.items() if v})}; losses {json.dumps(losses)}")
        want = _denoise_launches(cut, "flash_attention", forwards)
        if got != want:
            raise AssertionError(f"probe_depth ({label}): launches {got}, expected {want}")
        written = sorted(os.listdir(out))
        if written != sorted(f"probe_{t}.safetensors" for t in tags) or sorted(results) != \
                sorted(tags):
            raise AssertionError(f"probe_depth ({label}): wrote {written}, trained {results}")
        bad = {t: r for t, r in results.items() if not (
            np.isfinite([r["first_loss"], r["last_loss"], r["relative_depth_error"]]).all()
            and r["last_loss"] < r["first_loss"])}
        if bad:
            raise AssertionError(f"probe_depth ({label}): probes {bad}")
    shutil.rmtree(root / "probe_features")


def phase_quality_cli() -> None:
    """``python -m trajectorycrafter_tpu_torch.utils.quality`` three times, in
    parallel: run C's video against itself, run C against run D (the same
    input and seed), run A (49 frames) against run C (``CUT_FRAMES``)."""
    gen = {run: str(QUALITY_DIR / f"gen_{run}.mp4") for run in "ACD"}
    calls = {"C vs C": (gen["C"], gen["C"]), "C vs D": (gen["C"], gen["D"]),
             "A vs C": (gen["A"], gen["C"])}

    def run(pair):
        return subprocess.run([sys.executable, "-m", "trajectorycrafter_tpu_torch.utils.quality",
                               *pair], cwd=REPO, capture_output=True, text=True, timeout=120)

    with ThreadPoolExecutor(len(calls)) as pool:
        procs = dict(zip(calls, pool.map(run, calls.values())))
    out = {}
    for label, proc in procs.items():
        lines = proc.stdout.strip().splitlines()
        if not lines:
            raise AssertionError(f"quality CLI {label}: rc {proc.returncode}, no output; "
                                 f"{proc.stderr[-2000:]}")
        out[label] = json.loads(lines[-1])
        log(f"quality CLI {label}: rc {proc.returncode}, {json.dumps(out[label])}")
        if proc.returncode != (0 if out[label]["pass"] else 1):
            raise AssertionError(f"quality CLI {label}: rc {proc.returncode} against pass "
                                 f"{out[label]['pass']}")
    if procs["C vs C"].returncode != 0 or out["C vs C"]["psnr_db"] != 99.0:
        raise AssertionError(f"quality CLI C vs C: {out['C vs C']}")
    if procs["A vs C"].returncode != 1 or out["A vs C"] != {
            "pass": False, "error": "frame count mismatch", "frames_a": 49,
            "frames_b": CUT_FRAMES}:
        raise AssertionError(f"quality CLI A vs C: {out['A vs C']}")


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


def _sharded_launches_per_forward(dit) -> dict:
    """Kernel launches of one forward of a sharded DiT on one rank, from its
    modules: K5 once per block and visiting shard (sp of them, each rank's
    shard holding tokens), K1 once per Perceiver, K2a once per column-parallel
    int8 layer, its scale-taking entry once per row-parallel one, K2b once
    per int8 layer."""
    from trajectorycrafter_tpu_torch.ops.int8 import Int8Linear, Int8RowParallelLinear

    sp = dit.mesh.sp.size
    rows = sum(isinstance(m, Int8RowParallelLinear) for m in dit.modules())
    cols = sum(isinstance(m, Int8Linear) for m in dit.modules()) - rows
    out = {name: 0 for name in KERNELS}
    out.update({"flash_lse": len(dit.transformer_blocks) * sp,
                "flash_attention": len(dit.perceiver_cross_attention),
                "int8_quantize_rows": cols, "int8_quantize_rows_scaled": rows,
                "int8_gemm": cols + rows})
    return out


def cut_to_check_layers(dit) -> None:
    """Cut a DiT (whole or a shard) to its first RUN_S_CHECK_LAYERS blocks
    and their Perceivers, for run S's check of the check."""
    dit.transformer_blocks = dit.transformer_blocks[:RUN_S_CHECK_LAYERS]
    dit.perceiver_cross_attention = dit.perceiver_cross_attention[
        :RUN_S_CHECK_LAYERS // PERCEIVER_INTERVAL]


def check_weights_(model):
    """The check weights of run S's checks of the check, in place: every
    LayerNorm and GroupNorm weight 1 and every bias 0, as a trained model
    starts, the other weights the run's.  The same on a shard and on the
    whole DiT, on the VAE and on its sharded twin (which shares its
    weights)."""
    import torch
    from torch import nn

    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
        for m in model.modules():
            if isinstance(m, (nn.LayerNorm, nn.GroupNorm)) and m.weight is not None:
                m.weight.fill_(1.0)
    return model


def _joint_attention_hook(into: list, mesh=None):
    """A forward hook on a block's ``attn1`` that appends its joint [text;
    video] output, gathered over sp and dp where ``mesh`` shards it."""
    import torch

    from trajectorycrafter_tpu_torch.parallel import distributed as D

    def hook(module, args, output):
        video, text = output
        seq = args[3] if len(args) > 3 else None
        if seq is not None:
            video = seq.gather_video(video)
            text = D.all_gather(text, seq.axis, dim=1,
                                sizes=[n - v for n, v in zip(seq.sizes, seq.video_sizes)])
        joint = torch.cat([text, video], dim=1)
        into.append(joint if mesh is None else D.all_gather(joint, mesh.dp, dim=0))

    return hook


@contextlib.contextmanager
def _planted(name):
    """One of ``RUN_S_FAULTS`` (None: none) planted in this rank's modules
    while the block runs (every rank plants the same one, so the
    collectives still pair up)."""
    import torch

    from trajectorycrafter_tpu_torch.ops import ring_attention as ring
    from trajectorycrafter_tpu_torch.parallel import distributed as D

    if name is None:
        yield
        return
    sum_partials = D.sum_partials
    if name == RUN_S_FAULTS[0][0]:
        where, attr, fake = ring, "_combine", lambda o1, lse1, o2, lse2: (o1, lse1)
    else:
        where, attr = D, "sum_partials"
        fake = lambda p, axis, bias=None: sum_partials(
            torch.zeros_like(p) if axis.index == axis.size - 1 else p, axis, bias)
    real = getattr(where, attr)
    setattr(where, attr, fake)
    try:
        yield
    finally:
        setattr(where, attr, real)


@contextlib.contextmanager
def _planted_vae(name):
    """One of ``RUN_S_VAE_FAULTS`` (None: none) planted in this rank's
    spatial toolbox: every halo zero (each slab padded as if its edges were
    the picture's), or every GroupNorm on its slab's own statistics."""
    import torch.nn.functional as F

    from trajectorycrafter_tpu_torch.parallel import spatial

    if name is None:
        yield
        return
    if name == RUN_S_VAE_FAULTS[0]:
        attr, fake = "halo", lambda x, plane, t, b, l, r: F.pad(x, (l, r, t, b))
    else:
        attr = "group_norm"
        fake = lambda norm, x, plane: F.group_norm(x.float(), norm.num_groups,
                                                   norm.weight.float(), norm.bias.float(),
                                                   norm.eps).to(x.dtype)
    real = getattr(spatial, attr)
    setattr(spatial, attr, fake)
    try:
        yield
    finally:
        setattr(spatial, attr, real)


def _seam_errors(got, want, shape, scale) -> dict:
    """Relative L2 error of channel-last (B, T, H, W, C) ``got`` against
    ``want``, over the whole tensor and on the seam band of a dp x sp split
    ``shape`` in latents of ``scale`` pixels."""
    from trajectorycrafter_tpu_torch.parallel.sharding import shard_sizes
    from trajectorycrafter_tpu_torch.parallel.spatial import seam_band

    h, w = want.shape[2:4]
    rows = seam_band(h, shard_sizes(h // scale, shape[0]), scale, scale)
    cols = seam_band(w, shard_sizes(w // scale, shape[1]), scale, scale)
    band = (rows[:, None] | cols[None, :]).to(want.device)
    err = got.float() - want.float()
    return {"rel_l2": (err.norm() / want.float().norm()).item(),
            "band_rel_l2": (err[:, :, band].norm() / want.float()[:, :, band].norm()).item()}


def _sharded_stage_checks(tc, seen: dict) -> dict:
    """Run S's sharded warp and VAE against the unsharded ones on the run's
    inputs (``seen``: the warp's arguments and outputs; the condition
    prep's arguments, its generator's state before it drew and its outputs;
    the decode's latents and frames).  Every rank takes part; the leader
    computes the unsharded twins and returns the readings (the others only
    their slabs)."""
    import dataclasses

    import torch

    from trajectorycrafter_tpu_torch.models.vae import (
        decode_memory_bytes,
        posterior_mode,
        vae_decode_auto,
        vae_encode,
    )
    from trajectorycrafter_tpu_torch.ops.splat import forward_warp_batch
    from trajectorycrafter_tpu_torch.parallel import distributed as D
    from trajectorycrafter_tpu_torch.parallel import spatial
    from trajectorycrafter_tpu_torch.parallel.mesh import make_mesh

    pipe, mesh = tc.models.pipeline, tc.mesh
    lead, out = mesh.leader, {}
    args, kwargs, got = seen.pop("warp")
    if lead:
        want = forward_warp_batch(*args, **dict(kwargs, mesh=None))
        known, known_want = got[1] > 0, want[1] > 0
        both = known & known_want
        off = ((got[0] - want[0]).abs().amax(-1) > 1e-3) | ((got[2] - want[2]).abs() > 1e-3)
        out["warp"] = {"mask_disagree": (known != known_want).float().mean().item(),
                       "off": off[both].float().mean().item(),
                       "known": both.float().mean().item()}
        del want
    del args, kwargs, got
    (video, mask, ref, gen, aug), gen_state, run_conditions = seen.pop("conditions")
    z, run_frames = seen.pop("decode")
    h, w = video.shape[2:4]
    memory = decode_memory_bytes(pipe.device)

    def replayed():  # the run's generator as it stood before the condition prep drew
        g = torch.Generator(device=gen.device)
        g.set_state(gen_state)
        return g

    def outputs(p, vae):
        inpaint, ref_latents = p.prepare_conditions(video, mask, ref, replayed(), aug)
        return {"inpaint latents": inpaint, "reference latents": ref_latents,
                "frames": vae_decode_auto(vae, z, memory)}

    second = make_mesh(*RUN_S_VAE_MESH, device=pipe.device)
    twin = dataclasses.replace(pipe, mesh=second, spatial_vae=spatial.shard_spatially(
        pipe.vae, spatial.Plane.of(second)))
    plain = dataclasses.replace(pipe, mesh=None, spatial_vae=None)
    slabs = {}
    for shape, p in ((RUN_S_MESH, pipe), (RUN_S_VAE_MESH, twin)):
        plane = p.spatial_vae.plane
        rows, cols = plane.extents(h // 8, w // 8)
        slabs[str(shape)] = [rows[plane.rows.index], cols[plane.cols.index]]
    readings = {}

    def read(key, got, want, shape):
        if lead:
            readings[key] = {name: _seam_errors(got[name], want[name], shape,
                                                8 if name == "frames" else 1) for name in got}

    # the run's weights, bf16: the run's own sharded outputs (the run's mesh)
    want = outputs(plain, pipe.vae) if lead else None
    read(f"run {RUN_S_MESH} sound", {"inpaint latents": run_conditions[0],
                                     "reference latents": run_conditions[1],
                                     "frames": run_frames}, want, RUN_S_MESH)
    del want, run_conditions, run_frames
    # the check of the check: check weights, fp32 without TF32, the encode
    # of the run's rendered video's first chunk and the decode of the
    # unsharded encode's latents
    check_weights_(pipe.vae).float()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        crop_h, crop_w = RUN_S_VAE_CHECK_CROP
        x = video[:, :RUN_S_VAE_CHECK_FRAMES, :crop_h, :crop_w].float() * 2.0 - 1.0
        lc = pipe.vae.latent_channels
        want = None
        if lead:
            want = {"latents": vae_encode(pipe.vae, x)}
            zc = posterior_mode(want["latents"], lc)
        zc = D.broadcast(zc if lead else torch.empty(
            (1, (x.shape[1] - 1) // 4 + 1, x.shape[2] // 8, x.shape[3] // 8, lc),
            device=pipe.device),
            mesh.world)
        if lead:
            want["frames"] = vae_decode_auto(pipe.vae, zc, memory)
        for fault in (None,) + RUN_S_VAE_FAULTS:
            with _planted_vae(fault):
                got = {"latents": vae_encode(twin.spatial_vae, x),
                       "frames": vae_decode_auto(twin.spatial_vae, zc, memory)}
            read(f"check {RUN_S_VAE_MESH} {fault or 'sound'}", got, want, RUN_S_VAE_MESH)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.synchronize()
    return {"latent_slab": slabs, **({"vae": readings, **out} if lead else {})}


@contextlib.contextmanager
def _planted_depth(name):
    """One of ``RUN_S_DEPTH_FAULTS`` (None: none) planted in this rank's
    depth partition (parallel/frames.py): every row or frame halo zero (each
    slab padded as if its edges were the picture's or the clip's), every
    GroupNorm on its slab's statistics, the temporal transformers' frame ids
    counted from the slab's first frame, the self-attention's keys and
    values left the rank's own."""
    import torch
    import torch.nn.functional as F

    from trajectorycrafter_tpu_torch.models.depthcrafter import group_norm_cl
    from trajectorycrafter_tpu_torch.parallel import frames

    if name is None:
        yield
        return
    where, attr, fake = {
        "zero row halo": (frames, "row_halo",
                          lambda x, slab, above, below: F.pad(x, (0, 0, 0, 0, above, below))),
        "zero frame halo": (frames, "frame_halo", lambda x, slab, before, after: F.pad(
            x, (0, 0, 0, 0, 0, 0, before, after))),
        "local norm": (frames, "group_norm", lambda norm, x, axis: group_norm_cl(norm, x)),
        "local frame ids": (frames.Slab, "frame_ids", lambda slab, device: torch.arange(
            slab.num_frames, dtype=torch.float32, device=device)),
        "K/V ungathered": (frames, "gather_kv", lambda kv, axis, sizes: kv),
    }[name]
    real = getattr(where, attr)
    setattr(where, attr, fake)
    try:
        yield
    finally:
        setattr(where, attr, real)


def _depth_kernel_attentions(unet, h: int, w: int) -> int:
    """The UNet's attentions that launch a kernel per forward at ``h`` x
    ``w`` latents, from its modules: the spatial self-attention of each
    transformer at a level whose whole frame has s * s >= 2^20 scores (a
    sharded twin routes on the whole frame, so a rank launches as many).
    Level i of the down path, the bottom level of the mid block, level n - 1
    - i of the up path."""
    from trajectorycrafter_tpu_torch.models.depthcrafter import DEPTH_KERNEL_MIN_SCORES

    n = len(unet.down_blocks)
    levels = ([(lvl, i) for i, lvl in enumerate(unet.down_blocks)] + [(unet.mid_block, n - 1)]
              + [(lvl, n - 1 - i) for i, lvl in enumerate(unet.up_blocks)])
    return sum(len(level.attentions) for level, k in levels
               if ((h >> k) * (w >> k)) ** 2 >= DEPTH_KERNEL_MIN_SCORES)


def _depth_checksum(pipe) -> list:
    """A checksum of the depth stage's models' bits (UNet, SVD VAE, CLIP):
    one per model, from ``bits_checksum`` of each parameter and buffer."""
    return [[list(bits_checksum(t)[2:]) for t in (*m.parameters(), *m.buffers())]
            for m in (pipe.unet, pipe.vae, pipe.image_encoder)]


def _depth_errors(got, want, shape, frame_dim: int, row_dim: int, scale: int) -> dict:
    """Relative L2 error of ``got`` against ``want`` over the whole tensor
    and on the seam band of the depth partition of a dp x sp ``shape``
    (frames at ``frame_dim``, rows of ``scale`` per latent row at
    ``row_dim``): the rows within RUN_S_DEPTH_BAND_ROWS latent rows of a row
    seam, the frames within RUN_S_DEPTH_BAND_FRAMES of a frame seam."""
    import torch

    from trajectorycrafter_tpu_torch.parallel.frames import ROW_BLOCK
    from trajectorycrafter_tpu_torch.parallel.sharding import shard_sizes
    from trajectorycrafter_tpu_torch.parallel.spatial import seam_band

    got = torch.as_tensor(got).float()
    want = torch.as_tensor(want).float().to(got.device)
    f, h = want.shape[frame_dim], want.shape[row_dim]
    rows = [b * ROW_BLOCK for b in shard_sizes(h // scale // ROW_BLOCK, shape[1])]
    band = (seam_band(f, shard_sizes(f, shape[0]), 1, RUN_S_DEPTH_BAND_FRAMES)[:, None]
            | seam_band(h, rows, scale, RUN_S_DEPTH_BAND_ROWS * scale)[None, :])
    view = [f if d == frame_dim else h if d == row_dim else 1 for d in range(want.dim())]
    band = band.reshape(view).expand(want.shape).to(want.device)
    err = got - want
    return {"rel_l2": (err.norm() / want.norm()).item(),
            "band_rel_l2": (err[band].norm() / want[band].norm()).item(),
            "band_share": band.float().mean().item()}


def _first_forward(unet, call):
    """Run ``call()`` with a hook on the sharded ``unet``'s forward: ->
    (call's result, the first forward's arguments and output, this rank's
    slabs)."""
    seen = []
    hook = unet.register_forward_hook(lambda m, args, out: seen.append((args, out)) if not seen
                                      else None)
    try:
        result = call()
    finally:
        hook.remove()
    return result, seen[0]


def _joined(unet, forward):
    """A ``_first_forward`` record of the sharded ``unet`` joined whole over
    the plane (every rank takes part): ((sample, timestep, embeddings,
    added ids), output)."""
    (sample, t, ehs, added, height), out = forward
    slab = unet.plane.layout(ehs.shape[1], height)
    return ((slab.join(sample.contiguous(), 1, 2), t, ehs, added),
            slab.join(out.contiguous(), 1, 2))


def _sharded_depth_checks(tc, seen: dict) -> dict:
    """Run S's sharded depth stage against the unsharded one on the run's
    frames and seed (``seen``: the stage's call, its raw disparity and its
    first UNet forward's slabs) under RUN_S_MESH, then the check of the
    check under RUN_S_VAE_MESH (see RUN_S_DEPTH_*).  Every
    rank takes part; the leader computes the unsharded twins and returns the
    readings (the others only their slabs)."""
    import dataclasses

    import torch

    from trajectorycrafter_tpu_torch.models.depthcrafter import UNetSpatioTemporalConditionModel
    from trajectorycrafter_tpu_torch.orchestrator import _on_device, depth_pipeline, random_init_
    from trajectorycrafter_tpu_torch.parallel.frames import FrameRows
    from trajectorycrafter_tpu_torch.parallel.mesh import make_mesh
    from trajectorycrafter_tpu_torch.parallel.spatial import shard_spatially

    lead = tc.mesh.leader
    pipe = depth_pipeline(tc.models.depth_infer)
    frames, (near, far, steps, guidance), kwargs = seen["call"]

    def stage(p):  # DepthCrafterDemo.infer's call of the pipeline: raw disparity
        gen = torch.Generator(device=p.device).manual_seed(42)
        return torch.from_numpy(p(frames, num_inference_steps=steps, guidance_scale=guidance,
                                  generator=gen, **kwargs)).to(p.device)

    second = make_mesh(*RUN_S_VAE_MESH, device=pipe.device)
    twin = dataclasses.replace(pipe, mesh=second, sharded_unet=shard_spatially(
        pipe.unet, FrameRows.of(second)))
    layouts = {shape: p.sharded_unet.plane.layout(frames.shape[0], frames.shape[1] // 8)
               for shape, p in ((RUN_S_MESH, pipe), (RUN_S_VAE_MESH, twin))}
    slabs = {str(shape): [l.num_frames, l.num_rows] for shape, l in layouts.items()}
    run_forward = _joined(pipe.sharded_unet, seen["forward"])
    readings = {}
    if lead:  # the unsharded stage and forward on the same inputs
        plain = dataclasses.replace(pipe, mesh=None, sharded_unet=None)
        want_raw = stage(plain)
        (x, t, ehs, added), out = run_forward
        with torch.no_grad():
            want = pipe.unet(x, t, ehs, added)
        readings[f"{RUN_S_MESH} sound"] = {
            "raw disparity": _depth_errors(seen["raw"], want_raw, RUN_S_MESH, 0, 1, 8),
            "first UNet forward": _depth_errors(out, want, RUN_S_MESH, 1, 2, 1)}
        del plain, want_raw, want, out
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # the check of the check: fp32 without TF32, check weights, a UNet cut to
    # one layer a block, the run's first input cropped
    (x, t, ehs, added), _ = run_forward
    rows, cols = RUN_S_DEPTH_CHECK_CROP
    x, ehs = x[:, :, :rows, :cols].float(), ehs.float()
    check = check_weights_(random_init_(_on_device(
        lambda: UNetSpatioTemporalConditionModel(**RUN_S_DEPTH_CHECK_UNET), pipe.device,
        torch.float32), 3))
    check_twin = shard_spatially(check, FrameRows.of(second))
    slab = check_twin.plane.layout(x.shape[1], rows)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            want = check(x, t, ehs, added) if lead else None
            for fault in (None,) + RUN_S_DEPTH_FAULTS:
                with _planted_depth(fault):
                    got = check_twin(slab.take(x, 1, 2).contiguous(), t, ehs, added, rows)
                got = slab.join(got.contiguous(), 1, 2)
                if lead:
                    readings[f"check {RUN_S_VAE_MESH} {fault or 'sound'}"] = {
                        "first UNet forward": _depth_errors(got, want, RUN_S_VAE_MESH, 1, 2, 1)}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    del check, check_twin, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"slab": slabs, **({"readings": readings} if lead else {})}


def run_s_rank(out_dir: str, cut: bool, t_dir=None, u_plan=None) -> None:
    """One rank of phase 5s's torchrun world (``chip_smoke.py --run-s-rank
    DIR [--cut] [--run-t T_DIR] [--run-u PLAN]``): run S (``_run_s``), then,
    with ``t_dir`` (phase 5e's samples and twin), run T (``run_t_rank``)
    once run S's models are freed, then, with ``u_plan`` (phase 8's scripts
    on the tree), run U (``run_u_rank``)."""
    import torch

    from trajectorycrafter_tpu_torch.parallel import distributed as D

    def freed():
        gc.collect()
        torch.cuda.empty_cache()
        D.barrier(D.world_axis())

    try:
        _run_s(out_dir, cut)
        if t_dir is not None:
            freed()
            run_t_rank(out_dir, t_dir)
        if u_plan is not None:
            freed()
            run_u_rank(out_dir, u_plan)
    finally:
        D.shutdown()


def _run_s(out_dir: str, cut: bool) -> None:
    """One rank of run S: the process group from torchrun's environment through the CLI's
    ``start_world``; ``TrajCrafter`` on run A's command line with the mesh
    flags (this rank's DiT shard; the leader also the other models);
    ``infer_gradual`` with its launches counted in and outside the denoise,
    the latents' checksum after each step and its first DiT forward kept,
    the frames its warp splatted, its halo and norm bytes, its depth stage's
    call, raw disparity and first UNet forward kept; then that DiT forward
    again on the check weights, sound and with each planted fault; then
    the sharded warp and VAE against the unsharded ones on the run's
    inputs (``_sharded_stage_checks``), then the sharded depth stage
    (``_sharded_depth_checks``).  Writes its readings to
    DIR/rank<r>.json."""
    import traceback

    import numpy as np
    import torch

    os.chdir(REPO)
    sys.path.insert(0, str(REPO))
    from trajectorycrafter_tpu_torch import orchestrator
    from trajectorycrafter_tpu_torch.cli import get_parser, parse_config, start_world
    from trajectorycrafter_tpu_torch.ops import splat
    from trajectorycrafter_tpu_torch.orchestrator import TrajCrafter
    from trajectorycrafter_tpu_torch.parallel import distributed as D
    from trajectorycrafter_tpu_torch.pipelines import trajcrafter as tj
    from trajectorycrafter_tpu_torch.pipelines.depth import window_starts

    cuts = ["--video_length", str(CUT_FRAMES), "--depth_inference_steps", str(CUT_DEPTH_STEPS)]
    argv = MAIN_ARGV + RUN_S_ARGV + (cuts if cut else [])
    args, cfg = get_parser().parse_args(argv), parse_config(argv)
    rank = int(os.environ["RANK"])
    out = {"rank": rank}
    t0 = time.perf_counter()
    try:
        start_world(cfg, args.dist_backend)
        tc = TrajCrafter(cfg)
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        out["resident_gib"] = torch.cuda.memory_allocated() / 2**30
        mesh, pipe = tc.mesh, tc.models.pipeline
        dit = pipe.transformer
        out["coords"] = [mesh.dp.index, mesh.sp.index, mesh.tp.index]
        out["heads"] = [dit.transformer_blocks[0].attn1.heads,
                        dit.perceiver_cross_attention[0].heads]
        out["expected_per_forward"] = _sharded_launches_per_forward(dit)
        # the depth stage: every rank's models bit-equal, K4 once per kernel
        # attention of the sharded twin, UNet forward and window
        depth_pipe = orchestrator.depth_pipeline(tc.models.depth_infer)
        out["depth_checksum"] = _depth_checksum(depth_pipe)
        windows = len(window_starts(cfg.video_length, cfg.depth.window_size, cfg.depth.overlap))
        out["expected_depth"] = {**dict.fromkeys(KERNELS, 0), "flash_attention": (
            _depth_kernel_attentions(depth_pipe.sharded_unet, *(n // 8 for n in cfg.warp_size))
            * windows * cfg.depth.num_inference_steps)}
        counters = _kernel_counters()

        steps, seen = [], {}
        step, denoise = pipe.scheduler.step, pipe._denoise

        def recorded_step(*a, **kw):
            res = step(*a, **kw)
            steps.append(list(bits_checksum(res[0] if isinstance(res, tuple) else res)))
            return res

        def counted_denoise(*a, **kw):
            before = {kern.__name__: kern.launches for kern in counters}
            res = denoise(*a, **kw)
            seen["launches"] = {kern.__name__: kern.launches - before[kern.__name__]
                                for kern in counters}
            return res

        def first_forward(module, args, kwargs, output):
            # every rank keeps the denoise's first DiT call for the planted
            # faults; the leader saves its inputs and output for the main
            # process to run the unsharded DiT on
            if "first" in seen:
                return
            seen["first"] = (args, kwargs)
            if mesh.leader:
                move = lambda x: x.cpu() if torch.is_tensor(x) else x
                torch.save({"args": [move(a) for a in args],
                            "kwargs": {k: tuple(map(move, v)) if isinstance(v, tuple)
                                       else move(v) for k, v in kwargs.items()},
                            "output": output.cpu()}, Path(out_dir, "forward.pt"))

        # the sharded stages' inputs and outputs, for the checks after the run
        warp, bilinear, prepare, decode_auto = (orchestrator.forward_warp_batch,
                                                splat.bilinear_splat, pipe.prepare_conditions,
                                                tj.vae_decode_auto)
        splatted = []

        def recorded_warp(*a, **kw):
            res = warp(*a, **kw)
            seen["warp"] = (a, kw, res)
            return res

        def counted_splat(values, *a, **kw):
            splatted.append(values.shape[0])
            return bilinear(values, *a, **kw)

        def recorded_prepare(video, mask_video, reference, generator, aug, **kw):
            state = generator.get_state()
            res = prepare(video, mask_video, reference, generator, aug, **kw)
            seen["conditions"] = ((video, mask_video, reference, generator, aug), state, res)
            return res

        def recorded_decode(vae, z, memory):
            frames = decode_auto(vae, z, memory)
            seen["decode"] = (z, frames)
            return frames

        depth_seen = {}
        depth_call, decode_raw = tc.models.depth_infer, depth_pipe._decode_raw

        def recorded_depth(frames, *a, **kw):
            depth_seen["call"] = (frames, a, kw)
            return depth_call(frames, *a, **kw)

        def recorded_raw(latents):
            depth_seen["raw"] = decode_raw(latents)
            return depth_seen["raw"]

        orchestrator.forward_warp_batch, splat.bilinear_splat = recorded_warp, counted_splat
        pipe.prepare_conditions, tj.vae_decode_auto = recorded_prepare, recorded_decode
        pipe.scheduler.step, pipe._denoise = recorded_step, counted_denoise
        tc.models.depth_infer, depth_pipe._decode_raw = recorded_depth, recorded_raw
        hook = dit.register_forward_hook(first_forward, with_kwargs=True)
        for kern in counters:
            kern.launches = 0
        tc.timer.seconds.clear()
        torch.cuda.reset_peak_memory_stats()
        t2 = time.perf_counter()
        # the depth stage's first UNet forward, for the checks after the run
        gen, depth_seen["forward"] = _first_forward(depth_pipe.sharded_unet, tc.infer_gradual)
        torch.cuda.synchronize()
        out["run_s"] = time.perf_counter() - t2
        tc.models.depth_infer = depth_call
        del depth_pipe._decode_raw
        if mesh.leader:  # the decode's latents, for run U's sharded strip decode
            torch.save(seen["decode"][0].cpu(), Path(out_dir, "run_s_decode_latents.pt"))
        # the planes decode apart: let every rank end its decode and give
        # back its cached blocks before the checks (the ranks share the card)
        D.all_reduce(torch.zeros(1, device=pipe.device), mesh.world)
        torch.cuda.empty_cache()
        orchestrator.forward_warp_batch, splat.bilinear_splat = warp, bilinear
        tj.vae_decode_auto = decode_auto
        del pipe.prepare_conditions
        out["warp_frames"] = splatted
        total = {kern.__name__: kern.launches for kern in counters}
        denoised = seen["launches"]
        out["per_path"] = {"depth": {n: total[n] - denoised[n] for n in total},
                           "denoise": denoised}
        out.update(steps=steps, stages=dict(tc.timer.seconds), transport=dict(D.TRANSPORT),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   reserved_gib=torch.cuda.max_memory_reserved() / 2**30)
        hook.remove()
        t3 = time.perf_counter()
        args_, kwargs_ = seen.pop("first")
        cut_to_check_layers(dit)
        check_weights_(dit)
        caught = []
        for i in RUN_S_CHECK_BLOCKS:
            dit.transformer_blocks[i].attn1.register_forward_hook(
                _joint_attention_hook(caught, mesh))
        for i, name in enumerate([None] + [n for n, _ in RUN_S_FAULTS]):
            caught.clear()
            with _planted(name), torch.no_grad():
                y = dit(*args_, **kwargs_)
            if mesh.leader:
                torch.save({"name": name, "output": y.cpu(),
                            "attention": [a.cpu() for a in caught]},
                           Path(out_dir, f"check{i}.pt"))
            del y
        torch.cuda.synchronize()
        out["faults_s"] = time.perf_counter() - t3
        D.all_reduce(torch.zeros(1, device=pipe.device), mesh.world)
        torch.cuda.empty_cache()
        t4 = time.perf_counter()
        out["stage_checks"] = _sharded_stage_checks(tc, seen)
        out["stage_checks_s"] = time.perf_counter() - t4
        D.all_reduce(torch.zeros(1, device=pipe.device), mesh.world)
        torch.cuda.empty_cache()
        t5 = time.perf_counter()
        out["depth_checks"] = _sharded_depth_checks(tc, depth_seen)
        out["depth_checks_s"] = time.perf_counter() - t5
        if gen is not None:
            out["gen"] = {"shape": list(gen.shape), "finite": bool(np.isfinite(gen).all()),
                          "min": float(gen.min()), "max": float(gen.max()),
                          "std": float(gen.std())}
    except BaseException:
        out["error"] = traceback.format_exc() + (
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated, "
            f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved")
        raise
    finally:
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))


def _torchrun(rank_args: list, n: int = 4) -> tuple:
    """``chip_smoke.py <rank_args>`` as ``n`` ranks on the one card, started
    by torchrun: (their output, torchrun's return code, its wall seconds).
    Killed at RUN_S_TIMEOUT."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(n), str(REPO / "chip_smoke.py"), *rank_args]
    t0 = time.perf_counter()
    # the ranks share the card: expandable segments keep each rank's cached
    # blocks close to what it holds
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True, env=env)
    try:
        text, _ = proc.communicate(timeout=RUN_S_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"torchrun {' '.join(rank_args)} did not end within "
                             f"{RUN_S_TIMEOUT} s")
    return text, proc.returncode, time.perf_counter() - t0


def phase_sharded(runs: dict, cut: bool = True, t_dir=None, tree=None) -> dict:
    """Run S: the four ranks started by torchrun, then their readings held to
    the checks stated at RUN_S_MESH, against run A9 (``cut``, the smoke's)
    or run A; ``runs["S"]`` gets its launches.  With ``t_dir`` (phase 5e's
    samples and twin) the same ranks then run run T, whose readings are held
    to the checks stated at RUN_T_MESH; ``runs["T"]`` gets its launches.
    With ``tree`` (phase 8's, its scripts run) the same ranks then run run
    U, whose readings are held to the checks stated at RUN_U_ARGV;
    ``runs["U"]`` gets its launches."""
    n = RUN_S_MESH[0] * RUN_S_MESH[1] * RUN_S_MESH[2]
    twin, frames = ("A9", CUT_FRAMES) if cut else ("A", 49)
    out_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_run_s_"))
    u_plan = None
    if tree is not None:
        u_plan = out_dir / "run_u_plan.json"
        u_plan.write_text(json.dumps({
            "scripts": {name: script_argv(tree, name) + RUN_U_ARGV for name in SCRIPT_RUNS},
            "out": str(REPO / MAIN_ARGV[MAIN_ARGV.index("--out_dir") + 1] / "run_u")}))
    cmd = ["--run-s-rank", str(out_dir), *(["--cut"] if cut else []),
           *(["--run-t", str(t_dir)] if t_dir else []),
           *(["--run-u", str(u_plan)] if u_plan else [])]
    log(f"run S{' and run T' if t_dir else ''}{' and run U' if u_plan else ''}: {n} ranks on "
        f"one card, torchrun chip_smoke.py {' '.join(cmd)}")
    text, returncode, seconds = _torchrun(cmd)
    read = lambda name: [json.loads(p.read_text()) if p.is_file() else {"error": "no readings"}
                         for p in (out_dir / f"{name}{r}.json" for r in range(n))]
    results = read("rank")
    results_t = read("run_t_rank") if t_dir else []
    results_u = read("run_u_rank") if u_plan else []
    failed = {f"{run} {r.get('rank', i)}": r["error"]
              for run, rs in (("S", results), ("T", results_t), ("U", results_u))
              for i, r in enumerate(rs) if "error" in r}
    if returncode or failed:
        for line in text.splitlines()[-60:]:
            log("  run S | " + line)
        for rank, error in failed.items():  # a rank's own error, before its peers' hang-ups
            log(f"  run {rank} | " + " ".join(error.strip().splitlines()[-2:])[:2000])
        raise AssertionError(f"run S / T / U: torchrun rc {returncode}; failed ranks "
                             f"{json.dumps(failed)[-4000:]}")
    lead = results[0]
    log(f"run S: {seconds:.1f} s wall for torchrun (not a speed figure: {n} ranks time-share "
        f"one card and stage their hops through host memory)")
    forwards = int(MAIN_ARGV[MAIN_ARGV.index("--diffusion_inference_steps") + 1])  # DDIM
    for r in results:
        want = r["expected_per_forward"]
        if (want["flash_lse"], want["flash_attention"]) != (DIT_LAYERS * RUN_S_MESH[1],
                                                            DIT_LAYERS // PERCEIVER_INTERVAL):
            raise AssertionError(f"rank {r['rank']}: derived launches {want}")
        if r["per_path"]["denoise"] != {k: forwards * v for k, v in want.items()}:
            raise AssertionError(f"rank {r['rank']}: denoise launches "
                                 f"{r['per_path']['denoise']}, expected {forwards} x {want}")
        # every rank runs its share of the depth stage: as many launches as
        # the unsharded stage of run A9 / A (its query rows, every layer)
        depth = r["expected_depth"]
        if r["per_path"]["depth"] != depth or depth != runs[twin]["per_path"]["depth"]:
            raise AssertionError(f"rank {r['rank']}: launches outside the denoise "
                                 f"{r['per_path']['depth']}, expected {depth} (run {twin}: "
                                 f"{runs[twin]['per_path']['depth']})")
        if r["depth_checksum"] != lead["depth_checksum"]:
            raise AssertionError(f"rank {r['rank']}: the depth models' bits differ from rank 0's")
        if r["steps"] != lead["steps"] or len(r["steps"]) != forwards:
            raise AssertionError(f"rank {r['rank']}: latents differ from rank 0's "
                                 f"(steps {r['steps']} vs {lead['steps']})")
        log(f"  rank {r['rank']} (dp, sp, tp) {tuple(r['coords'])}, heads {r['heads']}: built in "
            f"{r['build_s']:.1f} s, {r['resident_gib']:.2f} GiB resident, peak "
            f"{r['peak_gib']:.2f} GiB ({r['reserved_gib']:.2f} reserved); infer_gradual {r['run_s']:.2f} s, check of the check {r['faults_s']:.2f} s, stages "
            f"{json.dumps({k: round(v, 3) for k, v in r['stages'].items()})}; launches a "
            f"forward {json.dumps({k: v for k, v in want.items() if v})}; transport "
            f"{json.dumps(r['transport'])}")
    stages = _run_s_stage_check(results, frames)
    depth = _run_s_depth_check(results)
    t3_reference = {}
    forward = _run_s_forward_check(out_dir, t3_reference if t_dir else None)
    if t_dir:
        runs["T"] = _run_t_check(out_dir, Path(t_dir), results_t, t3_reference)
    del t3_reference
    run_u = _run_u_check(results_u, json.loads(u_plan.read_text()), runs) if u_plan else None
    shutil.rmtree(out_dir, ignore_errors=True)
    log(f"run S: every rank's latents bit-equal after each of {forwards} steps; peaks summed "
        f"{sum(r['peak_gib'] for r in results):.2f} GiB")
    gen = lead["gen"]
    if not (gen["finite"] and gen["shape"] == [frames, 384, 672, 3] and 0.0 <= gen["min"]
            and gen["max"] <= 1.0 and gen["std"] > 0.0):
        raise AssertionError(f"run S's video: {gen}")
    save_dir = REPO / MAIN_ARGV[MAIN_ARGV.index("--out_dir") + 1] / "smoke_S"
    if mp4_frame_counts(save_dir) != save_scheme_counts(frames):
        raise AssertionError(f"run S's mp4s: {mp4_frame_counts(save_dir)}")
    proc = subprocess.run([sys.executable, "-m", "trajectorycrafter_tpu_torch.utils.quality",
                           str(QUALITY_DIR / f"gen_{twin}.mp4"), str(save_dir / "gen.mp4")],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    lines = proc.stdout.strip().splitlines()
    quality = json.loads(lines[-1]) if lines else {"pass": False, "error": proc.stderr[-2000:]}
    log(f"run S's video ({frames} frames) against run {twin}'s (quality CLI, 35 dB gate): rc "
        f"{proc.returncode}, {json.dumps(quality)}")
    if proc.returncode != 0 or not quality.get("pass"):
        raise AssertionError(f"run S's video against run {twin}'s: {quality}")
    runs["S"] = {"per_path": {p: {k: sum(r["per_path"][p][k] for r in results) for k in KERNELS}
                              for p in ("depth", "denoise")},
                 "per_rank": {k: [sum(r["per_path"][p][k] for p in ("depth", "denoise"))
                                  for r in results] for k in KERNELS},
                 "depth_per_rank": {k: [r["per_path"]["depth"][k] for r in results]
                                    for k in KERNELS}}
    return {"seconds": seconds, "quality": quality, "forward": forward, "stages": stages,
            "depth": depth, "ranks": results, "run_u": run_u}


def _run_s_depth_check(results: list) -> dict:
    """Run S's sharded depth stage: each rank's seconds, slabs and
    collectives logged; the leader's readings of the run's raw disparity
    and first UNet forward against the unsharded ones held to
    RUN_S_DEPTH_REL_TOL, and each planted fault of the check of the check
    to RUN_S_VAE_FAULT_RATIO times the sound reading on the seam band."""
    names = ("depth_halo", "depth_norm", "depth_kv", "depth_frames", "depth_latents")
    tensors = sum(map(len, results[0]["depth_checksum"]))
    log(f"run S: the depth models' bits equal on every rank ({tensors} tensors of the UNet, "
        f"the SVD VAE and CLIP)")
    for r in results:
        t = r["transport"]
        moved = ", ".join(f"{n} {t.get(f'{n} direct', 0)} x "
                          f"{t.get(f'{n} direct bytes', 0) / 1e6:.2f} MB" for n in names)
        log(f"  rank {r['rank']}: depth {r['stages']['depth']:.3f} s, slab (frames, latent "
            f"rows) by mesh {r['depth_checks']['slab']}, K4 launches "
            f"{r['per_path']['depth']['flash_attention']}; {moved}; checks "
            f"{r['depth_checks_s']:.1f} s")
        if not all(t.get(f"{n} direct bytes", 0) > 0 for n in names):
            raise AssertionError(f"rank {r['rank']}: a depth collective is missing in run S: {t}")
    readings = results[0]["depth_checks"]["readings"]
    for key, reading in readings.items():
        log(f"run S's depth stage, {key}: " + "; ".join(
            f"{name} rel L2 {e['rel_l2']:.3e}, seam band {e['band_rel_l2']:.3e} "
            f"({e['band_share']:.2f} of the elements)" for name, e in reading.items()))
    failed = [f"{RUN_S_MESH} sound"] if any(
        max(e["rel_l2"], e["band_rel_l2"]) > RUN_S_DEPTH_REL_TOL
        for e in readings[f"{RUN_S_MESH} sound"].values()) else []
    sound = readings[f"check {RUN_S_VAE_MESH} sound"]["first UNet forward"]["band_rel_l2"]
    for fault in RUN_S_DEPTH_FAULTS:
        wrong = readings[f"check {RUN_S_VAE_MESH} {fault}"]["first UNet forward"]["band_rel_l2"]
        ratio = wrong / max(sound, 1e-12)
        log(f"run S's depth stage, check weights, {RUN_S_VAE_MESH} {fault}: {ratio:.1f}x the "
            f"sound reading on the seam band (limit {RUN_S_VAE_FAULT_RATIO:g}x)")
        if ratio < RUN_S_VAE_FAULT_RATIO:
            failed.append(f"{RUN_S_VAE_MESH} {fault}")
    if failed:
        raise AssertionError(f"run S's sharded depth stage: {failed} outside their limits "
                             f"(rel L2 {RUN_S_DEPTH_REL_TOL:g}): {json.dumps(readings)}")
    return readings


def _run_s_stage_check(results: list, frames: int) -> dict:
    """Run S's sharded warp and VAE: each rank's share of the frames, its
    slabs and its halo and norm bytes logged and held to the mesh's layout;
    the leader's readings of the sharded warp and VAE against the unsharded
    ones held to their limits (RUN_S_WARP_*, RUN_S_VAE_*)."""
    from trajectorycrafter_tpu_torch.parallel.sharding import shard_sizes

    n = len(results)
    shares = shard_sizes(frames, n)
    for r, share in zip(results, shares):
        t = r["transport"]
        log(f"  rank {r['rank']}: warped {sum(r['warp_frames'])} of {frames} frames "
            f"{r['warp_frames']}, latent slab (rows, columns) by mesh "
            f"{r['stage_checks']['latent_slab']}; halo {t.get('halo direct', 0)} all_gathers "
            f"{t.get('halo direct bytes', 0) / 1e6:.1f} MB, norm {t.get('norm direct', 0)} "
            f"all_reduces {t.get('norm direct bytes', 0) / 1e3:.1f} kB, slabs "
            f"{t.get('slabs direct bytes', 0) / 1e6:.1f} MB, warp "
            f"{t.get('warp direct bytes', 0) / 1e6:.1f} MB; checks {r['stage_checks_s']:.1f} s")
        if r["warp_frames"] != ([share] if share else []):
            raise AssertionError(f"rank {r['rank']} warped {r['warp_frames']} frames, its share "
                                 f"is {share} of {shares}")
        if not (t.get("halo direct bytes", 0) > 0 and t.get("norm direct bytes", 0) > 0):
            raise AssertionError(f"rank {r['rank']}: no halo or norm traffic in run S: {t}")
    checks = results[0]["stage_checks"]
    warp = checks["warp"]
    log(f"run S: the sharded warp against the unsharded on the same inputs: masks disagree on "
        f"{warp['mask_disagree']:.2e} of the pixels (limit {RUN_S_WARP_MASK_MAX}), "
        f"{warp['off']:.2e} of the {warp['known']:.3f} known ones part by > 1e-3 (limit "
        f"{RUN_S_WARP_OFF_MAX})")
    failed = []
    if warp["mask_disagree"] > RUN_S_WARP_MASK_MAX or warp["off"] > RUN_S_WARP_OFF_MAX:
        failed.append("warp")
    vae = checks["vae"]
    for key, reading in vae.items():
        log(f"run S's VAE, {key}: " + "; ".join(
            f"{name} rel L2 {e['rel_l2']:.3e}, seam band {e['band_rel_l2']:.3e}"
            for name, e in reading.items()))
    if any(max(e.values()) > RUN_S_VAE_REL_TOL for e in vae[f"run {RUN_S_MESH} sound"].values()):
        failed.append(f"run {RUN_S_MESH} sound")
    sound = vae[f"check {RUN_S_VAE_MESH} sound"]
    for fault in RUN_S_VAE_FAULTS:
        wrong = vae[f"check {RUN_S_VAE_MESH} {fault}"]
        ratio = min(wrong[name]["band_rel_l2"] / max(e["band_rel_l2"], 1e-12)
                    for name, e in sound.items())
        log(f"run S's VAE, check weights, {RUN_S_VAE_MESH} {fault}: {ratio:.1f}x the sound "
            f"reading on the seam band at the least (limit {RUN_S_VAE_FAULT_RATIO:g}x)")
        if ratio < RUN_S_VAE_FAULT_RATIO:
            failed.append(f"{RUN_S_VAE_MESH} {fault}")
    if failed:
        raise AssertionError(f"run S's sharded stages: {failed} outside their limits "
                             f"(VAE rel L2 {RUN_S_VAE_REL_TOL:g}): {json.dumps(checks)}")
    return checks


def _run_s_forward_check(out_dir: Path, t3_reference=None) -> dict:
    """Run S's first DiT forward (the leader's inputs and sharded output,
    saved by its hook) against the unsharded int8 DiT of the same weights
    (run A's, rebuilt here: this process holds no model by now) on the
    same inputs: relative L2 error and the largest row error (one
    position's channels) over the largest reference row.  Then the check of
    the check (``RUN_S_FAULTS``): on the check weights, the sound forward
    and each with a planted fault, at the joint attention output of
    ``RUN_S_CHECK_BLOCKS`` (and, reported, at the output), against the
    unsharded DiT on them.  ``t3_reference`` (a dict) gets run T3's
    reference: the sequential block loop of the same DiT on the same
    inputs, before the check weights."""
    import torch

    from trajectorycrafter_tpu_torch.orchestrator import build_dit, full_scale_dit

    args, kwargs, output = _saved_forward(out_dir)
    dit = build_dit(full_scale_dit, "cuda", torch.bfloat16, 1, "int8")
    rows = lambda x: x.reshape(-1, x.shape[-1]).norm(dim=1)

    def against(got, ref):
        y, ref = got.cuda().float(), ref.float()
        err = y - ref
        out = {"rel_l2": (err.norm() / ref.norm()).item(),
               "row_err": (rows(err).max() / rows(ref).max()).item(),
               "finite": bool(torch.isfinite(y).all()), "shape": list(y.shape)}
        out["within"] = (out["finite"] and out["rel_l2"] <= RUN_S_REL_L2
                         and out["row_err"] <= DIT_REL_TOL)
        return out

    with torch.no_grad():
        out = against(output, dit(*args, **kwargs))
        if t3_reference is not None:
            t3_reference["hidden"], t3_reference["encoder"] = dit.run_blocks(
                *_blocks_inputs(dit, args, kwargs))
        cut_to_check_layers(dit)
        check_weights_(dit)
        attention = []
        for i in RUN_S_CHECK_BLOCKS:
            dit.transformer_blocks[i].attn1.register_forward_hook(_joint_attention_hook(attention))
        ref = dit(*args, **kwargs)
    del dit, args, kwargs, output
    checks = {}
    for i, (name, wrong) in enumerate([("sound", False), *RUN_S_FAULTS]):
        got = torch.load(out_dir / f"check{i}.pt")
        if (got["name"] or "sound") != name:
            raise AssertionError(f"run S: check {i} is {got['name']!r}, expected {name!r}")
        checks[name] = {"wrong": wrong, "output": against(got["output"], ref)}
        for block, a, want in zip(RUN_S_CHECK_BLOCKS, got["attention"], attention):
            checks[name][f"attention {block}"] = against(a, want)
        del got
    del ref, attention
    gc.collect()
    torch.cuda.empty_cache()
    if not out["within"]:
        raise AssertionError(f"run S's sharded forward against the unsharded: {out} (limits "
                             f"rel L2 {RUN_S_REL_L2:.3e}, row {DIT_REL_TOL:.3e})")
    gated = lambda check: [check[f"attention {block}"] for block in RUN_S_CHECK_BLOCKS]
    log(f"run S: its first sharded DiT forward {tuple(out['shape'])} against the unsharded "
        f"int8 DiT on the same inputs: rel L2 {out['rel_l2']:.3e} (limit {RUN_S_REL_L2:.3e}), "
        f"largest row error {out['row_err']:.3e} of the largest row (limit {DIT_REL_TOL:.3e})")
    for name, check in checks.items():
        log(f"run S, check weights, {name} ({'wrong' if check['wrong'] else 'not wrong'}): " +
            "; ".join(f"{where} rel L2 {c['rel_l2']:.3e}, row {c['row_err']:.3e}, "
                      f"{'within' if c['within'] else 'outside'}"
                      f"{' (reported, not held)' if where == 'output' else ''}"
                      for where, c in check.items() if where != "wrong"))
    sound = all(c["within"] for c in gated(checks["sound"]))
    missed = [name for name, check in checks.items()
              if check["wrong"] and all(c["within"] for c in gated(check))]
    if not sound or missed:
        raise AssertionError(f"run S's check of the check: the sound forward "
                             f"{'within' if sound else 'outside'} the limits, wrong ones that "
                             f"passed at every attention output {missed}: {json.dumps(checks)}")
    out["check_weights"] = checks
    return out


def _run_t_argv(t_dir: Path, run: str) -> list:
    """``scripts/train_lora`` flags of T1 and its twin (run: "sharded" or
    "twin")."""
    argv = ["--data_dir", str(t_dir / "latents"), "--output_dir", str(t_dir / run),
            "--train_steps", str(RUN_T_STEPS), "--batch_size", "2", "--checkpointing_steps", "1",
            "--log_every", "1", "--seed", "0"]
    if run == "sharded":
        argv += ["--mesh_dp", str(RUN_T_MESH[0]), "--mesh_tp", str(RUN_T_MESH[2]),
                 "--dist_backend", "gloo"]
    return argv


def _run_t5_step(dit, data_dir: Path, mesh=None) -> dict:
    """One step of ``make_train_step`` (under ``mesh``, or unsharded: T5's
    twin) on the first of T1's samples, batch 1: the adapters drawn from
    RUN_T5_SEED with B ~ N(0, 0.02) (B = 0 would leave every dA 0), AdamW
    at TRAIN_LR, dropout TRAIN_DROPOUT drawn from a generator seeded the
    same way on every rank and in the twin.  Returns the step's launches,
    seconds, loss and grad norm, and the adapters after it (fp32, flat, on
    the host)."""
    import torch

    from trajectorycrafter_tpu_torch.schedulers import CogVideoXDDIMScheduler
    from trajectorycrafter_tpu_torch.training import init_lora_params
    from trajectorycrafter_tpu_torch.training import step as tstep
    from trajectorycrafter_tpu_torch.training.data import LatentsDataset

    batch = {k: v[None] for k, v in LatentsDataset(str(data_dir))[0].items()}
    g = torch.Generator(device="cuda").manual_seed(RUN_T5_SEED)
    lora = init_lora_params(g, dit, rank=TRAIN_RANK)
    with torch.no_grad():
        for key, v in lora.items():
            if key.endswith("lora_B"):
                v.normal_(0.0, 0.02, generator=g)
    lora = {k: v.requires_grad_() for k, v in lora.items()}
    sched = CogVideoXDDIMScheduler()
    opt = tstep.make_optimizer(lr=TRAIN_LR)
    step = tstep.make_train_step(dit, sched, sched.set_timesteps(50), opt,
                                 cfg_dropout_prob=TRAIN_DROPOUT, lora_rank=TRAIN_RANK, mesh=mesh)
    state = tstep.TrainState(lora, opt.init(lora), 0)
    for kern in _kernel_counters():
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step(state, batch, torch.Generator(device="cuda").manual_seed(RUN_T5_SEED))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    flat = torch.cat([v.detach().float().reshape(-1) for v in state.lora.values()])
    return {"launches": _launch_counts(), "seconds": seconds, "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]), "adapters": flat.cpu(),
            "names": list(state.lora)}


def _run_t_twin(tc, data_root: Path, t_dir: Path, scenes: list) -> None:
    """Run T1's data and twin, in phase 5e while the bundle is resident:
    RUN_T_FRAMES-frame samples of run P's SceneFlow scenes by ``datagen``
    (every 6th frame),
    then ``train_lora.main`` unsharded over them on T1's DiT (``run_t1_dit``,
    bf16, ``flash_stock`` and ``remat``), as T1 runs sharded; then T5's
    twin, ``_run_t5_step`` on the same DiT unsharded (``t5_twin.pt``)."""
    import numpy as np
    import torch

    from trajectorycrafter_tpu_torch import datagen
    from trajectorycrafter_tpu_torch.orchestrator import build_dit
    from trajectorycrafter_tpu_torch.scripts import train_lora
    from trajectorycrafter_tpu_torch.training.data import LatentsDataset

    pe, _ = tc.models.encode_prompt("a scene", tc.cfg.diffusion.negative_prompt)
    # every 6th of the 49 frames: the camera moves as far as over the whole
    # clip, so the clips pass datagen's motion filter as run P's do
    step = (TRAIN_FRAMES - 1) // (RUN_T_FRAMES - 1)
    clips = datagen.clips_from_dataset(
        datagen.load_sceneflow_clip(str(data_root / "sceneflow"), name,
                                    frame_ids=range(0, TRAIN_FRAMES, step)) for name in scenes)
    datagen.generate_dataset(tc.models.pipeline.vae, str(t_dir / "latents"), clips,
                             pe[0].float().cpu().numpy(),
                             sample_size=tuple(tc.cfg.diffusion.sample_size))
    data = LatentsDataset(str(t_dir / "latents"))
    shapes = [{k: v.shape for k, v in data[i].items()} for i in range(len(data))]
    if shapes != [RUN_T_LATENT_SHAPES] * len(scenes) or not all(
            np.isfinite(v).all() for i in range(len(data)) for v in data[i].values()):
        raise AssertionError(f"run T's samples: {shapes}, expected {len(scenes)} of "
                             f"{RUN_T_LATENT_SHAPES}, finite")
    dit = build_dit(lambda: run_t1_dit("flash_stock"), "cuda", torch.bfloat16, 1, "none")
    dit.remat = True
    real = train_lora.build_base_model
    train_lora.build_base_model = lambda args, sample, device, **kw: dit
    try:
        for kern in _kernel_counters():
            kern.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        train_lora.main(_run_t_argv(t_dir, "twin"))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got, want = _launch_counts(), _training_launches(dit, RUN_T_STEPS)
    finally:
        train_lora.build_base_model = real
    if got != want:
        raise AssertionError(f"run T's twin: launches {got}, expected {want}")
    recs = [json.loads(line) for line in open(t_dir / "twin" / "metrics.jsonl")]
    log(f"run T's twin: {len(scenes)} samples of {RUN_T_FRAMES} frames "
        f"({json.dumps(shapes[0])}); train_lora.main unsharded, batch 2, {RUN_T_STEPS} steps on "
        f"the bf16 DiT cut to {RUN_T_LAYERS} layers in {seconds:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; losses {[r['loss'] for r in recs]}, grad norms {[r['grad_norm'] for r in recs]}")
    t5 = _run_t5_step(dit, t_dir / "latents")
    if t5["launches"] != _training_launches(dit):
        raise AssertionError(f"run T5's twin: launches {t5['launches']}, expected "
                             f"{_training_launches(dit)}")
    torch.save(t5, t_dir / "t5_twin.pt")
    log(f"run T5's twin: one step unsharded, batch 1, in {t5['seconds']:.2f} s; loss "
        f"{t5['loss']:.6f}, grad norm {t5['grad_norm']:.6f}")
    del dit
    torch.cuda.empty_cache()


def _blocks_inputs(dit, args, kwargs) -> tuple:
    """The block stack's inputs (video tokens, text tokens, temb, rope,
    reference tokens) of a DiT call with ``args`` and ``kwargs``."""
    import torch

    with torch.no_grad():
        video, text, temb, cross = dit.embed(*args, inpaint_latents=kwargs["inpaint_latents"],
                                             cross_latents=kwargs["cross_latents"])
    return video, text, temb, kwargs["image_rotary_emb"], cross


def _saved_forward(out_dir: Path) -> tuple:
    """Run S's first DiT call, saved by the leader's hook: its args and
    kwargs on the card, and its sharded output."""
    import torch

    saved = torch.load(out_dir / "forward.pt")
    to = lambda x: x.cuda() if torch.is_tensor(x) else x
    return ([to(a) for a in saved["args"]],
            {k: tuple(map(to, v)) if isinstance(v, tuple) else to(v)
             for k, v in saved["kwargs"].items()}, saved["output"])


def _rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()


def _run_t1(out_dir: Path, t_dir: Path) -> dict:
    """T1 on this rank: ``train_lora.main`` under RUN_T_MESH, the base DiT
    built shard by shard; each step's launches, loss, grad norm and the
    adapters' checksum, the resident memory after the build."""
    import torch

    from trajectorycrafter_tpu_torch import training
    from trajectorycrafter_tpu_torch.orchestrator import build_dit
    from trajectorycrafter_tpu_torch.scripts import train_lora

    out = {"steps": []}

    def build(args, sample, device, attention_impl="flash_stock", remat=True, tp=None):
        dit = build_dit(lambda: run_t1_dit(attention_impl), device, torch.bfloat16, 1, "none",
                        tp=tp)
        dit.remat = remat
        torch.cuda.synchronize()
        out.update(resident_gib=torch.cuda.memory_allocated() / 2**30,
                   heads=[dit.transformer_blocks[0].attn1.heads,
                          dit.perceiver_cross_attention[0].heads],
                   expected_per_step=_training_launches(dit))
        return dit

    make_step = training.make_train_step

    def counted_make(*a, **kw):
        step = make_step(*a, **kw)

        def counted(state, batch, rng):
            for kern in _kernel_counters():
                kern.launches = 0
            t0 = time.perf_counter()
            state, metrics = step(state, batch, rng)
            torch.cuda.synchronize()
            flat = torch.cat([v.detach().reshape(-1) for v in state.lora.values()])
            out["steps"].append({"seconds": time.perf_counter() - t0,
                                 "launches": _launch_counts(),
                                 "adapters": list(bits_checksum(flat)[2:]),
                                 "loss": float(metrics["loss"]),
                                 "grad_norm": float(metrics["grad_norm"])})
            return state, metrics

        return counted

    real = train_lora.build_base_model, training.make_train_step
    train_lora.build_base_model, training.make_train_step = build, counted_make
    try:
        out["step"] = train_lora.main(_run_t_argv(t_dir, "sharded")).step
    finally:
        train_lora.build_base_model, training.make_train_step = real
    return out


def _sp_fault(name: str):
    """A context that plants one of RUN_T_SP_FAULTS in this rank: the
    adapters' sp sum left out; the output gather's backward summing the sp
    ranks' gradients before taking the rank's slice; the ring's backward
    returning the dK / dV of the rank's own queries against its own shard
    (the accumulators never travel).  Each is made from the sound pieces."""
    from types import SimpleNamespace
    from unittest import mock

    import torch

    from trajectorycrafter_tpu_torch.ops import ring_attention as ra
    from trajectorycrafter_tpu_torch.ops.attention import attention_backward_reference
    from trajectorycrafter_tpu_torch.parallel import distributed as D
    from trajectorycrafter_tpu_torch.training import step as tstep

    if name == RUN_T_SP_FAULTS[0]:
        return mock.patch.object(tstep, "sp_sum", lambda flat, sp: flat)
    if name == RUN_T_SP_FAULTS[1]:
        class GatherSummed(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, axis, dim, sizes):
                ctx.axis, ctx.dim = axis, dim
                ctx.lo, ctx.n = sum(sizes[:axis.index]), sizes[axis.index]
                return D.all_gather(x, axis, dim=dim, sizes=sizes)

            @staticmethod
            def backward(ctx, grad):
                summed = D.sum_partials(grad.contiguous(), ctx.axis)
                return summed.narrow(ctx.dim, ctx.lo, ctx.n), None, None, None

        return mock.patch.object(D, "gather_tokens", lambda x, axis, dim, sizes: (
            GatherSummed.apply(x, axis, dim, list(sizes)) if axis.size > 1 else x))
    sound = ra.RingAttentionFunction.backward

    def own_queries(ctx, dout):
        saved = ctx.saved_tensors  # a recomputed block's unpack once
        dq, _, _, *rest = sound(SimpleNamespace(saved_tensors=saved, **{
            k: getattr(ctx, k) for k in ("axis", "s_true", "scale", "kernels_on")}), dout)
        q, k, v, out, lse = saved
        bshd = lambda x: x.transpose(1, 2)
        _, dk, dv = attention_backward_reference(bshd(q), bshd(k), bshd(v), bshd(out), lse,
                                                 bshd(dout), ctx.scale)
        return (dq, bshd(dk).to(k.dtype), bshd(dv).to(v.dtype), *rest)

    return mock.patch.object(ra.RingAttentionFunction, "backward", staticmethod(own_queries))


def _run_t2(out_dir: Path, t_dir: Path) -> dict:
    """T2 on this rank: one batch's adapter gradients reduced over
    RUN_T_MESH, sound and with each of RUN_T_FAULTS, and over RUN_T_SP_MESH
    (the token stream on sp), sound and with each of RUN_T_SP_FAULTS; the
    leader holds them against the unsharded model's and returns the
    readings."""
    from unittest import mock

    import torch

    from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel
    from trajectorycrafter_tpu_torch.orchestrator import build_dit
    from trajectorycrafter_tpu_torch.parallel import distributed as D
    from trajectorycrafter_tpu_torch.parallel.mesh import make_mesh
    from trajectorycrafter_tpu_torch.schedulers import CogVideoXDDIMScheduler
    from trajectorycrafter_tpu_torch.training import init_lora_params
    from trajectorycrafter_tpu_torch.training import step as tstep

    mesh = make_mesh(*RUN_T_MESH)
    make = lambda: CrossTransformer3DModel(num_layers=RUN_T_CHECK_LAYERS,
                                           attention_impl="reference", remat=True)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        sharded = check_weights_(build_dit(make, "cuda", torch.float32, RUN_T_CHECK_SEED,
                                           tp=mesh.tp))
        g = torch.Generator(device="cuda").manual_seed(5)
        lora = init_lora_params(g, sharded, rank=TRAIN_RANK)
        with torch.no_grad():  # B != 0, so that every dA is not
            for key, v in lora.items():
                if key.endswith("lora_B"):
                    v.normal_(0.0, 0.02, generator=g)
        f, h, w = RUN_T_CHECK_LATENTS
        rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda")
        batch = {"gt_latents": rnd(2, f, h, w, 16), "prompt_embeds": rnd(2, 226, 4096),
                 "ref_latents": rnd(2, f, h, w, 16), "inpaint_latents": rnd(2, f, h, w, 17),
                 "noise": rnd(2, f, h, w, 16), "timesteps": torch.tensor([300, 700],
                                                                         device="cuda")}
        sched = CogVideoXDDIMScheduler()
        sch_state = sched.set_timesteps(50)
        names, params = list(lora), list(lora.values())

        def grads(model, dp):
            fn = tstep.make_loss_fn(model, sched, sch_state, cfg_dropout_prob=0.0,
                                    lora_rank=TRAIN_RANK, dp=dp)
            return torch.autograd.grad(fn(lora, batch, 0), params)

        reduce = lambda gs: tstep.reduce_lora_grads(gs, names, sharded, mesh)
        local = grads(sharded, mesh.dp)
        got = {"sound": reduce(local)}
        with mock.patch.object(tstep, "tp_sharded_adapters", lambda model, keys: set(keys)):
            got[RUN_T_FAULTS[1]] = reduce(local)
        with mock.patch.object(tstep, "dp_mean", lambda flat, dp: D.sum_partials(flat, dp)):
            got[RUN_T_FAULTS[2]] = reduce(local)
        with mock.patch.object(D, "tp_input_grad", lambda grad, axis: grad):
            got[RUN_T_FAULTS[0]] = reduce(grads(sharded, mesh.dp))
        del sharded
        # the same batch and adapters under RUN_T_SP_MESH: the token stream on
        # sp, the ring on its plain versions in fp32 (the "reference" route)
        sp_mesh = make_mesh(*RUN_T_SP_MESH)
        on_sp = check_weights_(build_dit(make, "cuda", torch.float32, RUN_T_CHECK_SEED,
                                         tp=sp_mesh.tp))

        def grads_sp():
            fn = tstep.make_loss_fn(on_sp, sched, sch_state, cfg_dropout_prob=0.0,
                                    lora_rank=TRAIN_RANK, dp=sp_mesh.dp, sp=sp_mesh.sp)
            return torch.autograd.grad(fn(lora, batch, 0), params)

        reduce_sp = lambda gs: tstep.reduce_lora_grads(gs, names, on_sp, sp_mesh)
        local = grads_sp()
        got_sp = {"sound": reduce_sp(local)}
        with _sp_fault(RUN_T_SP_FAULTS[0]):
            got_sp[RUN_T_SP_FAULTS[0]] = reduce_sp(local)
        for fault in RUN_T_SP_FAULTS[1:]:
            with _sp_fault(fault):
                got_sp[fault] = reduce_sp(grads_sp())
        del on_sp
        readings = readings_sp = {}
        if mesh.leader:
            want = grads(check_weights_(build_dit(make, "cuda", torch.float32,
                                                  RUN_T_CHECK_SEED)), None)
            last_ff = f"transformer_blocks.{RUN_T_CHECK_LAYERS - 1}.ff."
            touched = {"every adapter": names,
                       RUN_T_FAULTS[0]: [n for n in names
                                         if not n.startswith((last_ff, "proj_out."))],
                       RUN_T_FAULTS[1]: [n for n in names if n.startswith("proj_out.")],
                       RUN_T_FAULTS[2]: names}
            touched_sp = {"every adapter": names, RUN_T_SP_FAULTS[0]: names,
                          RUN_T_SP_FAULTS[1]: names,
                          RUN_T_SP_FAULTS[2]: [n for n in names
                                               if ".attn1.to_k." in n or ".attn1.to_v." in n]}
            flat = lambda gs, keys: torch.cat([gs[names.index(k)].reshape(-1) for k in keys])
            read = lambda runs, where: {run: {w: _rel_l2(flat(gs, keys), flat(want, keys))
                                              for w, keys in where.items()}
                                        for run, gs in runs.items()}
            readings, readings_sp = read(got, touched), read(got_sp, touched_sp)
        D.barrier(mesh.world)
        return {"readings": readings, "readings_sp": readings_sp, "adapters": len(names)}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _stage_launches(dit, blocks: range, microbatches: int) -> dict:
    """{kernel: launches} of one pipeline stage's forward over ``blocks``
    without gradients, from its modules: K1 once a block and Perceiver, K2a
    and K2b once an int8 layer (no tp), each microbatch."""
    from trajectorycrafter_tpu_torch.ops.int8 import Int8Linear

    units = [dit.transformer_blocks[i] for i in blocks]
    units += [dit.perceiver_cross_attention[i // 2] for i in blocks if i % 2 == 0]
    int8 = sum(isinstance(m, Int8Linear) for u in units for m in u.modules())
    out = {name: 0 for name in KERNELS}
    out.update({"flash_attention": microbatches * len(units),
                "int8_quantize_rows": microbatches * int8, "int8_gemm": microbatches * int8})
    return out


def _run_t3(out_dir: Path, t_dir: Path) -> dict:
    """T3 on this rank: its stage of the int8 DiT under pp RUN_T_PP, the
    stack pipelined over run S's first DiT call; the leader saves the
    output for the main process."""
    import warnings

    import torch

    from trajectorycrafter_tpu_torch.orchestrator import build_dit, full_scale_dit
    from trajectorycrafter_tpu_torch.parallel.mesh import make_mesh
    from trajectorycrafter_tpu_torch.parallel.pipeline import (
        pipeline_dit_blocks,
        stack_superblock_params,
    )

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mesh = make_mesh(pp=RUN_T_PP)
    out = {"warning": [str(w.message) for w in caught]}
    if not mesh.member:
        return {**out, "idle": True}
    dit = build_dit(full_scale_dit, "cuda", torch.bfloat16, 1, "int8")
    torch.cuda.synchronize()
    whole = torch.cuda.memory_allocated()
    stages = stack_superblock_params(dit, mesh.pp.size, mesh.pp.index)
    gc.collect()
    torch.cuda.synchronize()
    inputs = _blocks_inputs(dit, *_saved_forward(out_dir)[:2])
    stage = stages[mesh.pp.index]
    blocks = range(2 * stage.start, 2 * stage.stop)
    out.update(whole_gib=whole / 2**30, resident_gib=torch.cuda.memory_allocated() / 2**30,
               superblocks=[stage.start, stage.stop],
               expected=_stage_launches(dit, blocks, RUN_T_MICROBATCHES))
    for kern in _kernel_counters():
        kern.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        h, e = pipeline_dit_blocks(dit, stages, *inputs, mesh, RUN_T_MICROBATCHES)
    torch.cuda.synchronize()
    out.update(pipeline_s=time.perf_counter() - t0, launches=_launch_counts(),
               output=[list(bits_checksum(h)[2:]), list(bits_checksum(e)[2:])])
    if mesh.leader:
        torch.save({"hidden": h.cpu(), "encoder": e.cpu()}, out_dir / "t3.pt")
    return out


def _run_t4(out_dir: Path, t_dir: Path) -> dict:
    """T4 on this rank: GPipe under pp 2 x tp 2 on the full-width DiT cut
    to RUN_T_PP_TP_LAYERS layers, on run S's first DiT call, sound and with
    a stage that skips its hop, against the model's sequential loop."""
    from unittest import mock

    import torch

    from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel
    from trajectorycrafter_tpu_torch.orchestrator import build_dit
    from trajectorycrafter_tpu_torch.parallel import distributed as D
    from trajectorycrafter_tpu_torch.parallel.mesh import make_mesh
    from trajectorycrafter_tpu_torch.parallel.pipeline import (
        pipeline_dit_blocks,
        stack_superblock_params,
        stacked_param_sharding,
    )

    class SkippedHop(D.Shift):
        """The planted fault: the hop runs, the stage reads zeros."""

        def wait(self):
            return [torch.zeros_like(t) for t in super().wait()]

    mesh = make_mesh(*RUN_T_PP_TP)
    dit = build_dit(lambda: CrossTransformer3DModel(num_layers=RUN_T_PP_TP_LAYERS), "cuda",
                    torch.bfloat16, RUN_T_CHECK_SEED, "int8")
    inputs = _blocks_inputs(dit, *_saved_forward(out_dir)[:2])
    with torch.no_grad():
        want = torch.cat(dit.run_blocks(*inputs), dim=1)
    stages = stack_superblock_params(dit, mesh.pp.size, mesh.pp.index)
    stacked_param_sharding(dit, stages, mesh)
    readings = {}
    for name in ("sound", "stage skips its hop"):
        hop = SkippedHop if name != "sound" else D.Shift
        with mock.patch.object(D, "Shift", hop), torch.no_grad():
            got = torch.cat(pipeline_dit_blocks(dit, stages, *inputs, mesh,
                                                RUN_T_MICROBATCHES), dim=1)
        readings[name] = {"rel_l2": _rel_l2(got, want), "bit_equal": bool(torch.equal(got, want))}
    return {"coords": [mesh.tp.index, mesh.pp.index], "readings": readings,
            "heads": [dit.transformer_blocks[2 * stages[mesh.pp.index].start].attn1.heads]}


def _run_t5(out_dir: Path, t_dir: Path) -> dict:
    """T5 on this rank: one step of ``make_train_step`` under RUN_T_SP_MESH
    (the token stream on sp) on T1's DiT, built shard by shard; its
    launches against those derived from the shard's modules, its loss and
    grad norm, the adapters' checksum; the leader saves the adapters for the
    main process to hold against the twin's."""
    import torch

    from trajectorycrafter_tpu_torch.orchestrator import build_dit
    from trajectorycrafter_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(*RUN_T_SP_MESH)
    dit = build_dit(lambda: run_t1_dit("flash_stock"), "cuda", torch.bfloat16, 1, "none",
                    tp=mesh.tp)
    dit.remat = True
    torch.cuda.synchronize()
    out = {"coords": [mesh.dp.index, mesh.sp.index, mesh.tp.index],
           "resident_gib": torch.cuda.memory_allocated() / 2**30,
           "heads": [dit.transformer_blocks[0].attn1.heads,
                     dit.perceiver_cross_attention[0].heads],
           "expected": _training_launches(dit, sp=mesh.sp.size)}
    step = _run_t5_step(dit, t_dir / "latents", mesh)
    out.update({k: step[k] for k in ("launches", "loss", "grad_norm")},
               step_seconds=step["seconds"], adapters=list(bits_checksum(step["adapters"])[2:]))
    if mesh.leader:
        torch.save(step, out_dir / "t5.pt")
    return out


def run_t_alone_rank(out_dir: str, t_dir: str) -> None:
    """One rank of run T in a torchrun world of its own (``chip_smoke.py
    --run-t-rank DIR T_DIR``, tools/run_t.py): the gloo process group from
    torchrun's environment, then ``run_t_rank``."""
    from trajectorycrafter_tpu_torch.parallel import distributed as D

    os.chdir(REPO)
    sys.path.insert(0, str(REPO))
    D.init_from_env("gloo")
    try:
        run_t_rank(out_dir, t_dir)
    finally:
        D.shutdown()


def run_t_rank(out_dir: str, t_dir: str) -> None:
    """This rank's part of run T (T1-T5), in run S's torchrun world once run
    S is done; writes its readings to DIR/run_t_rank<r>.json."""
    import traceback

    import torch
    import torch.distributed as dist

    from trajectorycrafter_tpu_torch.parallel import distributed as D

    rank = dist.get_rank()
    out = {"rank": rank, "held_before_gib": torch.cuda.memory_allocated() / 2**30}
    try:
        for name, fn in (("T1", _run_t1), ("T2", _run_t2), ("T3", _run_t3), ("T4", _run_t4),
                         ("T5", _run_t5)):
            before = dict(D.TRANSPORT)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out[name] = fn(Path(out_dir), Path(t_dir))
            torch.cuda.synchronize()
            out[name].update(seconds=time.perf_counter() - t0,
                             peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                             transport={k: v - before.get(k, 0) for k, v in D.TRANSPORT.items()
                                        if v != before.get(k, 0)})
            gc.collect()
            torch.cuda.empty_cache()
            D.barrier(D.world_axis())
    except BaseException:
        out["error"] = traceback.format_exc() + (
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
        raise
    finally:
        Path(out_dir, f"run_t_rank{rank}.json").write_text(json.dumps(out))


def _run_t_check(out_dir: Path, t_dir: Path, results: list, t3_reference: dict) -> dict:
    """Run T's readings held to the checks stated at RUN_T_MESH; returns
    the launches a rank for the kernels line."""
    import torch
    from safetensors.torch import load_file

    failed = []
    # -- T1 --
    twin = [json.loads(line) for line in open(t_dir / "twin" / "metrics.jsonl")]
    lead = results[0]["T1"]
    for r in results:
        t1 = r["T1"]
        want = t1["expected_per_step"]
        layers = RUN_T_LAYERS + RUN_T_LAYERS // PERCEIVER_INTERVAL
        if (want["flash_lse"], want["flash_attention_bwd_dkv"], want["flash_attention_bwd_dq"]) \
                != (RUN_T_LAYERS + layers, layers, layers):
            failed.append(f"T1 rank {r['rank']}: derived launches {want}")
        for i, s in enumerate(t1["steps"]):
            if s["launches"] != want:
                failed.append(f"T1 rank {r['rank']} step {i + 1}: launches {s['launches']}")
            if s["adapters"] != lead["steps"][i]["adapters"]:
                failed.append(f"T1 rank {r['rank']} step {i + 1}: adapters differ from rank 0's")
        if t1["step"] != RUN_T_STEPS or len(t1["steps"]) != RUN_T_STEPS:
            failed.append(f"T1 rank {r['rank']}: {t1['step']} steps")
        log(f"  T1 rank {r['rank']}: heads {t1['heads']}, {t1['resident_gib']:.2f} GiB resident "
            f"after the build, peak {t1['peak_gib']:.2f} GiB, {t1['seconds']:.1f} s (steps "
            f"{[round(s['seconds'], 2) for s in t1['steps']]} s); launches a step "
            f"{json.dumps({k: v for k, v in want.items() if v})}; transport "
            f"{json.dumps(t1['transport'])}")
    sharded = [json.loads(line) for line in open(t_dir / "sharded" / "metrics.jsonl")]
    if sorted(os.listdir(t_dir / "sharded")) != sorted(
            [f"ckpt_{i + 1:07d}" for i in range(RUN_T_STEPS)] + ["lora_final", "metrics.jsonl"]
            + (["tb"] if (t_dir / "sharded" / "tb").exists() else [])):
        failed.append(f"T1 wrote {sorted(os.listdir(t_dir / 'sharded'))}")
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    t1 = {"loss": [rel(s["loss"], w["loss"]) for s, w in zip(sharded, twin)],
          "grad_norm": [rel(s["grad_norm"], w["grad_norm"]) for s, w in zip(sharded, twin)]}
    got = load_file(str(t_dir / "sharded" / "lora_final" / "lora.safetensors"))
    ref = load_file(str(t_dir / "twin" / "lora_final" / "lora.safetensors"))
    cat = lambda sd, part: torch.cat([sd[k].reshape(-1) for k in sorted(ref) if part in k])
    t1["adapters"] = _rel_l2(cat(got, "lora_"), cat(ref, "lora_"))
    t1["B"] = _rel_l2(cat(got, "lora_B"), cat(ref, "lora_B"))
    log(f"run T1: sharded (dp {RUN_T_MESH[0]} x tp {RUN_T_MESH[2]}) against the twin: losses "
        f"{[s['loss'] for s in sharded]} vs {[w['loss'] for w in twin]} (rel "
        f"{[f'{x:.2e}' for x in t1['loss']]}), grad norms rel "
        f"{[f'{x:.2e}' for x in t1['grad_norm']]}; adapters after {RUN_T_STEPS} steps rel L2 "
        f"{t1['adapters']:.3e} (limit {RUN_T_REL_L2:.3e}; the B alone, which start at 0, "
        f"{t1['B']:.3e}, reported); adapters bit-equal on all ranks after every step")
    if len(sharded) != RUN_T_STEPS or max(t1["loss"] + t1["grad_norm"] + [t1["adapters"]]) \
            > RUN_T_REL_L2:
        failed.append(f"T1 against the twin: {t1}")
    # -- T2 --
    readings = results[0]["T2"]["readings"]
    for run, reading in readings.items():
        log(f"run T2, {run}: " + "; ".join(f"{where} rel L2 {x:.3e}"
                                           for where, x in reading.items()))
    sound = readings["sound"]
    if max(sound.values()) > RUN_T_REL_L2:
        failed.append(f"T2 sound: {sound}")
    for fault in RUN_T_FAULTS:
        ratio = readings[fault][fault] / max(sound[fault], 1e-30)
        log(f"run T2, {fault}: {ratio:.1f}x the sound reading on the adapters it touches "
            f"(limit {RUN_S_VAE_FAULT_RATIO:g}x)")
        if ratio < RUN_S_VAE_FAULT_RATIO:
            failed.append(f"T2 {fault}: {ratio:.1f}x")
    readings = results[0]["T2"]["readings_sp"]
    for run, reading in readings.items():
        log(f"run T2 on {RUN_T_SP_MESH}, {run}: " + "; ".join(
            f"{where} rel L2 {x:.3e}" for where, x in reading.items()))
    sound = readings["sound"]
    if max(sound.values()) > RUN_T_REL_L2:
        failed.append(f"T2 sp sound: {sound}")
    for fault in RUN_T_SP_FAULTS:
        ratio = readings[fault][fault] / max(sound[fault], 1e-30)
        log(f"run T2 on {RUN_T_SP_MESH}, {fault}: {ratio:.1f}x the sound reading on the "
            f"adapters it touches (limit {RUN_S_VAE_FAULT_RATIO:g}x)")
        if ratio < RUN_S_VAE_FAULT_RATIO:
            failed.append(f"T2 sp {fault}: {ratio:.1f}x")
    # -- T3 --
    stages = [r["T3"] for r in results if not r["T3"].get("idle")]
    idle = [r["rank"] for r in results if r["T3"].get("idle")]
    if len(stages) != RUN_T_PP or idle != [RUN_T_PP] or not any(
            f"uses {RUN_T_PP} of {len(results)} ranks" in w for w in results[0]["T3"]["warning"]):
        failed.append(f"T3: stages {len(stages)}, idle {idle}, warning "
                      f"{results[0]['T3']['warning']}")
    per = DIT_LAYERS // 2 // RUN_T_PP
    formula = {"flash_attention": RUN_T_MICROBATCHES * per * 3,
               "int8_quantize_rows": RUN_T_MICROBATCHES * per * 15,
               "int8_gemm": RUN_T_MICROBATCHES * per * 15}
    for r in results:
        t3 = r["T3"]
        if t3.get("idle"):
            continue
        if t3["launches"] != t3["expected"] or any(t3["expected"][k] != v
                                                   for k, v in formula.items()):
            failed.append(f"T3 rank {r['rank']}: launches {t3['launches']}, derived "
                          f"{t3['expected']}")
        if t3["output"] != stages[0]["output"]:
            failed.append(f"T3 rank {r['rank']}: output differs from rank 0's")
        log(f"  T3 rank {r['rank']}: superblocks {t3['superblocks']}, {t3['resident_gib']:.2f} "
            f"GiB resident of the whole int8 DiT's {t3['whole_gib']:.2f}, peak "
            f"{t3['peak_gib']:.2f} GiB; pipeline {t3['pipeline_s']:.2f} s; launches "
            f"{json.dumps({k: v for k, v in t3['launches'].items() if v})}; transport "
            f"{json.dumps(t3['transport'])}")
    got3 = torch.load(out_dir / "t3.pt")
    t3 = {name: {"rel_l2": _rel_l2(got3[name].cuda(), t3_reference[name]),
                 "bit_equal": bool(torch.equal(got3[name].cuda(), t3_reference[name]))}
          for name in ("hidden", "encoder")}
    log(f"run T3: GPipe pp {RUN_T_PP} x {RUN_T_MICROBATCHES} microbatches against the "
        f"sequential block loop of the whole int8 DiT: {json.dumps(t3)} (limit "
        f"{RUN_T_REL_L2:.3e}); rank {idle} idle: {results[0]['T3']['warning']}")
    if max(x["rel_l2"] for x in t3.values()) > RUN_T_REL_L2:
        failed.append(f"T3 against the sequential loop: {t3}")
    # -- T4 --
    for r in results:
        t4 = r["T4"]["readings"]
        sound, wrong = t4["sound"]["rel_l2"], t4["stage skips its hop"]["rel_l2"]
        log(f"  T4 rank {r['rank']} (tp, pp) {tuple(r['T4']['coords'])}, heads "
            f"{r['T4']['heads']}: sound rel L2 {sound:.3e} (bit-equal "
            f"{t4['sound']['bit_equal']}), stage skips its hop {wrong:.3e} "
            f"({wrong / max(sound, 1e-30):.1f}x); transport {json.dumps(r['T4']['transport'])}")
        if sound > RUN_T_REL_L2 or wrong < RUN_S_VAE_FAULT_RATIO * sound:
            failed.append(f"T4 rank {r['rank']}: {t4}")
    # -- T5 --
    layers = RUN_T_LAYERS // PERCEIVER_INTERVAL
    sp = RUN_T_SP_MESH[1]
    for r in results:
        t5 = r["T5"]
        want = t5["expected"]
        if (want["flash_lse"], want["flash_attention_bwd_dkv"], want["flash_attention_bwd_dq"]) \
                != (2 * RUN_T_LAYERS * sp + layers, RUN_T_LAYERS * sp + layers,
                    RUN_T_LAYERS * sp + layers):
            failed.append(f"T5 rank {r['rank']}: derived launches {want}")
        if t5["launches"] != want:
            failed.append(f"T5 rank {r['rank']}: launches {t5['launches']}, derived {want}")
        if t5["adapters"] != results[0]["T5"]["adapters"]:
            failed.append(f"T5 rank {r['rank']}: adapters differ from rank 0's")
        log(f"  T5 rank {r['rank']} (dp, sp, tp) {tuple(t5['coords'])}, heads {t5['heads']}: "
            f"{t5['resident_gib']:.2f} GiB resident after the build, peak {t5['peak_gib']:.2f} "
            f"GiB, {t5['seconds']:.1f} s (the step {t5['step_seconds']:.2f} s); launches "
            f"{json.dumps({k: v for k, v in t5['launches'].items() if v})}; transport "
            f"{json.dumps(t5['transport'])}")
    got5, twin5 = torch.load(out_dir / "t5.pt"), torch.load(t_dir / "t5_twin.pt")
    t5 = {"loss": rel(got5["loss"], twin5["loss"]),
          "grad_norm": rel(got5["grad_norm"], twin5["grad_norm"]),
          "adapters": _rel_l2(got5["adapters"], twin5["adapters"])}
    log(f"run T5: one step under (dp, sp, tp) {RUN_T_SP_MESH} against the unsharded twin: "
        f"loss {got5['loss']:.6f} vs {twin5['loss']:.6f}, grad norm {got5['grad_norm']:.6f} vs "
        f"{twin5['grad_norm']:.6f}; rel {json.dumps({k: f'{v:.3e}' for k, v in t5.items()})} "
        f"(limit {RUN_T_REL_L2:.3e}); adapters bit-equal on all ranks")
    if got5["names"] != twin5["names"] or max(t5.values()) > RUN_T_REL_L2:
        failed.append(f"T5 against the twin: {t5}")
    if failed:
        raise AssertionError(f"run T: {failed}")
    log(f"run T: seconds a rank " + ", ".join(
        f"{t} {[round(r[t]['seconds'], 1) for r in results]}"
        for t in ("T1", "T2", "T3", "T4", "T5")))
    return {"per_rank": {k: {"T1 a step": [r["T1"]["steps"][0]["launches"][k] for r in results],
                             "T3 a stage": [r["T3"].get("launches", {}).get(k, 0)
                                            for r in results],
                             "T5 a step": [r["T5"]["launches"][k] for r in results]}
                         for k in KERNELS}}


# Run U: the five scripts of SCRIPT_RUNS, each through its ``main(argv)``
# with phase 8's command line plus run S's mesh flags (RUN_U_ARGV), in run
# S's torchrun world once run T is done, on phase 8's tree (the DiT at full
# width cut to 6 layers, every other family whole, the vitl ``.pth``); each
# rank loads the bundle once and hands it to the later scripts (one mesh,
# one load a rank: the reloads were cut for the smoke's clock) and writes
# under an ``--out_dir`` of its own.  Held: each leader's output
# (SCRIPT_RUNS' last field) against phase 8's unsharded run of the script
# through the quality CLI at its 35 dB gate; the joined video's and every
# mp4's frame count; the followers' directories empty; every rank's latents
# bit-equal after each step; each rank's launches of K1, K2a (both entries),
# K2b, K4 and K5 against the counts derived from its sharded modules
# (``_sharded_launches_per_forward``, ``_depth_kernel_attentions``) times the
# script's diffusions and depth stages.  Then the sharded strip decode on
# run S's latents (9 frames at 384x672, saved by run S's leader) under
# RUN_U_STRIP_MEMORY, which sends both the twin (its estimate over dp x sp)
# and the unsharded VAE to strips of RUN_U_STRIP_HEIGHT latent rows: every
# rank's video bit-equal, the leader's against the unsharded strip decode by
# relative L2 over the whole video and on the strip seams' blend rows within
# RUN_S_VAE_REL_TOL, and the planted fault (the first strip seam's blend
# rows dropped on the leader) at least RUN_S_VAE_FAULT_RATIO times the sound
# reading on those rows.  Seconds per stage and memory per rank are logged:
# no speed figure (gloo on one card sets the pace).
RUN_U_ARGV = RUN_S_ARGV[:RUN_S_ARGV.index("--exp_name")]
RUN_U_STRIP_MEMORY = 2**30
RUN_U_STRIP_HEIGHT = 24


def strip_seam_rows(height: int, strip_height: int) -> list:
    """The output rows ``vae_decode_auto``'s strips blend with the strip
    above (overlap 1/7, as ``vae_decode_tiled``'s arithmetic)."""
    blend = int(8 * strip_height / 7.0)
    limit = 8 * strip_height - blend
    return [r for k in range(1, height // limit + 1)
            for r in range(k * limit, min(k * limit + blend, height))]


def run_u_rank(out_dir: str, plan_path: str) -> None:
    """This rank's part of run U, in run S's torchrun world once run T is
    done (see RUN_U_ARGV); writes its readings to DIR/run_u_rank<r>.json."""
    import importlib
    import traceback
    from collections import Counter

    import torch
    import torch.distributed as dist

    from trajectorycrafter_tpu_torch import orchestrator
    from trajectorycrafter_tpu_torch.models import vae as vae_mod
    from trajectorycrafter_tpu_torch.parallel import distributed as D
    from trajectorycrafter_tpu_torch.pipelines.depth import window_starts
    from trajectorycrafter_tpu_torch.pipelines.trajcrafter import TrajCrafterPipeline

    plan = json.loads(Path(plan_path).read_text())
    rank = dist.get_rank()
    out = {"rank": rank, "held_before_gib": torch.cuda.memory_allocated() / 2**30,
           "scripts": {}}
    denoise = TrajCrafterPipeline._denoise
    counters = _kernel_counters()
    steps, denoised = [], Counter()

    def counted_denoise(self, *a, **kw):
        step = self.scheduler.step

        def recorded(*sa, **skw):
            res = step(*sa, **skw)
            steps.append(list(bits_checksum(res[0] if isinstance(res, tuple) else res)))
            return res

        before = {kern.__name__: kern.launches for kern in counters}
        self.scheduler.step = recorded
        try:
            return denoise(self, *a, **kw)
        finally:
            del self.scheduler.step
            for kern in counters:
                denoised[kern.__name__] += kern.launches - before[kern.__name__]

    TrajCrafterPipeline._denoise = counted_denoise
    try:
        with loaded_once() as held:
            rank_dir = Path(plan["out"], f"rank{rank}")
            for name, argv in plan["scripts"].items():
                module = importlib.import_module(f"trajectorycrafter_tpu_torch.scripts.{name}")
                steps.clear()
                denoised.clear()
                if "bundle" in held:
                    held["bundle"].pipeline.timer.seconds.clear()
                for kern in counters:
                    kern.launches = 0
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                returned = module.main(argv + ["--out_dir", str(rank_dir)])
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                total = {kern.__name__: kern.launches for kern in counters}
                save_dir = rank_dir / f"script_{name}"
                r = {"seconds": seconds, "steps": list(steps),
                     "per_path": {"depth": {k: total[k] - denoised[k] for k in total},
                                  "denoise": {k: denoised[k] for k in total}},
                     "stages": dict(held["bundle"].pipeline.timer.seconds),
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "files": sorted(str(f.relative_to(save_dir)) for f in save_dir.rglob("*")
                                     if f.is_file()) if save_dir.exists() else []}
                if hasattr(returned, "shape"):
                    r["video"] = {"shape": list(returned.shape), "min": float(returned.min()),
                                  "max": float(returned.max()),
                                  "finite": bool(torch.isfinite(torch.as_tensor(returned)).all())}
                out["scripts"][name] = r
                gc.collect()
                D.barrier(D.world_axis())
        bundle, mesh = held["bundle"], held["mesh"]
        out.update(load_s=held["load_s"], resident_gib=held["resident_gib"])
        cfg = _script_cfg(plan["scripts"]["inference_orbits"])
        windows = len(window_starts(cfg.video_length, cfg.depth.window_size, cfg.depth.overlap))
        depth_pipe = orchestrator.depth_pipeline(bundle.depth_infer)
        out["expected_per_forward"] = _sharded_launches_per_forward(bundle.pipeline.transformer)
        out["expected_per_depth"] = {**dict.fromkeys(KERNELS, 0), "flash_attention": (
            _depth_kernel_attentions(depth_pipe.sharded_unet, *(n // 8 for n in cfg.warp_size))
            * windows * cfg.depth.num_inference_steps)}

        # the sharded strip decode on run S's latents, sound, then with the
        # first strip seam's blend rows dropped on the leader (every rank
        # decodes twice: the strips' gathers pair up)
        pipe = bundle.pipeline
        z = torch.load(Path(out_dir, "run_s_decode_latents.pt")).to(pipe.device)
        memory = RUN_U_STRIP_MEMORY
        tiled = [vae_mod.decode_is_tiled(z.shape, memory, vae_mod.decode_peak_divisor(vae))
                 for vae in (pipe.spatial_vae, pipe.vae)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sound = vae_mod.vae_decode_auto(pipe.spatial_vae, z, memory, RUN_U_STRIP_HEIGHT)
        torch.cuda.synchronize()
        strips = {"tiled": tiled, "seconds": time.perf_counter() - t0,
                  "checksum": list(bits_checksum(sound)), "shape": list(sound.shape)}
        blend, calls = vae_mod._blend, []

        def dropped(a, b, extent, dim):
            calls.append(extent)
            return b if len(calls) == 1 else blend(a, b, extent, dim)

        if mesh.leader:
            vae_mod._blend = dropped
        try:
            wrong = vae_mod.vae_decode_auto(pipe.spatial_vae, z, memory, RUN_U_STRIP_HEIGHT)
        finally:
            vae_mod._blend = blend
        if mesh.leader:
            want = vae_mod.vae_decode_auto(pipe.vae, z, memory, RUN_U_STRIP_HEIGHT)
            rows = torch.tensor(strip_seam_rows(want.shape[2], RUN_U_STRIP_HEIGHT),
                                dtype=torch.long, device=want.device)
            rel = lambda got, band: ((got.float() - want.float())[:, :, rows if band else
                                                                   slice(None)].norm()
                                     / want.float()[:, :, rows if band else slice(None)].norm()
                                     ).item()
            strips.update(seam_rows=len(rows), blends=len(calls),
                          sound={"rel_l2": rel(sound, False), "band_rel_l2": rel(sound, True)},
                          fault={"rel_l2": rel(wrong, False), "band_rel_l2": rel(wrong, True)})
            del want
        out["strips"] = strips
        del sound, wrong
    except BaseException:
        out["error"] = traceback.format_exc() + (
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
        raise
    finally:
        TrajCrafterPipeline._denoise = denoise
        Path(out_dir, f"run_u_rank{rank}.json").write_text(json.dumps(out))


def _quality(video_a: Path, video_b: Path) -> dict:
    """The quality CLI (``utils/quality.py main``) on two mp4s, in this
    process: its JSON line and whether it passed."""
    import io

    from trajectorycrafter_tpu_torch.utils import quality

    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            quality.main([str(video_a), str(video_b)])
        rc = 0
    except SystemExit as e:
        rc = e.code
    lines = text.getvalue().strip().splitlines()
    return {"rc": rc, **(json.loads(lines[-1]) if lines else {"pass": False})}


def _run_u_check(results: list, plan: dict, runs: dict) -> dict:
    """Run U's readings held to the checks stated at RUN_U_ARGV; sets
    ``runs["U"]`` (its launches) and returns the readings to log."""
    failed = []
    lead = results[0]
    forwards = int(MAIN_ARGV[MAIN_ARGV.index("--diffusion_inference_steps") + 1])  # DDIM
    phase8 = REPO / MAIN_ARGV[MAIN_ARGV.index("--out_dir") + 1]
    joined = 2 * (SCRIPT_FRAMES - 8) + 8
    quality = {}
    for name, (_, stages, diffusions, output) in SCRIPT_RUNS.items():
        for r in results:
            got = r["scripts"][name]
            per_forward, per_depth = r["expected_per_forward"], r["expected_per_depth"]
            want = {"depth": {k: stages * v for k, v in per_depth.items()},
                    "denoise": {k: diffusions * forwards * v for k, v in per_forward.items()}}
            if got["per_path"] != want:
                failed.append(f"{name} rank {r['rank']}: launches {got['per_path']}, "
                              f"expected {want}")
            if got["steps"] != lead["scripts"][name]["steps"] or \
                    len(got["steps"]) != diffusions * forwards:
                failed.append(f"{name} rank {r['rank']}: latents differ from rank 0's after "
                              "a step")
            if r["rank"] and got["files"]:
                failed.append(f"{name} rank {r['rank']} wrote {got['files'][:4]}")
            log(f"  {name} rank {r['rank']}: {got['seconds']:.2f} s, peak "
                f"{got['peak_gib']:.2f} GiB, stages "
                f"{json.dumps({k: round(v, 3) for k, v in got['stages'].items()})}")
        save_dir = Path(plan["out"], "rank0", f"script_{name}")
        if not lead["scripts"][name]["files"]:
            failed.append(f"{name}: the leader wrote nothing")
        video = lead["scripts"][name].get("video")
        frames = joined if name != "inference_alignment" else 2 * SCRIPT_FRAMES
        if not output.endswith("gen.mp4"):  # a joined video, which main returns
            if not video or video["shape"] != [frames, 384, 672, 3] or not video["finite"]:
                failed.append(f"{name}: the joined video {video}")
        mp4s = [save_dir / f"stage_{k:02d}" for k in range(2)] \
            if name == "inference_alignment" else [(save_dir / output).parent]
        for d in mp4s:
            if mp4_frame_counts(d) != save_scheme_counts(SCRIPT_FRAMES):
                failed.append(f"{name}: mp4 frame counts {mp4_frame_counts(d)} in {d}")
        if _mp4_frames(save_dir / output) != _mp4_frames(phase8 / f"script_{name}" / output):
            failed.append(f"{name}: {output} frame count against phase 8's")
        if name == "autoregressive_global":
            _check_scene(f"U {name}", save_dir / "scene", MAX_POINTS, joined)
        quality[name] = _quality(phase8 / f"script_{name}" / output, save_dir / output)
        log(f"run U's {name} {output} against phase 8's unsharded run (quality CLI, 35 dB "
            f"gate): {json.dumps(quality[name])}")
        if quality[name]["rc"] != 0 or not quality[name].get("pass"):
            failed.append(f"{name}: {output} against phase 8's: {quality[name]}")
    strips = lead["strips"]
    sums = {tuple(map(str, r["strips"]["checksum"])) for r in results}
    sound, fault = strips["sound"], strips["fault"]
    ratio = fault["band_rel_l2"] / max(sound["band_rel_l2"], 1e-30)
    log(f"run U's sharded strip decode of run S's latents {strips['shape']} under "
        f"{RUN_U_STRIP_MEMORY / 2**30:g} GiB (strips: sharded {strips['tiled'][0]}, unsharded "
        f"{strips['tiled'][1]}; {strips['blends']} blends, {strips['seam_rows']} seam rows): "
        f"{strips['seconds']:.2f} s; against the unsharded strip decode {json.dumps(sound)} "
        f"(limit {RUN_S_VAE_REL_TOL:g}); the first seam's blend rows dropped "
        f"{json.dumps(fault)}: {ratio:.1f}x the sound reading on the seam rows (limit "
        f"{RUN_S_VAE_FAULT_RATIO:g}x); every rank's video bit-equal: {len(sums) == 1}")
    if strips["tiled"] != [True, True] or len(sums) != 1 or \
            max(sound.values()) > RUN_S_VAE_REL_TOL or ratio < RUN_S_VAE_FAULT_RATIO:
        failed.append(f"the sharded strip decode: {json.dumps(strips)}")
    for r in results:
        log(f"  rank {r['rank']}: loaded the tree once in {r['load_s']:.2f} s, "
            f"{r['resident_gib']:.2f} GiB resident ({r['held_before_gib']:.2f} held before)")
    if failed:
        raise AssertionError(f"run U: {failed}")
    per_rank = [{k: sum(s["per_path"][p][k] for s in r["scripts"].values()
                        for p in ("depth", "denoise")) for k in KERNELS} for r in results]
    runs["U"] = {"per_path": {p: {k: sum(s["per_path"][p][k] for r in results
                                         for s in r["scripts"].values()) for k in KERNELS}
                              for p in ("depth", "denoise")},
                 "per_rank": {k: [pr[k] for pr in per_rank] for k in KERNELS}}
    return {"quality": quality, "strips": strips}


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


# the pinned host buffer the checkpoint tree's bytes pass through
TREE_STAGE_BYTES = 1 << 28
SAFETENSORS_DTYPES = {"torch.bfloat16": "BF16", "torch.float16": "F16", "torch.float32": "F32",
                      "torch.float64": "F64", "torch.int8": "I8", "torch.uint8": "U8",
                      "torch.int16": "I16", "torch.int32": "I32", "torch.int64": "I64",
                      "torch.bool": "BOOL"}


def _save(sd: dict, path: Path, name: str, stage) -> int:
    """Write ``sd`` (device tensors) as one safetensors file, its bytes: the
    format's header (its length, then the JSON of each key's dtype, shape
    and byte range, padded to 8 bytes), then each tensor's bytes, copied off
    the card through ``stage`` (a pinned uint8 buffer) and written straight
    to the file.  The library's serializer copies every tensor once more
    under the GIL (0.8 GB/s on the H100 machine's host, threads or not);
    the port's loader reads the files with the library."""
    import torch

    path.mkdir(parents=True, exist_ok=True)
    flat = {k: v.detach().contiguous().reshape(-1).view(torch.uint8) for k, v in sd.items()}
    header, offset = {}, 0
    for k, v in sd.items():
        n = flat[k].numel()
        header[k] = {"dtype": SAFETENSORS_DTYPES[str(v.dtype)], "shape": list(v.shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path / name, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head)
        for v in flat.values():
            for start in range(0, v.numel(), stage.numel()):
                n = min(stage.numel(), v.numel() - start)
                stage[:n].copy_(v[start:start + n])
                f.write(stage[:n].numpy())
    return offset


def write_checkpoint_tree(tc, root: Path) -> dict:
    """Write the random bundle's seeded weights (and a cut BLIP-2 seeded on
    the card) as an HF-layout tree under ``root``; return {"sums": {family:
    {key: checksum}} of what each loaded module must hold, "dit_keys",
    "damaged": {kind: transformer dir}}."""
    import functools
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
    save = functools.partial(_save, stage=torch.empty(TREE_STAGE_BYTES, dtype=torch.uint8,
                                                      pin_memory=True))
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
            written += save(part, path, name)

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
    written += save(body, d["dit"], "diffusion_pytorch_model-00001-of-00002.safetensors")
    written += save(head, d["dit"], "diffusion_pytorch_model-00002-of-00002.safetensors")
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
        save(shard, path, "diffusion_pytorch_model-00002-of-00002.safetensors")
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
    """The command line of run L and of phase 8's scripts on the tree: the
    smoke's without its prompt, with ``--mask`` and ``CUT_DEPTH_STEPS``
    Euler steps a depth window (5 before run S's sharded VAE took their
    seconds: the launches per UNet forward do not depend on it)."""
    d = tree["dirs"]
    argv = [a for a in MAIN_ARGV if a not in ("--prompt", "a scene")]
    return argv + [
        "--mask", "--depth_inference_steps", str(CUT_DEPTH_STEPS),
        "--exp_name", "smoke_checkpoints",
        "--model_name", str(d["vae"].parent), "--transformer_path",
        str(transformer_path or d["dit"]), "--unet_path", str(d["svd_unet"]),
        "--pre_train_path", str(d["svd_vae"].parent), "--blip_path", str(d["blip2"])]


def phase_checkpoints(tree: dict, runs: dict):
    """Load the written tree through the normal entry point and run it;
    returns the loaded bundle, which phase 8's scripts then run on."""
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

    # run L reads CUT_FRAMES frames (since PR 20, for the smoke's clock: 49
    # before), as run A9 does, which it is held against
    cfg = parse_config(_tree_argv(tree) + ["--video_length", str(CUT_FRAMES)])
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
    if not run["known_share"] < runs["A9"]["known_share"]:
        raise AssertionError(f"--mask known share {run['known_share']} is not below run A9's "
                             f"{runs['A9']['known_share']}")
    rel = np.abs(np.log(run["depth"] / runs["A9"]["depth"]))
    log(f"  --mask: known share {run['known_share']:.6f} against run A9's "
        f"{runs['A9']['known_share']:.6f}; depth against run A9's (the same UNet weights, "
        f"information): median |log ratio| {np.median(rel):.3e}, max {rel.max():.3e}")
    frame = seen["frame"]
    del tc, pipe, dit, loaded, captioner
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
    return models


# Phase 8's scripts on the tree, each once through ``main(argv)``, and run
# U's under run S's mesh: name -> (the script's own flags, its depth stages
# and diffusions at ``SCRIPT_FRAMES``, the output run U holds against phase
# 8's: the joined video, or the one diffusion's gen.mp4)
SCRIPT_RUNS = {
    "inference_autoregressive": (["--n_splits", "2", "--overlap_frames", "8",
                                  "--total_theta", "30"], 2, 2, "autoregressive.mp4"),
    "autoregressive_global": (["--n_splits", "2", "--overlap_frames", "8", "--total_theta", "30",
                               "--max_points", str(MAX_POINTS)], 2, 2,
                              "autoregressive_global.mp4"),
    "run_w_cam_poses": (["--source_cam", "00_00", "--target_cam", "00_01", "--smooth",
                         "--target_video", MAIN_ARGV[1]], 1, 1, "gen.mp4"),
    "inference_orbits": (["--test_run"], 1, 1, "left30/gen.mp4"),
    "inference_alignment": (["--n_splits", "2", "--total_theta", "30",
                             "--align_epochs", str(ALIGN_EPOCHS)], 0, 2,
                            "autoregressive_aligned.mp4"),
}


def script_argv(tree: dict, name: str) -> list:
    """The command line of a script of ``SCRIPT_RUNS`` on the tree, at
    ``SCRIPT_FRAMES``: the Panoptic calibration and the vitl ``.pth`` that
    phase 8 writes beside the tree."""
    root = tree["root"]
    extra = SCRIPT_RUNS[name][0]
    if name == "run_w_cam_poses":
        extra = extra + ["--calib_json", str(root / "calib.json")]
    if name == "inference_alignment":
        extra = extra + ["--vda_ckpt", str(root / "video_depth_anything_vitl.pth")]
    return _tree_argv(tree) + ["--exp_name", f"script_{name}", "--video_length",
                               str(SCRIPT_FRAMES)] + extra


@contextlib.contextmanager
def loaded_once(models=None):
    """Within the block every entry point that builds its models gets one
    bundle, and every one that stages a mesh one mesh (the scripts' tree
    reloads were cut for the smoke's clock): ``models`` where it is given
    (run L's, loaded from the tree), else the first bundle built in the
    block.  Yields {"bundle", "mesh", and once a bundle is built here,
    "load_s" and "resident_gib"}."""
    import torch

    from trajectorycrafter_tpu_torch import orchestrator

    build, stage_mesh = orchestrator.build_models, orchestrator.stage_mesh
    held = {} if models is None else {"bundle": models}

    def one_bundle(cfg, *args, **kwargs):
        if "bundle" not in held:
            t0 = time.perf_counter()
            held["bundle"] = build(cfg, *args, **kwargs)
            torch.cuda.synchronize()
            held.update(load_s=time.perf_counter() - t0,
                        resident_gib=torch.cuda.memory_allocated() / 2**30)
        return held["bundle"]

    def one_mesh(cfg):
        if "mesh" not in held:
            held["mesh"] = stage_mesh(cfg)
        return held["mesh"]

    orchestrator.build_models, orchestrator.stage_mesh = one_bundle, one_mesh
    try:
        yield held
    finally:
        orchestrator.build_models, orchestrator.stage_mesh = build, stage_mesh


def phase_scripts(tree: dict, runs: dict, models) -> None:
    """Each entry point of ``trajectorycrafter_tpu_torch/scripts/`` but the
    consistent-depth one once, through ``main(argv)`` (its real argument
    parsing), on run L's bundle of the written tree (the 6-layer DiT, BLIP-2
    captions, ``--mask``): the launches held to run L's per depth stage and
    per diffusion times the script's stages, the outputs counted.  The
    orbit runner catches a variant's failure as the root script does, so its
    mp4s and launches are what fails it."""
    import importlib

    import numpy as np

    per_l = runs["L"]["per_path"]
    frames = SCRIPT_FRAMES
    joined = 2 * (frames - 8) + 8
    root = tree["root"]
    # the Panoptic cameras at the clip's native 512 x 288 (the script scales
    # K to the warp size)
    calib = [{**c, "K": [[v / 2 for v in row] for row in c["K"][:2]] + [c["K"][2]]}
             for c in PANOPTIC_CAMERAS]
    (root / "calib.json").write_text(json.dumps({"cameras": calib}))
    for name, (extra, stages, _, _) in SCRIPT_RUNS.items():
        if name == "inference_alignment":
            continue
        module = importlib.import_module(f"trajectorycrafter_tpu_torch.scripts.{name}")
        argv = script_argv(tree, name)
        log(f"script {name}: python -m trajectorycrafter_tpu_torch.scripts.{name} "
            f"{' '.join(extra)} on the tree")
        with loaded_once(models):
            r = drive(f"script {name}", lambda: module.main(argv), models)
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
            video = save_dir / SCRIPT_RUNS[name][3]
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


def phase_alignment_script(tree: dict, runs: dict, models) -> None:
    """``scripts/inference_alignment.main(argv)`` on run L's bundle of the
    written tree with a vitl ``.pth`` written beside it (the seeded VDA of
    run M under the official keys): ``load_vda``'s key check on the card, 2
    segments of ``SCRIPT_FRAMES``, ``ALIGN_EPOCHS``; its launches held to two
    of run L's diffusions and no depth stage, its outputs counted.  First
    the same file under ``--vda_encoder vits`` must be refused before any
    model is built or any kernel launched.  The file stays for run U."""
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
    argv = script_argv(tree, "inference_alignment")
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
    with loaded_once(models):
        r = drive("script inference_alignment", lambda: inference_alignment.main(argv), models)
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
               or key.startswith(("depth_", "perceiver_", "d128_", "run_s_", "run_t_",
                                  "run_t5_"))}}


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
    run_phase("5r 576x1024", phase_sample_576, tc, dit8, runs)
    run_phase("5 quality CLI", phase_quality_cli)
    with cut_runs(tc.cfg):
        run_phase("5b modes", phase_modes, tc, dit8, runs)
        run_phase("5c tiled decode", phase_tiled_decode, tc.models.pipeline.vae)
        run_phase("5d consistent", phase_consistent, tc, dit8, runs)
    run_phase("6 whole models", phase_whole_models, tc, dit8, unet8)
    bench = run_phase("7 bench", phase_bench)

    import torch

    del dit8, unet8
    gc.collect()
    torch.cuda.empty_cache()
    t_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_run_t_"))  # run T1's samples and twin
    data_root = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_tree_"))  # run U reads it too
    try:
        # phase 5e: run P, LoRA training at full width, and run T1's twin
        step_launches = run_phase("5e training", phase_training, tc, data_root, t_dir)
        # phase 5f: run Q, feature probing at full width
        probe_launches = run_phase("5f probing", phase_probing, tc, data_root)
        # phase 8: write the random bundle's weights as a tree, free the
        # bundle, load the tree through the entry point
        tree = run_phase("8 tree write", write_checkpoint_tree, tc, root)
        del tc
        gc.collect()
        torch.cuda.empty_cache()
        models = run_phase("8 checkpoints", phase_checkpoints, tree, runs)
        run_phase("8 scripts", phase_scripts, tree, runs, models)
        run_phase("8 alignment script", phase_alignment_script, tree, runs, models)
        del models
        gc.collect()
        torch.cuda.empty_cache()
        run_phase("8 train script", phase_train_script, tree, str(data_root / "latents"))
        run_phase("8 probe script", phase_probe_script, tree, str(data_root / "latents"))
        shutil.rmtree(data_root, ignore_errors=True)
        # phase 5s: run S, the sharded denoise, then run T, sharded training
        # and GPipe, then run U, phase 8's scripts sharded, in one torchrun
        # world, once this process holds no model
        gc.collect()
        torch.cuda.empty_cache()
        log(f"before run S this process holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        run_phase("5s sharded, 5t and 5u", phase_sharded, runs, True, t_dir, tree)
    finally:
        for d in (t_dir, data_root, root):
            shutil.rmtree(d, ignore_errors=True)

    per_path = lambda kern: _launches_per_path(runs, kern)
    run_launches = lambda run, kern: _run_launches(runs, run, kern)
    depth = timing["depth"]
    sdpa = "flash SDPA"
    # K1 at the Perceiver's shape, at run R's two shapes and at the depth
    # UNet's 2,304-token level
    other_shapes = {f"{name}_{key}": timing[name][key]
                    for name in ("perceiver", "dit576", "perceiver576", "depth_2304",
                                 *run_s_depth_shapes())
                    for key in ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "sfu_ms")}
    kernels_line = [
        _attention_entry(
            "flash_attention", {**timing["dit"], "shape": "(2, 48, 13330, 13330, 64)",
                                "library": sdpa},
            also_replaces="trajectorycrafter_tpu/ops/attention.py:39",
            launches=run_launches("A", "flash_attention"), launches_run="A",
            launches_per_path=per_path("flash_attention"),
            launches_576=run_launches("R", "flash_attention"), probing_launches=probe_launches,
            launches_run_s=run_launches("S", "flash_attention"),
            launches_run_s_per_rank=runs["S"]["per_rank"]["flash_attention"],
            launches_run_t_per_rank=runs["T"]["per_rank"]["flash_attention"],
            launches_run_u_per_rank=runs["U"]["per_rank"]["flash_attention"],
            depth_launches_run_s_per_rank=runs["S"]["depth_per_rank"]["flash_attention"],
            probing_shape="(1, 48, 13330, 13330, 64); Perceiver (1, 16, 13104 x 3024, 128)",
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
        _attention_entry("flash_lse", variant_timing["flash_lse"],
                         launches=_run_launches(runs, "S", "flash_lse"),
                         launches_run="S (the ring's inner, all ranks)",
                         launches_run_s_per_rank=runs["S"]["per_rank"]["flash_lse"],
                         launches_run_t_per_rank=runs["T"]["per_rank"]["flash_lse"],
                         launches_run_u_per_rank=runs["U"]["per_rank"]["flash_lse"],
                         launches_per_path=per_path("flash_lse"),
                         bench_launches=bench["flash_lse"], max_abs_err=variant_err["flash_lse"]),
        *(_attention_entry(name, variant_timing[name], launches=bench[name],
                           launches_run="the attention bench", max_abs_err=variant_err[name])
          for name in ("flash_exp2", "int8_flash_attention")),
        _attention_entry("flash_pv8", variant_timing["flash_pv8"],
                         launches=run_launches("D", "flash_pv8"),
                         launches_run="D (attention_impl and TRAJCRAFTER_DEPTH_ATTN flash_pv8)",
                         launches_per_path=per_path("flash_pv8"),
                         bench_launches=bench["flash_pv8"], max_abs_err=variant_err["flash_pv8"]),
        *_backward_entries(backward_err, backward_timing, step_launches, runs["T"]["per_rank"]),
    ]
    print(json.dumps({"kernels": kernels_line}), flush=True)
    log(f"chip smoke: {time.perf_counter() - T_START:.1f} s; by phase {json.dumps(PHASE_SECONDS)}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--run-s-rank"]:
        after = lambda flag: sys.argv[sys.argv.index(flag) + 1] if flag in sys.argv else None
        run_s_rank(sys.argv[2], "--cut" in sys.argv[3:], after("--run-t"), after("--run-u"))
    elif sys.argv[1:2] == ["--run-t-rank"]:
        run_t_alone_rank(sys.argv[2], sys.argv[3])
    else:
        main()
