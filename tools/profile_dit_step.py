#!/usr/bin/env python3
"""Profile one denoise step of the PyTorch port on a CUDA card.

    python3 tools/profile_dit_step.py                # from the root of a checkout
    python3 tools/profile_dit_step.py --quant int8   # the int8 DiT (unfused FF)
    python3 tools/profile_dit_step.py --quant int8 --fuse   # ... with the fused FF
    python3 tools/profile_dit_step.py --depth [--quant_depth int8]   # the depth stage
    python3 tools/profile_dit_step.py --train        # one LoRA training step

One step is one forward of the full-width CrossTransformer3D DiT (random
bf16 weights from seed 0, quantized by ``build_full_scale_models`` under
``--quant int8``, as the CLI builds it) on the CFG pair at the main path's shapes: 49
frames at 384x672 (13 latent frames, 13,330 joint tokens), 10 reference
frames for the Perceiver (3 latent frames, 3,024 tokens), RoPE on.  With
``--depth`` it is one forward of the DepthCrafter SVD UNet on the depth
stage's window: 49 frames of 72 x 128 latents (576x1024 frames), and the
depth stage's parts are timed first (CLIP embedding, VAE encode, the 5
Euler steps, the chunked VAE decode, each after a warm-up run of the whole
stage).  With ``--train`` it is one LoRA training step at the configuration
of chip_smoke.py's run P: the full-width bf16 DiT at B = 1 (13,330 joint
tokens), rank 8 adapters on its 316 target layers, ``remat``,
``flash_stock`` (K5 forward, the backward kernels K4-dkv and K4-dq),
AdamW, on a random batch of run P's latent shapes.  After two warm-up
forwards (steps) it times one unprofiled (host clock ending in a
synchronize), then one under ``torch.profiler``, and prints the device
time per kernel group (with the int8 GEMM groups' int8 operations, counted
by hooks on the int8 layers in the first warm-up forward, and their TOP/s;
a training step also the attention kernels' launches), the top kernels,
and the device's idle share (1 - summed kernel time / profiled wall time).
"""

import argparse
import contextlib
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

ARGV = ["--video_path", str(REPO / "test/videos/synth.mp4"), "--camera", "traj",
        "--traj_txt", str(REPO / "test/trajs/loop1.txt")]


def kernel_group(name: str) -> str:
    if "quantize_rows_kernel" in name:
        return "int8 row quantization"
    if "gelu_quant_kernel" in name:
        return "int8 FF1 GEMM + gelu + requant"
    if "int8_gemm_gscale_kernel" in name:
        return "int8 FF2 grouped GEMM"
    if "int8_gemm_kernel" in name:
        return "int8 GEMMs"
    if "pv8_kernel" in name:
        return "PV-int8 attention (K6)"
    if "flash_bwd::dkv_kernel" in name:
        return "attention backward dK/dV (K4-dkv)"
    if "flash_bwd::dq_kernel" in name:
        return "attention backward dQ (K4-dq)"
    # mode 1 is K5, the training forward (attention and its logsumexp)
    if "hopper_attn::attention_kernel<64, 1>" in name or \
            "hopper_attn::attention_kernel<128, 1>" in name:
        return "flash attention + lse (K5)"
    # hopper_attn::attention_kernel<head dim, mode>: mode 3 is the two-pass K4b
    if "hopper_attn::attention_kernel<64, 3>" in name:
        return "two-pass flash self-attention"
    if "hopper_attn::attention_kernel<64," in name:
        return "flash self-attention (d 64)"
    if "hopper_attn::attention_kernel<128," in name:
        return "flash Perceiver (d 128)"
    if any(key in name.lower() for key in ("conv", "fprop", "implicit")):
        return "convolutions (cuDNN)"
    if "nvjet" in name or "gemm" in name.lower() or "cutlass" in name.lower():
        return "bf16 GEMMs"
    if "layer_norm" in name:
        return "layer norm"
    if "reduce" in name.lower():
        return "reductions (group-norm statistics)"
    if "Cat" in name:
        return "concatenation"
    if "copy" in name:
        return "copies / casts"
    return "other elementwise"


def _synced_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def dit_step(models, cfg):
    """(label, forward) of one denoise step: the DiT on the CFG pair."""
    import torch

    from trajectorycrafter_tpu_torch.ops.rope import rope_for_sample

    dit = models.pipeline.transformer
    hs, ws = cfg.diffusion.sample_size
    b, f, h, w = 2, (cfg.video_length - 1) // 4 + 1, hs // 8, ws // 8
    f_ref = (cfg.diffusion.ref_frames - 1) // 4 + 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda").bfloat16()
    cos, sin = rope_for_sample(64, hs, ws, f)
    args = (randn(b, f, h, w, 16), randn(b, 226, 4096), torch.full((b,), 999.0, device="cuda"))
    kwargs = dict(inpaint_latents=randn(b, f, h, w, 17), cross_latents=randn(b, f_ref, h, w, 16),
                  image_rotary_emb=(torch.from_numpy(cos).cuda(), torch.from_numpy(sin).cuda()))
    label = (f"DiT forward on (B, F, H, W) = {(b, f, h, w)}, {f_ref} reference latent "
             "frames")
    return label, lambda: dit(*args, **kwargs)


def depth_step(models, cfg):
    """Time the depth stage's parts; (label, forward) of one Euler step: the
    SVD UNet on the 49-frame window."""
    import numpy as np
    import torch

    from trajectorycrafter_tpu_torch.models.svd_vae import (
        svd_decode_chunked,
        svd_encode_chunked,
    )

    demo = models.depth_infer.__self__
    pipe = demo.pipe
    f, (hh, ww) = cfg.video_length, cfg.warp_size
    frames = np.random.default_rng(0).uniform(0, 1, (f, hh, ww, 3)).astype(np.float32)
    first = _synced_ms(lambda: demo.infer(frames, cfg.render.near, cfg.render.far))
    whole = _synced_ms(lambda: demo.infer(frames, cfg.render.near, cfg.render.far))
    ft = torch.from_numpy(frames).cuda()
    state = pipe.scheduler.set_timesteps(cfg.depth.num_inference_steps)
    with torch.no_grad():
        parts = {"CLIP embedding": lambda: pipe.encode_image_embeddings(ft)}
        parts["VAE encode"] = lambda: svd_encode_chunked(pipe.vae, (ft * 2 - 1)[None].bfloat16())
        lat = torch.randn((f, hh // 8, ww // 8, 4), device="cuda")
        ctx = torch.randn((f, 1, 1024), device="cuda").bfloat16()
        parts[f"{cfg.depth.num_inference_steps} Euler steps"] = lambda: pipe._denoise_window(
            state, lat * state.init_noise_sigma, lat, ctx, cfg.depth.num_inference_steps, 1.0)
        parts["VAE decode (chunks of 4)"] = lambda: svd_decode_chunked(pipe.vae, lat[None].bfloat16())
        times = {name: _synced_ms(fn) for name, fn in parts.items()}
    print(f"depth stage, {f} frames at {hh}x{ww}: first call {first:.1f} ms, then {whole:.1f} ms; "
          + ", ".join(f"{name} {ms:.1f} ms" for name, ms in times.items()))
    args = (lat[None].repeat(1, 1, 1, 1, 2).bfloat16(), torch.full((1,), 1.6, device="cuda"),
            ctx[None], torch.tensor([[6.0, 127.0, 0.02]], device="cuda"))
    label = f"depth UNet forward on (B, F, h, w) = {(1, f, hh // 8, ww // 8)}"
    return label, lambda: pipe.unet(*args)


def train_step(models, cfg):
    """(label, step) of one LoRA training step at run P's configuration
    (chip_smoke.py phase 5e) on a random batch of its latent shapes."""
    import numpy as np
    import torch

    from chip_smoke import LATENT_SHAPES, TRAIN_DROPOUT, TRAIN_LR, TRAIN_RANK, set_impl
    from trajectorycrafter_tpu_torch.schedulers import CogVideoXDDIMScheduler
    from trajectorycrafter_tpu_torch.training import TrainState, init_lora_params, make_train_step
    from trajectorycrafter_tpu_torch.training.step import make_optimizer

    dit = models.pipeline.transformer
    dit.remat = True
    set_impl(dit, "flash_stock")
    gen = torch.Generator(device="cuda").manual_seed(0)
    lora = init_lora_params(gen, dit, rank=TRAIN_RANK)
    scheduler = CogVideoXDDIMScheduler()
    opt = make_optimizer(lr=TRAIN_LR)
    step_fn = make_train_step(dit, scheduler, scheduler.set_timesteps(50), opt,
                              cfg_dropout_prob=TRAIN_DROPOUT, lora_rank=TRAIN_RANK)
    state = [TrainState(lora, opt.init(lora), 0)]
    rng = np.random.default_rng(0)
    batch = {key: rng.standard_normal((1, *shape)).astype(np.float32)
             for key, shape in LATENT_SHAPES.items()}

    def step():
        state[0], _ = step_fn(state[0], batch, gen)

    f, h, w, _ = LATENT_SHAPES["gt_latents"]
    label = (f"LoRA training step of the bf16 DiT on (B, F, H, W) = {(1, f, h, w)}, rank "
             f"{TRAIN_RANK}, remat, flash_stock")
    return label, step


def int8_ops(model, forward) -> dict:
    """{kernel group: int8 operations} of one ``forward``, counted by forward
    hooks on ``model``'s int8 layers (2 M K N per GEMM): an ``Int8Linear``
    runs one ``int8_gemm``; a fused feed-forward runs the gelu-quant GEMM and
    the grouped GEMM in place of its two layers."""
    import torch

    from trajectorycrafter_tpu_torch.models.dit import FeedForward
    from trajectorycrafter_tpu_torch.ops.int8 import Int8Linear

    ops = defaultdict(float)

    def rows(x):
        return x.numel() // x.shape[-1]

    def linear(mod, inputs, out):
        ops["int8 GEMMs"] += 2.0 * rows(inputs[0]) * mod.weight_q.numel()

    def fused_ff(mod, inputs, out):
        if mod.fuse and isinstance(mod.net[0].proj, Int8Linear):
            ops["int8 FF1 GEMM + gelu + requant"] += 2.0 * rows(inputs[0]) * \
                mod.net[0].proj.weight_q.numel()
            ops["int8 FF2 grouped GEMM"] += 2.0 * rows(inputs[0]) * mod.net[2].weight_q.numel()

    hooks = [m.register_forward_hook(linear) for m in model.modules() if isinstance(m, Int8Linear)]
    hooks += [m.register_forward_hook(fused_ff) for m in model.modules()
              if isinstance(m, FeedForward)]
    try:
        with torch.no_grad():
            forward()
    finally:
        for hook in hooks:
            hook.remove()
    return ops


def main() -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from trajectorycrafter_tpu_torch.cli import parse_config
    from trajectorycrafter_tpu_torch.orchestrator import build_full_scale_models

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--depth", action="store_true", help="profile the depth stage's step")
    parser.add_argument("--quant", choices=("none", "int8"), default="none")
    parser.add_argument("--quant_depth", choices=("none", "int8"), default="none")
    parser.add_argument("--fuse", action="store_true",
                        help="the int8 DiT's fused feed-forward (int8_ff_apply)")
    parser.add_argument("--train", action="store_true",
                        help="profile one LoRA training step of the bf16 DiT (run P)")
    args = parser.parse_args()
    if args.train and (args.depth or args.quant != "none"):
        parser.error("--train profiles the bf16 DiT: no --depth, --quant none")
    if not torch.cuda.is_available():
        raise SystemExit("profile_dit_step: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cfg = parse_config(ARGV + ["--quant", args.quant, "--quant_depth", args.quant_depth])
    models = build_full_scale_models(cfg, "cuda")
    for block in models.pipeline.transformer.transformer_blocks:
        block.ff.fuse = args.fuse or None
    if args.train:
        label, forward = train_step(models, cfg)
        forward()  # the first warm-up step
        ops, grad_mode = {}, contextlib.nullcontext
    else:
        label, forward = (depth_step if args.depth else dit_step)(models, cfg)
        label += f", --quant {args.quant}{' (fused FF)' if args.fuse else ''}, --quant_depth " \
                 f"{args.quant_depth}"
        model = models.depth_infer.__self__.pipe.unet if args.depth else models.pipeline.transformer
        ops = int8_ops(model, forward)  # also the first warm-up forward
        grad_mode = torch.no_grad

    from trajectorycrafter_tpu_torch.ops import kernels as kern
    counted = (kern.flash_lse, kern.flash_attention_bwd_dkv, kern.flash_attention_bwd_dq)
    with grad_mode():
        _synced_ms(forward)
        wall = _synced_ms(forward)
        before = [fn.launches for fn in counted]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled_wall = _synced_ms(forward)
    print(f"{label}: {wall:.1f} ms unprofiled, {profiled_wall:.1f} ms profiled")
    if args.train:
        print("launches in the profiled step: " + ", ".join(
            f"{fn.__name__} {fn.launches - n}" for fn, n in zip(counted, before)))

    kernels = defaultdict(lambda: [0.0, 0])  # name -> [device us, launches]
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            kernels[event.name][0] += event.device_time_total
            kernels[event.name][1] += 1
    total_us = sum(t for t, _ in kernels.values())
    print(f"kernel time {total_us / 1e3:.1f} ms in {sum(n for _, n in kernels.values())} "
          f"launches; device idle share {1 - total_us / 1e3 / profiled_wall:.3f}")
    groups = defaultdict(lambda: [0.0, 0])
    for name, (t, n) in kernels.items():
        groups[kernel_group(name)][0] += t
        groups[kernel_group(name)][1] += n
    for group, (t, n) in sorted(groups.items(), key=lambda x: -x[1][0]):
        rate = f"  {ops[group] / 1e12:.1f} T int8 operations, {ops[group] / t / 1e6:.0f} TOP/s" \
            if ops.get(group) else ""
        print(f"{group:36s} {t / 1e3:9.2f} ms {100 * t / total_us:5.1f}%  x{n}{rate}")
    print("top kernels:")
    for name, (t, n) in sorted(kernels.items(), key=lambda x: -x[1][0])[:15]:
        print(f"{t / 1e3:9.2f} ms {100 * t / total_us:5.1f}%  x{n:5d}  {name[:100]}")


if __name__ == "__main__":
    main()
