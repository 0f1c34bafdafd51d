#!/usr/bin/env python3
"""Profile one denoise step of the PyTorch port on a CUDA card.

    python3 tools/profile_dit_step.py        # from the root of a checkout

One step is one forward of the full-width CrossTransformer3D DiT (random
bf16 weights from seed 0) on the CFG pair at the main path's shapes: 49
frames at 384x672 (13 latent frames, 13,330 joint tokens), 10 reference
frames for the Perceiver (3 latent frames, 3,024 tokens), RoPE on.  After two
warm-up forwards it times one forward unprofiled (host clock ending in a
synchronize), then one under ``torch.profiler``, and prints the device time
per kernel group, the top kernels, and the device's idle share (1 - summed
kernel time / profiled wall time).
"""

import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

ARGV = ["--video_path", str(REPO / "test/videos/synth.mp4"), "--camera", "traj",
        "--traj_txt", str(REPO / "test/trajs/loop1.txt"), "--quant", "none"]


def kernel_group(name: str) -> str:
    if "flash_attention_kernel<64>" in name:
        return "flash self-attention (d 64)"
    if "flash_attention_kernel<128>" in name:
        return "flash Perceiver (d 128)"
    if "nvjet" in name or "gemm" in name.lower() or "cutlass" in name.lower():
        return "bf16 GEMMs"
    if "layer_norm" in name:
        return "layer norm"
    if "Cat" in name:
        return "concatenation"
    if "copy" in name:
        return "copies / casts"
    return "other elementwise"


def main() -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from trajectorycrafter_tpu_torch.cli import parse_config
    from trajectorycrafter_tpu_torch.ops.rope import rope_for_sample
    from trajectorycrafter_tpu_torch.orchestrator import build_full_scale_models

    if not torch.cuda.is_available():
        raise SystemExit("profile_dit_step: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cfg = parse_config(ARGV)
    dit = build_full_scale_models(cfg, "cuda").pipeline.transformer
    hs, ws = cfg.diffusion.sample_size
    b, f, h, w = 2, (cfg.video_length - 1) // 4 + 1, hs // 8, ws // 8
    f_ref = (cfg.diffusion.ref_frames - 1) // 4 + 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda").bfloat16()
    cos, sin = rope_for_sample(64, hs, ws, f)
    args = (randn(b, f, h, w, 16), randn(b, 226, 4096), torch.full((b,), 999.0, device="cuda"))
    kwargs = dict(inpaint_latents=randn(b, f, h, w, 17), cross_latents=randn(b, f_ref, h, w, 16),
                  image_rotary_emb=(torch.from_numpy(cos).cuda(), torch.from_numpy(sin).cuda()))

    def step() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dit(*args, **kwargs)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    with torch.no_grad():
        step(), step()
        wall = step()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled_wall = step()
    print(f"DiT forward on (B, F, H, W) = {(b, f, h, w)}, {f_ref} reference latent frames: "
          f"{wall:.1f} ms unprofiled, {profiled_wall:.1f} ms profiled")

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
        print(f"{group:28s} {t / 1e3:9.2f} ms {100 * t / total_us:5.1f}%  x{n}")
    print("top kernels:")
    for name, (t, n) in sorted(kernels.items(), key=lambda x: -x[1][0])[:15]:
        print(f"{t / 1e3:9.2f} ms {100 * t / total_us:5.1f}%  x{n:5d}  {name[:100]}")


if __name__ == "__main__":
    main()
