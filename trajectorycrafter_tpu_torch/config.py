"""Unified configuration of the PyTorch port.

The port's own copy of trajectorycrafter_tpu/config.py: the same dataclasses,
fields and defaults, so that one command line gives the same configuration
in both packages (tests/test_torch_cli.py holds them together).  Fields that
only the JAX package reads (``steps_per_dispatch``, ``offload``, the mesh
sizes of ``ParallelConfig``) are kept so the flag surface stays the same.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


@dataclass
class RenderConfig:
    """Camera / warping options (reference inference.py:37-68)."""

    radius_scale: float = 1.0
    camera: str = "traj"  # 'traj' | 'target'
    mode: str = "gradual"  # 'gradual' | 'direct' | 'bullet' | 'zoom'
    mask: bool = False  # clean (dilate) the disocclusion mask
    traj_txt: Optional[str] = None
    target_pose: Optional[Tuple[float, float, float, float, float]] = None
    near: float = 0.0001
    far: float = 10000.0
    anchor_idx: int = 0
    # intrinsics used by pose synthesis (reference demo.py:545-547)
    focal: float = 500.0
    cx: float = 512.0
    cy: float = 288.0


@dataclass
class DiffusionConfig:
    """Generative-core options (reference inference.py:70-132)."""

    model_name: str = "checkpoints/CogVideoX-Fun-V1.1-5b-InP"
    transformer_path: str = "checkpoints/TrajectoryCrafter"
    sampler_name: str = "DDIM_Origin"  # Euler|Euler A|DPM++|PNDM|DDIM_Cog|DDIM_Origin
    sample_size: Tuple[int, int] = (384, 672)  # (height, width)
    guidance_scale: float = 6.0
    num_inference_steps: int = 50
    prompt: Optional[str] = None
    negative_prompt: str = (
        "The video is not of a high quality, it has a low resolution. "
        "Watermark present in each frame. The background is solid. "
        "Strange body and strange trajectory. Distortion."
    )
    refine_prompt: str = (
        ". The video is of high quality, and the view is very clear. "
        "High quality, masterpiece, best quality, highres, ultra-detailed, "
        "fantastic."
    )
    blip_path: str = "checkpoints/blip2-opt-2.7b"
    noise_aug_strength: float = 0.0563
    # "int8" (the default): the DiT blocks' and Perceivers' GEMMs in int8
    # (ops/int8.py; weights per output channel, activations per token);
    # "none" (--quant none) keeps them bf16
    quant: str = "int8"
    # denoise steps per compiled program in the JAX package; the port runs
    # eagerly and does not read it
    steps_per_dispatch: int = 5
    use_dynamic_cfg: bool = False
    torch_rng_compat: bool = False  # draw initial latents with torch's RNG
    ref_frames: int = 10  # reference frames fed to the Perceiver branch


@dataclass
class DepthConfig:
    """DepthCrafter options (reference inference.py:134-170)."""

    unet_path: str = "checkpoints/DepthCrafter"
    pre_train_path: str = "checkpoints/stable-video-diffusion-img2vid"
    num_inference_steps: int = 5
    guidance_scale: float = 1.0
    window_size: int = 110
    overlap: int = 25
    max_res: int = 1024
    seed: int = 42
    # "int8": the UNet's transformer GEMMs in int8 (--quant_depth int8),
    # separate from diffusion.quant: depth drives all warp geometry
    quant: str = "none"


@dataclass
class ParallelConfig:
    """Device-mesh layout of the JAX package (read there, not by the port)."""

    dp: int = 1  # data axis (CFG pair / batch)
    sp: int = 1  # sequence axis (video tokens)
    tp: int = 1  # tensor axis (attention heads / mlp)
    # dtype policy
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = False  # rematerialize DiT blocks (training)


@dataclass
class TrajCrafterConfig:
    """Top-level config = general + render + diffusion + depth + parallel."""

    # general (reference inference.py:11-35)
    video_path: Optional[str] = None
    out_dir: str = "./experiments/"
    exp_name: Optional[str] = None
    save_dir: str = "./experiments/run"
    seed: int = 43
    video_length: int = 49
    fps: int = 10
    stride: int = 1
    # fixed processing resolution of the warp stage (reference models/utils.py:32)
    warp_size: Tuple[int, int] = (576, 1024)  # (height, width)
    # opt-in dev mode: permit randomly initialised models when checkpoints
    # are missing; off by default so a run against an incomplete model dir
    # fails with an actionable error
    allow_dev_stubs: bool = False
    # stage-wise host offload of the JAX package ("auto" | "stage" | "none");
    # the port keeps the whole bundle on the card and does not read it
    offload: str = "auto"

    render: RenderConfig = field(default_factory=RenderConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    depth: DepthConfig = field(default_factory=DepthConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def replace(self, **kw) -> "TrajCrafterConfig":
        return dataclasses.replace(self, **kw)


def flatten_overrides(cfg: TrajCrafterConfig, overrides: Sequence[str]) -> TrajCrafterConfig:
    """Apply ``section.key=value`` string overrides (e.g. from the CLI)."""
    for ov in overrides:
        key, _, raw = ov.partition("=")
        parts = key.split(".")
        obj = cfg
        for p in parts[:-1]:
            obj = getattr(obj, p)
        cur = getattr(obj, parts[-1])
        if isinstance(cur, bool):
            val = raw.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            val = int(raw)
        elif isinstance(cur, float):
            val = float(raw)
        elif isinstance(cur, (tuple, list)) and cur is not None:
            val = type(cur)(type(cur[0])(x) for x in raw.split(","))
        else:
            val = raw
        setattr(obj, parts[-1], val)
    return cfg
