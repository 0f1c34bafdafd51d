"""TrajCrafter orchestrator for the PyTorch port: the gradual mode end to end.

Counterpart of trajectorycrafter_tpu/orchestrator.py.  ``infer_gradual``
reads the frames, estimates depth, synthesises the poses, forward-splats the
frames into the new camera on the device, resizes the warp outputs there,
runs the diffusion pipeline and writes the five mp4s (input, render, mask,
gen, viz).  The other three modes are not ported yet.

Checkpoint loading is not ported yet either: without weights, and only with
``--allow_dev_stubs``, the models are randomly initialised from a seed, with
the stand-ins the JAX package uses when checkpoints are missing -- a
plane-depth stub for DepthCrafter and seeded gaussian prompt embeddings for
T5-XXL.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import Callable, Optional

import cv2
import numpy as np
import torch
import torch.nn.functional as F

from trajectorycrafter_tpu.config import TrajCrafterConfig
from trajectorycrafter_tpu.utils.video import (
    VideoSaveQueue,
    pad_to_length,
    read_video_frames,
    save_video,
)
from trajectorycrafter_tpu_torch.geometry.cameras import (
    default_c2w,
    intrinsics_matrix,
    pose_radius_from_depth,
)
from trajectorycrafter_tpu_torch.geometry.trajectory import (
    generate_traj_specified,
    generate_traj_txt,
    load_traj_txt,
)
from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel
from trajectorycrafter_tpu_torch.models.vae import AutoencoderKLCogVideoX
from trajectorycrafter_tpu_torch.ops.splat import forward_warp_batch
from trajectorycrafter_tpu_torch.pipelines.trajcrafter import TrajCrafterPipeline
from trajectorycrafter_tpu_torch.schedulers.ddim import DDIMScheduler
from trajectorycrafter_tpu_torch.utils.timing import StageTimer

# deployed widths: T5-XXL prompt embeddings (tokens, channels)
T5_TEXT_LEN, T5_TEXT_DIM = 226, 4096


@dataclass
class ModelBundle:
    pipeline: TrajCrafterPipeline
    depth_infer: Callable  # (frames, near, far, steps, gs, window, overlap) -> (F,1,H,W)
    encode_prompt: Callable  # (prompt, negative) -> (pe, ne) each (1, L, D) on the device
    get_caption: Callable  # (frame_hw3) -> str


# ----------------------------------------------------------------------------
# model construction
# ----------------------------------------------------------------------------


def _pseudo_text_embeds(prompt: str, length: int, dim: int, device) -> torch.Tensor:
    """Stand-in embeddings when no T5 checkpoint is present: each prompt maps
    to gaussian token embeddings drawn from a generator seeded by its sha256."""
    seed = int.from_bytes(hashlib.sha256(prompt.encode()).digest()[:4], "little")
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((1, length, dim), generator=gen, device=device)


def _plane_depth_infer(frames, near, far, *a, **kw):
    """Constant-plane depth stub used when no DepthCrafter weights exist."""
    f, h, w = frames.shape[:3]
    yy = np.mgrid[0:h, 0:w][0]
    depth = (2.0 + 2.0 * yy / h).astype(np.float32)
    return np.tile(depth[None, None], (f, 1, 1, 1))


def check_supported(cfg: TrajCrafterConfig) -> None:
    """Raise for a configuration the port does not run yet."""
    if cfg.diffusion.quant != "none":
        raise NotImplementedError(
            f"--quant {cfg.diffusion.quant} is not ported yet (ROADMAP queue 1 item 10, "
            "the int8 DiT path); run with --quant none (bf16)")
    if cfg.diffusion.sampler_name != "DDIM_Origin":
        raise NotImplementedError(
            f"sampler {cfg.diffusion.sampler_name!r} is not ported yet (ROADMAP queue 1 "
            "item 9); DDIM_Origin is")


@torch.no_grad()
def random_init_(module: torch.nn.Module, seed: int, std: float = 0.02) -> torch.nn.Module:
    """Fill every parameter with N(0, std^2) from one generator seeded with
    ``seed`` on the module's device, in parameter order (as the JAX bench's
    synthetic weights)."""
    device = next(module.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    for p in module.parameters():
        p.normal_(0.0, std, generator=gen)
    return module


def _on_device(make: Callable[[], torch.nn.Module], device, dtype) -> torch.nn.Module:
    """Construct without allocating, then allocate once on ``device`` in ``dtype``."""
    with torch.device("meta"):
        module = make()
    return module.to(dtype=dtype).to_empty(device=device).eval()


def _bundle(cfg, pipeline, text_len, text_dim) -> ModelBundle:
    device = pipeline.device

    def encode_prompt(prompt, negative):
        return (_pseudo_text_embeds(prompt or "", text_len, text_dim, device),
                _pseudo_text_embeds(negative or "", text_len, text_dim, device))

    return ModelBundle(
        pipeline=pipeline,
        depth_infer=_plane_depth_infer,
        encode_prompt=encode_prompt,
        get_caption=lambda frame: cfg.diffusion.prompt or "a video",
    )


def build_dev_models(cfg: TrajCrafterConfig, device="cpu", seed: int = 0) -> ModelBundle:
    """Randomly initialised tiny stack (the JAX package's dev widths), fp32."""
    check_supported(cfg)
    lc, text_len, text_dim = 4, 16, 64
    vae = _on_device(lambda: AutoencoderKLCogVideoX(
        latent_channels=lc, block_out_channels=(8, 16, 16, 32), layers_per_block=1,
        norm_num_groups=4), device, torch.float32)
    dit = _on_device(lambda: CrossTransformer3DModel(
        num_attention_heads=4, attention_head_dim=16, in_channels=2 * lc + 1,
        out_channels=lc, time_embed_dim=32, text_embed_dim=text_dim, num_layers=4,
        max_text_seq_length=text_len, cross_attn_dim_head=16, cross_attn_num_heads=4),
        device, torch.float32)
    pipeline = TrajCrafterPipeline(
        vae=random_init_(vae, seed), transformer=random_init_(dit, seed + 1),
        scheduler=DDIMScheduler(), dtype=torch.float32)
    return _bundle(cfg, pipeline, text_len, text_dim)


def build_full_scale_models(cfg: TrajCrafterConfig, device="cuda", seed: int = 0) -> ModelBundle:
    """The diffusion stack at its deployed widths, bf16, randomly initialised
    straight on ``device``: the CrossTransformer3D DiT (48 heads x 64, 42
    layers, text 226 x 4096, Perceiver 16 x 128 every 2 blocks) and the
    CogVideoX VAE ((128, 256, 256, 512), 3 layers per block, 16 latent
    channels), DDIM_Origin, the plane-depth stand-in and pseudo prompt
    embeddings at T5-XXL's width."""
    check_supported(cfg)
    dtype = torch.bfloat16
    vae = _on_device(lambda: AutoencoderKLCogVideoX(), device, dtype)
    dit = _on_device(lambda: CrossTransformer3DModel(
        num_attention_heads=48, attention_head_dim=64, num_layers=42,
        max_text_seq_length=T5_TEXT_LEN, text_embed_dim=T5_TEXT_DIM,
        cross_attn_interval=2, cross_attn_dim_head=128, cross_attn_num_heads=16,
        use_rotary_positional_embeddings=True), device, dtype)
    pipeline = TrajCrafterPipeline(
        vae=random_init_(vae, seed), transformer=random_init_(dit, seed + 1),
        scheduler=DDIMScheduler(), dtype=dtype)
    return _bundle(cfg, pipeline, T5_TEXT_LEN, T5_TEXT_DIM)


def build_models(cfg: TrajCrafterConfig) -> ModelBundle:
    """Checkpoint loading is not ported yet, so a model dir that exists is an
    error; without one, only ``--allow_dev_stubs`` builds random models at
    the deployed widths, on the CUDA card."""
    model_dir = cfg.diffusion.model_name
    if os.path.isdir(model_dir):
        raise NotImplementedError(
            f"checkpoints found at '{model_dir}', but checkpoint loading is not ported "
            "yet (ROADMAP queue 1 item 9)")
    if not cfg.allow_dev_stubs:
        raise FileNotFoundError(
            f"model checkpoints not found at '{model_dir}'; pass --allow_dev_stubs to "
            "run randomly initialised models with the depth and prompt stand-ins")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: the deployed-width models are "
                           "built on the card (build_dev_models makes the tiny CPU stack)")
    print(f"[trajcrafter-torch] checkpoints not found at {model_dir}; building "
          "randomly initialised models on cuda (--allow_dev_stubs)")
    return build_full_scale_models(cfg, "cuda")


# ----------------------------------------------------------------------------
# orchestration
# ----------------------------------------------------------------------------


class TrajCrafter:
    def __init__(self, cfg: TrajCrafterConfig, models: Optional[ModelBundle] = None):
        self.cfg = cfg
        self.models = models if models is not None else build_models(cfg)
        self.device = self.models.pipeline.device
        self.timer: StageTimer = self.models.pipeline.timer

    # -- pose synthesis --------------------------------------------------
    def get_poses(self, depths: np.ndarray, num_frames: int):
        """-> (pose_s, pose_t (n, 4, 4), K (n, 3, 3)), float32 on the host."""
        cfg = self.cfg
        radius = pose_radius_from_depth(depths[0, 0], cfg.render.radius_scale)
        K = intrinsics_matrix(cfg.render.focal, cfg.render.cx, cfg.render.cy)
        K = K[None].repeat(num_frames, 1, 1)
        c2w0 = default_c2w()
        if cfg.render.camera == "target":
            dtheta, dphi, dr, dx, dy = cfg.render.target_pose
            poses = generate_traj_specified(c2w0, dtheta, dphi, dr * radius, dx, dy, num_frames)
        elif cfg.render.camera == "traj":
            theta, phi, r = load_traj_txt(cfg.render.traj_txt)
            poses = generate_traj_txt(c2w0, phi, theta, [x * radius for x in r], num_frames)
        else:
            raise ValueError(cfg.render.camera)
        poses[:, 2, 3] += radius
        anchor = cfg.render.anchor_idx
        pose_s = poses[anchor:anchor + 1].repeat(num_frames, 1, 1)
        return pose_s, poses, K

    # -- shared stages -----------------------------------------------------
    def _load_frames(self):
        cfg = self.cfg
        frames = read_video_frames(cfg.video_path, cfg.video_length, cfg.stride,
                                   cfg.depth.max_res, width=cfg.warp_size[1],
                                   height=cfg.warp_size[0])
        return pad_to_length(frames, cfg.video_length)

    def _estimate_depth(self, frames):
        cfg = self.cfg
        return np.asarray(self.models.depth_infer(
            frames, cfg.render.near, cfg.render.far, cfg.depth.num_inference_steps,
            cfg.depth.guidance_scale, window_size=cfg.depth.window_size,
            overlap=cfg.depth.overlap))

    def _device_frames_pm1(self, frames: np.ndarray) -> torch.Tensor:
        """Frames to the device as uint8 (lossless: they were decoded from
        8-bit video), expanded to [-1, 1] there."""
        u8 = np.round(np.asarray(frames, np.float32) * 255.0).astype(np.uint8)
        return torch.from_numpy(u8).to(self.device).float() / 127.5 - 1.0

    def _fetch_cond(self, warped: torch.Tensor, masks: torch.Tensor):
        """Resize the warp outputs to sample_size on the device (bilinear,
        half-pixel; nearest for the mask) and fetch them as uint8."""
        size = tuple(self.cfg.diffusion.sample_size)
        w01 = ((warped + 1.0) * 0.5).clamp(0.0, 1.0).permute(0, 3, 1, 2)
        w_s = F.interpolate(w01, size=size, mode="bilinear", align_corners=False)
        m_s = F.interpolate(masks[:, None].float(), size=size, mode="nearest")[:, 0]
        to_u8 = lambda x: torch.round(x.clamp(0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
        return (to_u8(w_s.permute(0, 2, 3, 1)).astype(np.float32) / 255.0,
                to_u8(m_s).astype(np.float32) / 255.0)

    def _initial_latents(self, f: int) -> Optional[torch.Tensor]:
        """--torch_rng_compat: the reference's initial draw, torch.randn in
        (B, F, C, h, w) from a CPU generator at --seed, made channel-last."""
        cfg = self.cfg
        if not cfg.diffusion.torch_rng_compat:
            return None
        hs, ws = cfg.diffusion.sample_size
        shape = (1, (f - 1) // 4 + 1, self.models.pipeline.vae.latent_channels, hs // 8, ws // 8)
        gen = torch.Generator(device="cpu").manual_seed(cfg.seed)
        return torch.randn(shape, generator=gen).permute(0, 1, 3, 4, 2)

    def _diffuse_and_save(self, frames, cond_video, cond_masks, prompt,
                          ref_slice=slice(0, None)):
        """Resize the frames to sample_size, save input/render/mask, run the
        diffusion pipeline, save gen and viz.

        frames: (F, H, W, 3) in [0, 1] at the warp size; cond_video
        (F, hs, ws, 3) and cond_masks (F, hs, ws) already at sample_size.
        """
        cfg = self.cfg
        hs, ws = cfg.diffusion.sample_size
        device = self.device
        frames_s = np.stack([cv2.resize(np.asarray(fr, np.float32), (ws, hs),
                                        interpolation=cv2.INTER_LINEAR) for fr in frames])
        os.makedirs(cfg.save_dir, exist_ok=True)
        # the condition mp4s encode on background threads during diffusion
        saves = VideoSaveQueue()
        saves.save(frames_s, os.path.join(cfg.save_dir, "input.mp4"), fps=cfg.fps)
        saves.save(cond_video, os.path.join(cfg.save_dir, "render.mp4"), fps=cfg.fps)
        saves.save(np.repeat(cond_masks[..., None], 3, -1),
                   os.path.join(cfg.save_dir, "mask.mp4"), fps=cfg.fps)

        with self.timer("prompt_encode"):
            pe, ne = self.models.encode_prompt(prompt, cfg.diffusion.negative_prompt)
        ref = torch.from_numpy(frames_s[ref_slice][None]).to(device)
        mask_video = torch.from_numpy((1.0 - cond_masks)[None, ..., None] * 255.0).to(device)
        sample = self.models.pipeline(
            pe, ne, torch.from_numpy(cond_video[None]).to(device), mask_video, ref,
            num_inference_steps=cfg.diffusion.num_inference_steps,
            guidance_scale=cfg.diffusion.guidance_scale,
            use_dynamic_cfg=cfg.diffusion.use_dynamic_cfg,
            generator=torch.Generator(device=device).manual_seed(cfg.seed),
            latents=self._initial_latents(frames.shape[0]),
            noise_aug_strength=cfg.diffusion.noise_aug_strength,
        )
        with self.timer("write_mp4"):
            # fetch as uint8: the mp4 stores 8 bits anyway
            gen = torch.round(sample[0].clamp(0.0, 1.0) * 255.0).to(torch.uint8)
            gen = gen.cpu().numpy().astype(np.float32) / 255.0
            saves.join()
            save_video(gen, os.path.join(cfg.save_dir, "gen.mp4"), fps=cfg.fps)
            # side-by-side viz with a boomerang reverse
            gap = np.ones((frames_s.shape[0], hs, 30, 3), np.float32)
            viz = np.concatenate([frames_s, gap, gen], axis=2)
            viz = np.concatenate([viz, viz[::-1][1:]], axis=0)
            save_video(viz, os.path.join(cfg.save_dir, "viz.mp4"), fps=cfg.fps * 2)
        return gen

    # -- the modes -----------------------------------------------------------
    def infer_gradual(self):
        cfg = self.cfg
        with self.timer("read_frames"):
            frames = self._load_frames()
        prompt = self.models.get_caption(frames[cfg.video_length // 2]) + \
            cfg.diffusion.refine_prompt
        with self.timer("depth"):
            depths = self._estimate_depth(frames)
        with self.timer("poses"):
            pose_s, pose_t, K = self.get_poses(depths, cfg.video_length)
        with self.timer("warp"):
            to_dev = lambda x: x.to(self.device)
            warped, masks, _, _ = forward_warp_batch(
                self._device_frames_pm1(frames), to_dev(torch.from_numpy(depths[:, 0])),
                to_dev(pose_s), to_dev(pose_t), to_dev(K), use_mask_clean=cfg.render.mask)
            cond_s, masks_s = self._fetch_cond(warped, masks)
            warped = masks = None
        return self._diffuse_and_save(frames, cond_s, masks_s, prompt,
                                      ref_slice=slice(0, cfg.diffusion.ref_frames))

    def infer_direct(self):
        raise NotImplementedError("--mode direct is not ported yet (ROADMAP queue 1 item 9)")

    def infer_bullet(self):
        raise NotImplementedError("--mode bullet is not ported yet (ROADMAP queue 1 item 9)")

    def infer_zoom(self):
        raise NotImplementedError("--mode zoom is not ported yet (ROADMAP queue 1 item 9)")
