"""End-to-end conditional video-diffusion pipeline.

Counterpart of trajectorycrafter_tpu/pipelines/trajcrafter.py
``TrajCrafterPipeline``: condition prep (VAE encodes of the reference clip
and the masked warped video, latent-space mask resize, noise aug), the CFG
denoise loop as a plain Python loop, and the VAE decode.  The CFG pair rides
the batch axis (uncond first, then cond).

Inputs are channel-last tensors on the pipeline's device: video
(B, F, H, W, 3) in [0, 1], mask_video (B, F, H, W, 1) in [0, 255] where 255
marks holes, reference (B, F_ref, H, W, 3) in [0, 1].
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel
from trajectorycrafter_tpu_torch.models.vae import (
    AutoencoderKLCogVideoX,
    posterior_mode,
    sample_posterior,
    vae_decode,
    vae_encode,
)
from trajectorycrafter_tpu_torch.ops.rope import rope_for_sample
from trajectorycrafter_tpu_torch.schedulers.ddim import DDIMScheduler
from trajectorycrafter_tpu_torch.utils.timing import StageTimer


def resize_mask_latent(mask: torch.Tensor, latent_shape: Tuple[int, int, int]) -> torch.Tensor:
    """(B, C, F, H, W) mask -> (B, C, f_lat, h_lat, w_lat): the first frame
    maps alone onto the first latent frame, the rest onto the rest
    (trilinear, align_corners=False)."""
    f_lat, h_lat, w_lat = latent_shape
    resize = lambda x, f: F.interpolate(x, size=(f, h_lat, w_lat), mode="trilinear",
                                        align_corners=False)
    first = resize(mask[:, :, :1], 1)
    if f_lat == 1:
        return first
    return torch.cat([first, resize(mask[:, :, 1:], f_lat - 1)], dim=2)


@dataclass
class TrajCrafterPipeline:
    vae: AutoencoderKLCogVideoX
    transformer: CrossTransformer3DModel
    scheduler: DDIMScheduler
    vae_scale_factor_spatial: int = 8
    vae_scale_factor_temporal: int = 4
    dtype: torch.dtype = torch.bfloat16
    timer: Optional[StageTimer] = None  # shared with the orchestrator's stages

    def __post_init__(self):
        if self.timer is None:
            self.timer = StageTimer(self.device)

    @property
    def device(self) -> torch.device:
        return self.transformer.proj_out.weight.device

    @property
    def _vae_dtype(self) -> torch.dtype:
        return self.vae.encoder.conv_in.conv.weight.dtype

    # ------------------------------------------------------------------
    @torch.no_grad()
    def prepare_conditions(
        self,
        video: torch.Tensor,
        mask_video: torch.Tensor,
        reference: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        noise_aug_strength: float = 0.0563,
        noise_override: Optional[Tuple] = None,
    ):
        """-> (inpaint_latents (B,F',h,w,1+C), ref_latents (B,Fr',h,w,C)).

        ``noise_override=(ref_noise, aug_noise)`` (channel-last) replaces the
        two gaussian draws; a 3-tuple (ref, video, aug) is also accepted.
        """
        lc = self.vae.latent_channels
        sf = self.vae.scaling_factor
        b, f, h, w, _ = video.shape
        if noise_override is None:
            f_ref = reference.shape[1]
            ref_shape = (b, (f_ref - 1) // 4 + 1, h // 8, w // 8, lc)
            ref_noise = torch.randn(ref_shape, generator=generator, device=video.device)
            aug_noise = torch.randn(video.shape, generator=generator, device=video.device)
        else:
            ref_noise, aug_noise = (x.to(video.device, torch.float32)
                                    for x in (noise_override[0], noise_override[-1]))
        f_lat, h_lat, w_lat = (f - 1) // 4 + 1, h // 8, w // 8

        # reference branch: VAE-encode the first frames, posterior sample
        ref = reference.float() * 2.0 - 1.0
        ref_moments = vae_encode(self.vae, ref.to(self._vae_dtype))
        ref_latents = sample_posterior(ref_moments.float(), lc, noise=ref_noise) * sf

        # inpaint branch; the mask binarises at 0.5 on its raw [0, 255] scale
        init_video = video.float() * 2.0 - 1.0
        mask01 = (mask_video.float() >= 0.5).float()
        masked_video = init_video * (mask01 < 0.5) + (-1.0) * (mask01 > 0.5)
        if self.transformer.add_noise_in_inpaint_model:
            noise = aug_noise * noise_aug_strength
            noise = torch.where(masked_video == -1.0, torch.zeros_like(noise), noise)
            masked_video = masked_video + noise
        mv_moments = vae_encode(self.vae, masked_video.to(self._vae_dtype))
        masked_video_latents = posterior_mode(mv_moments.float(), lc) * sf

        # latent-size mask: 1 - mask01 (known = 1)
        mask_latents = resize_mask_latent((1.0 - mask01).permute(0, 4, 1, 2, 3),
                                          (f_lat, h_lat, w_lat))
        mask_latents = mask_latents.permute(0, 2, 3, 4, 1) * sf
        inpaint_latents = torch.cat([mask_latents, masked_video_latents], dim=-1)
        return inpaint_latents.to(self.dtype), ref_latents.to(self.dtype)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def __call__(
        self,
        prompt_embeds: torch.Tensor,  # (B, 226, 4096)
        negative_prompt_embeds: torch.Tensor,
        video: torch.Tensor,
        mask_video: torch.Tensor,
        reference: torch.Tensor,
        num_inference_steps: int = 50,
        guidance_scale: float = 6.0,
        use_dynamic_cfg: bool = False,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        strength: float = 1.0,
        noise_aug_strength: float = 0.0563,
        output_type: str = "np",
        noise_override: Optional[Tuple] = None,
    ) -> torch.Tensor:
        """Full sampling run; returns (B, F, H, W, 3) video in [0, 1], or the
        final latents (B, F', h, w, C) with ``output_type="latent"``.

        ``strength`` < 1 is img2img: the first ``N - int(N * strength)``
        steps are skipped and the initial latents are the VAE-encoded warped
        video noised to the first kept timestep.  ``latents``, when given, is
        the initial noise draw.
        """
        b, f, h, w, _ = video.shape
        f_lat = (f - 1) // self.vae_scale_factor_temporal + 1
        h_lat = h // self.vae_scale_factor_spatial
        w_lat = w // self.vae_scale_factor_spatial
        device = self.device

        with self.timer("vae_encode"):
            inpaint_latents, ref_latents = self.prepare_conditions(
                video, mask_video, reference, generator, noise_aug_strength,
                noise_override=noise_override)

        if latents is None:
            latents = torch.randn((b, f_lat, h_lat, w_lat, self.vae.latent_channels),
                                  generator=generator, device=device)
        latents = latents.to(device, torch.float32)

        state = self.scheduler.set_timesteps(num_inference_steps)
        init_timestep = min(int(num_inference_steps * strength), num_inference_steps)
        if init_timestep == 0:
            raise ValueError(
                f"strength={strength} truncates every denoise step "
                f"(int({num_inference_steps} * {strength}) == 0); raise "
                "strength or num_inference_steps")
        t_start = num_inference_steps - init_timestep
        if t_start == 0:
            latents = latents * state.init_noise_sigma
        else:
            with self.timer("vae_encode"):
                if noise_override is not None and len(noise_override) == 3:
                    vid_noise = noise_override[1].to(device, torch.float32)
                else:
                    vid_noise = torch.randn(latents.shape, generator=generator, device=device)
                moments = vae_encode(self.vae, (video.float() * 2.0 - 1.0).to(self._vae_dtype))
                video_latents = sample_posterior(moments.float(), self.vae.latent_channels,
                                                 noise=vid_noise) * self.vae.scaling_factor
            latents = self.scheduler.add_noise(state, video_latents.float(), latents,
                                               int(state.timesteps[t_start]))
        # the conditioning videos are consumed: free them before the denoise
        video = mask_video = reference = None

        rope = None
        if self.transformer.use_rotary_positional_embeddings:
            cos, sin = rope_for_sample(self.transformer.attention_head_dim, h, w, f_lat,
                                       self.vae_scale_factor_spatial,
                                       self.transformer.patch_size)
            rope = (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))

        do_cfg = guidance_scale > 1.0
        if do_cfg:
            text = torch.cat([negative_prompt_embeds, prompt_embeds], dim=0)
            inpaint_in = torch.cat([inpaint_latents] * 2, dim=0)
            ref_in = torch.cat([ref_latents] * 2, dim=0)
        else:
            text, inpaint_in, ref_in = prompt_embeds, inpaint_latents, ref_latents
        text = text.to(device, self.dtype)

        with self.timer("denoise"):
            for i in range(t_start, num_inference_steps):
                lat_in = torch.cat([latents] * 2, dim=0) if do_cfg else latents
                t = int(state.timesteps[i])
                tvec = torch.full((lat_in.shape[0],), float(t), device=device)
                noise_pred = self.transformer(
                    lat_in.to(self.dtype), text, tvec, inpaint_latents=inpaint_in,
                    cross_latents=ref_in, image_rotary_emb=rope,
                ).float()
                if do_cfg:
                    uncond, cond = noise_pred.chunk(2, dim=0)
                    g = guidance_scale
                    if use_dynamic_cfg:  # cosine-power dynamic CFG
                        g = 1.0 + guidance_scale * (
                            (1.0 - math.cos(math.pi * ((num_inference_steps - t)
                                                       / num_inference_steps) ** 5.0)) / 2.0)
                    noise_pred = uncond + g * (cond - uncond)
                latents = self.scheduler.step(state, noise_pred, i, latents)

        if output_type == "latent":
            return latents
        with self.timer("vae_decode"):
            z = latents / self.vae.scaling_factor
            frames = vae_decode(self.vae, z.to(self._vae_dtype)).float()
            return (frames / 2.0 + 0.5).clamp(0.0, 1.0)
