"""DepthCrafter windowed video-depth pipeline, in PyTorch.

Counterpart of trajectorycrafter_tpu/pipelines/depth.py:
  * per-frame CLIP image embeddings (frames resized to 224x224, half-pixel
    bilinear, OpenAI normalisation) and per-frame SVD VAE conditioning
    latents (the un-scaled posterior mean);
  * Euler (continuous Karras sigmas, v-prediction, the SVD configuration)
    denoising of each temporal window (110 frames, overlap 25, by default),
    with SVD-style CFG when ``guidance_scale > 1`` (zeroed CLIP embeddings
    and conditioning latents in the unconditional branch);
  * the public DepthCrafter chaining of windows: a later window's overlap
    latents start from the running result re-noised to the first sigma,
    and each finished window is blended in with a 0 -> 1 linear ramp over
    the overlap;
  * the frame-chunked temporal VAE decode, then the reference's
    post-processing (channel mean, min-max normalise, x3900, 10000 / d,
    clip to [near, far]).

The denoise loop is a plain Python loop.  Each window's initial noise is
drawn from a ``torch.Generator`` on the pipeline's device; the
``window_noises`` and ``image_embeddings`` overrides let a test share them
with the JAX pipeline.  The running latents are updated in place.

``with_mesh`` (JAX ``with_mesh``) shards the stage over a dp x sp x tp mesh
(parallel/frames.py), every rank holding the models: the CLIP embed and the
SVD encode each take the rank's whole frames of the clip (dealt over every
rank, the leader fewest) and one ``all_gather`` joins them; every rank draws
each window's whole noise from the same generator, denoises its slab of the
window (its frames on dp, its latent rows on sp, on the UNet's sharded twin)
and joins the window's latents over the plane, so the chaining runs on whole
latents, the same on every rank; the decode deals whole chunks (the
unsharded chunk boundaries) to the ranks in the same way, and the raw
disparity is joined whole.  Every rank returns the whole disparity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from trajectorycrafter_tpu_torch.models.clip import (
    CLIP_IMAGE_MEAN,
    CLIP_IMAGE_STD,
    CLIPVisionModelWithProjection,
)
from trajectorycrafter_tpu_torch.models.depthcrafter import UNetSpatioTemporalConditionModel
from trajectorycrafter_tpu_torch.models.svd_vae import (
    AutoencoderKLTemporalDecoder,
    decode_chunk,
    svd_decode_chunked,
    svd_encode_chunked,
)
from trajectorycrafter_tpu_torch.ops.resize import resize_linear
from trajectorycrafter_tpu_torch.parallel import frames as FR
from trajectorycrafter_tpu_torch.parallel.spatial import shard_spatially
from trajectorycrafter_tpu_torch.schedulers.euler import EulerDiscreteScheduler, EulerState

ADDED_TIME_IDS = (6.0, 127.0, 0.02)  # fps, motion bucket, noise aug


def svd_euler_scheduler() -> EulerDiscreteScheduler:
    """The SVD / DepthCrafter scheduler configuration."""
    return EulerDiscreteScheduler(
        prediction_type="v_prediction", timestep_type="continuous", use_karras_sigmas=True,
        sigma_min=0.002, sigma_max=700.0, timestep_spacing="leading", steps_offset=1)


def window_starts(f: int, window_size: int, overlap: int) -> list:
    """First frame of each window; the last one is pulled back to end at f."""
    stride = max(window_size - overlap, 1)
    starts = list(range(0, max(f - window_size, 0) + 1, stride))
    if starts[-1] + window_size < f:
        starts.append(f - window_size)
    return starts


def chain_blend(latents_all: torch.Tensor, win_lat: torch.Tensor, s: int, ov: int) -> torch.Tensor:
    """Write a finished window into the running latents, in place: its first
    ``ov`` frames ramp linearly from the running result (weight 0) to the
    window (weight 1), the rest are the window's."""
    if ov > 0:
        w = torch.linspace(0.0, 1.0, ov, device=win_lat.device)[:, None, None, None]
        blended = win_lat[:ov] * w + latents_all[s:s + ov] * (1.0 - w)
        win_lat = torch.cat([blended, win_lat[ov:]], dim=0)
    latents_all[s:s + win_lat.shape[0]] = win_lat
    return latents_all


def postprocess_depth(raw: np.ndarray, near: float, far: float) -> np.ndarray:
    """The reference's post-processing chain, verbatim (models/infer.py:79-91)."""
    d = (raw - raw.min()) / max(raw.max() - raw.min(), 1e-12)
    d = d * 3900.0
    d = np.where(d < 1e-5, 1e-5, d)
    d = 10000.0 / d
    return np.clip(d, near, far)


@dataclass
class DepthCrafterPipeline:
    unet: UNetSpatioTemporalConditionModel
    vae: AutoencoderKLTemporalDecoder
    image_encoder: Optional[CLIPVisionModelWithProjection] = None
    scheduler: Optional[EulerDiscreteScheduler] = None
    dtype: torch.dtype = torch.bfloat16
    mesh: object = None  # parallel/mesh.py Mesh, set by with_mesh
    sharded_unet: Optional[UNetSpatioTemporalConditionModel] = None  # the UNet's twin, ditto

    def __post_init__(self):
        if self.scheduler is None:
            self.scheduler = svd_euler_scheduler()

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    def with_mesh(self, mesh) -> "DepthCrafterPipeline":
        """Shard the stage over ``mesh`` (dp x sp x tp), in place: the
        UNet's windows on a twin sharing its weights, frames on dp and
        latent rows on sp (parallel/frames.py ``FrameRows``), the same slab
        on every tp rank; CLIP and the SVD VAE on whole frames over every
        rank.  The JAX package returns a copy with the parameters
        replicated; here every rank holds the models already."""
        self.sharded_unet = shard_spatially(self.unet, FR.FrameRows.of(mesh))
        self.mesh = mesh
        return self

    def _per_frame(self, fn, frames: torch.Tensor, empty: torch.Tensor) -> torch.Tensor:
        """``fn`` of the clip's frames, a per-frame function: under a mesh
        each rank runs it on its share (``empty`` where it has none) and one
        ``all_gather`` joins the results."""
        if self.mesh is None:
            return fn(frames)
        start, n, sizes = FR.frame_share(frames.shape[0], self.mesh.world)
        local = fn(frames[start:start + n]) if n else empty
        return FR.gather_frames(local.contiguous(), self.mesh.world, sizes)

    @torch.no_grad()
    def encode_image_embeddings(self, frames: torch.Tensor) -> torch.Tensor:
        """(F, H, W, 3) in [0, 1] -> per-frame CLIP embeddings (F, 1, D)."""
        proj = self.image_encoder.visual_projection.weight
        return self._per_frame(self._embed, frames, proj.new_empty((0, 1, proj.shape[0])))

    def _embed(self, frames: torch.Tensor) -> torch.Tensor:
        size = self.image_encoder.image_size
        x = resize_linear(frames.permute(0, 3, 1, 2), (size, size)).permute(0, 2, 3, 1)
        mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device)
        std = torch.tensor(CLIP_IMAGE_STD, device=x.device)
        dtype = self.image_encoder.visual_projection.weight.dtype
        return self.image_encoder(((x - mean) / std).to(dtype))[:, None, :]

    @torch.no_grad()
    def _cond_latents(self, frames: torch.Tensor) -> torch.Tensor:
        """(F, H, W, 3) in [0, 1] -> per-frame conditioning latents (F, h,
        w, 4) fp32: the posterior mean, un-scaled (SVD)."""
        lc = self.vae.latent_channels
        encode = lambda x: svd_encode_chunked(self.vae, (x * 2.0 - 1.0)[None].to(self.dtype))[0]
        h, w = frames.shape[1:3]
        empty = frames.new_empty((0, h // 8, w // 8, lc), dtype=self.dtype)
        return self._per_frame(lambda x: encode(x)[..., :lc], frames, empty).float()

    def _decode_raw(self, latents: torch.Tensor) -> torch.Tensor:
        """Whole latents (F, h, w, 4) -> raw disparity (F, 8h, 8w), fp32 on
        the device: the chunked temporal decode, clamped, channel mean.
        Under a mesh each rank decodes its whole chunks (the unsharded
        chunk boundaries, so the time mixing never crosses a rank) and the
        disparity is joined over every rank."""
        f, h, w = latents.shape[:3]
        chunk = decode_chunk(h, w)
        z = (latents[None] / self.vae.scaling_factor).to(self.dtype)
        raw = lambda z: torch.clamp(svd_decode_chunked(self.vae, z, chunk)[0].float() / 2.0
                                    + 0.5, 0.0, 1.0).mean(dim=-1)
        if self.mesh is None:
            return raw(z)
        world = self.mesh.world
        lengths = [min(chunk, f - s) for s in range(0, f, chunk)]
        counts = FR.deal(len(lengths), world)
        sizes = [sum(lengths[sum(counts[:r]):sum(counts[:r + 1])]) for r in range(world.size)]
        start, n = sum(sizes[:world.index]), sizes[world.index]
        local = (raw(z[:, start:start + n]) if n else
                 torch.empty((0, 8 * h, 8 * w), device=latents.device))
        return FR.gather_frames(local, world, sizes)

    def _denoise_window(self, state: EulerState, latents, cond_latents, ctx, steps: int,
                        guidance_scale: float) -> torch.Tensor:
        """The Euler denoise of one window's latents (F, h, w, 4), fp32.
        Under a mesh this rank denoises its slab (frames on dp, latent rows
        on sp) on the UNet's sharded twin, with every frame's ``ctx``, and
        the window's latents are joined whole over the plane."""
        unet, height, slab = self.unet, None, None
        if self.mesh is not None:
            unet, height = self.sharded_unet, latents.shape[1]
            slab = unet.plane.layout(latents.shape[0], height)
            latents, cond_latents = slab.take(latents, 0, 1), slab.take(cond_latents, 0, 1)
        added = torch.tensor([ADDED_TIME_IDS], device=latents.device)
        for i in range(steps):
            scaled = self.scheduler.scale_model_input(state, latents, i)
            t = float(state.timesteps[i])
            if guidance_scale > 1.0:
                x_in = torch.stack([torch.cat([scaled, torch.zeros_like(cond_latents)], dim=-1),
                                    torch.cat([scaled, cond_latents], dim=-1)])
                pred = unet(x_in.to(self.dtype), torch.full((2,), t, device=x_in.device),
                            torch.stack([torch.zeros_like(ctx), ctx]), added.repeat(2, 1),
                            height).float()
                pred = pred[0] + guidance_scale * (pred[1] - pred[0])
            else:
                x_in = torch.cat([scaled, cond_latents], dim=-1)[None]
                pred = unet(x_in.to(self.dtype), torch.full((1,), t, device=x_in.device),
                            ctx[None], added, height)[0].float()
            latents = self.scheduler.step(state, pred, i, latents)
        return latents if slab is None else slab.join(latents.contiguous(), 0, 1)

    @torch.no_grad()
    def __call__(
        self,
        frames: np.ndarray,  # (F, H, W, 3) in [0, 1]
        num_inference_steps: int = 5,
        guidance_scale: float = 1.0,
        window_size: int = 110,
        overlap: int = 25,
        generator: Optional[torch.Generator] = None,
        image_embeddings: Optional[np.ndarray] = None,
        window_noises: Optional[Sequence[np.ndarray]] = None,
    ) -> np.ndarray:
        """-> raw single-channel disparity (F, H, W), before post-processing.

        ``image_embeddings`` (F, 1, D) bypasses the CLIP encoder (the
        pipeline then needs none);
        ``window_noises`` supplies each window's initial noise (F_w, h, w, 4)
        (under a mesh every rank passes the whole of each and takes its
        share).  Every rank of a mesh returns the whole disparity."""
        device = self.device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(42)
        frames_t = torch.as_tensor(np.asarray(frames, np.float32), device=device)
        f = frames_t.shape[0]
        window_size = min(window_size, f)

        if image_embeddings is not None:
            ctx = torch.as_tensor(image_embeddings, device=device).to(self.dtype)
        else:
            ctx = self.encode_image_embeddings(frames_t).to(self.dtype)
        cond_latents = self._cond_latents(frames_t)

        state = self.scheduler.set_timesteps(num_inference_steps)
        sigma0 = state.init_noise_sigma
        latents_all = torch.zeros_like(cond_latents)
        prev_start = None
        for wi, s in enumerate(window_starts(f, window_size, overlap)):
            win_cond = cond_latents[s:s + window_size]
            if window_noises is not None:
                noise = torch.as_tensor(window_noises[wi], dtype=torch.float32, device=device)
            else:
                noise = torch.randn(win_cond.shape, generator=generator, device=device)
            init = noise * sigma0
            # frames shared with the previous window start from the running
            # result for those frames, re-noised to the first sigma
            ov = 0 if prev_start is None else min(max(prev_start + window_size - s, 0),
                                                  window_size)
            if ov > 0:
                init = torch.cat([latents_all[s:s + ov] + noise[:ov] * sigma0, init[ov:]])
            win_lat = self._denoise_window(state, init, win_cond, ctx[s:s + window_size],
                                           num_inference_steps, float(guidance_scale))
            chain_blend(latents_all, win_lat, s, ov)
            prev_start = s

        return self._decode_raw(latents_all).cpu().numpy()


class DepthCrafterDemo:
    """The reference's depth facade (models/infer.py:12-92)."""

    def __init__(self, pipeline: DepthCrafterPipeline):
        self.pipe = pipeline

    def infer(self, frames, near, far, num_denoising_steps=5, guidance_scale=1.0,
              window_size=110, overlap=25, seed=42):
        """(F, H, W, 3) in [0, 1] -> depth (F, 1, H, W) in [near, far]."""
        generator = torch.Generator(device=self.pipe.device).manual_seed(seed)
        raw = self.pipe(frames, num_inference_steps=num_denoising_steps,
                        guidance_scale=guidance_scale, window_size=window_size,
                        overlap=overlap, generator=generator)
        return postprocess_depth(raw, near, far)[:, None]
