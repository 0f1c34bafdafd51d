"""End-to-end conditional video-diffusion pipeline.

Counterpart of trajectorycrafter_tpu/pipelines/trajcrafter.py
``TrajCrafterPipeline``: condition prep (VAE encodes of the reference clip
and the masked warped video, latent-space mask resize, noise aug), the CFG
denoise loop as a plain Python loop over any of the six samplers
(schedulers/__init__.py), and the VAE decode.  The CFG pair rides the batch
axis (uncond first, then cond).

The loop is generic as the JAX package's ``_denoise_chunk_jit``: the model
input is ``scheduler.scale_model_input`` of the CFG-doubled latents (Euler
divides by sqrt(sigma^2 + 1)); PNDM runs ``num_loop_steps`` entries and
carries its loop state; DPM++ carries the previous x0; Euler A draws its
per-step noise from the pipeline's ``torch.Generator``, or takes it from
``ancestral_noise_override`` (S, *latents), indexed by absolute step.
The decode is ``vae_decode_auto`` planned against the device's memory: one
shot for every deployed size on an 80 GB card, full-width strips when the
one-shot peak would not fit.

Inputs are channel-last tensors on the pipeline's device: video
(B, F, H, W, 3) in [0, 1], mask_video (B, F, H, W, 1) in [0, 255] where 255
marks holes, reference (B, F_ref, H, W, 3) in [0, 1].

``with_mesh`` (JAX ``with_mesh``) shards the pipeline over a dp x sp x tp
mesh (parallel/mesh.py): the DiT tensor-parallel, its tokens on sp with the
joint self-attention on the ring, the CFG pair on dp; the CogVideoX VAE
spatially, H on dp and W on sp (a twin of the VAE sharing its weights,
parallel/spatial.py), the same slab on every tp rank.  Every rank passes
the conditioning video, mask and reference; the leader (rank 0) alone
passes the prompt embeddings and the sampling arguments, and hands them and
its generator's state to every rank before anything is drawn, so that
every rank draws the same noise: the condition prep and the decode run on
every rank, each on its slab, the latents gathered over the plane; every
rank runs the same sampling loop on bit-equal latents.  The img2img encode
(strength < 1) runs unsharded on the leader, as the JAX package's.  Every
rank returns the result: the final latents are bit-equal on every rank, and
the decode gathers the whole video on every rank of each plane.
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
    decode_memory_bytes,
    posterior_mode,
    sample_posterior,
    vae_decode_auto,
    vae_encode,
)
from trajectorycrafter_tpu_torch.ops.rope import rope_for_sample
from trajectorycrafter_tpu_torch.parallel import distributed as D
from trajectorycrafter_tpu_torch.parallel.sharding import shard_dit_
from trajectorycrafter_tpu_torch.parallel.spatial import Plane, shard_spatially
from trajectorycrafter_tpu_torch.schedulers import (
    DPMSolverMultistepScheduler,
    EulerAncestralDiscreteScheduler,
    PNDMScheduler,
    Scheduler,
)
from trajectorycrafter_tpu_torch.utils.timing import StageTimer, span

# the ``__call__`` arguments every rank of a mesh takes from the leader
_LEADER_VALUES = ("num_inference_steps", "guidance_scale", "use_dynamic_cfg", "strength",
                  "noise_aug_strength", "output_type")
_LEADER_TENSORS = ("prompt_embeds", "negative_prompt_embeds", "latents",
                   "ancestral_noise_override")


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
    scheduler: Scheduler
    vae_scale_factor_spatial: int = 8
    vae_scale_factor_temporal: int = 4
    dtype: torch.dtype = torch.bfloat16
    timer: Optional[StageTimer] = None  # shared with the orchestrator's stages
    mesh: object = None  # parallel/mesh.py Mesh, set by with_mesh
    spatial_vae: Optional[AutoencoderKLCogVideoX] = None  # the VAE's sharded twin, ditto
    device_ranks: int = 1  # the mesh's ranks on this rank's device, ditto

    def __post_init__(self):
        if self.timer is None:
            self.timer = StageTimer(self.device)

    @property
    def device(self) -> torch.device:
        return self.transformer.proj_out.weight.device

    @property
    def _vae_dtype(self) -> torch.dtype:
        return self.vae.encoder.conv_in.conv.weight.dtype

    @property
    def leader(self) -> bool:
        """True unless a mesh makes this rank one that takes the sampling
        arguments from the leader."""
        return self.mesh is None or self.mesh.leader

    @property
    def _cond_vae(self) -> AutoencoderKLCogVideoX:
        """The VAE of the condition prep and the decode: the sharded twin
        under a mesh."""
        return self.vae if self.mesh is None else self.spatial_vae

    def with_mesh(self, mesh) -> "TrajCrafterPipeline":
        """Shard the pipeline over ``mesh`` (dp x sp x tp), in place: the DiT
        tensor-parallel (parallel/sharding.py rules), its activations over
        dp and sp, its joint self-attention on the ring when sp > 1; the
        VAE's condition prep and decode H on dp, W on sp (``spatial_vae``,
        a twin sharing the VAE's weights, which every rank holds); the
        mesh's ranks on this rank's device counted (``device_ranks``).  The
        JAX package returns a sharded copy; here the DiT is replaced by its
        shard, so nothing holds the whole DiT beside it."""
        if self.vae is None:
            raise ValueError("a sharded pipeline needs the VAE on every rank")
        shard_dit_(self.transformer, mesh)
        self.spatial_vae = shard_spatially(self.vae, Plane.of(mesh))
        self.device_ranks = D.ranks_on_device(mesh.world, self.device)
        self.mesh = mesh
        return self

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
        Under a mesh every rank draws the whole noise from the same
        generator state and encodes its slab (the moments gathered over
        the plane); the latent mask is computed whole.
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
        ref_moments = vae_encode(self._cond_vae, ref.to(self._vae_dtype))
        ref_latents = sample_posterior(ref_moments.float(), lc, noise=ref_noise) * sf

        # inpaint branch; the mask binarises at 0.5 on its raw [0, 255] scale
        init_video = video.float() * 2.0 - 1.0
        mask01 = (mask_video.float() >= 0.5).float()
        masked_video = init_video * (mask01 < 0.5) + (-1.0) * (mask01 > 0.5)
        if self.transformer.add_noise_in_inpaint_model:
            noise = aug_noise * noise_aug_strength
            noise = torch.where(masked_video == -1.0, torch.zeros_like(noise), noise)
            masked_video = masked_video + noise
        mv_moments = vae_encode(self._cond_vae, masked_video.to(self._vae_dtype))
        masked_video_latents = posterior_mode(mv_moments.float(), lc) * sf

        # latent-size mask: 1 - mask01 (known = 1)
        mask_latents = resize_mask_latent((1.0 - mask01).permute(0, 4, 1, 2, 3),
                                          (f_lat, h_lat, w_lat))
        mask_latents = mask_latents.permute(0, 2, 3, 4, 1) * sf
        inpaint_latents = torch.cat([mask_latents, masked_video_latents], dim=-1)
        inpaint_latents, ref_latents = inpaint_latents.to(self.dtype), ref_latents.to(self.dtype)
        if self.mesh is not None:
            # the tp ranks encoded the same slabs: tp coordinate 0's bits on
            # all of them, so that every rank denoises bit-equal inputs
            inpaint_latents = D.broadcast(inpaint_latents, self.mesh.tp)
            ref_latents = D.broadcast(ref_latents, self.mesh.tp)
        return inpaint_latents, ref_latents

    # ------------------------------------------------------------------
    def _model_call(self, state, latents, i, text, inpaint_in, ref_in, rope,
                    num_inference_steps, guidance_scale, do_cfg, use_dynamic_cfg):
        """The CFG-combined model output at loop entry ``i``."""
        lat_in = torch.cat([latents] * 2, dim=0) if do_cfg else latents
        lat_in = self.scheduler.scale_model_input(state, lat_in, i)
        t = float(state.timesteps[i])
        tvec = torch.full((lat_in.shape[0],), t, device=latents.device)
        noise_pred = self.transformer(
            lat_in.to(self.dtype), text, tvec, inpaint_latents=inpaint_in,
            cross_latents=ref_in, image_rotary_emb=rope,
        ).float()
        if not do_cfg:
            return noise_pred
        uncond, cond = noise_pred.chunk(2, dim=0)
        g = guidance_scale
        if use_dynamic_cfg:  # cosine-power dynamic CFG, in float64
            g = 1.0 + guidance_scale * (
                (1.0 - math.cos(math.pi * ((num_inference_steps - t)
                                           / num_inference_steps) ** 5.0)) / 2.0)
        return uncond + g * (cond - uncond)

    def _denoise(self, state, latents, text, inpaint_in, ref_in, rope, num_inference_steps,
                 t_start, guidance_scale, do_cfg, use_dynamic_cfg, generator,
                 ancestral_noise_override):
        """The sampling loop from entry ``t_start`` to ``num_loop_steps``, each
        entry one ``sampler.step`` span (utils/timing.py)."""
        sched = self.scheduler
        loop = sched.init_loop_state(latents) if isinstance(sched, PNDMScheduler) else None
        prev_x0 = None
        for i in range(t_start, sched.num_loop_steps(num_inference_steps)):
            with span("sampler.step", latents):
                noise_pred = self._model_call(state, latents, i, text, inpaint_in, ref_in, rope,
                                              num_inference_steps, guidance_scale, do_cfg,
                                              use_dynamic_cfg)
                if isinstance(sched, PNDMScheduler):
                    latents, loop = sched.step(state, noise_pred, i, latents, loop)
                elif isinstance(sched, DPMSolverMultistepScheduler):
                    latents, prev_x0 = sched.step(state, noise_pred, i, latents, prev_x0=prev_x0,
                                                  num_steps=num_inference_steps,
                                                  first_index=t_start)
                elif isinstance(sched, EulerAncestralDiscreteScheduler):
                    if ancestral_noise_override is None:
                        noise = torch.randn(latents.shape, generator=generator,
                                            device=latents.device)
                    else:
                        noise = ancestral_noise_override[i].to(latents.device, torch.float32)
                    latents = sched.step(state, noise_pred, i, latents, noise=noise)
                else:
                    latents = sched.step(state, noise_pred, i, latents)
        return latents

    def _prepare(self, state, t_start, video, mask_video, reference, generator, latents,
                 noise_aug_strength, noise_override):
        """The conditions and the initial latents -> [latents (fp32),
        inpaint_latents, ref_latents], the same on every rank of a mesh."""
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
        if t_start == 0:
            return [latents * state.init_noise_sigma, inpaint_latents, ref_latents]
        if isinstance(self.scheduler, PNDMScheduler):
            raise NotImplementedError(
                "strength < 1 is not supported with the PNDM sampler "
                "(its PRK warmup is incompatible with timestep skipping)")
        with self.timer("vae_encode"):
            if noise_override is not None and len(noise_override) == 3:
                vid_noise = noise_override[1].to(device, torch.float32)
            else:
                vid_noise = torch.randn(latents.shape, generator=generator, device=device)
            if self.leader:  # unsharded, as the JAX package's img2img encode
                moments = vae_encode(self.vae, (video.float() * 2.0 - 1.0).to(self._vae_dtype))
                video_latents = sample_posterior(moments.float(), self.vae.latent_channels,
                                                 noise=vid_noise) * self.vae.scaling_factor
                latents = self.scheduler.add_noise(state, video_latents.float(), latents,
                                                   state.timesteps[t_start])
            if self.mesh is not None:
                latents = D.broadcast(latents, self.mesh.world)
        return [latents, inpaint_latents, ref_latents]

    def _leader_arguments(self, args: dict) -> dict:
        """Under a mesh: ``args`` (``__call__``'s, in their order) with the
        leader's sampling values, tensors, noise overrides and generator on
        every rank; the
        generator's state is taken before anything is drawn, so every rank
        draws what the leader draws.  The conditioning videos stay each
        rank's own."""
        world, gen = self.mesh.world, args["generator"]
        overrides = list(args["noise_override"] or ())
        values = D.broadcast_object(
            {**{k: args[k] for k in _LEADER_VALUES}, "overrides": len(overrides),
             "generator": None if gen is None else (gen.device.type, gen.get_state())}
            if self.leader else None, world)
        tensors = D.broadcast_tensors(
            [args[k] for k in _LEADER_TENSORS] + overrides if self.leader else None, world,
            self.device)
        out = dict(args, **{k: values[k] for k in _LEADER_VALUES})
        out.update(zip(_LEADER_TENSORS, tensors))
        out["noise_override"] = tuple(tensors[len(_LEADER_TENSORS):]) or None
        if not self.leader:
            out["generator"] = None
            if values["generator"] is not None:
                kind, gen_state = values["generator"]
                out["generator"] = torch.Generator(device=self.device if kind == "cuda" else "cpu")
                out["generator"].set_state(gen_state)
        return out

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
        ancestral_noise_override: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Full sampling run; returns (B, F, H, W, 3) video in [0, 1], or the
        final latents (B, F', h, w, C) with ``output_type="latent"``.

        ``strength`` < 1 is img2img: the first ``N - int(N * strength)``
        steps are skipped and the initial latents are the VAE-encoded warped
        video noised to the first kept timestep.  ``latents``, when given, is
        the initial noise draw.  PNDM does not take ``strength`` < 1 (its
        warm-up cannot skip steps).
        """
        if self.mesh is not None:
            args = self._leader_arguments(dict(
                prompt_embeds=prompt_embeds, negative_prompt_embeds=negative_prompt_embeds,
                num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
                use_dynamic_cfg=use_dynamic_cfg, generator=generator, latents=latents,
                strength=strength, noise_aug_strength=noise_aug_strength,
                output_type=output_type, noise_override=noise_override,
                ancestral_noise_override=ancestral_noise_override))
            (prompt_embeds, negative_prompt_embeds, num_inference_steps, guidance_scale,
             use_dynamic_cfg, generator, latents, strength, noise_aug_strength, output_type,
             noise_override, ancestral_noise_override) = args.values()
            if video is None or mask_video is None or reference is None:
                raise ValueError("under a mesh every rank passes the conditioning video, mask "
                                 "and reference: each encodes its slab of them")
        state = self.scheduler.set_timesteps(num_inference_steps)
        init_timestep = min(int(num_inference_steps * strength), num_inference_steps)
        if init_timestep == 0:
            raise ValueError(
                f"strength={strength} truncates every denoise step "
                f"(int({num_inference_steps} * {strength}) == 0); raise "
                "strength or num_inference_steps")
        t_start = num_inference_steps - init_timestep
        latents, inpaint_latents, ref_latents = self._prepare(
            state, t_start, video, mask_video, reference, generator, latents,
            noise_aug_strength, noise_override)
        # the conditioning videos are consumed: free them before the denoise
        video = mask_video = reference = None
        device = self.device
        f_lat, h_lat, w_lat = latents.shape[1:4]

        rope = None
        if self.transformer.use_rotary_positional_embeddings:
            cos, sin = rope_for_sample(self.transformer.attention_head_dim,
                                       h_lat * self.vae_scale_factor_spatial,
                                       w_lat * self.vae_scale_factor_spatial, f_lat,
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
            latents = self._denoise(state, latents, text, inpaint_in, ref_in, rope,
                                    num_inference_steps, t_start, guidance_scale, do_cfg,
                                    use_dynamic_cfg, generator, ancestral_noise_override)

        if output_type == "latent":
            return latents
        with self.timer("vae_decode"):
            return self.decode(latents)

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Final latents (B, F', h, w, C) -> video (B, F, H, W, 3) in [0, 1]
        (the JAX ``_decode_jit``).  Under a mesh every rank decodes its slab
        and every rank of its plane gets the whole video; ranks that share
        one device plan the decode in their share of its memory (the
        device's over ``device_ranks``)."""
        z = latents / self.vae.scaling_factor
        frames = vae_decode_auto(self._cond_vae, z.to(self._vae_dtype),
                                 decode_memory_bytes(z.device) // self.device_ranks)
        return (frames.float() / 2.0 + 0.5).clamp(0.0, 1.0)
