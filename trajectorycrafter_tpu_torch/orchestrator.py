"""TrajCrafter orchestrator for the PyTorch port: the four modes end to end.

Counterpart of trajectorycrafter_tpu/orchestrator.py.  Each mode reads the
frames, captions the middle frame (BLIP-2, unless ``--prompt`` is given),
estimates depth, synthesises the poses, forward-splats frames into the new
cameras on the device (``--mask``: the holes dilated and blanked), resizes
the warp outputs there, runs the diffusion pipeline with the
``--sampler_name`` sampler and writes the five mp4s (input, render, mask,
gen, viz).  The modes differ in what they warp:

  * ``infer_gradual``: frame k from the anchor camera into camera k;
  * ``infer_direct``: the camera flies in over the first ``cut`` frames on a
    frozen first frame, then follows the source delayed by ``cut``; the
    mp4s drop the fly-in (``_diffuse_and_save(save_skip=cut)``);
  * ``infer_bullet``: the last frame, frozen, seen from the orbit; the
    reference frames are the last ones;
  * ``infer_zoom``: a dolly zoom, the target focal ramped per frame.

Under ``--mesh_dp/--mesh_sp/--mesh_tp`` (ranks started by torchrun, cli.py
``entry_world``) every entry point runs sharded as the JAX package's, by
one rule: a step that calls a collective runs on every rank, in the same
order; a step that runs on one device runs on the leader (rank 0) alone,
and ``_from_leader`` hands its arrays to every rank.  The collective steps
are the depth stage (pipelines/depth.py ``with_mesh``: CLIP and the SVD VAE
on whole frames over every rank, the UNet's windows with frames on dp and
latent rows on sp; every rank ends with the whole depth), the warp (ops/
splat.py, frames over every mesh axis, every frame's outputs back on every
rank) and the pipeline (pipelines/trajcrafter.py ``with_mesh``: its slab of
the VAE's condition prep and decode, H on dp and W on sp, and its shard of
the denoise, the DiT tensor-parallel over tp, its tokens on sp, the CFG
pair on dp; the whole video back on every rank).  The leader's steps are
the frames' reading and the caption, the poses, the prompt encode, and in
the subclasses the z-buffer renders, the point clouds, the VDA and its
alignment trainer and the dataset readers (autoregressive.py,
known_poses.py, consistent_autoregressive.py).  Every rank holds the VAE,
its DiT shard and the depth stage's models (the UNet, the SVD VAE, CLIP);
the leader also T5 and the captioner.  ``_diffuse_and_save`` returns the
generated video on every rank, so a loop that feeds a segment forward runs
its next collective step on every rank; the leader alone makes directories
and writes files.

``build_models`` loads the checkpoints of an HF-layout tree
(``load_full_bundle``, utils/checkpoints.py) onto the card, or onto the CPU
when the caller passes ``device="cpu"``.  Without a tree, and only with
``--allow_dev_stubs``, the models are randomly initialised from a seed at
their deployed widths (``build_full_scale_models``) and T5 reads stand-in
token ids drawn from a generator seeded by the prompt's sha256.  The tiny
CPU stack of the tests (``build_dev_models``) keeps the JAX package's
stand-ins for missing checkpoints: a plane-depth stub and seeded gaussian
prompt embeddings.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from dataclasses import dataclass, field
from typing import Callable, Optional

import cv2
import numpy as np
import torch
import torch.nn.functional as F

from trajectorycrafter_tpu_torch.config import TrajCrafterConfig
from trajectorycrafter_tpu_torch.geometry.cameras import (
    default_c2w,
    intrinsics_matrix,
    pose_radius_from_depth,
    zoom_intrinsics,
)
from trajectorycrafter_tpu_torch.geometry.trajectory import (
    generate_traj_specified,
    generate_traj_txt,
    load_traj_txt,
)
from trajectorycrafter_tpu_torch.models.clip import CLIPVisionModelWithProjection
from trajectorycrafter_tpu_torch.models.depthcrafter import UNetSpatioTemporalConditionModel
from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel
from trajectorycrafter_tpu_torch.models.svd_vae import AutoencoderKLTemporalDecoder
from trajectorycrafter_tpu_torch.models.t5 import T5EncoderModel
from trajectorycrafter_tpu_torch.models.vae import AutoencoderKLCogVideoX
from trajectorycrafter_tpu_torch.ops.int8 import quantize_depth_unet_, quantize_dit_unit_
from trajectorycrafter_tpu_torch.ops.resize import resize_nearest
from trajectorycrafter_tpu_torch.ops.splat import forward_warp_batch
from trajectorycrafter_tpu_torch.parallel import distributed as D
from trajectorycrafter_tpu_torch.parallel.sharding import shard_dit_, shard_unit_
from trajectorycrafter_tpu_torch.pipelines.depth import DepthCrafterDemo, DepthCrafterPipeline
from trajectorycrafter_tpu_torch.pipelines.trajcrafter import TrajCrafterPipeline
from trajectorycrafter_tpu_torch.schedulers import SCHEDULER_REGISTRY
from trajectorycrafter_tpu_torch.utils.caption import build_captioner
from trajectorycrafter_tpu_torch.utils.checkpoints import (
    LOG,
    load_depthcrafter,
    load_dit,
    load_t5,
    load_vae,
)
from trajectorycrafter_tpu_torch.utils.timing import StageTimer
from trajectorycrafter_tpu_torch.utils.tokenizer import T5Tokenizer
from trajectorycrafter_tpu_torch.utils.video import (
    VideoSaveQueue,
    pad_to_length,
    read_video_frames,
    save_video,
)

# deployed widths: T5-XXL prompt embeddings (tokens, channels)
T5_TEXT_LEN, T5_TEXT_DIM = 226, 4096


@dataclass
class ModelBundle:
    pipeline: TrajCrafterPipeline
    depth_infer: Callable  # (frames, near, far, steps, gs, window, overlap) -> (F,1,H,W)
    encode_prompt: Callable  # (prompt, negative) -> (pe, ne) each (1, L, D) on the device
    get_caption: Callable  # (frame_hw3) -> str
    # {family: {"bytes", "seconds", "tensors"}} of a bundle loaded from checkpoints
    load_stats: dict = field(default_factory=dict)


# ----------------------------------------------------------------------------
# model construction
# ----------------------------------------------------------------------------


def _prompt_seed(prompt: str) -> int:
    return int.from_bytes(hashlib.sha256(prompt.encode()).digest()[:4], "little")


def _pseudo_text_embeds(prompt: str, length: int, dim: int, device) -> torch.Tensor:
    """Stand-in embeddings of the tiny stack: each prompt maps to gaussian
    token embeddings drawn from a generator seeded by its sha256."""
    gen = torch.Generator(device=device).manual_seed(_prompt_seed(prompt))
    return torch.randn((1, length, dim), generator=gen, device=device)


def stand_in_token_ids(prompt: str, length: int, vocab_size: int) -> torch.Tensor:
    """(1, length) T5 token ids for ``prompt`` in the random-weight bundle,
    which has no tokenizer: drawn on the CPU from a generator seeded by the
    prompt's sha256, so the same prompt gives the same ids in every process
    and on every device."""
    gen = torch.Generator().manual_seed(_prompt_seed(prompt))
    return torch.randint(0, vocab_size, (1, length), generator=gen)


class T5PromptEncoder:
    """``encode_prompt`` of a bundle: T5 on the token ids of the prompt and
    of the negative prompt, one batch of two, with no attention mask (as the
    reference pipeline encodes).  The ids are ``tokenizer``'s (padded and
    truncated to ``text_len``) or, without one, ``stand_in_token_ids``."""

    def __init__(self, t5: T5EncoderModel, text_len: int,
                 tokenizer: Optional[T5Tokenizer] = None):
        self.t5, self.text_len, self.tokenizer = t5, text_len, tokenizer

    def token_ids(self, texts) -> torch.Tensor:
        if self.tokenizer is not None:
            return self.tokenizer(list(texts), max_length=self.text_len)
        return torch.cat([stand_in_token_ids(text, self.text_len, self.t5.shared.num_embeddings)
                          for text in texts])

    @torch.no_grad()
    def __call__(self, prompt, negative):
        ids = self.token_ids([prompt or "", negative or ""])
        out = self.t5(ids.to(self.t5.shared.weight.device))
        return out[:1], out[1:]


def depth_stage(unet: UNetSpatioTemporalConditionModel, vae: AutoencoderKLTemporalDecoder,
                image_encoder: Optional[CLIPVisionModelWithProjection],
                dtype: torch.dtype) -> Callable:
    """``depth_infer`` of a bundle: the DepthCrafter pipeline over these models."""
    return DepthCrafterDemo(DepthCrafterPipeline(
        unet=unet, vae=vae, image_encoder=image_encoder, dtype=dtype)).infer


def depth_pipeline(depth_infer: Callable) -> Optional[DepthCrafterPipeline]:
    """The DepthCrafter pipeline behind a bundle's ``depth_infer`` (a
    ``DepthCrafterDemo.infer``), or None for another callable (the
    plane-depth stand-in, which needs no mesh)."""
    demo = getattr(depth_infer, "__self__", None)
    return demo.pipe if isinstance(demo, DepthCrafterDemo) else None


def _plane_depth_infer(frames, near, far, *a, **kw):
    """Constant-plane depth stub used when no DepthCrafter weights exist."""
    f, h, w = frames.shape[:3]
    yy = np.mgrid[0:h, 0:w][0]
    depth = (2.0 + 2.0 * yy / h).astype(np.float32)
    return np.tile(depth[None, None], (f, 1, 1, 1))


QUANTS = ("none", "int8")


def check_supported(cfg: TrajCrafterConfig) -> None:
    """Raise for a configuration the port does not run, before any model is
    built: a quantization other than ``QUANTS`` or an unknown sampler."""
    for flag, quant in (("--quant", cfg.diffusion.quant), ("--quant_depth", cfg.depth.quant)):
        if quant not in QUANTS:
            raise NotImplementedError(f"{flag} {quant} is not ported; the port runs {QUANTS}")
    if cfg.diffusion.sampler_name not in SCHEDULER_REGISTRY:
        raise NotImplementedError(
            f"unknown sampler {cfg.diffusion.sampler_name!r}; the port runs "
            f"{sorted(SCHEDULER_REGISTRY)}")


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


def dit_units(dit: CrossTransformer3DModel) -> list:
    """The DiT's top-level modules in parameter order, its blocks and
    Perceivers one by one: their parameters, in turn, are ``dit.parameters()``."""
    units = []
    for child in dit.children():
        units.extend(child if isinstance(child, torch.nn.ModuleList) else [child])
    return units


@torch.no_grad()
def build_dit(make: Callable[[], CrossTransformer3DModel], device, dtype, seed: int,
              quant: str = "none", tp=None, std: float = 0.02) -> CrossTransformer3DModel:
    """The DiT ``make`` builds, randomly initialised as ``random_init_``
    initialises it (N(0, std^2) in parameter order from one generator seeded
    with ``seed``), allocated one top-level module at a time; under ``quant``
    "int8" each block and Perceiver is quantized as soon as it is drawn, and
    with ``tp`` (a mesh axis) cut to this rank's tensor-parallel shard over
    it (parallel/sharding.py ``shard_unit_``), so a rank never holds more of
    the whole DiT than one block beside its shard.  A sharded denoise then
    takes the mesh (``shard_dit_(dit, mesh, units_done=True)``); training
    leaves the forward unsharded."""
    with torch.device("meta"):
        dit = make()
    dit.to(dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    for unit in dit_units(dit):
        unit.to_empty(device=device)
        for p in unit.parameters():
            p.normal_(0.0, std, generator=gen)
        if unit in (*dit.transformer_blocks, *(dit.perceiver_cross_attention or ())):
            if quant == "int8":
                quantize_dit_unit_(unit)
            if tp is not None:
                shard_unit_(unit, tp)
    return dit.eval()


def stage_mesh(cfg: TrajCrafterConfig):
    """The run's dp x sp x tp mesh (parallel/mesh.py), or None at 1x1x1: the
    JAX package's ``stage_mesh``.  Its ranks' process group must be started
    (cli.py ``start_world``)."""
    par = cfg.parallel
    if par.dp * par.sp * par.tp <= 1:
        return None
    import torch.distributed as dist

    from trajectorycrafter_tpu_torch.parallel.mesh import make_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "--mesh_dp/--mesh_sp/--mesh_tp need a process group of that many ranks, which "
            "the entry points start under torchrun (cli.py and scripts/inference_orbits.py, "
            "inference_autoregressive.py, autoregressive_global.py, run_w_cam_poses.py, "
            "inference_alignment.py: cli.entry_world); a caller building TrajCrafter itself "
            "starts it first (parallel/distributed.py init or init_from_env)")
    return make_mesh(dp=par.dp, sp=par.sp, tp=par.tp)


def _bundle(cfg, pipeline, depth_infer, encode_prompt) -> ModelBundle:
    return ModelBundle(pipeline=pipeline, depth_infer=depth_infer,
                       encode_prompt=encode_prompt,
                       get_caption=lambda frame: cfg.diffusion.prompt or "a video")


def build_dev_models(cfg: TrajCrafterConfig, device="cpu", seed: int = 0) -> ModelBundle:
    """Randomly initialised tiny diffusion stack (the JAX package's dev
    widths), fp32, with the plane-depth and pseudo-embedding stand-ins; the
    DiT quantized under ``--quant int8``."""
    check_supported(cfg)
    lc, text_len, text_dim = 4, 16, 64
    vae = _on_device(lambda: AutoencoderKLCogVideoX(
        latent_channels=lc, block_out_channels=(8, 16, 16, 32), layers_per_block=1,
        norm_num_groups=4), device, torch.float32)
    dit = build_dit(lambda: CrossTransformer3DModel(
        num_attention_heads=4, attention_head_dim=16, in_channels=2 * lc + 1,
        out_channels=lc, time_embed_dim=32, text_embed_dim=text_dim, num_layers=4,
        max_text_seq_length=text_len, cross_attn_dim_head=16, cross_attn_num_heads=4),
        device, torch.float32, seed + 1, cfg.diffusion.quant)
    pipeline = TrajCrafterPipeline(
        vae=random_init_(vae, seed), transformer=dit,
        scheduler=SCHEDULER_REGISTRY[cfg.diffusion.sampler_name](), dtype=torch.float32)

    def encode_prompt(prompt, negative):
        return (_pseudo_text_embeds(prompt or "", text_len, text_dim, device),
                _pseudo_text_embeds(negative or "", text_len, text_dim, device))

    return _bundle(cfg, pipeline, _plane_depth_infer, encode_prompt)


def _follower_bundle(cfg: TrajCrafterConfig, vae, dit, dtype,
                     depth_infer: Callable) -> ModelBundle:
    """The bundle of a mesh rank other than the leader: the VAE, the DiT
    (its shard once the pipeline takes the mesh), the sampler and the depth
    stage, no prompt encoder or captioner."""
    pipeline = TrajCrafterPipeline(vae=vae, transformer=dit, dtype=dtype,
                                   scheduler=SCHEDULER_REGISTRY[cfg.diffusion.sampler_name]())
    return ModelBundle(pipeline=pipeline, depth_infer=depth_infer, encode_prompt=None,
                       get_caption=None)


def full_scale_dit(attention_impl: str = "auto") -> CrossTransformer3DModel:
    """The deployed DiT (48 heads x 64, 42 layers, text 226 x 4096,
    Perceiver 16 x 128 every 2 blocks), unallocated when built under
    ``torch.device("meta")``."""
    return CrossTransformer3DModel(
        num_attention_heads=48, attention_head_dim=64, num_layers=42,
        max_text_seq_length=T5_TEXT_LEN, text_embed_dim=T5_TEXT_DIM,
        cross_attn_interval=2, cross_attn_dim_head=128, cross_attn_num_heads=16,
        use_rotary_positional_embeddings=True, attention_impl=attention_impl)


def build_full_scale_models(cfg: TrajCrafterConfig, device="cuda", seed: int = 0,
                            attention_impl: str = "auto", mesh=None) -> ModelBundle:
    """Every model at its deployed width, bf16, randomly initialised straight
    on ``device`` (the JAX package's full-scale synthetic bundle): the
    CrossTransformer3D DiT (48 heads x 64, 42 layers, text 226 x 4096,
    Perceiver 16 x 128 every 2 blocks) and the CogVideoX VAE ((128, 256,
    256, 512), 3 layers per block, 16 latent channels) with the
    ``--sampler_name`` sampler;
    T5-XXL; DepthCrafter's SVD UNet ((320, 640, 1280, 1280), heads (5, 10,
    20, 20)), SVD VAE and CLIP ViT-H/14.  ``--quant int8`` (the default)
    quantizes the DiT and ``--quant_depth int8`` the UNet's transformers
    after their init, so an int8 model is the quantization of the same
    seeded bf16 weights.  ``attention_impl`` is the DiT's (``"flash_pv8"``
    routes its joint self-attention and its Perceivers through the PV-int8
    kernel), as the JAX package's model constructors take it.

    Under ``mesh`` each rank builds its shard of the same DiT
    (``build_dit``), the same VAE and the same depth stage's models (each
    drawn from its own seed), and only the leader T5."""
    check_supported(cfg)
    dtype = torch.bfloat16
    dit = build_dit(lambda: full_scale_dit(attention_impl), device, dtype, seed + 1,
                    cfg.diffusion.quant, None if mesh is None else mesh.tp)
    if mesh is not None:
        shard_dit_(dit, mesh, units_done=True)
    vae = random_init_(_on_device(lambda: AutoencoderKLCogVideoX(), device, dtype), seed)
    unet = random_init_(_on_device(UNetSpatioTemporalConditionModel, device, dtype), seed + 3)
    if cfg.depth.quant == "int8":
        quantize_depth_unet_(unet)
    svd_vae = random_init_(_on_device(AutoencoderKLTemporalDecoder, device, dtype), seed + 4)
    clip = random_init_(_on_device(CLIPVisionModelWithProjection, device, dtype), seed + 5)
    depth_infer = depth_stage(unet, svd_vae, clip, dtype)
    if mesh is not None and not mesh.leader:
        return _follower_bundle(cfg, vae, dit, dtype, depth_infer)
    pipeline = TrajCrafterPipeline(vae=vae, transformer=dit,
                                   scheduler=SCHEDULER_REGISTRY[cfg.diffusion.sampler_name](),
                                   dtype=dtype)
    t5 = random_init_(_on_device(T5EncoderModel, device, dtype), seed + 2)
    return _bundle(cfg, pipeline, depth_infer, T5PromptEncoder(t5, T5_TEXT_LEN))


def load_full_bundle(cfg: TrajCrafterConfig, device="cuda", mesh=None) -> ModelBundle:
    """The inference bundle from a checkpoint tree laid out as the
    reference's: ``model_name/{vae,text_encoder,tokenizer}``,
    ``transformer_path``, ``unet_path``, ``pre_train_path/{vae,
    image_encoder}`` and ``blip_path``, every model on ``device`` in
    bf16 (the DiT in int8 under ``--quant int8``, the UNet's
    transformers under ``--quant_depth int8``).  A missing or unloadable T5 /
    tokenizer or DepthCrafter raises, unless ``--allow_dev_stubs``: then the
    pseudo prompt embeddings or the plane depth stand in, with a printed
    line.  BLIP-2 captions unless ``--prompt`` is given.  Under ``mesh``
    every rank loads the VAE, the DiT, of which it keeps its shard, and the
    depth stage; only the leader loads T5 and the captioner."""
    stats: dict = {}
    dtype = torch.bfloat16
    vae = load_vae(os.path.join(cfg.diffusion.model_name, "vae"), device, dtype, stats)
    dit = load_dit(cfg.diffusion.transformer_path, device, dtype, quant=cfg.diffusion.quant,
                   stats=stats)
    if mesh is not None and not mesh.leader:
        depth_infer = _load_depth(cfg, device, dtype, stats, mesh)
        return dataclasses.replace(_follower_bundle(cfg, vae, dit, dtype, depth_infer),
                                   load_stats=stats)
    pipeline = TrajCrafterPipeline(vae=vae, transformer=dit,
                                   scheduler=SCHEDULER_REGISTRY[cfg.diffusion.sampler_name](),
                                   dtype=dtype)

    te_path = os.path.join(cfg.diffusion.model_name, "text_encoder")
    tok_path = os.path.join(cfg.diffusion.model_name, "tokenizer")
    try:
        if not os.path.isdir(te_path):
            raise FileNotFoundError(
                f"text encoder directory missing: {te_path} -- download the "
                "CogVideoX-Fun text_encoder/ + tokenizer/ folders")
        encode_prompt = T5PromptEncoder(load_t5(te_path, device, dtype, stats), T5_TEXT_LEN,
                                        T5Tokenizer(tok_path))
    except Exception as e:
        if not cfg.allow_dev_stubs:
            raise RuntimeError(
                f"text encoder/tokenizer unavailable ({e}). Real prompts are "
                "load-bearing for output quality; pass --allow_dev_stubs to "
                "run with deterministic pseudo text embeddings instead.") from e
        print(f"{LOG} text encoder unavailable ({e}); falling back to pseudo-embeddings "
              "(--allow_dev_stubs)")

        def encode_prompt(prompt, negative):
            return (_pseudo_text_embeds(prompt or "", T5_TEXT_LEN, T5_TEXT_DIM, device),
                    _pseudo_text_embeds(negative or "", T5_TEXT_LEN, T5_TEXT_DIM, device))

    depth_infer = _load_depth(cfg, device, dtype, stats, mesh)
    if cfg.diffusion.prompt:
        get_caption = lambda frame: cfg.diffusion.prompt
    else:
        get_caption = build_captioner(cfg.diffusion.blip_path, device, stats)
    total = sum(s["bytes"] for s in stats.values())
    print(f"{LOG} bundle loaded on {device}: {total / 1e9:.2f} GB")
    return ModelBundle(pipeline=pipeline, depth_infer=depth_infer, encode_prompt=encode_prompt,
                       get_caption=get_caption, load_stats=stats)


def _load_depth(cfg: TrajCrafterConfig, device, dtype, stats: dict, mesh=None) -> Callable:
    """The depth stage from ``--unet_path`` and ``--pre_train_path``, or,
    only with ``--allow_dev_stubs``, the plane-depth stand-in where they do
    not load.  Under ``mesh`` every rank loads it, and ranks that disagree on
    which they got raise: the stage never runs on some ranks alone."""
    try:
        if not os.path.isdir(cfg.depth.unet_path):
            raise FileNotFoundError(f"DepthCrafter UNet directory missing: {cfg.depth.unet_path}")
        depth_infer = load_depthcrafter(cfg, device, dtype, stats)
    except Exception as e:
        if not cfg.allow_dev_stubs:
            raise RuntimeError(
                f"DepthCrafter unavailable ({e}). Depth drives the warp geometry; pass "
                "--allow_dev_stubs to run with a constant-plane depth stub instead.") from e
        print(f"{LOG} DepthCrafter unavailable ({e}); using plane-depth stub "
              "(--allow_dev_stubs)")
        depth_infer = _plane_depth_infer
    if mesh is not None:
        stub = torch.tensor([float(depth_infer is _plane_depth_infer)], device=device)
        agreed = D.all_reduce(stub.clone(), mesh.world, op="max")
        if agreed.item() != stub.item():
            raise RuntimeError("the ranks of the mesh disagree on the depth stage: some loaded "
                               "DepthCrafter, some fell back to the plane-depth stub")
    return depth_infer


def build_models(cfg: TrajCrafterConfig, device="cuda", mesh=None) -> ModelBundle:
    """The bundle of a run, on ``device`` (the card unless the caller asks
    for the CPU; the mesh's device under ``mesh``): loaded from the
    checkpoint tree at ``--model_name`` when it exists; without one, only
    ``--allow_dev_stubs`` builds random models at the deployed widths."""
    if mesh is not None:
        device = mesh.device
    check_supported(cfg)
    model_dir = cfg.diffusion.model_name
    exists = os.path.isdir(model_dir)
    if not exists and not cfg.allow_dev_stubs:
        raise FileNotFoundError(
            f"model checkpoints not found at '{model_dir}'; pass --allow_dev_stubs to "
            "run randomly initialised models")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: the models run on the card "
                           "(pass device='cpu' to build them on the CPU)")
    if exists:
        return load_full_bundle(cfg, device, mesh)
    print(f"{LOG} checkpoints not found at {model_dir}; building randomly initialised "
          f"models on {device} (--allow_dev_stubs)")
    return build_full_scale_models(cfg, device, mesh=mesh)


# ----------------------------------------------------------------------------
# orchestration
# ----------------------------------------------------------------------------


def resize_video(video, size) -> np.ndarray:
    """(F, H, W, 3) frames -> fp32 at ``size`` (height, width) by cv2
    ``INTER_LINEAR``; frames already at ``size`` are returned as they are."""
    video = np.asarray(video, np.float32)
    if video.shape[1:3] == tuple(size):
        return video
    return np.stack([cv2.resize(fr, (size[1], size[0]), interpolation=cv2.INTER_LINEAR)
                     for fr in video])


class TrajCrafter:
    def __init__(self, cfg: TrajCrafterConfig, models: Optional[ModelBundle] = None,
                 mesh=None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else stage_mesh(cfg)
        self.models = models if models is not None else build_models(cfg, mesh=self.mesh)
        if self.mesh is not None:
            self.models.pipeline.with_mesh(self.mesh)
            depth = depth_pipeline(self.models.depth_infer)
            if depth is not None:
                depth.with_mesh(self.mesh)
        self.device = self.models.pipeline.device
        self.timer: StageTimer = self.models.pipeline.timer

    @property
    def leader(self) -> bool:
        """True unless a mesh makes this rank one that does not write."""
        return self.mesh is None or self.mesh.leader

    def _from_leader(self, *xs):
        """Under a mesh, the leader's host arrays (numpy, or torch on the
        host; None passes as None) on every rank, each of the leader's kind;
        the other ranks pass as many placeholders.  Without a mesh, ``xs``."""
        if self.mesh is None:
            return xs
        world = self.mesh.world
        kinds = D.broadcast_object([None if x is None else isinstance(x, np.ndarray)
                                    for x in xs] if self.leader else None, world)
        got = D.broadcast_tensors([None if x is None else torch.as_tensor(x) for x in xs]
                                  if self.leader else None, world, self.device)
        if self.leader:
            return xs
        return tuple(None if numpy is None else g.cpu().numpy() if numpy else g.cpu()
                     for g, numpy in zip(got, kinds))

    # -- pose synthesis --------------------------------------------------
    def get_poses(self, depths: np.ndarray, num_frames: int, f_new: Optional[float] = None):
        """-> (pose_s, pose_t (n, 4, 4), K (n, 3, 3)), float32 on the host;
        with ``f_new`` the focal of K ramps from ``--focal`` to it."""
        cfg = self.cfg
        radius = pose_radius_from_depth(depths[0, 0], cfg.render.radius_scale)
        if f_new is not None:
            K = zoom_intrinsics(cfg.render.focal, f_new, num_frames, cfg.render.cx,
                                cfg.render.cy)
        else:
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
                          ref_slice=slice(0, None), save_skip: int = 0):
        """Resize to sample_size, save input/render/mask, run the diffusion
        pipeline, save gen and viz.

        frames and cond_video: (F, H, W, 3) in [0, 1]; cond_masks (F, H, W).
        Each that is not at sample_size is resized on the host as the JAX
        package resizes it: the videos with cv2 ``INTER_LINEAR`` on fp32, the
        masks with ``resize_nearest``; one already at sample_size (the modes'
        conditions, resized on the card by ``_fetch_cond``) is used as given.

        ``save_skip`` is the direct mode's saving scheme: render, mask and
        gen drop the first ``save_skip`` frames (the camera's fly-in), input
        keeps the first ``F - save_skip`` source frames, and viz pairs
        input[k] with gen[save_skip + k], which was generated from source
        frame k.

        Under a mesh every rank runs the pipeline on its own copy of the
        conditions (bit-equal on every rank) and gets the generated video
        back; the leader alone encodes the prompt and writes the mp4s.
        """
        cfg = self.cfg
        hs, ws = cfg.diffusion.sample_size
        device = self.device
        f = frames.shape[0]
        frames_s = resize_video(frames, (hs, ws))
        cond_video = resize_video(cond_video, (hs, ws))
        cond_masks = np.asarray(cond_masks, np.float32)
        if cond_masks.shape[1:3] != (hs, ws):
            cond_masks = resize_nearest(torch.from_numpy(cond_masks), (hs, ws)).numpy()
        pe = ne = None
        if self.leader:
            os.makedirs(cfg.save_dir, exist_ok=True)
            # the condition mp4s encode on background threads during diffusion
            saves = VideoSaveQueue()
            saves.save(frames_s[:f - save_skip], os.path.join(cfg.save_dir, "input.mp4"),
                       fps=cfg.fps)
            saves.save(cond_video[save_skip:], os.path.join(cfg.save_dir, "render.mp4"),
                       fps=cfg.fps)
            saves.save(np.repeat(cond_masks[save_skip:, ..., None], 3, -1),
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
            latents=self._initial_latents(f),
            noise_aug_strength=cfg.diffusion.noise_aug_strength,
        )
        # fetch as uint8: the mp4 stores 8 bits anyway
        gen = torch.round(sample[0].clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        gen = gen.cpu().numpy().astype(np.float32) / 255.0
        if not self.leader:
            return gen
        with self.timer("write_mp4"):
            saves.join()
            save_video(gen[save_skip:], os.path.join(cfg.save_dir, "gen.mp4"), fps=cfg.fps)
            # side-by-side viz with a boomerang reverse
            left, right = frames_s[:f - save_skip], gen[save_skip:]
            gap = np.ones((left.shape[0], hs, 30, 3), np.float32)
            viz = np.concatenate([left, gap, right], axis=2)
            viz = np.concatenate([viz, viz[::-1][1:]], axis=0)
            save_video(viz, os.path.join(cfg.save_dir, "viz.mp4"), fps=cfg.fps * 2)
        return gen

    # -- the modes -----------------------------------------------------------
    def _frames_prompt_depths(self):
        """The stages every mode opens with: frames and caption on the
        leader, then depth; under a mesh the frames are handed to every
        rank, each runs its share of the depth stage and ends with the
        whole depth (the prompt stays the leader's: None elsewhere)."""
        cfg = self.cfg
        frames = prompt = None
        if self.leader:
            with self.timer("read_frames"):
                frames = self._load_frames()
            with self.timer("caption"):
                prompt = self.models.get_caption(frames[cfg.video_length // 2]) + \
                    cfg.diffusion.refine_prompt
        if self.mesh is not None:
            with self.timer("handoff"):
                (frames,) = self._from_leader(frames)
        with self.timer("depth"):
            depths = self._estimate_depth(frames)
        return frames, prompt, depths

    def _poses(self, depths: np.ndarray, num_frames: int, f_new: Optional[float] = None):
        """``get_poses`` on the leader, handed to every rank of a mesh."""
        poses = self.get_poses(depths, num_frames, f_new) if self.leader else (None,) * 3
        return self._from_leader(*poses)

    def _warp(self, frames_pm1, depths, pose_s, pose_t, K1, K2=None):
        """Splat on the device (under a mesh each rank its share of the
        frames, every frame's outputs back on every rank), fetch the
        conditions at sample_size (host arrays) -> (cond_video, cond_masks)."""
        to_dev = lambda x: None if x is None else x.to(self.device)
        warped, masks, _, _ = forward_warp_batch(
            frames_pm1, depths, to_dev(pose_s), to_dev(pose_t), to_dev(K1), to_dev(K2),
            use_mask_clean=self.cfg.render.mask, mesh=self.mesh)
        return self._fetch_cond(warped, masks)

    def _device_depths(self, depths: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(depths[:, 0]).to(self.device)

    def _to_device(self, x) -> torch.Tensor:
        """A host array to the device as fp32."""
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)

    def infer_gradual(self):
        cfg = self.cfg
        frames, prompt, depths = self._frames_prompt_depths()
        with self.timer("poses"):
            pose_s, pose_t, K = self._poses(depths, cfg.video_length)
        with self.timer("warp"):
            cond_s, masks_s = self._warp(self._device_frames_pm1(frames),
                                         self._device_depths(depths), pose_s, pose_t, K)
        return self._diffuse_and_save(frames, cond_s, masks_s, prompt,
                                      ref_slice=slice(0, cfg.diffusion.ref_frames))

    def infer_direct(self, cut: int = 20):
        """The camera flies in over ``cut`` frames (clamped to [1, F // 2])
        on the frozen first frame, then follows the source delayed by
        ``cut``; returns the whole generated clip."""
        cfg = self.cfg
        n = cfg.video_length
        cut = max(1, min(cut, n // 2))
        frames, prompt, depths = self._frames_prompt_depths()
        with self.timer("poses"):
            pose_s, pose_t, K = self._poses(depths, cut)
            # freeze-then-follow schedule of source and target frames
            src_idx = torch.tensor([0 if i < cut else i - cut for i in range(n)])
            tgt_idx = torch.tensor([i if i < cut else cut - 1 for i in range(n)])
        with self.timer("warp"):
            # the source frames gathered on the device
            dev_idx = src_idx.to(self.device)
            cond_s, masks_s = self._warp(
                self._device_frames_pm1(frames)[dev_idx], self._device_depths(depths)[dev_idx],
                pose_s[:1].repeat(n, 1, 1), pose_t[tgt_idx], K[:1].repeat(n, 1, 1))
        return self._diffuse_and_save(frames, cond_s, masks_s, prompt,
                                      ref_slice=slice(0, cfg.diffusion.ref_frames),
                                      save_skip=cut)

    def infer_bullet(self):
        """The last frame, frozen, seen from every camera of the orbit."""
        cfg = self.cfg
        n = cfg.video_length
        frames, prompt, depths = self._frames_prompt_depths()
        with self.timer("poses"):
            pose_s, pose_t, K = self._poses(depths, n)
        with self.timer("warp"):
            cond_s, masks_s = self._warp(
                self._device_frames_pm1(frames[-1:]).repeat(n, 1, 1, 1),
                self._device_depths(depths[-1:]).repeat(n, 1, 1),
                pose_s[:1].repeat(n, 1, 1), pose_t, K[:1].repeat(n, 1, 1))
        return self._diffuse_and_save(frames, cond_s, masks_s, prompt,
                                      ref_slice=slice(-cfg.diffusion.ref_frames, None))

    def infer_zoom(self, f_new: float = 250.0):
        """A dolly zoom: the source intrinsics stay at frame 0's, the target
        focal ramps from ``--focal`` to ``f_new``."""
        cfg = self.cfg
        n = cfg.video_length
        frames, prompt, depths = self._frames_prompt_depths()
        with self.timer("poses"):
            pose_s, pose_t, K = self._poses(depths, n, f_new=f_new)
        with self.timer("warp"):
            cond_s, masks_s = self._warp(self._device_frames_pm1(frames),
                                         self._device_depths(depths), pose_s, pose_t,
                                         K[:1].repeat(n, 1, 1), K)
        return self._diffuse_and_save(frames, cond_s, masks_s, prompt,
                                      ref_slice=slice(0, cfg.diffusion.ref_frames))
