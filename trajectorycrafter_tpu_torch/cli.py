"""Command line for the PyTorch port: ``python -m trajectorycrafter_tpu_torch.cli``.

The reference flag surface (the upstream inference.py:8-172) on the
port's dataclass config: ``get_parser``, ``config_from_args`` and
``validate`` are the port's copies of trajectorycrafter_tpu/cli.py's (the
same option strings, defaults and messages; tests/test_torch_cli.py holds
them together).  ``main`` runs the port's ``TrajCrafter`` on the CUDA card.

``--mesh_dp/--mesh_sp/--mesh_tp`` shard the run over that many ranks (the
warp's frames, the VAE's slabs, the denoise; orchestrator.py), started by
torchrun, one process a rank:

    torchrun --nproc_per_node 4 -m trajectorycrafter_tpu_torch.cli \
        --mesh_sp 2 --mesh_tp 2 --video_path ... --traj_txt ...

The scripts of ``scripts/`` built on ``TrajCrafter`` (the orbit sweep,
autoregressive v1 and v2, known cameras, consistent depth) take the same
flags and start the same world (``entry_world``); the Gradio app refuses
them.  A mesh whose product is not the world size raises.  One option of the port
alone chooses the transport: ``--dist_backend`` (``nccl``, the default, one
card a rank; or ``gloo``, which also runs several ranks on one card: with
fewer cards than ranks, the ranks share them evenly).
"""

from __future__ import annotations

import argparse
import contextlib
import os
from datetime import datetime

import torch
import torch.distributed as dist

from trajectorycrafter_tpu_torch.config import TrajCrafterConfig
from trajectorycrafter_tpu_torch.orchestrator import TrajCrafter, check_supported
from trajectorycrafter_tpu_torch.parallel import distributed


def get_parser() -> argparse.ArgumentParser:
    d = TrajCrafterConfig()
    p = argparse.ArgumentParser(description="TrajectoryCrafter-TPU inference")

    # general (reference inference.py:11-35)
    p.add_argument("--video_path", type=str, help="Input path")
    p.add_argument("--out_dir", type=str, default=d.out_dir, help="Output dir")
    p.add_argument("--exp_name", type=str, default=None,
                   help="Experiment name, video file name by default")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--video_length", type=int, default=d.video_length)
    p.add_argument("--fps", type=int, default=d.fps)
    p.add_argument("--stride", type=int, default=d.stride)
    p.add_argument("--server_name", type=str, help="Gradio server IP address")

    # render (reference inference.py:37-68)
    p.add_argument("--radius_scale", type=float, default=d.render.radius_scale)
    p.add_argument("--camera", type=str, default=d.render.camera,
                   choices=["traj", "target"])
    p.add_argument("--mode", type=str, default=d.render.mode,
                   choices=["gradual", "direct", "bullet", "zoom"])
    p.add_argument("--mask", action="store_true", default=False,
                   help="Clean (dilate) the disocclusion mask")
    p.add_argument("--traj_txt", type=str, help="theta/phi/r knot file for 'traj'")
    p.add_argument("--target_pose", nargs=5, type=float,
                   help="<theta phi r x y> for 'target'")
    p.add_argument("--near", type=float, default=d.render.near)
    p.add_argument("--far", type=float, default=d.render.far)
    p.add_argument("--anchor_idx", type=int, default=d.render.anchor_idx)

    # diffusion (reference inference.py:70-132)
    p.add_argument("--low_gpu_memory_mode", type=bool, default=False,
                   help="accepted for reference-CLI compatibility (no effect)")
    p.add_argument("--model_name", type=str, default=d.diffusion.model_name)
    p.add_argument("--quant", type=str, default=d.diffusion.quant,
                   choices=("none", "int8"),
                   help="DiT GEMM precision; default int8, 'none' keeps bf16")
    p.add_argument("--quant_depth", type=str, default=d.depth.quant,
                   choices=("none", "int8"),
                   help="int8: the depth UNet's transformer GEMMs in int8")
    p.add_argument("--steps_per_dispatch", type=int,
                   default=d.diffusion.steps_per_dispatch,
                   help="read by the JAX package only (the port runs eagerly)")
    p.add_argument("--sampler_name", type=str, default=d.diffusion.sampler_name,
                   choices=["Euler", "Euler A", "DPM++", "PNDM", "DDIM_Cog",
                            "DDIM_Origin"])
    p.add_argument("--transformer_path", type=str,
                   default=d.diffusion.transformer_path)
    p.add_argument("--sample_size", type=int, nargs=2,
                   default=list(d.diffusion.sample_size))
    p.add_argument("--diffusion_guidance_scale", type=float,
                   default=d.diffusion.guidance_scale)
    p.add_argument("--diffusion_inference_steps", type=int,
                   default=d.diffusion.num_inference_steps)
    p.add_argument("--prompt", type=str, default=None)
    p.add_argument("--negative_prompt", type=str, default=d.diffusion.negative_prompt)
    p.add_argument("--refine_prompt", type=str, default=d.diffusion.refine_prompt)
    p.add_argument("--blip_path", type=str, default=d.diffusion.blip_path)
    p.add_argument("--torch_rng_compat", action="store_true", default=False,
                   help="draw initial latents with torch's RNG at --seed for "
                        "bit-comparable outputs vs the reference")

    # depth (reference inference.py:134-170)
    p.add_argument("--unet_path", type=str, default=d.depth.unet_path)
    p.add_argument("--pre_train_path", type=str, default=d.depth.pre_train_path)
    p.add_argument("--cpu_offload", type=str, default=None,
                   help="reference-CLI compatibility alias (reference default "
                        "'model'): 'model'/'sequential' map to --offload stage")
    p.add_argument("--depth_inference_steps", type=int,
                   default=d.depth.num_inference_steps)
    p.add_argument("--depth_guidance_scale", type=float,
                   default=d.depth.guidance_scale)
    p.add_argument("--window_size", type=int, default=d.depth.window_size)
    p.add_argument("--overlap", type=int, default=d.depth.overlap)
    p.add_argument("--max_res", type=int, default=d.depth.max_res)

    # parallelism: the dp x sp x tp mesh of the run, over torchrun's ranks
    p.add_argument("--mesh_dp", type=int, default=1)
    p.add_argument("--mesh_sp", type=int, default=1)
    p.add_argument("--mesh_tp", type=int, default=1)
    # the port's transport (the JAX package takes its devices from jax)
    p.add_argument("--dist_backend", choices=distributed.BACKENDS, default="nccl",
                   help="process-group backend of a sharded run: nccl (one card a "
                        "rank) or gloo (also ranks that share a card)")

    p.add_argument("--offload", choices=["auto", "stage", "none"],
                   default=TrajCrafterConfig().offload,
                   help="the JAX package's stage-wise host offload (the port "
                        "keeps every model on the card)")
    p.add_argument("--allow_dev_stubs", action="store_true", default=False,
                   help="run with randomly-initialised models when checkpoints "
                        "are missing (development only; off by default)")
    return p


def config_from_args(args: argparse.Namespace) -> TrajCrafterConfig:
    cfg = TrajCrafterConfig()
    cfg.video_path = args.video_path
    cfg.out_dir = args.out_dir
    cfg.seed = args.seed
    cfg.video_length = args.video_length
    cfg.fps = args.fps
    cfg.stride = args.stride

    cfg.render.radius_scale = args.radius_scale
    cfg.render.camera = args.camera
    cfg.render.mode = args.mode
    cfg.render.mask = args.mask
    cfg.render.traj_txt = args.traj_txt
    cfg.render.target_pose = tuple(args.target_pose) if args.target_pose else None
    cfg.render.near = args.near
    cfg.render.far = args.far
    cfg.render.anchor_idx = args.anchor_idx

    cfg.diffusion.model_name = args.model_name
    cfg.diffusion.sampler_name = args.sampler_name
    cfg.diffusion.quant = args.quant
    cfg.depth.quant = args.quant_depth
    cfg.diffusion.steps_per_dispatch = args.steps_per_dispatch
    cfg.diffusion.transformer_path = args.transformer_path
    cfg.diffusion.sample_size = tuple(args.sample_size)
    cfg.diffusion.guidance_scale = args.diffusion_guidance_scale
    cfg.diffusion.num_inference_steps = args.diffusion_inference_steps
    cfg.diffusion.prompt = args.prompt
    cfg.diffusion.negative_prompt = args.negative_prompt
    cfg.diffusion.refine_prompt = args.refine_prompt
    cfg.diffusion.blip_path = args.blip_path
    cfg.diffusion.torch_rng_compat = args.torch_rng_compat

    cfg.depth.unet_path = args.unet_path
    cfg.depth.pre_train_path = args.pre_train_path
    cfg.depth.num_inference_steps = args.depth_inference_steps
    cfg.depth.guidance_scale = args.depth_guidance_scale
    cfg.depth.window_size = args.window_size
    cfg.depth.overlap = args.overlap
    cfg.depth.max_res = args.max_res

    cfg.parallel.dp = args.mesh_dp
    cfg.parallel.sp = args.mesh_sp
    cfg.parallel.tp = args.mesh_tp
    cfg.allow_dev_stubs = args.allow_dev_stubs
    cfg.offload = args.offload
    # reference-CLI alias: a passed --cpu_offload (default None = not passed)
    # maps onto stage offload unless --offload was set away from its default
    if args.cpu_offload in ("model", "sequential") and cfg.offload == "auto":
        cfg.offload = "stage"

    exp = args.exp_name
    if exp is None:
        prefix = datetime.now().strftime("%Y%m%d_%H%M")
        base = os.path.splitext(os.path.basename(args.video_path or "run"))[0]
        exp = f"{base}_{prefix}"
    cfg.exp_name = exp
    cfg.save_dir = os.path.join(cfg.out_dir, exp)
    return cfg


def validate(cfg: TrajCrafterConfig) -> None:
    """Fail fast on config errors -- before any model is built."""
    if not cfg.video_path:
        raise SystemExit("error: --video_path is required")
    if not os.path.isfile(cfg.video_path):
        raise SystemExit(f"error: video not found: {cfg.video_path}")
    if cfg.render.camera == "traj":
        if not cfg.render.traj_txt:
            raise SystemExit("error: --camera traj requires --traj_txt")
        if not os.path.isfile(cfg.render.traj_txt):
            raise SystemExit(f"error: traj file not found: {cfg.render.traj_txt}")
    if cfg.render.camera == "target" and cfg.render.target_pose is None:
        raise SystemExit("error: --camera target requires --target_pose "
                         "<theta phi r x y>")
    if cfg.video_length > 49:
        raise SystemExit("error: --video_length must be <= 49 "
                         "(DiT positional-embedding cap; reference "
                         "pipeline_trajectorycrafter.py:786-789)")
    if (cfg.video_length - 1) % 8 != 0:
        raise SystemExit("error: --video_length must be 8k+1 (9, 17, ..., 49) "
                         "so the causal VAE's latent count stays odd and the "
                         "decode returns exactly video_length frames")


def parse_config(argv=None) -> TrajCrafterConfig:
    """A validated config from a command line; raises for a quantization or
    sampler the port does not have, before anything is built (int8 never
    becomes bf16)."""
    cfg = config_from_args(get_parser().parse_args(argv))
    validate(cfg)
    check_supported(cfg)
    return cfg


def require_card() -> None:
    """Exit with an error when no CUDA device is available: the entry points
    run on the card."""
    if not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device is available; the port runs on a CUDA card")


def start_world(cfg: TrajCrafterConfig, backend: str = "nccl") -> bool:
    """The process group of a sharded run: started from torchrun's
    environment, or, where this process runs one already (a caller's world:
    the tests' gloo worlds, the smoke's torchrun world), that one, which
    must hold as many ranks as the mesh.  Returns whether this call started
    it (the caller then shuts it down: ``entry_world``); False at a 1x1x1
    mesh, which runs unsharded with no process group.  Raises, before
    anything is built, where the mesh's product is not the world size."""
    par = cfg.parallel
    n = par.dp * par.sp * par.tp
    running = dist.is_initialized()
    world = dist.get_world_size() if running else int(os.environ.get("WORLD_SIZE", "1"))
    if n != world:
        raise ValueError(f"the mesh --mesh_dp {par.dp} x --mesh_sp {par.sp} x --mesh_tp "
                         f"{par.tp} = {n} ranks does not match the world of {world} "
                         "(torchrun --nproc_per_node)")
    if n == 1 or running:
        return False
    distributed.init_from_env(backend)
    return True


@contextlib.contextmanager
def entry_world(cfg: TrajCrafterConfig, backend: str = "nccl"):
    """The process group of an entry point's run (``start_world``) while the
    block runs, shut down after it where this call started it; yields
    whether this rank leads (rank 0 of a mesh, or an unsharded run): the
    leader alone makes directories, writes and prints."""
    started = start_world(cfg, backend)
    try:
        yield not dist.is_initialized() or dist.get_rank() == 0
    finally:
        if started:
            distributed.shutdown()


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)
    cfg = parse_config(argv)
    require_card()
    with entry_world(cfg, args.dist_backend) as leader:
        if leader:
            os.makedirs(cfg.save_dir, exist_ok=True)
        tc = TrajCrafter(cfg)
        modes = {"gradual": tc.infer_gradual, "direct": tc.infer_direct,
                 "bullet": tc.infer_bullet, "zoom": tc.infer_zoom}
        modes[cfg.render.mode]()
        if leader:
            print(f"outputs written to {cfg.save_dir}")


if __name__ == "__main__":
    main()
