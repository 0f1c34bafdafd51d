"""Long trajectory with consistent depth (the alignment-driven loop) on the card.

    python -m trajectorycrafter_tpu_torch.scripts.inference_alignment \
        --video_path clip.mp4 --n_splits 4 --total_theta 90 \
        [--vda_ckpt video_depth_anything_vitl.pth --vda_encoder vitl]

The port's counterpart of the root ``inference_alignment.py``: the CLI's
flags plus the trajectory's, the alignment's and the VDA's; writes each
stage's mp4s and cameras to ``stage_XX/`` and the joined video to
``autoregressive_aligned.mp4``.  ``--vda_ckpt`` is the official
Video-Depth-Anything checkpoint (``.pth``, or a ``.safetensors`` of its
keys), held to its key manifest as it loads; a file that fails to load is an
error.  Without the flag, the segment depth is DepthCrafter's, aligned per
frame to the clouds' renders.
"""

from __future__ import annotations

import os

from trajectorycrafter_tpu_torch import orchestrator
from trajectorycrafter_tpu_torch.cli import config_from_args, get_parser, require_card
from trajectorycrafter_tpu_torch.consistent_autoregressive import TrajCrafterConsistentDepth
from trajectorycrafter_tpu_torch.orchestrator import check_supported
from trajectorycrafter_tpu_torch.utils.checkpoints import load_vda
from trajectorycrafter_tpu_torch.utils.video import save_video


def main(argv=None):
    parser = get_parser()
    parser.add_argument("--n_splits", type=int, default=4)
    parser.add_argument("--total_theta", type=float, default=90.0)
    parser.add_argument("--total_phi", type=float, default=0.0)
    parser.add_argument("--total_dr", type=float, default=0.0)
    parser.add_argument("--align_epochs", type=int, default=50)
    parser.add_argument("--resize_factor", type=int, default=2,
                        help="the alignment runs at 1/N of the resolution")
    parser.add_argument("--vda_ckpt", type=str, default=None,
                        help="the official Video-Depth-Anything checkpoint (.pth, or "
                             ".safetensors of its keys; the JAX entry point takes an orbax "
                             "directory here, which the port does not read); enables the "
                             "visual-prompt trainer")
    parser.add_argument("--vda_encoder", choices=("vits", "vitb", "vitl"), default="vitl")
    parser.add_argument("--tae_weight", type=float, default=0.0,
                        help="weight of the geometric reprojection TAE term in the "
                             "alignment loss")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    check_supported(cfg)
    require_card()
    os.makedirs(cfg.save_dir, exist_ok=True)

    # the checkpoint is read and checked before the bundle is built
    vda = load_vda(args.vda_ckpt, args.vda_encoder, device="cpu") if args.vda_ckpt else None
    models = orchestrator.build_models(cfg)
    if vda is not None:
        vda = vda.to(models.pipeline.device)
    tc = TrajCrafterConsistentDepth(cfg, models=models, vda=vda,
                                    align_epochs=args.align_epochs,
                                    resize_factor=args.resize_factor, tae_weight=args.tae_weight)
    video = tc.infer_autoregressive(n_splits=args.n_splits, theta=args.total_theta,
                                    phi=args.total_phi, d_r=args.total_dr)
    save_video(video, os.path.join(cfg.save_dir, "autoregressive_aligned.mp4"), fps=cfg.fps)
    print(f"wrote {video.shape[0]} frames to {cfg.save_dir}")
    return video


if __name__ == "__main__":
    main()
