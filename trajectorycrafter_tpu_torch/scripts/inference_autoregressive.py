"""Long trajectory by pose continuation (autoregressive v1) on the card.

    python -m trajectorycrafter_tpu_torch.scripts.inference_autoregressive \
        --video_path clip.mp4 --n_splits 4 --overlap_frames 8 --total_theta 180

The port's counterpart of the root ``inference_autoregressive.py``: the CLI's
flags plus the trajectory's; writes each segment's mp4s to the run's
directory and the joined video to ``autoregressive.mp4``.  Under
``--mesh_dp/--mesh_sp/--mesh_tp`` (torchrun, as cli.py) it runs sharded
(autoregressive.py) and the leader alone writes; every rank returns the
joined video.
"""

from __future__ import annotations

import os

from trajectorycrafter_tpu_torch.autoregressive import TrajCrafterAutoregressive
from trajectorycrafter_tpu_torch.cli import (
    config_from_args,
    entry_world,
    get_parser,
    require_card,
)
from trajectorycrafter_tpu_torch.orchestrator import check_supported
from trajectorycrafter_tpu_torch.utils.video import save_video


def add_trajectory_flags(parser):
    parser.add_argument("--n_splits", type=int, default=4)
    parser.add_argument("--overlap_frames", type=int, default=8)
    parser.add_argument("--total_theta", type=float, default=180.0)
    parser.add_argument("--total_phi", type=float, default=0.0)
    parser.add_argument("--total_dr", type=float, default=0.0)
    return parser


def main(argv=None):
    args = add_trajectory_flags(get_parser()).parse_args(argv)
    cfg = config_from_args(args)
    check_supported(cfg)
    require_card()
    with entry_world(cfg, args.dist_backend) as leader:
        if leader:
            os.makedirs(cfg.save_dir, exist_ok=True)
        tc = TrajCrafterAutoregressive(cfg)
        video = tc.infer_autoregressive(n_splits=args.n_splits,
                                        overlap_frames=args.overlap_frames,
                                        theta=args.total_theta, phi=args.total_phi,
                                        d_r=args.total_dr)
        if leader:
            save_video(video, os.path.join(cfg.save_dir, "autoregressive.mp4"), fps=cfg.fps)
            print(f"wrote {video.shape[0]} frames to {cfg.save_dir}/autoregressive.mp4")
    return video


if __name__ == "__main__":
    main()
