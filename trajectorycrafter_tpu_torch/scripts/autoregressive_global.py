"""Long trajectory from a global point cloud (autoregressive v2) on the card.

    python -m trajectorycrafter_tpu_torch.scripts.autoregressive_global \
        --video_path clip.mp4 --n_splits 4 --overlap_frames 8 --max_points 4000000

The port's counterpart of the root ``autoregressive_global.py``: the CLI's
flags plus the trajectory's and ``--max_points``; writes each segment's
mp4s, the scene (``scene/points.ply``, a COLMAP text model,
``scene/viewer.html``) and the joined video ``autoregressive_global.mp4``.
Under ``--mesh_dp/--mesh_sp/--mesh_tp`` (torchrun, as cli.py) it runs
sharded (autoregressive.py: the cloud on the leader) and the leader alone
writes; every rank returns the joined video.
"""

from __future__ import annotations

import os

from trajectorycrafter_tpu_torch.autoregressive import TrajCrafterGlobalPointCloud
from trajectorycrafter_tpu_torch.cli import (
    config_from_args,
    entry_world,
    get_parser,
    require_card,
)
from trajectorycrafter_tpu_torch.orchestrator import check_supported
from trajectorycrafter_tpu_torch.scripts.inference_autoregressive import add_trajectory_flags
from trajectorycrafter_tpu_torch.utils.video import save_video


def main(argv=None):
    parser = add_trajectory_flags(get_parser())
    parser.add_argument("--max_points", type=int, default=4_000_000)
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    check_supported(cfg)
    require_card()
    with entry_world(cfg, args.dist_backend) as leader:
        if leader:
            os.makedirs(cfg.save_dir, exist_ok=True)
        tc = TrajCrafterGlobalPointCloud(cfg)
        video = tc.infer_autoregressive(n_splits=args.n_splits,
                                        overlap_frames=args.overlap_frames,
                                        theta=args.total_theta, phi=args.total_phi,
                                        d_r=args.total_dr, max_points=args.max_points)
        if leader:
            save_video(video, os.path.join(cfg.save_dir, "autoregressive_global.mp4"),
                       fps=cfg.fps)
            print(f"wrote {video.shape[0]} frames to {cfg.save_dir}")
    return video


if __name__ == "__main__":
    main()
