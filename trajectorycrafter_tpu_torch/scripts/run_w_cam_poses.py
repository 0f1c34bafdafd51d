"""Re-render a source camera's video from a calibrated target camera, on the card.

    python -m trajectorycrafter_tpu_torch.scripts.run_w_cam_poses \
        --video_path src.mp4 --calib_json calib.json --source_cam a --target_cam b \
        [--depth_npy depth.npy] [--smooth [--target_video tgt.mp4]]

The port's counterpart of the root ``run_w_cam_poses.py``: the cameras come
from a Panoptic-style json (a ``cameras`` list of {name, K, R, t in cm,
distCoef}); the clip is read at its native size, undistorted with the source
camera's calibration and resized to the warp size, and the target camera's
intrinsics are scaled by the same factors.  ``--smooth`` flies the target
camera from the source to the target over the clip, and with
``--target_video`` scores the last frame against the held-out view
(``metrics.json``).  Under ``--mesh_dp/--mesh_sp/--mesh_tp`` (torchrun, as
cli.py) the leader reads the calibration, the clips and the depth and hands
them to every rank, the run is sharded (known_poses.py), and the leader
alone writes and returns the metrics.
"""

from __future__ import annotations

import json
import os

import numpy as np

from trajectorycrafter_tpu_torch.cli import (
    config_from_args,
    entry_world,
    get_parser,
    require_card,
)
from trajectorycrafter_tpu_torch.known_poses import (
    CalibratedCamera,
    CameraPoseTrajCrafter,
    panoptic_to_camera,
    undistort_and_resize,
)
from trajectorycrafter_tpu_torch.orchestrator import check_supported
from trajectorycrafter_tpu_torch.utils.video import pad_to_length, read_video_frames


def main(argv=None):
    parser = get_parser()
    parser.add_argument("--calib_json", type=str, required=True,
                        help="Panoptic-style calibration json with a "
                             "'cameras' list of {name, K, R, t, distCoef}")
    parser.add_argument("--source_cam", type=str, required=True)
    parser.add_argument("--target_cam", type=str, required=True)
    parser.add_argument("--depth_npy", type=str, default=None,
                        help="optional (F, H, W) metric depth .npy; "
                             "estimated otherwise")
    parser.add_argument("--smooth", action="store_true",
                        help="SLERP-interpolate the target camera from "
                             "source to target over the clip")
    parser.add_argument("--target_video", type=str, default=None,
                        help="held-out target-view video for the smooth "
                             "variant's PSNR/SSIM/MS-SSIM eval")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    check_supported(cfg)
    require_card()
    with entry_world(cfg, args.dist_backend) as leader:
        inputs = _read_inputs(args, cfg) if leader else (None,) * 9
        tc = CameraPoseTrajCrafter(cfg)
        frames, depths, target_frames, *cams = tc._from_leader(*inputs)
        src, tgt = CalibratedCamera(*cams[:3]), CalibratedCamera(*cams[3:])
        metrics = None
        if args.smooth:
            _, metrics = tc.infer_camera_poses_smooth(frames, depths, src, tgt,
                                                      target_frames=target_frames)
            if metrics is not None:
                print(json.dumps(metrics["metrics"]))
        else:
            tc.infer_camera_poses(frames, depths, src, tgt)
        if leader:
            print(f"outputs written to {cfg.save_dir}")
    return metrics


def _read_inputs(args, cfg):
    """The run's inputs, read on the leader: (frames at the warp size,
    depth or None, held-out target frames or None, the source camera's K, R,
    t, the target camera's K, R, t)."""
    os.makedirs(cfg.save_dir, exist_ok=True)
    with open(args.calib_json) as f:
        calib = json.load(f)
    cams = {c.get("name", str(i)): panoptic_to_camera(c) for i, c in enumerate(calib["cameras"])}
    src, tgt = cams[args.source_cam], cams[args.target_cam]

    # native size: the undistortion takes the calibrated K before any resize
    frames = read_video_frames(cfg.video_path, cfg.video_length, cfg.stride, cfg.depth.max_res,
                               width=None, height=None)
    frames = pad_to_length(frames, cfg.video_length)
    native_hw = frames.shape[1:3]
    frames, k_scaled = undistort_and_resize(frames, src, cfg.warp_size)
    tgt_k = tgt.K.copy()
    tgt_k[0] *= cfg.warp_size[1] / native_hw[1]
    tgt_k[1] *= cfg.warp_size[0] / native_hw[0]
    depths = np.load(args.depth_npy) if args.depth_npy else None
    target_frames = None
    if args.smooth and args.target_video:
        target_frames = pad_to_length(read_video_frames(
            args.target_video, cfg.video_length, cfg.stride, cfg.depth.max_res,
            width=None, height=None), cfg.video_length)
    return frames, depths, target_frames, k_scaled, src.R, src.t, tgt_k, tgt.R, tgt.t


if __name__ == "__main__":
    main()
