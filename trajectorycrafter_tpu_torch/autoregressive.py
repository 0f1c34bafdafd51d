"""Long trajectories generated segment by segment (both variants).

Counterpart of trajectorycrafter_tpu/autoregressive.py.  A trajectory of
``n_splits * (F - overlap) + overlap`` poses is cut into windows of F poses
that share ``overlap`` poses (``split_trajectory``); each window is one
diffusion of F frames, and the segments are joined dropping each later
segment's first ``overlap`` frames.

  * v1, ``TrajCrafterAutoregressive``: each window warps the previous
    segment's video (the source clip for the first) from the window's first
    pose into its poses, with depth estimated anew on that video, resized
    from sample size to warp size by cv2.
  * v2, ``TrajCrafterGlobalPointCloud``: the clip is lifted once into a
    world-space point cloud from the anchor camera; each window's views are
    z-buffer renders of the cloud (geometry/pointcloud.py); each generated
    segment is lifted back with its depth scaled to the renders' (the
    IQR-filtered median ratio, ``align_depth_scale``), merged into the cloud
    and the cloud downsampled above ``max_points``; the cloud, the cameras
    and a viewer are written to ``save_dir/scene/`` (utils/export.py).

The warp and the renders run on the device; the conditions go to
``_diffuse_and_save`` at warp size and are resized there as the JAX package
resizes them.  Stages: those of the modes, ``render`` (the z-buffer views),
``relift`` (the cloud's lifts, merges and downsampling) and ``export``.

Under a mesh (orchestrator.py's rule) the leader makes the trajectory and
hands it on; v1 warps on the mesh (every rank its share of the frames,
every frame back on every rank) and every rank feeds each generated
segment, which ``_diffuse_and_save`` returns on every rank, into the next
collective depth stage.  v2's cloud is the leader's: it lifts, renders,
merges, downsamples and exports, and hands each window's renders and masks
to every rank; every rank runs the depth stage on each generated segment,
and the leader aligns its scale to the renders.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from trajectorycrafter_tpu_torch.geometry.cameras import (
    default_c2w,
    intrinsics_matrix,
    pose_radius_from_depth,
)
from trajectorycrafter_tpu_torch.geometry.pointcloud import (
    downsample_pointcloud,
    lift_video_to_pointcloud,
    merge_pointclouds,
    render_zbuffer,
)
from trajectorycrafter_tpu_torch.geometry.trajectory import generate_traj_specified
from trajectorycrafter_tpu_torch.ops.splat import forward_warp_batch
from trajectorycrafter_tpu_torch.orchestrator import TrajCrafter, resize_video
from trajectorycrafter_tpu_torch.utils.export import save_colmap, save_html_viewer, save_ply


def align_depth_scale(depth_new: np.ndarray, depth_ref: np.ndarray,
                      mask: Optional[np.ndarray] = None) -> float:
    """Robust scale from ``depth_new`` to ``depth_ref``: the median of the
    ratios ref / new over the pixels where both are finite and above 1e-6
    (and ``mask`` > 0.5), after dropping ratios outside 1.5 IQR of the
    quartiles; 1.0 when fewer than 16 pixels qualify."""
    a = depth_new.reshape(-1)
    b = depth_ref.reshape(-1)
    if mask is not None:
        keep = mask.reshape(-1) > 0.5
        a, b = a[keep], b[keep]
    ok = (a > 1e-6) & (b > 1e-6) & np.isfinite(a) & np.isfinite(b)
    if ok.sum() < 16:
        return 1.0
    ratio = b[ok] / a[ok]
    q1, q3 = np.percentile(ratio, [25, 75])
    iqr = q3 - q1
    inlier = (ratio >= q1 - 1.5 * iqr) & (ratio <= q3 + 1.5 * iqr)
    if inlier.sum() == 0:
        return float(np.median(ratio))
    return float(np.median(ratio[inlier]))


def split_trajectory(total_poses, n_splits: int, seg_len: int, overlap: int) -> List[np.ndarray]:
    """Index windows of ``seg_len`` poses over all of ``total_poses``, each
    starting ``seg_len - overlap`` after the last; a last window is moved
    back to end at the last pose when the stride does not reach it."""
    n = total_poses.shape[0]
    step = seg_len - overlap
    starts = list(range(0, max(n - seg_len, 0) + 1, step))
    if starts[-1] + seg_len < n:
        starts.append(n - seg_len)
    return [np.arange(s, s + seg_len) for s in starts]


class _Segments(TrajCrafter):
    """What both variants share: the trajectory and its windows."""

    def _windows(self, n_splits: int, overlap_frames: int) -> List[np.ndarray]:
        """The trajectory's windows of ``--video_length`` poses (they depend
        on its length alone, so every rank of a mesh makes them)."""
        seg_len = self.cfg.video_length
        total = n_splits * (seg_len - overlap_frames) + overlap_frames
        return split_trajectory(np.empty((total, 0)), n_splits, seg_len, overlap_frames)

    def _trajectory(self, depths, n_splits, overlap_frames, theta, phi, d_r):
        """-> (poses (total, 4, 4) c2w on the host, K (3, 3), radius): on the
        leader of a mesh, None elsewhere."""
        if not self.leader:
            return None, None, None
        cfg = self.cfg
        seg_len = cfg.video_length
        total = n_splits * (seg_len - overlap_frames) + overlap_frames
        radius = pose_radius_from_depth(depths[0, 0], cfg.render.radius_scale)
        poses = generate_traj_specified(default_c2w(), theta, phi, d_r * radius, 0.0, 0.0, total)
        poses[:, 2, 3] += radius
        K = intrinsics_matrix(cfg.render.focal, cfg.render.cx, cfg.render.cy)
        return poses, K, radius


class TrajCrafterAutoregressive(_Segments):
    """v1: pose continuation, depth re-estimated on each generated segment."""

    def infer_autoregressive(self, n_splits: int = 4, overlap_frames: int = 8,
                             theta: float = 180.0, phi: float = 0.0,
                             d_r: float = 0.0) -> np.ndarray:
        cfg = self.cfg
        seg_len = cfg.video_length
        frames, prompt, depths = self._frames_prompt_depths()
        with self.timer("poses"):
            poses_all, K, _ = self._trajectory(depths, n_splits, overlap_frames, theta, phi,
                                               d_r)
            poses_all, K = self._from_leader(poses_all, K)
            K = K[None].repeat(seg_len, 1, 1).to(self.device)

        out_segments: List[np.ndarray] = []
        cur_frames, cur_depths = frames, depths
        windows = self._windows(n_splits, overlap_frames)
        for wi, win in enumerate(windows):
            pose_t = poses_all[win].to(self.device)
            with self.timer("warp"):
                # from the window's first pose, continuing the pose chain
                warped, masks, _, _ = forward_warp_batch(
                    self._to_device(cur_frames * 2.0 - 1.0), self._to_device(cur_depths[:, 0]),
                    pose_t[:1].repeat(seg_len, 1, 1), pose_t, K,
                    use_mask_clean=cfg.render.mask, mesh=self.mesh)
                cond = ((warped + 1.0) / 2.0).cpu().numpy()
                masks = masks.cpu().numpy()
                del warped
            gen = self._diffuse_and_save(cur_frames, cond, masks, prompt,
                                         ref_slice=slice(0, cfg.diffusion.ref_frames))
            out_segments.append(gen if wi == 0 else gen[overlap_frames:])
            if wi + 1 < len(windows):
                cur_frames = resize_video(gen, cfg.warp_size)
                with self.timer("depth"):
                    cur_depths = self._estimate_depth(cur_frames)
        return np.concatenate(out_segments, axis=0)


class TrajCrafterGlobalPointCloud(_Segments):
    """v2: every view rendered from one global point cloud that each
    generated segment is merged back into."""

    def infer_autoregressive(self, n_splits: int = 4, overlap_frames: int = 8,
                             theta: float = 180.0, phi: float = 0.0, d_r: float = 0.0,
                             max_points: int = 4_000_000) -> np.ndarray:
        cfg = self.cfg
        seg_len = cfg.video_length
        hw, ww = cfg.warp_size
        frames, prompt, depths = self._frames_prompt_depths()
        with self.timer("poses"):
            poses_all, K, radius = self._trajectory(depths, n_splits, overlap_frames, theta, phi,
                                                    d_r)
        if self.leader:
            anchor = default_c2w()
            anchor[2, 3] += radius
            K_dev = K.to(self.device)
            Ks = K_dev[None].repeat(seg_len, 1, 1)
            with self.timer("relift"):
                # the input frames, all seen from the anchor camera
                points, colors = lift_video_to_pointcloud(
                    self._to_device(frames), self._to_device(depths[:, 0]), Ks,
                    anchor.to(self.device)[None].repeat(seg_len, 1, 1))

        out_segments: List[np.ndarray] = []
        windows = self._windows(n_splits, overlap_frames)
        for wi, win in enumerate(windows):
            cond = rend_depth = masks = None
            if self.leader:
                pose_t = poses_all[win].to(self.device)
                with self.timer("render"):
                    views = [render_zbuffer(points, colors, K_dev, w2c, hw, ww)
                             for w2c in torch.linalg.inv(pose_t)]
                    cond = torch.stack([v[0] for v in views]).cpu().numpy()
                    rend_depth = torch.stack([v[1] for v in views]).cpu().numpy()
                    masks = torch.stack([v[2] for v in views]).cpu().numpy()
                    del views
            if self.mesh is not None:
                with self.timer("handoff"):
                    cond, masks = self._from_leader(cond, masks)
            gen = self._diffuse_and_save(cond, cond, masks, prompt,
                                         ref_slice=slice(0, cfg.diffusion.ref_frames))
            out_segments.append(gen if wi == 0 else gen[overlap_frames:])
            if wi + 1 < len(windows):
                gen_w = resize_video(gen, cfg.warp_size)
                with self.timer("depth"):
                    gen_depth = self._estimate_depth(gen_w)[:, 0]
                if not self.leader:
                    continue
                with self.timer("relift"):
                    scale = align_depth_scale(gen_depth, rend_depth, masks)
                    del rend_depth
                    new_pts, new_cols = lift_video_to_pointcloud(
                        self._to_device(gen_w), self._to_device(gen_depth * scale), Ks, pose_t)
                    points, colors = merge_pointclouds([points, new_pts], [colors, new_cols])
                    del new_pts, new_cols
                    if points.shape[0] > max_points:
                        points, colors = downsample_pointcloud(
                            points, colors, max_points,
                            torch.Generator(device=self.device).manual_seed(wi))

        if self.leader:
            with self.timer("export"):
                # the scene: a PLY, a COLMAP text model and an HTML viewer
                scene_dir = os.path.join(cfg.save_dir, "scene")
                pts_np, cols_np = points.cpu().numpy(), colors.cpu().numpy()
                c2ws_np = list(poses_all.numpy())
                Ks_np = [K.numpy()] * len(c2ws_np)
                save_ply(os.path.join(scene_dir, "points.ply"), pts_np, cols_np)
                save_colmap(scene_dir, Ks_np, c2ws_np, ww, hw, pts_np, cols_np)
                save_html_viewer(os.path.join(scene_dir, "viewer.html"), pts_np, cols_np,
                                 c2ws_np, Ks_np, height=hw)
        return np.concatenate(out_segments, axis=0)
