"""Alignment-driven autoregressive generation with consistent depth.

Counterpart of trajectorycrafter_tpu/consistent_autoregressive.py.  A long
trajectory is generated segment by segment against one point cloud per
frame; from the second stage on, the source segment's depth is aligned to
the depth rendered from those clouds before it is lifted and merged into
them, so the world geometry holds across segments.  Per stage:

  1. (stage > 0) ``_align_video_to_pcs``: render sparse depth and masks from
     the per-frame clouds at the source poses (z-buffer, point size 2, the
     masks opened with a 9 x 9 kernel); with a Video-Depth-Anything model,
     a visual prompt is trained through it at 1/``resize_factor`` of the
     resolution snapped to a multiple of 14 (``DepthAlignmentTrainer``);
     without one, the clip's DepthCrafter depth is aligned per frame by
     ``estimate_depth_with_alignment``; the source frames are lifted with the
     aligned depth and merged into the clouds, each downsampled to half;
  2. the clouds' frame order is reversed on even stages;
  3. the target views are rendered from the clouds and diffused;
  4. the generated segment, resized to the warp size, is the next source.

Depth is metric; VDA's inverse depth converts by ``DEPTH_SCALE``
(``invert_depth_with_scale``).  The clouds, renders and the trainer run on
the bundle's device.  The downsample draws from a ``torch.Generator`` seeded
with ``--seed``: ``jax.random`` cannot be replayed, so a run cannot
reproduce the JAX package's points from a seed.  Stages: those of the modes,
``relift`` (the first lift), ``align`` and ``render``.

Under a mesh (orchestrator.py's rule) the leader reads and captions the
clip and hands the frames on, keeps the clouds, lifts, renders, merges and
downsamples them, writes the stage directories and cameras, and hands each
stage's renders and masks to every rank, which runs the pipeline.  The VDA
and its alignment trainer run on the leader alone (the other ranks hold
none); without a VDA the segment depth is the collective DepthCrafter stage
on every rank, and the leader aligns it to the clouds' renders.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from trajectorycrafter_tpu_torch.depth_alignment import (
    DepthAlignmentTrainer,
    estimate_depth_with_alignment,
)
from trajectorycrafter_tpu_torch.geometry.cameras import (
    default_c2w,
    intrinsics_matrix,
    pose_radius_from_depth,
)
from trajectorycrafter_tpu_torch.geometry.pointcloud import (
    downsample_pointcloud,
    lift_to_pointcloud,
    render_zbuffer,
)
from trajectorycrafter_tpu_torch.geometry.trajectory import generate_traj_specified
from trajectorycrafter_tpu_torch.models.vda import infer_video_depth, normalize_imagenet
from trajectorycrafter_tpu_torch.ops.morphology import mask_open
from trajectorycrafter_tpu_torch.ops.resize import resize_linear, resize_nearest
from trajectorycrafter_tpu_torch.orchestrator import TrajCrafter, resize_video
from trajectorycrafter_tpu_torch.parallel import distributed as D

DEPTH_SCALE = 10000.0

PointClouds = List[Tuple[torch.Tensor, torch.Tensor]]


def invert_depth_with_scale(depth: torch.Tensor, scale: float = DEPTH_SCALE,
                            eps: float = 1e-8) -> torch.Tensor:
    """depth <-> scaled inverse depth, zeros kept."""
    return torch.where(depth > eps, scale / depth.clamp_min(eps), torch.zeros_like(depth))


@torch.no_grad()
def render_video_from_pcs(pcs: Sequence[Tuple[torch.Tensor, torch.Tensor]], poses: torch.Tensor,
                          intrinsic: torch.Tensor, hw: Tuple[int, int], point_size: int = 2,
                          mask_kernel: int = 9) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Frame i's cloud rendered into camera i (``poses`` c2w) -> (images,
    depths, masks) as host arrays; the masks opened (``mask_open``, one
    erosion and one dilation by ``mask_kernel``) and applied to image and
    depth."""
    views = [render_zbuffer(pts, cols, intrinsic, w2c, hw[0], hw[1], point_size=point_size)
             for (pts, cols), w2c in zip(pcs, torch.linalg.inv(poses))]
    masks = mask_open(torch.stack([v[2] for v in views]), size=mask_kernel, n_erosion=1,
                      n_dilation=1)
    imgs = torch.stack([v[0] for v in views]) * masks[..., None]
    depths = torch.stack([v[1] for v in views]) * masks
    return imgs.cpu().numpy(), depths.cpu().numpy(), masks.cpu().numpy()


def lift_video_to_pcs(frames: torch.Tensor, depths: torch.Tensor, intrinsic: torch.Tensor,
                      poses: torch.Tensor) -> PointClouds:
    """One cloud per frame, frames (F, H, W, 3) lifted with depths (F, H, W)
    from cameras ``poses`` (c2w).  A pixel whose depth is not above 1e-6 is
    parked at NaN, which fails every bounds test of ``render_zbuffer``, so
    it is culled rather than drawn at the camera's origin."""
    out = []
    for frame, depth, pose in zip(frames, depths, poses):
        pts, cols = lift_to_pointcloud(frame, depth, intrinsic, pose)
        valid = (depth > 1e-6).reshape(-1, 1)
        out.append((torch.where(valid, pts, torch.full_like(pts, float("nan"))), cols))
    return out


def merge_pcs_downsample(global_pcs: PointClouds, new_pcs: PointClouds,
                         generator: torch.Generator) -> PointClouds:
    """Each frame's clouds joined, then half of the points drawn from
    ``generator`` without replacement."""
    merged = []
    for (gp, gc), (sp, sc) in zip(global_pcs, new_pcs):
        pts, cols = torch.cat([gp, sp]), torch.cat([gc, sc])
        merged.append(downsample_pointcloud(pts, cols, pts.shape[0] // 2, generator))
    return merged


def _snap(v: int, multiple: int) -> int:
    return max((v // multiple) * multiple, multiple)


def estimate_depth_with_prompt_alignment(
    frames01: np.ndarray,  # (F, H, W, 3) in [0, 1]
    sparse_depth: np.ndarray,  # (F, H, W) metric, 0 = unknown
    sparse_mask: np.ndarray,  # (F, H, W)
    intrinsic: np.ndarray,  # (3, 3)
    extrinsics: np.ndarray,  # (F, 4, 4)
    trainer: DepthAlignmentTrainer,
    depth_scale: float = DEPTH_SCALE,
    resize_factor: int = 2,
    multiple_of: int = 14,
    epochs: int = 50,
    device="cpu",
) -> np.ndarray:
    """Metric depth (F, H, W) aligned to the rendered sparse depth: the
    trainer runs at (H, W) / ``resize_factor`` snapped to a multiple of 14,
    in inverse depth; its result is resized back and inverted."""
    f, h, w, _ = frames01.shape
    hr = _snap(h // resize_factor, multiple_of)
    wr = _snap(w // resize_factor, multiple_of)
    to_dev = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)

    frames_r = resize_linear(to_dev(frames01).permute(0, 3, 1, 2), (hr, wr))
    sparse_r = resize_linear(to_dev(sparse_depth)[:, None], (hr, wr))[:, 0]
    mask_r = resize_nearest(to_dev(sparse_mask), (hr, wr)) > 0.5
    # zero depth outside the resized mask, then the mask from what is positive
    sparse_r = sparse_r * mask_r
    mask_r = sparse_r > 0

    k = np.asarray(intrinsic, np.float32).copy()
    k[0, :] *= wr / w
    k[1, :] *= hr / h
    depth_inv, _, _, _ = trainer.train(
        normalize_imagenet(frames_r), invert_depth_with_scale(sparse_r, depth_scale), mask_r,
        intrinsics=to_dev(k), extrinsics=to_dev(extrinsics), epochs=epochs)
    with torch.no_grad():
        depth_inv_full = resize_linear(depth_inv[:, None], (h, w))[:, 0]
        return invert_depth_with_scale(depth_inv_full, depth_scale).cpu().numpy()


class TrajCrafterConsistentDepth(TrajCrafter):
    """The consistent-depth autoregressive orchestrator.  ``vda`` is a
    ``VideoDepthAnything`` on the bundle's device, or None: then the segment
    depth is the bundle's DepthCrafter and stages align it with
    ``estimate_depth_with_alignment`` in place of the visual-prompt
    trainer."""

    def __init__(self, cfg, models=None, vda=None, align_epochs: int = 50,
                 resize_factor: int = 2, depth_scale: float = DEPTH_SCALE,
                 tae_weight: float = 0.0, mesh=None):
        super().__init__(cfg, models, mesh)
        self.vda = vda
        # under a mesh the leader alone holds the VDA: every rank follows its route
        self.uses_vda = vda is not None if self.mesh is None else \
            D.broadcast_object(vda is not None if self.leader else None, self.mesh.world)
        self.align_epochs = align_epochs
        self.resize_factor = resize_factor
        self.depth_scale = depth_scale
        # the trainer's metric-space TAE inverts with the targets' scale
        self.trainer: Optional[DepthAlignmentTrainer] = None if vda is None else \
            DepthAlignmentTrainer(vda, depth_scale=depth_scale, tae_weight=tae_weight)

    # -- depth ---------------------------------------------------------------
    def _segment_depth(self, frames01: np.ndarray) -> Optional[np.ndarray]:
        """(F, H, W) metric depth of a segment: the VDA on the frames
        reflect-padded to multiples of 14 (windows of 32 sharing 10),
        inverted with ``depth_scale`` and cropped, on the leader (None on the
        other ranks of a mesh); DepthCrafter without a VDA, on every rank."""
        if not self.uses_vda:
            return self._estimate_depth(frames01)[:, 0]
        if not self.leader:
            return None
        f, h, w, _ = frames01.shape
        ph, pw = (-h) % 14, (-w) % 14
        top, left = ph // 2, pw // 2
        x = self._to_device(frames01).permute(0, 3, 1, 2)
        x = F.pad(x, (left, pw - left, top, ph - top), mode="reflect")
        inv = infer_video_depth(self.vda, normalize_imagenet(x))[:, top:top + h, left:left + w]
        return invert_depth_with_scale(inv, self.depth_scale).cpu().numpy()

    def _align_video_to_pcs(self, frames01: np.ndarray, poses_source: torch.Tensor,
                            intrinsic: torch.Tensor, global_pcs: PointClouds,
                            generator: torch.Generator):
        """Render sparse depth from the clouds, align a fresh estimate to it,
        lift the frames with it and merge -> (clouds, aligned depth); under a
        mesh the DepthCrafter estimate runs on every rank, the rest on the
        leader (the other ranks get (None, None))."""
        raw = None if self.uses_vda else self._segment_depth(frames01)
        if not self.leader:
            return None, None
        hw = frames01.shape[1:3]
        _, sparse_depth, sparse_mask = render_video_from_pcs(global_pcs, poses_source,
                                                             intrinsic, hw)
        if self.trainer is not None:
            aligned = estimate_depth_with_prompt_alignment(
                frames01, sparse_depth, sparse_mask, intrinsic.cpu().numpy(),
                poses_source.cpu().numpy(), self.trainer, depth_scale=self.depth_scale,
                resize_factor=self.resize_factor, epochs=self.align_epochs, device=self.device)
        else:
            aligned = estimate_depth_with_alignment(raw, sparse_depth, sparse_mask,
                                                    steps=self.align_epochs, device=self.device)
        new_pcs = lift_video_to_pcs(self._to_device(frames01), self._to_device(aligned),
                                    intrinsic, poses_source)
        return merge_pcs_downsample(global_pcs, new_pcs, generator), aligned

    # -- the loop ------------------------------------------------------------
    def infer_autoregressive(self, n_splits: int = 4, theta: float = 90.0, phi: float = 0.0,
                             d_r: float = 0.0, d_x: float = 0.0, d_y: float = 0.0,
                             save_stages: bool = True) -> np.ndarray:
        """``n_splits`` consecutive segments along the specified trajectory,
        each of ``--video_length`` frames, anchored by the per-frame clouds;
        each stage's mp4s and cameras (``c2ws_target.npy``,
        ``c2ws_source.npy``) go to ``stage_XX/``."""
        cfg = self.cfg
        seg_len = cfg.video_length
        hw, ww = cfg.warp_size
        frames = prompt = None
        if self.leader:
            with self.timer("read_frames"):
                frames = self._load_frames()
            with self.timer("caption"):
                prompt = self.models.get_caption(frames[seg_len // 2]) + \
                    cfg.diffusion.refine_prompt
        if self.mesh is not None:
            with self.timer("handoff"):
                (frames,) = self._from_leader(frames)
        with self.timer("depth"):
            depths = self._segment_depth(frames)

        global_pcs = poses_all = poses_source = K = generator = None
        if self.leader:
            with self.timer("poses"):
                radius = pose_radius_from_depth(depths[0], cfg.render.radius_scale)
                K = intrinsics_matrix(cfg.render.focal, cfg.render.cx,
                                      cfg.render.cy).to(self.device)
                # the target chain over every segment; the source is its first pose
                poses_all = generate_traj_specified(default_c2w(), theta, phi, d_r * radius,
                                                    d_x, d_y, seg_len * n_splits)
                poses_all[:, 2, 3] += radius
                poses_all = poses_all.to(self.device)
                poses_source = poses_all[0:1].repeat(seg_len, 1, 1)
            with self.timer("relift"):
                global_pcs = lift_video_to_pcs(self._to_device(frames), self._to_device(depths),
                                               K, poses_source)
            generator = torch.Generator(device=self.device).manual_seed(cfg.seed)

        out_segments: List[np.ndarray] = []
        cur_frames = frames
        base_dir = cfg.save_dir
        for stage in range(n_splits):
            stage_dir = os.path.join(base_dir, f"stage_{stage:02d}")
            renders = masks = None
            if self.leader:
                poses_target = poses_all[stage * seg_len:(stage + 1) * seg_len]
                if save_stages:
                    os.makedirs(stage_dir, exist_ok=True)
                    np.save(os.path.join(stage_dir, "c2ws_target.npy"),
                            poses_target.cpu().numpy())
                    np.save(os.path.join(stage_dir, "c2ws_source.npy"),
                            poses_source.cpu().numpy())
            if stage > 0:
                with self.timer("align"):
                    global_pcs, _ = self._align_video_to_pcs(cur_frames, poses_source, K,
                                                             global_pcs, generator)
            if self.leader:
                if stage % 2 == 0:
                    global_pcs = global_pcs[::-1]
                with self.timer("render"):
                    renders, _, masks = render_video_from_pcs(global_pcs, poses_target, K,
                                                              (hw, ww))
            if self.mesh is not None:
                with self.timer("handoff"):
                    renders, masks = self._from_leader(renders, masks)

            cfg.save_dir = stage_dir if save_stages else base_dir
            try:
                gen = self._diffuse_and_save(cur_frames, renders, masks, prompt,
                                             ref_slice=slice(0, cfg.diffusion.ref_frames))
            finally:
                cfg.save_dir = base_dir
            out_segments.append(gen)
            if stage + 1 < n_splits:
                cur_frames = resize_video(gen, (hw, ww))
                if self.leader:
                    poses_source = poses_target
        return np.concatenate(out_segments, axis=0)
