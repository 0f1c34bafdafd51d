"""Known camera poses: re-render a source camera's video from calibrated
dataset cameras.

Counterpart of trajectorycrafter_tpu/known_poses.py.  Calibrated cameras
(K, R, t, optional distortion) drive the source -> target warp in place of a
synthesised orbit: Panoptic Studio json entries, DyCheck-iPhone sequences,
MVTracker / Kubric npz samples and Shape-of-Motion items.  The camera
conversions, undistortion and the loaders are the JAX module's host code
(numpy and cv2), copied; the warp runs on the device through
``forward_warp_batch`` and the diffusion through ``_diffuse_and_save``, which
resizes the warp-size conditions as the JAX package does.

``infer_camera_poses_smooth`` flies the target camera from the source to the
target over the clip (quaternion SLERP of the world-to-camera matrices, lerp
of the intrinsics: geometry/interpolate.py) and, given the held-out target
view, scores the last generated frame against it (``evaluate_target_view``).

Under a mesh (orchestrator.py's rule) every rank passes the same clip,
depth and cameras (scripts/run_w_cam_poses.py reads them on the leader and
hands them on); a depth left None is estimated by the collective depth
stage, the caption is the leader's, the warp runs on the mesh and every
rank runs the pipeline; the leader alone makes directories and writes the
metrics.
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from datetime import datetime
from typing import Dict, List, Optional, Sequence, Tuple

import cv2
import numpy as np

from trajectorycrafter_tpu_torch.geometry.interpolate import (
    interpolate_intrinsics,
    interpolate_poses,
)
from trajectorycrafter_tpu_torch.ops.splat import forward_warp_batch
from trajectorycrafter_tpu_torch.orchestrator import TrajCrafter
from trajectorycrafter_tpu_torch.utils.quality import _ssim_frame, ms_ssim, psnr
from trajectorycrafter_tpu_torch.utils.video import f01_to_u8, save_video


@dataclass
class CalibratedCamera:
    """One dataset camera: intrinsics + world-to-camera extrinsics."""

    K: np.ndarray  # (3, 3)
    R: np.ndarray  # (3, 3)
    t: np.ndarray  # (3,) or (3, 1)
    dist_coef: Optional[np.ndarray] = None  # cv2 distortion coefficients

    @property
    def w2c(self) -> np.ndarray:
        m = np.eye(4, dtype=np.float64)
        m[:3, :3] = self.R
        m[:3, 3] = np.asarray(self.t).reshape(3)
        return m

    @property
    def c2w(self) -> np.ndarray:
        return np.linalg.inv(self.w2c)


def panoptic_to_camera(calib: dict) -> CalibratedCamera:
    """Panoptic Studio json calibration entry -> CalibratedCamera
    (reference run_w_cam_poses.py:13-27; t is in cm -> metres)."""
    return CalibratedCamera(
        K=np.asarray(calib["K"], np.float64),
        R=np.asarray(calib["R"], np.float64),
        t=np.asarray(calib["t"], np.float64).reshape(3) / 100.0,
        dist_coef=np.asarray(calib.get("distCoef"), np.float64)
        if calib.get("distCoef") is not None else None,
    )


def undistort_and_resize(
    frames: np.ndarray,  # (F, H, W, 3) float [0, 1]
    cam: CalibratedCamera,
    out_size: Tuple[int, int],  # (height, width)
) -> Tuple[np.ndarray, np.ndarray]:
    """cv2 undistort then resize, rescaling the intrinsics accordingly
    (reference run_w_cam_poses.py:71-149)."""
    oh, ow = out_size
    h, w = frames.shape[1:3]
    K = cam.K.copy()
    out = []
    for f in frames:
        img = (f * 255.0).astype(np.uint8)
        if cam.dist_coef is not None:
            img = cv2.undistort(img, cam.K, cam.dist_coef)
        out.append(cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR))
    K[0] *= ow / w
    K[1] *= oh / h
    return np.stack(out).astype(np.float32) / 255.0, K


# ----------------------------------------------------------------------------
# DyCheck-iPhone dataset (reference iphone_original_dataset.py)
#
# Layout: root/{sequence}/camera/{cam}_{frame:05d}.json
#         root/{sequence}/rgb/{scale}/{cam}_{frame:05d}.png
#         root/{sequence}/depth/{scale}/{0}_{frame:05d}.npy   (camera 0 only)
# ----------------------------------------------------------------------------


def iphone_camera_from_json(params: dict) -> CalibratedCamera:
    """DyCheck camera json -> warp extrinsics.

    The json stores a scalar ``focal_length``, ``principal_point`` [cx, cy],
    ``orientation`` (3x3) and ``position`` (3,).  The reference's net
    transform chain (iphone_original_dataset.py:226-253 builds
    inv([orientation.T | -orientation.T t]) = [orientation | position], then
    run_w_cam_poses_iphone.py:21-33 inverts once more before warping) ends at
    inv([orientation | position]) = [orientation.T | -orientation.T position],
    which is what the warper consumes as world-to-camera here.
    """
    f = float(params["focal_length"])
    cx, cy = (float(v) for v in params["principal_point"])
    K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float64)
    Rw = np.asarray(params["orientation"], np.float64)
    p = np.asarray(params["position"], np.float64).reshape(3)
    return CalibratedCamera(K=K, R=Rw.T, t=-Rw.T @ p)


@dataclass
class IPhoneSequence:
    """One contiguous multi-camera slice of a DyCheck-iPhone sequence."""

    frame_ids: List[int]
    frames: Dict[int, np.ndarray]  # cam id -> (F, H, W, 3) float [0, 1]
    depths: Optional[np.ndarray]  # (F, H, W) metric depth from camera 0
    cameras: Dict[int, List[CalibratedCamera]]  # cam id -> per-frame cameras


def load_iphone_sequence(
    root: str,
    sequence: str,
    scale: str = "1x",
    camera_ids: Sequence[int] = (0, 1, 2),
    frame_range: Optional[Tuple[int, int]] = None,
    min_sequence_length: int = 1,
) -> IPhoneSequence:
    """Discover and load the longest contiguous frame run present for ALL
    requested cameras (reference iphone_original_dataset.py:70-150: frames
    are valid when the camera json + rgb png -- and depth npy for camera
    0 -- all exist; the intersection across cameras is split into contiguous
    runs and short runs are dropped)."""
    seq_dir = os.path.join(root, sequence)
    cam_dir = os.path.join(seq_dir, "camera")
    rgb_dir = os.path.join(seq_dir, "rgb", scale)
    depth_dir = os.path.join(seq_dir, "depth", scale)

    per_cam: Dict[int, set] = {}
    for cam in camera_ids:
        ids = set()
        for path in glob.glob(os.path.join(cam_dir, f"{cam}_*.json")):
            fid = int(os.path.splitext(os.path.basename(path))[0].split("_")[1])
            if not os.path.isfile(os.path.join(rgb_dir, f"{cam}_{fid:05d}.png")):
                continue
            if cam == 0 and not os.path.isfile(
                os.path.join(depth_dir, f"0_{fid:05d}.npy")
            ):
                continue
            ids.add(fid)
        per_cam[cam] = ids

    common = sorted(set.intersection(*per_cam.values())) if per_cam else []
    if frame_range is not None:
        lo, hi = frame_range
        common = [f for f in common if lo <= f <= hi]

    # longest contiguous run of at least min_sequence_length
    runs: List[List[int]] = []
    for fid in common:
        if runs and fid == runs[-1][-1] + 1:
            runs[-1].append(fid)
        else:
            runs.append([fid])
    runs = [r for r in runs if len(r) >= min_sequence_length]
    if not runs:
        raise ValueError(
            f"no contiguous frame run >= {min_sequence_length} found for "
            f"cameras {tuple(camera_ids)} under {seq_dir}"
        )
    frame_ids = max(runs, key=len)

    frames: Dict[int, np.ndarray] = {}
    cameras: Dict[int, List[CalibratedCamera]] = {}
    for cam in camera_ids:
        imgs, cams = [], []
        for fid in frame_ids:
            img = cv2.imread(os.path.join(rgb_dir, f"{cam}_{fid:05d}.png"),
                             cv2.IMREAD_COLOR)
            imgs.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
            with open(os.path.join(cam_dir, f"{cam}_{fid:05d}.json")) as fh:
                cams.append(iphone_camera_from_json(json.load(fh)))
        frames[cam] = np.stack(imgs).astype(np.float32) / 255.0
        cameras[cam] = cams

    depths = None
    if 0 in camera_ids:
        ds = []
        for fid in frame_ids:
            d = np.load(os.path.join(depth_dir, f"0_{fid:05d}.npy"))
            ds.append(np.squeeze(d, -1) if d.ndim == 3 else d)
        depths = np.stack(ds).astype(np.float32)

    return IPhoneSequence(frame_ids=list(frame_ids), frames=frames,
                          depths=depths, cameras=cameras)


# ----------------------------------------------------------------------------
# MVTracker / Kubric multiview samples (reference run_w_cam_poses_mvtracker.py)
# ----------------------------------------------------------------------------


def mvtracker_camera(intrs: np.ndarray, extrs: np.ndarray) -> CalibratedCamera:
    """MVTracker convention: ``intrs`` (3, 3), ``extrs`` (3, 4) = [R|t]
    world-to-camera, used as-is (run_w_cam_poses_mvtracker.py:21-36)."""
    extrs = np.asarray(extrs, np.float64)
    return CalibratedCamera(K=np.asarray(intrs, np.float64),
                            R=extrs[:, :3], t=extrs[:, 3])


def load_mvtracker_npz(path: str, source_view: int = 0,
                       target_view: int = 1) -> dict:
    """Load one MVTracker/Kubric multiview sample from an .npz file.

    Mirrors the field accesses at run_w_cam_poses_mvtracker.py:93-135:
    ``video`` (V, T, 3, H, W) or (V, T, H, W, 3) uint8/float, ``videodepth``
    (V, T, 1, H, W) or (V, T, H, W), ``intrs`` (V, T, 3, 3) or (V, 3, 3),
    ``extrs`` (V, T, 3, 4) or (V, 3, 4); cameras are taken at t=0 as the
    reference does (``data.intrs[v][0]``).
    """
    with np.load(path, allow_pickle=False) as z:
        def pick(*names):
            for n in names:
                if n in z:
                    return np.asarray(z[n])
            raise KeyError(f"{path}: none of {names} present "
                           f"(has {sorted(z.keys())})")

        video = pick("video", "rgbs")
        depth = pick("videodepth", "depths")
        intrs = pick("intrs", "intrinsics")
        extrs = pick("extrs", "extrinsics")

    if video.ndim != 5:
        raise ValueError(f"video must be 5-D (V,T,...), got {video.shape}")
    if video.shape[2] == 3 and video.shape[-1] != 3:  # (V, T, 3, H, W)
        video = np.moveaxis(video, 2, -1)
    if np.issubdtype(video.dtype, np.integer):
        video = video.astype(np.float32) / 255.0
    video = video.astype(np.float32)

    if depth.ndim == 5:  # (V, T, 1, H, W)
        depth = depth[:, :, 0]
    cam_at = lambda a, v: a[v, 0] if a.ndim == 4 else a[v]

    return {
        "frames": video[source_view],
        "target_frames": video[target_view],
        "depths": depth[source_view].astype(np.float32),
        "source_cam": mvtracker_camera(cam_at(intrs, source_view),
                                       cam_at(extrs, source_view)),
        "target_cam": mvtracker_camera(cam_at(intrs, target_view),
                                       cam_at(extrs, target_view)),
        "seq_name": os.path.splitext(os.path.basename(path))[0],
    }


# ----------------------------------------------------------------------------
# Shape-of-Motion items (reference run_w_cam_poses_iphone_som.py)
# ----------------------------------------------------------------------------


def som_camera(item: dict) -> CalibratedCamera:
    """SOM dataset item: ``Ks`` (3, 3) and ``w2cs`` (4, 4) world-to-camera,
    consumed directly (run_w_cam_poses_iphone_som.py:21-36: 'Keep as w2c
    since TrajCrafter expects that')."""
    w2c = np.asarray(item["w2cs"], np.float64)
    return CalibratedCamera(K=np.asarray(item["Ks"], np.float64),
                            R=w2c[:3, :3], t=w2c[:3, 3])


def load_som_sequence(source_items: Sequence[dict],
                      target_items: Sequence[dict]) -> dict:
    """Stack per-frame SOM items (keys ``imgs`` (H, W, 3) in [0, 1],
    ``depths`` (H, W), ``Ks``, ``w2cs``, optional segmentation ``masks``)
    into one warp-ready sample (run_w_cam_poses_iphone_som.py:37-93)."""
    if len(source_items) != len(target_items):
        raise ValueError("source/target sequences must be the same length")
    frames = np.stack([np.asarray(it["imgs"], np.float32)
                       for it in source_items])
    target_frames = np.stack([np.asarray(it["imgs"], np.float32)
                              for it in target_items])
    depths = np.stack([np.asarray(it["depths"], np.float32)
                       for it in source_items])
    sample = {
        "frames": frames,
        "target_frames": target_frames,
        "depths": depths,
        "source_cam": som_camera(source_items[0]),
        "target_cam": som_camera(target_items[0]),
        "seq_name": "som",
    }
    if all("masks" in it for it in source_items):
        sample["masks"] = np.stack([np.asarray(it["masks"], np.float32)
                                    for it in source_items])
    return sample


def rotate_for_aspect(frames: np.ndarray, K: np.ndarray,
                      target_size: Tuple[int, int],
                      enable: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Rotate a portrait clip 90 deg clockwise when that matches the target
    aspect better, updating intrinsics (run_w_cam_poses_iphone_som.py:160-258;
    the reference computes the decision but ships with it disabled --
    ``enable`` mirrors that default)."""
    h, w = frames.shape[1:3]
    th, tw = target_size
    if not enable or abs(h / w - tw / th) >= abs(w / h - tw / th):
        return frames, K
    rotated = np.stack([np.rot90(f, k=-1, axes=(0, 1)) for f in frames])
    K_new = K.copy()
    # 90 deg clockwise: (x, y) -> (y, -x)  (reference :230-246)
    K_new[0, 0], K_new[1, 1] = K[1, 1], K[0, 0]
    K_new[0, 2] = K[1, 2]
    K_new[1, 2] = w - 1 - K[0, 2]
    return rotated, K_new


class CameraPoseTrajCrafter(TrajCrafter):
    """Source view -> target view re-rendering with calibrated cameras."""

    def _warp_known(self, frames, depths, prompt, t2, k2, source_cam):
        """Depth (estimated when ``depths`` is None) and caption, then the warp
        of every frame from ``source_cam`` into the per-frame world-to-camera
        ``t2`` (n, 4, 4) and intrinsics ``k2`` (n, 3, 3) on the device ->
        (depths, prompt, cond (n, H, W, 3) in [0, 1], masks (n, H, W)) on the
        host, at the frames' size."""
        cfg = self.cfg
        n = frames.shape[0]
        if depths is None:
            with self.timer("depth"):
                depths = self._estimate_depth(frames)[:, 0]
        if self.leader:
            with self.timer("caption"):
                prompt = (prompt or self.models.get_caption(frames[n // 2])) + \
                    cfg.diffusion.refine_prompt
        to_dev = self._to_device
        with self.timer("warp"):
            t1 = to_dev(source_cam.w2c)[None].repeat(n, 1, 1)
            k1 = to_dev(source_cam.K)[None].repeat(n, 1, 1)
            warped, masks, _, _ = forward_warp_batch(
                to_dev(frames * 2.0 - 1.0), to_dev(depths), t1, to_dev(t2), k1, to_dev(k2),
                use_mask_clean=cfg.render.mask, mesh=self.mesh)
            cond = ((warped + 1.0) / 2.0).cpu().numpy()
            masks = masks.cpu().numpy()
        return prompt, cond, masks

    def infer_camera_poses(
        self,
        frames: np.ndarray,  # (F, H, W, 3) source-view frames in [0, 1]
        depths: Optional[np.ndarray],  # (F, H, W) metric depth or None
        source_cam: CalibratedCamera,
        target_cam: CalibratedCamera,
        prompt: Optional[str] = None,
    ) -> np.ndarray:
        """Every frame warped from the source camera into the target camera
        (each with its own K and dataset extrinsics), then diffused."""
        n = frames.shape[0]
        t2 = np.repeat(np.asarray(target_cam.w2c, np.float32)[None], n, 0)
        k2 = np.repeat(np.asarray(target_cam.K, np.float32)[None], n, 0)
        prompt, cond, masks = self._warp_known(frames, depths, prompt, t2, k2, source_cam)
        return self._diffuse_and_save(frames, cond, masks, prompt,
                                      ref_slice=slice(0, self.cfg.diffusion.ref_frames))

    def infer_multiview(
        self,
        frames: np.ndarray,
        depths: Optional[np.ndarray],
        source_cam: CalibratedCamera,
        target_cams: Sequence[CalibratedCamera],
        prompt: Optional[str] = None,
    ) -> List[np.ndarray]:
        """Several target cameras from one source view, each into
        ``save_dir/view_<i>``."""
        base = self.cfg.save_dir
        outs = []
        try:
            for i, cam in enumerate(target_cams):
                self.cfg.save_dir = os.path.join(base, f"view_{i:02d}")
                if self.leader:
                    os.makedirs(self.cfg.save_dir, exist_ok=True)
                outs.append(self.infer_camera_poses(frames, depths, source_cam, cam, prompt))
        finally:
            self.cfg.save_dir = base
        return outs

    def infer_camera_poses_smooth(
        self,
        frames: np.ndarray,  # (F, H, W, 3) source-view frames in [0, 1]
        depths: Optional[np.ndarray],  # (F, H, W) metric depth or None
        source_cam: CalibratedCamera,
        target_cam: CalibratedCamera,
        target_frames: Optional[np.ndarray] = None,  # held-out GT view
        prompt: Optional[str] = None,
    ) -> Tuple[np.ndarray, Optional[dict]]:
        """The source camera stays fixed while frame k's target camera is the
        source's interpolated k / (F - 1) of the way to the target's (the
        dataset's raw world-to-camera matrices SLERPed, the intrinsics
        lerped); with ``target_frames`` the last generated frame is scored
        against the last ground-truth one -> (gen, metrics or None; under a
        mesh the leader scores and writes, the other ranks get None)."""
        n = frames.shape[0]
        t2 = interpolate_poses(source_cam.w2c, target_cam.w2c, n).numpy()
        k2 = interpolate_intrinsics(source_cam.K, target_cam.K, n).numpy()
        prompt, cond, masks = self._warp_known(frames, depths, prompt, t2, k2, source_cam)
        gen = self._diffuse_and_save(frames, cond, masks, prompt,
                                     ref_slice=slice(0, self.cfg.diffusion.ref_frames))
        metrics = None
        if target_frames is not None and self.leader:
            metrics = evaluate_target_view(gen, target_frames, self.cfg.save_dir,
                                           seq_name="smooth", fps=self.cfg.fps)
        return gen, metrics

    def infer_sample(self, sample: dict, prompt: Optional[str] = None,
                     smooth: bool = False) -> np.ndarray:
        """Run a loader's sample (``load_mvtracker_npz``, ``load_som_sequence``,
        or an ``IPhoneSequence`` flattened into the same keys)."""
        if smooth:
            gen, _ = self.infer_camera_poses_smooth(
                sample["frames"], sample.get("depths"), sample["source_cam"],
                sample["target_cam"], target_frames=sample.get("target_frames"), prompt=prompt)
            return gen
        return self.infer_camera_poses(sample["frames"], sample.get("depths"),
                                       sample["source_cam"], sample["target_cam"], prompt)


def evaluate_target_view(
    gen: np.ndarray,  # (F, Hs, Ws, 3) generated frames in [0, 1]
    target_frames: np.ndarray,  # (F, H, W, 3) held-out GT view in [0, 1]
    save_dir: str,
    seq_name: str = "seq",
    fps: int = 10,
) -> dict:
    """Score the last generated frame against the last ground-truth target
    frame and persist the eval artifacts.

    PSNR and the luma SSIM of the last frames, and MS-SSIM in place of the
    reference's LPIPS (whose AlexNet weights are not available offline; the
    JSON says so).  Writes metrics.json, metrics_summary.txt, the last-frame
    pngs, the ground-truth target video and a side-by-side gen-vs-target
    video.
    """
    hs, ws = gen.shape[1:3]
    tgt = np.stack([
        cv2.resize(f, (ws, hs), interpolation=cv2.INTER_LINEAR)
        for f in np.asarray(target_frames, np.float32)
    ])
    n = min(len(gen), len(tgt))
    g_last = np.clip(gen[n - 1], 0.0, 1.0)
    t_last = np.clip(tgt[n - 1], 0.0, 1.0)

    lum = np.array([0.299, 0.587, 0.114])
    psnr_v = psnr(g_last, t_last, peak=1.0)
    ssim_v = _ssim_frame(g_last @ lum, t_last @ lum, peak=1.0)
    msssim_v = ms_ssim(g_last, t_last, peak=1.0)

    metrics = {
        "sequence_name": seq_name,
        "evaluation_timestamp": datetime.now().isoformat(),
        "metrics": {
            "PSNR": float(min(psnr_v, 99.0)),
            "SSIM": float(ssim_v),
            "MS_SSIM": float(msssim_v),
        },
        "perceptual_metric": "MS-SSIM (offline stand-in for the reference's "
                             "LPIPS; AlexNet weights unreachable)",
        "frame_info": {
            "frame_shape": list(g_last.shape),
            "value_range": [0.0, 1.0],
            "compared_frames": "last_frame_generated_vs_target",
        },
    }
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    with open(os.path.join(save_dir, "metrics_summary.txt"), "w") as f:
        f.write(f"Evaluation Metrics for {seq_name}\n" + "=" * 50 + "\n")
        f.write(f"PSNR:    {psnr_v:.4f} dB\n")
        f.write(f"SSIM:    {ssim_v:.4f}\n")
        f.write(f"MS-SSIM: {msssim_v:.4f}\n")

    # last-frame pngs + side-by-side (reference :126-156)
    g_u8, t_u8 = f01_to_u8(g_last), f01_to_u8(t_last)
    cv2.imwrite(os.path.join(save_dir, f"last_frame_generated_{seq_name}.png"),
                cv2.cvtColor(g_u8, cv2.COLOR_RGB2BGR))
    cv2.imwrite(os.path.join(save_dir, f"last_frame_target_{seq_name}.png"),
                cv2.cvtColor(t_u8, cv2.COLOR_RGB2BGR))
    cv2.imwrite(
        os.path.join(save_dir, f"last_frame_comparison_{seq_name}.png"),
        cv2.cvtColor(np.concatenate([g_u8, t_u8], axis=1), cv2.COLOR_RGB2BGR))

    # target-GT + side-by-side videos (reference :723-773)
    save_video(tgt[:n], os.path.join(save_dir, f"target_gt_{seq_name}.mp4"),
               fps=fps)
    save_video(np.concatenate([np.clip(gen[:n], 0, 1), tgt[:n]], axis=2),
               os.path.join(save_dir,
                            f"comparison_gen_vs_target_{seq_name}.mp4"),
               fps=fps)
    return metrics
