"""Training-data generation for the LoRA trainer.

Counterpart of trajectorycrafter_tpu/datagen.py (the rebuild of the
reference's generate_sceneflow.py): paired (warped, ground-truth) latent
samples from clips with known depth and camera motion (SceneFlow /
Monkaa / Driving, TartanAir lists): smart-resize to the diffusion sample
size, warp the source view into the target camera with the ground-truth
geometry, VAE-encode everything, and store ``.npz`` samples that
``training/data.py LatentsDataset`` reads.

On the port's own modules: the CogVideoX VAE encode (``models/vae.py``),
the forward-splat warp (``ops/splat.py``) and the resizes
(``ops/resize.py``).  They run on the device of the VAE the caller passes
(the card, in deployment); the readers are numpy and OpenCV.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trajectorycrafter_tpu_torch.models.vae import (
    AutoencoderKLCogVideoX,
    posterior_mode,
    vae_encode,
)
from trajectorycrafter_tpu_torch.ops.resize import resize_linear, resize_nearest
from trajectorycrafter_tpu_torch.ops.splat import forward_warp_batch
from trajectorycrafter_tpu_torch.pipelines.trajcrafter import resize_mask_latent
from trajectorycrafter_tpu_torch.training.data import save_latent_sample


def _device(vae: AutoencoderKLCogVideoX) -> torch.device:
    return next(vae.parameters()).device


def smart_resize(frames: np.ndarray, out_hw: Tuple[int, int], device="cpu") -> np.ndarray:
    """Aspect-preserving (bilinear) resize, then a centre crop to (h, w);
    (F, H, W, C) numpy in and out."""
    h, w = frames.shape[1:3]
    oh, ow = out_hw
    scale = max(oh / h, ow / w)
    rh, rw = int(round(h * scale)), int(round(w * scale))
    x = torch.as_tensor(frames, device=device).movedim(-1, 1)
    x = resize_linear(x, (rh, rw)).movedim(1, -1).cpu().numpy()
    top = (rh - oh) // 2
    left = (rw - ow) // 2
    return x[:, top:top + oh, left:left + ow]


@torch.no_grad()
def encode_sample(
    vae: AutoencoderKLCogVideoX,
    gt_frames: np.ndarray,  # (F, H, W, 3) in [0, 1] target-view ground truth
    warped_frames: np.ndarray,  # (F, H, W, 3) in [0, 1] warped render
    masks: np.ndarray,  # (F, H, W) 1 = known
    prompt_embeds: np.ndarray,  # (L, D)
    ref_frames: Optional[np.ndarray] = None,  # defaults to the first 10 gt frames
) -> Dict[str, np.ndarray]:
    """-> dict of channel-last fp32 latents for one training sample, the keys
    of ``training/data.py``: each video encoded at the VAE's dtype, its
    posterior mode in fp32 times the scaling factor; the inpaint latents are
    the latent-size mask (scaled) before the masked video's latents."""
    device = _device(vae)
    dtype = next(vae.parameters()).dtype
    scaling = vae.scaling_factor
    f = gt_frames.shape[0]
    f_lat = (f - 1) // 4 + 1
    h_lat, w_lat = gt_frames.shape[1] // 8, gt_frames.shape[2] // 8

    def enc(v):
        x = torch.as_tensor(v * 2.0 - 1.0, device=device)[None].to(dtype)
        z = posterior_mode(vae_encode(vae, x).float(), vae.latent_channels)
        return (z[0] * scaling).cpu().numpy()

    gt_lat = enc(gt_frames)
    masked = warped_frames.copy()
    masked[masks < 0.5] = 0.0  # the holes at 0 in [0, 1], -1 after the shift
    mv_lat = enc(masked)
    if ref_frames is None:
        ref_frames = gt_frames[:10]
    ref_lat = enc(ref_frames)

    mask_b = torch.as_tensor(masks, dtype=torch.float32, device=device)[None, None]
    mask_lat = resize_mask_latent(mask_b, (f_lat, h_lat, w_lat))  # (1, 1, f, h, w)
    mask_lat = mask_lat.movedim(1, -1)[0].cpu().numpy() * scaling
    inpaint = np.concatenate([mask_lat, mv_lat], axis=-1)
    return {
        "gt_latents": gt_lat.astype(np.float32),
        "ref_latents": ref_lat.astype(np.float32),
        "inpaint_latents": inpaint.astype(np.float32),
        "prompt_embeds": prompt_embeds.astype(np.float32),
    }


def generate_pair_from_depth(
    frames: np.ndarray,  # (F, H, W, 3) source view in [0, 1]
    depths: np.ndarray,  # (F, H, W) metric depth
    pose_s: np.ndarray,  # (F, 4, 4)
    pose_t: np.ndarray,  # (F, 4, 4)
    K: np.ndarray,  # (F, 3, 3)
    device="cpu",
):
    """Warp source -> target with ground-truth geometry on ``device`` ->
    (warped (F, H, W, 3) in [0, 1], masks (F, H, W)), numpy."""
    put = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    warped, masks, _, _ = forward_warp_batch(put(frames * 2.0 - 1.0), put(depths),
                                             put(pose_s), put(pose_t), put(K))
    return (warped.cpu().numpy() + 1.0) / 2.0, masks.cpu().numpy()


# ----------------------------------------------------------------------------
# SceneFlow / Monkaa / Driving on-disk format
#    <root>/<dstype>/<scene>/<side>/NNNN.png            RGB
#    <root>/disparity/<scene>/<side>/NNNN.pfm           disparity
#    <root>/camera_data/<scene>/camera_data.txt         per-frame L/R 4x4
# ----------------------------------------------------------------------------

# published SceneFlow intrinsics: 960x540, f = 1050 px (Driving also ships a
# 15 mm focal variant at f = 450), principal point at the image centre
SCENEFLOW_FOCAL = {"35mm": 1050.0, "15mm": 450.0}
SCENEFLOW_BASELINE = 1.0


def sceneflow_intrinsics(focal: float = 1050.0, width: int = 960,
                         height: int = 540) -> np.ndarray:
    return np.array([[focal, 0.0, width / 2.0 - 0.5],
                     [0.0, focal, height / 2.0 - 0.5],
                     [0.0, 0.0, 1.0]], np.float64)


def read_pfm(path: str) -> np.ndarray:
    """Portable-float-map reader (SceneFlow disparities ship as Pf).

    Header: 'PF' (3-channel) or 'Pf' (1-channel), then 'W H', then a scale
    whose sign gives the endianness; rows are stored bottom to top.
    """
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"{path}: not a PFM file (header {header!r})")
        channels = 3 if header == b"PF" else 1
        dims = f.readline()
        while dims.startswith(b"#"):  # comments permitted by the spec
            dims = f.readline()
        w, h = (int(v) for v in dims.split())
        scale = float(f.readline())
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(w * h * channels * 4), dtype)
    img = data.reshape(h, w, channels) if channels == 3 else data.reshape(h, w)
    return np.ascontiguousarray(np.flipud(img)).astype(np.float32)


def disparity_to_depth(disp: np.ndarray, focal: float = 1050.0,
                       baseline: float = SCENEFLOW_BASELINE) -> np.ndarray:
    """Stereo disparity (px) -> metric depth: z = f * B / d."""
    return focal * baseline / np.maximum(np.abs(disp), 1e-6)


def read_sceneflow_camera_data(path: str) -> Dict[int, Dict[str, np.ndarray]]:
    """Parse a SceneFlow camera_data.txt into {frame: {'L': c2w, 'R': c2w}}.

    Blocks look like::
        Frame 0
        L <16 floats, row-major 4x4 camera-to-world>
        R <16 floats>
    """
    out: Dict[int, Dict[str, np.ndarray]] = {}
    frame = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            m = re.match(r"Frame\s+(\d+)", line)
            if m:
                frame = int(m.group(1))
                out[frame] = {}
                continue
            side, rest = line.split(None, 1)
            if side in ("L", "R") and frame is not None:
                vals = np.array(rest.split(), np.float64)
                if vals.size != 16:
                    raise ValueError(f"{path}: frame {frame} side {side} has {vals.size} "
                                     "values, expected 16")
                out[frame][side] = vals.reshape(4, 4)
    return out


def _read_rgb(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def load_sceneflow_clip(root: str, scene: str, dstype: str = "frames_cleanpass",
                        side: str = "left", frame_ids: Optional[Sequence[int]] = None,
                        focal: float = 1050.0) -> dict:
    """One Monkaa / Driving-style clip: frames in [0, 1], metric depth from
    the pfm disparities, per-frame world-to-camera poses and K."""
    cam = read_sceneflow_camera_data(
        os.path.join(root, "camera_data", scene, "camera_data.txt"))
    img_dir = os.path.join(root, dstype, scene, side)
    if frame_ids is None:
        frame_ids = sorted(cam)
    key = "L" if side == "left" else "R"
    frames, depths, poses = [], [], []
    for fid in frame_ids:
        frames.append(_read_rgb(os.path.join(img_dir, f"{fid:04d}.png")))
        disp = read_pfm(os.path.join(root, "disparity", scene, side, f"{fid:04d}.pfm"))
        depths.append(disparity_to_depth(disp, focal))
        poses.append(np.linalg.inv(cam[fid][key]))  # c2w -> w2c for the warper
    h, w = frames[0].shape[:2]
    return {
        "frames": np.stack(frames).astype(np.float32) / 255.0,
        "depths": np.stack(depths),
        "poses": np.stack(poses).astype(np.float64),
        "K": sceneflow_intrinsics(focal, w, h),
        "frame_ids": list(frame_ids),
    }


# ----------------------------------------------------------------------------
# TartanAir (the reference's ta_datafile.txt; per sequence:
#   <root>/<seq>/image_left/NNNNNN_left.png
#   <root>/<seq>/depth_left/NNNNNN_left_depth.npy
#   <root>/<seq>/pose_left.txt    one 'x y z qx qy qz qw' NED pose per frame)
# ----------------------------------------------------------------------------

# the fixed published TartanAir pinhole: 640x480, fx = fy = 320, cx = 320, cy = 240
TARTANAIR_K = np.array([[320.0, 0, 320.0], [0, 320.0, 240.0], [0, 0, 1]])

# NED (x forward, y right, z down) -> camera (x right, y down, z forward)
_NED2CAM = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])


def parse_ta_datafile(path: str) -> List[Tuple[str, List[int]]]:
    """Parse the TartanAir list file: blocks of '<sequence_path> <n_frames>'
    followed by n frame-id lines."""
    entries: List[Tuple[str, List[int]]] = []
    with open(path) as f:
        lines = [line.strip() for line in f if line.strip()]
    i = 0
    while i < len(lines):
        parts = lines[i].split()
        if len(parts) != 2:
            raise ValueError(f"{path}:{i + 1}: expected '<seq> <count>', got {lines[i]!r}")
        seq, n = parts[0], int(parts[1])
        ids = [int(v) for v in lines[i + 1:i + 1 + n]]
        if len(ids) != n:
            raise ValueError(f"{path}: block {seq} truncated ({len(ids)}/{n} frame ids)")
        entries.append((seq, ids))
        i += 1 + n
    return entries


def tartanair_pose_to_w2c(pose7: Sequence[float]) -> np.ndarray:
    """One 'x y z qx qy qz qw' NED camera-to-world line -> 4x4 world-to-camera
    in the standard camera frame (tartanair-tools' ned2cam: c2w_cam = E
    c2w_ned E^T with E the NED -> camera axis permutation)."""
    from scipy.spatial.transform import Rotation

    x, y, z, qx, qy, qz, qw = (float(v) for v in pose7)
    c2w = np.eye(4)
    c2w[:3, :3] = Rotation.from_quat([qx, qy, qz, qw]).as_matrix()
    c2w[:3, 3] = [x, y, z]
    E = np.eye(4)
    E[:3, :3] = _NED2CAM
    return np.linalg.inv(E @ c2w @ E.T)


def load_tartanair_clip(root: str, seq: str, frame_ids: Sequence[int],
                        side: str = "left") -> dict:
    seq_dir = os.path.join(root, seq)
    pose_lines = np.loadtxt(os.path.join(seq_dir, f"pose_{side}.txt"))
    frames, depths, poses = [], [], []
    for fid in frame_ids:
        frames.append(_read_rgb(os.path.join(seq_dir, f"image_{side}", f"{fid:06d}_{side}.png")))
        depths.append(np.load(os.path.join(seq_dir, f"depth_{side}",
                                           f"{fid:06d}_{side}_depth.npy")))
        poses.append(tartanair_pose_to_w2c(pose_lines[fid]))
    return {
        "frames": np.stack(frames).astype(np.float32) / 255.0,
        "depths": np.stack(depths).astype(np.float32),
        "poses": np.stack(poses),
        "K": TARTANAIR_K.copy(),
        "frame_ids": list(frame_ids),
    }


# ----------------------------------------------------------------------------
# camera-motion filtering and clip generation
# ----------------------------------------------------------------------------


def motion_metrics(poses: np.ndarray) -> dict:
    """Frame-to-frame translation / rotation statistics (the reference's
    CameraMotionFilter.compute_motion_metrics)."""
    poses = np.asarray(poses, np.float64)
    t = poses[:, :3, 3]
    R = poses[:, :3, :3]
    dt = np.linalg.norm(np.diff(t, axis=0), axis=1)
    R_rel = np.einsum("nij,nkj->nik", R[1:], R[:-1])  # R_curr @ R_prev^T
    tr = np.clip((np.trace(R_rel, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    ang = np.arccos(tr)
    return {
        "max_frame_translation": float(dt.max()),
        "mean_frame_translation": float(dt.mean()),
        "total_translation": float(dt.sum()),
        "max_frame_rotation": float(ang.max()),
        "mean_frame_rotation": float(ang.mean()),
        "total_rotation": float(ang.sum()),
    }


def is_low_motion(poses: np.ndarray, min_total_translation: float = 10.0,
                  max_total_translation: float = 100.0, min_total_rotation: float = 0.1,
                  max_total_rotation: float = 0.55) -> Tuple[bool, dict]:
    """Keep clips whose camera moves some but not too much: total translation
    and rotation below their caps, and at least one above its minimum."""
    m = motion_metrics(poses)
    ok = (m["total_translation"] <= max_total_translation
          and m["total_rotation"] <= max_total_rotation
          and (m["total_translation"] >= min_total_translation
               or m["total_rotation"] >= min_total_rotation))
    return ok, m


def clips_from_dataset(clip_dicts: Iterator[dict], anchor: int = 10,
                       motion_filter: bool = True, **filter_kw):
    """Loader clips (``load_sceneflow_clip`` / ``load_tartanair_clip`` dicts)
    -> (gt, src, depth, pose_s, pose_t, K) tuples for ``generate_dataset``:
    every frame is warped into the anchor frame's camera (the reference warps
    frame i -> frame 10), gt is the clip itself, high-motion clips are
    skipped."""
    for clip in clip_dicts:
        poses = clip["poses"]
        if motion_filter:
            ok, _ = is_low_motion(poses, **filter_kw)
            if not ok:
                continue
        n = clip["frames"].shape[0]
        pose_t = np.tile(poses[min(anchor, n - 1)][None], (n, 1, 1))
        K = np.tile(np.asarray(clip["K"], np.float32)[None], (n, 1, 1))
        yield (clip["frames"], clip["frames"], clip["depths"],
               poses.astype(np.float32), pose_t.astype(np.float32), K)


def generate_dataset(vae: AutoencoderKLCogVideoX, out_dir: str, clips,
                     prompt_embeds: np.ndarray,
                     sample_size: Tuple[int, int] = (384, 672)) -> str:
    """clips: iterable of (gt_frames, src_frames, depths, pose_s, pose_t, K);
    each becomes ``<out_dir>/sample_<i:06d>.npz``, the warp, resizes and
    encodes on the VAE's device."""
    device = _device(vae)
    os.makedirs(out_dir, exist_ok=True)
    for i, (gt, src, depth, ps, pt, K) in enumerate(clips):
        warped, masks = generate_pair_from_depth(src, depth, ps, pt, K, device=device)
        gt_r = smart_resize(gt, sample_size, device)
        warped_r = smart_resize(warped, sample_size, device)
        masks_r = resize_nearest(torch.as_tensor(masks, device=device)[:, None],
                                 sample_size)[:, 0].cpu().numpy()
        sample = encode_sample(vae, gt_r, warped_r, masks_r, prompt_embeds)
        save_latent_sample(os.path.join(out_dir, f"sample_{i:06d}.npz"), **sample)
    return out_dir
