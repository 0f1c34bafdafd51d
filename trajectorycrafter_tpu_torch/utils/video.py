"""Host-side video I/O (cv2) of the PyTorch port.

The port's own copy of trajectorycrafter_tpu/utils/video.py, with the numpy
pixel conversions only (the JAX package can swap in native ones; they
compute the same values).  ``read_video_frames`` reproduces the reference's
fixed 1024x576 resize and stride sampling; ``save_video`` writes mp4.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

import cv2
import numpy as np


def u8_to_f01(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float32) / 255.0


def f01_to_u8(x: np.ndarray) -> np.ndarray:
    return (np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def read_video_frames(
    video_path: str,
    process_length: int,
    stride: int = 1,
    max_res: int = 1024,
    width: Optional[int] = 1024,
    height: Optional[int] = 576,
) -> np.ndarray:
    """-> (N, height, width, 3) float32 RGB in [0, 1].

    ``width=None``/``height=None`` keeps the native resolution.  ``max_res``
    is accepted for reference-CLI parity but -- exactly like the reference
    (models/utils.py:38-48) -- does not change the fixed decode size.
    """
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {video_path}")
    frames: List[np.ndarray] = []
    idx = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if idx % stride == 0:
            if width is not None and height is not None:
                frame = cv2.resize(frame, (width, height), interpolation=cv2.INTER_LINEAR)
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            if process_length != -1 and len(frames) >= process_length:
                break
        idx += 1
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {video_path}")
    return u8_to_f01(np.stack(frames))


def pad_to_length(frames: np.ndarray, length: int) -> np.ndarray:
    """Repeat the last frame up to ``length`` (reference demo.py:50-57)."""
    if frames.shape[0] >= length:
        return frames[:length]
    pad = np.repeat(frames[-1:], length - frames.shape[0], axis=0)
    return np.concatenate([frames, pad], axis=0)


def save_video(frames: np.ndarray, path: str, fps: int = 8) -> None:
    """frames (N, H, W, 3) float in [0, 1] (or uint8) -> mp4."""
    frames = np.asarray(frames)
    if frames.shape[0] == 0:
        raise ValueError(f"refusing to write empty video to {path}")
    if frames.dtype != np.uint8:
        frames = f01_to_u8(frames.astype(np.float32))
    n, h, w = frames.shape[:3]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    for fourcc_name in ("mp4v", "avc1"):
        fourcc = cv2.VideoWriter_fourcc(*fourcc_name)
        writer = cv2.VideoWriter(path, fourcc, fps, (w, h))
        if writer.isOpened():
            break
    if not writer.isOpened():
        raise RuntimeError(f"cannot open video writer for {path}")
    for f in frames:
        if f.ndim == 2 or f.shape[-1] == 1:
            f = cv2.cvtColor(f.reshape(h, w), cv2.COLOR_GRAY2BGR)
        else:
            f = cv2.cvtColor(f, cv2.COLOR_RGB2BGR)
        writer.write(f)
    writer.release()


class VideoSaveQueue:
    """Background-thread mp4 writes: the orchestrator queues the condition
    videos (input/render/mask) so that their encoding overlaps the diffusion
    stage.  ``join()`` blocks until all writes land and re-raises the first
    failure."""

    def __init__(self):
        self._threads: List[threading.Thread] = []
        self._errs: List = []

    def save(self, frames: np.ndarray, path: str, fps: int = 8) -> None:
        def run():
            try:
                save_video(frames, path, fps=fps)
            except Exception as e:  # noqa: BLE001 -- reported via join()
                self._errs.append((path, e))

        t = threading.Thread(target=run, daemon=True)
        t.start()
        self._threads.append(t)

    def join(self) -> None:
        for t in self._threads:
            t.join()
        self._threads.clear()
        if self._errs:
            path, err = self._errs[0]
            self._errs.clear()
            raise RuntimeError(f"async video save failed for {path}") from err
