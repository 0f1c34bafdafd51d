"""Output quality: PSNR and SSIM between two videos, in numpy.

Counterpart of trajectorycrafter_tpu/utils/quality.py, same formulas: PSNR
over the 8-bit range, per-frame grayscale SSIM (Wang et al. 2004 constants,
8x8 non-overlapping uniform windows) on the BT.601 luma, and multi-scale
SSIM (Wang et al. 2003 exponents, 2x average pooling between levels).
chip_smoke.py uses it to compare the int8 path's video with the bf16 one.
Its CLI compares two written videos, as the JAX one does:

    python -m trajectorycrafter_tpu_torch.utils.quality a_gen.mp4 b_gen.mp4
"""

from __future__ import annotations

from typing import Dict

import numpy as np

_LUMA = np.array([0.299, 0.587, 0.114])


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    """PSNR in dB between two arrays of one shape (inf when they are equal)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    mse = float(np.mean((a - b) ** 2))
    return float("inf") if mse == 0.0 else 10.0 * np.log10(peak * peak / mse)


def _windows(x: np.ndarray) -> np.ndarray:
    """(H, W) -> (H/8 * W/8, 64): the 8x8 windows, the ragged edge dropped."""
    bh, bw = x.shape[0] // 8, x.shape[1] // 8
    if bh == 0 or bw == 0:
        raise ValueError(f"frame {x.shape} smaller than the 8x8 SSIM window")
    return x[:bh * 8, :bw * 8].reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(bh * bw, 64)


def _contrast_structure(a: np.ndarray, b: np.ndarray, c2: float) -> np.ndarray:
    va, vb = a.var(1), b.var(1)
    cov = ((a - a.mean(1, keepdims=True)) * (b - b.mean(1, keepdims=True))).mean(1)
    return (2 * cov + c2) / (va + vb + c2)


def _ssim_frame(a: np.ndarray, b: np.ndarray, peak: float) -> float:
    """Grayscale SSIM of one (H, W) frame over 8x8 windows."""
    c1, c2 = (0.01 * peak) ** 2, (0.03 * peak) ** 2
    a, b = _windows(a), _windows(b)
    mu_a, mu_b = a.mean(1), b.mean(1)
    luminance = (2 * mu_a * mu_b + c1) / (mu_a ** 2 + mu_b ** 2 + c1)
    return float((luminance * _contrast_structure(a, b, c2)).mean())


def ms_ssim(a: np.ndarray, b: np.ndarray, peak: float = 255.0, levels: int = 5) -> float:
    """Multi-scale SSIM of two (H, W) or (H, W, 3) frames.  Levels whose
    frame falls below 16 pixels are dropped and the exponents renormalised;
    negative contrast-structure terms count as 0."""
    weights = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333])[:levels]
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.ndim == 3 and a.shape[-1] == 3:
        a, b = a @ _LUMA, b @ _LUMA
    c2 = (0.03 * peak) ** 2
    vals, used = [], []
    for lvl in range(levels):
        if min(a.shape) < 16:
            break
        if lvl == levels - 1:
            vals.append(_ssim_frame(a, b, peak))  # the full SSIM at the last scale
        else:
            vals.append(float(np.mean(_contrast_structure(_windows(a), _windows(b), c2))))
        used.append(weights[lvl])
        h2, w2 = (a.shape[0] // 2) * 2, (a.shape[1] // 2) * 2
        a = a[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2).mean((1, 3))
        b = b[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2).mean((1, 3))
    if not vals:
        raise ValueError("frame too small for MS-SSIM (needs >= 16x16)")
    used = np.asarray(used) / np.sum(used)
    return float(np.prod(np.maximum(vals, 0.0) ** used))


def video_quality(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> Dict[str, float]:
    """PSNR and SSIM between two (F, H, W, C) videos in [0, peak]: overall and
    weakest-frame PSNR, mean and weakest-frame SSIM of the luma."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    frame_psnr = [psnr(x, y, peak) for x, y in zip(a, b)]
    if a.ndim == 4 and a.shape[-1] == 3:
        ga, gb = a @ _LUMA, b @ _LUMA
    else:
        ga, gb = a.reshape(a.shape[:3]), b.reshape(b.shape[:3])
    frame_ssim = [_ssim_frame(x, y, peak) for x, y in zip(ga, gb)]
    return {
        "psnr_db": psnr(a, b, peak),
        "psnr_min_frame_db": float(min(frame_psnr)),
        "ssim": float(np.mean(frame_ssim)),
        "ssim_min_frame": float(min(frame_ssim)),
        "frames": int(a.shape[0]),
    }


def gate_metrics(m: Dict[str, float], psnr_pass_db: float) -> Dict[str, float]:
    """Gate ``video_quality`` metrics in place: ``pass`` needs both the overall
    and the weakest frame's PSNR at or above the bar; an infinite PSNR is
    written as 99.0 and a NaN as 0.0, so the JSON stays strict."""
    m["pass"] = bool(m["psnr_db"] >= psnr_pass_db and m["psnr_min_frame_db"] >= psnr_pass_db)
    m["psnr_pass_db"] = float(psnr_pass_db)
    for k in ("psnr_db", "psnr_min_frame_db"):
        if np.isnan(m[k]):
            m[k] = 0.0
        elif np.isinf(m[k]):
            m[k] = 99.0
    return m


def main(argv=None) -> None:
    """``python -m trajectorycrafter_tpu_torch.utils.quality a.mp4 b.mp4``:
    print the gated metrics as one JSON line; exit 1 when the gate fails or
    the frame counts differ (unless ``--allow-frame-mismatch``, which
    compares the common prefix).  Needs no card."""
    import argparse
    import json

    from trajectorycrafter_tpu_torch.utils.video import f01_to_u8, read_video_frames

    p = argparse.ArgumentParser(
        description="PSNR/SSIM between two same-seed generated videos (e.g. bf16 vs "
                    "--quant int8)")
    p.add_argument("video_a")
    p.add_argument("video_b")
    p.add_argument("--psnr_pass_db", type=float, default=35.0,
                   help="exit non-zero if overall OR weakest-frame PSNR falls below this")
    p.add_argument("--allow-frame-mismatch", action="store_true",
                   help="compare the common frame prefix instead of failing when the two "
                        "videos have different frame counts")
    args = p.parse_args(argv)

    # every frame at its native size: judge what was written
    a = read_video_frames(args.video_a, -1, width=None, height=None)
    b = read_video_frames(args.video_b, -1, width=None, height=None)
    if len(a) != len(b) and not args.allow_frame_mismatch:
        # a run that stopped partway and wrote fewer frames must not pass
        print(json.dumps({"pass": False, "error": "frame count mismatch",
                          "frames_a": int(len(a)), "frames_b": int(len(b))}))
        raise SystemExit(1)
    n = min(len(a), len(b))
    m = video_quality(f01_to_u8(a[:n]), f01_to_u8(b[:n]))
    if len(a) != len(b):
        m["frames_a"], m["frames_b"] = int(len(a)), int(len(b))
    gate_metrics(m, args.psnr_pass_db)
    print(json.dumps(m))
    if not m["pass"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
