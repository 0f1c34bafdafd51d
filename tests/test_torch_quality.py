"""Port output-quality metrics and their CLI
(trajectorycrafter_tpu_torch/utils/quality.py) vs the JAX package's
utils/quality.py, on the CPU.

The metric functions are the same float64 numpy arithmetic on both sides:
held equal to 1e-12 (relative), on random frames, on frames small enough
that MS-SSIM drops levels, at every level count 1-5.  The two CLIs read the
same mp4s (written here with cv2) and must print the same JSON and exit with
the same code: identical videos (inf PSNR written as 99.0), one darkened
frame (the overall PSNR passes, the weakest frame fails the gate), and
videos of different lengths with and without ``--allow-frame-mismatch``.
"""

import json
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from trajectorycrafter_tpu.utils import quality as jquality
from trajectorycrafter_tpu_torch.utils import quality as tquality

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-12


def _pair(rng, shape, noise=20.0):
    a = rng.uniform(0, 255, shape)
    return a, np.clip(a + noise * rng.standard_normal(shape), 0, 255)


@pytest.mark.parametrize("shape", [(3, 24, 40, 3), (2, 17, 9), (5,)])
def test_psnr_matches_jax(shape):
    a, b = _pair(np.random.default_rng(0), shape)
    np.testing.assert_allclose(tquality.psnr(a, b), jquality.psnr(a, b), rtol=RTOL)
    assert tquality.psnr(a, a) == jquality.psnr(a, a) == float("inf")
    with pytest.raises(ValueError, match="shape mismatch"):
        tquality.psnr(a, b[..., :-1] if a.ndim > 1 else b[:-1])


@pytest.mark.parametrize("shape", [(8, 8), (23, 41), (64, 48)])
def test_ssim_frame_matches_jax(shape):
    a, b = _pair(np.random.default_rng(1), shape)
    np.testing.assert_allclose(tquality._ssim_frame(a, b, 255.0),
                               jquality._ssim_frame(a, b, 255.0), rtol=RTOL)
    with pytest.raises(ValueError, match="smaller than the 8x8"):
        tquality._ssim_frame(a[:7], b[:7], 255.0)


@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("shape", [(96, 128, 3), (40, 70), (17, 33)],
                         ids=["all_levels", "drops_levels", "one_level"])
def test_ms_ssim_matches_jax(shape, levels):
    a, b = _pair(np.random.default_rng(2), shape, noise=40.0)
    np.testing.assert_allclose(tquality.ms_ssim(a, b, levels=levels),
                               jquality.ms_ssim(a, b, levels=levels), rtol=RTOL)


def test_ms_ssim_refuses_a_frame_below_16_as_jax():
    a, b = _pair(np.random.default_rng(3), (15, 40))
    for module in (tquality, jquality):
        with pytest.raises(ValueError, match="needs >= 16x16"):
            module.ms_ssim(a, b)


@pytest.mark.parametrize("shape", [(4, 24, 32, 3), (3, 16, 24, 1), (2, 16, 16)])
def test_video_quality_matches_jax(shape):
    a, b = _pair(np.random.default_rng(4), shape)
    got, want = tquality.video_quality(a, b), jquality.video_quality(a, b)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)


@pytest.mark.parametrize("psnr_db,min_db", [(float("inf"), float("inf")), (40.0, 30.0),
                                            (float("nan"), 36.0), (36.0, float("nan")),
                                            (35.0, 35.0)])
def test_gate_metrics_matches_jax(psnr_db, min_db):
    m = {"psnr_db": psnr_db, "psnr_min_frame_db": min_db, "ssim": 0.9}
    got, want = tquality.gate_metrics(dict(m), 35.0), jquality.gate_metrics(dict(m), 35.0)
    assert got == want
    assert json.loads(json.dumps(got)) == got  # strict JSON: no inf or NaN left


def _write_mp4(path: Path, frames_u8: np.ndarray) -> str:
    h, w = frames_u8.shape[1:3]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 8, (w, h))
    for frame in frames_u8:
        writer.write(frame[..., ::-1].copy())
    writer.release()
    return str(path)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """Smooth 16-frame clips (mp4v keeps them near lossless): the clip, the
    clip with frame 8 darkened, and its first 12 frames."""
    root = tmp_path_factory.mktemp("videos")
    yy, xx = np.mgrid[0:64, 0:96].astype(np.float64)
    clip = np.stack([np.stack([96 + 60 * np.sin(xx / 23.0 + i / 5.0 + c) * np.cos(yy / 31.0)
                               for c in range(3)], -1) for i in range(16)])
    clip = np.clip(clip, 0, 255).astype(np.uint8)
    dark = clip.copy()
    dark[8] = (dark[8] * 0.9).astype(np.uint8)
    return {"clip": _write_mp4(root / "clip.mp4", clip),
            "dark": _write_mp4(root / "dark.mp4", dark),
            "short": _write_mp4(root / "short.mp4", clip[:12])}


def _run(main, argv, capsys):
    try:
        main(argv)
        code = 0
    except SystemExit as e:
        code = e.code
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1]), code


@pytest.mark.parametrize("case", ["identical", "darkened", "mismatch", "mismatch_allowed"])
def test_cli_matches_jax(videos, capsys, case):
    argv = {"identical": [videos["clip"], videos["clip"]],
            "darkened": [videos["clip"], videos["dark"]],
            "mismatch": [videos["clip"], videos["short"]],
            "mismatch_allowed": [videos["clip"], videos["short"], "--allow-frame-mismatch"]}[case]
    got, got_code = _run(tquality.main, argv, capsys)
    want, want_code = _run(jquality.main, argv, capsys)
    assert (got, got_code) == (want, want_code)
    assert got_code == (0 if got["pass"] else 1)
    if case in ("identical", "mismatch_allowed"):
        assert got["pass"] and got["psnr_db"] == 99.0 and got["frames"] == 12 + 4 * (
            case == "identical")
    if case == "darkened":
        # the mean passes; the weakest frame alone fails the gate
        assert got["psnr_db"] >= 35.0 > got["psnr_min_frame_db"] and not got["pass"]
    if case == "mismatch":
        assert got == {"pass": False, "error": "frame count mismatch", "frames_a": 16,
                       "frames_b": 12}
    if case == "mismatch_allowed":
        assert (got["frames_a"], got["frames_b"]) == (16, 12)


def test_cli_runs_as_a_module(videos):
    proc = subprocess.run([sys.executable, "-m", "trajectorycrafter_tpu_torch.utils.quality",
                           videos["clip"], videos["short"]], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])["error"] == "frame count mismatch"
