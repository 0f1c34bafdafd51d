"""The port's entry points beside the CLI (trajectorycrafter_tpu_torch/scripts/)
on a tiny checkpoint tree, on the CPU.

Each script's ``main(argv)`` goes through its real argument parsing with
the root script's flags and loads the tree through ``build_models`` (the
fixed-width constructors patched to tiny ones as in
tests/test_torch_checkpoints.py, the models built on the CPU, the warp size
64 x 128 as the SVD UNet wants); the outputs are counted: the joined videos'
frames (``n_splits * (F - overlap) + overlap``), each segment's or variant's
five mp4s, v2's scene, the known-pose run's metrics.  Without a CUDA device
every script refuses to start, as the CLI does (``probe_depth`` too, whose
runs on a tree are in tests/test_torch_probing.py).
"""

import functools
import json
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from test_tokenizer import _synth_spiece
from test_torch_checkpoints import _tiny, write_tiny_tree

from trajectorycrafter_tpu_torch import orchestrator
from trajectorycrafter_tpu_torch.scripts import (
    autoregressive_global,
    inference_autoregressive,
    inference_orbits,
    probe_depth,
    run_w_cam_poses,
)
from trajectorycrafter_tpu_torch.utils.video import save_video

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
# the scripts that build the CLI's config (their warp size is patched on the tree)
CLI_SCRIPTS = [inference_autoregressive, autoregressive_global, run_w_cam_poses,
               inference_orbits]
SCRIPTS = CLI_SCRIPTS + [probe_depth]
MP4S = ("input", "render", "mask", "gen", "viz")


def _frames(path):
    return int(cv2.VideoCapture(str(path)).get(cv2.CAP_PROP_FRAME_COUNT))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree")
    with pytest.MonkeyPatch.context() as mp:
        _tiny(mp)
        _synth_spiece(root)
        write_tiny_tree(root / "tree", root)
    return root / "tree"


@pytest.fixture
def on_tree(tree, monkeypatch):
    """The scripts build the tree's models on the CPU, at warp size 64 x 128."""
    _tiny(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(orchestrator, "build_models",
                        functools.partial(orchestrator.build_models, device="cpu"))
    for script in CLI_SCRIPTS:
        parse = script.config_from_args

        def at_warp_size(args, parse=parse):
            cfg = parse(args)
            cfg.warp_size = (64, 128)
            return cfg

        monkeypatch.setattr(script, "config_from_args", at_warp_size)
    return tree


def _argv(tree, out, *extra):
    return ["--video_path", str(REPO / "test/videos/synth.mp4"),
            "--diffusion_inference_steps", "2", "--video_length", "9",
            "--sample_size", "32", "48", "--depth_inference_steps", "2",
            "--model_name", str(tree / "CogVideoX-Fun"),
            "--transformer_path", str(tree / "TrajectoryCrafter"),
            "--unet_path", str(tree / "DepthCrafter"), "--pre_train_path", str(tree / "svd"),
            "--blip_path", str(tree / "blip2"), "--out_dir", str(out), "--exp_name", "run",
            *extra]


@pytest.mark.parametrize("script,video", [(inference_autoregressive, "autoregressive.mp4"),
                                          (autoregressive_global, "autoregressive_global.mp4")],
                         ids=["v1", "v2"])
def test_autoregressive_scripts_write_the_joined_video(on_tree, tmp_path, script, video):
    extra = ["--max_points", "4000"] if script is autoregressive_global else []
    out = script.main(_argv(on_tree, tmp_path, "--prompt", "a scene", "--n_splits", "2",
                            "--overlap_frames", "3", "--total_theta", "20", *extra))
    run = tmp_path / "run"
    assert out.shape == (2 * 6 + 3, 32, 48, 3) and np.isfinite(out).all()
    assert _frames(run / video) == 15
    for name in MP4S:
        assert (run / f"{name}.mp4").stat().st_size > 0
    if extra:
        lines = (run / "scene/points.ply").read_text().splitlines()
        assert lines[2] == "element vertex 4000"
        assert (run / "scene/viewer.html").stat().st_size > 0
        assert len((run / "scene/cameras.txt").read_text().splitlines()) == 1 + 15


def test_run_w_cam_poses_smooth_writes_the_metrics(on_tree, tmp_path):
    rng = np.random.default_rng(13)
    src, tgt = tmp_path / "src.mp4", tmp_path / "tgt.mp4"
    save_video(rng.uniform(0, 1, (9, 72, 120, 3)).astype(np.float32), str(src))
    save_video(rng.uniform(0, 1, (9, 72, 120, 3)).astype(np.float32), str(tgt))
    K = [[80.0, 0, 60.0], [0, 80.0, 36.0], [0, 0, 1]]
    calib = {"cameras": [
        {"name": "a", "K": K, "R": np.eye(3).tolist(), "t": [[0.0], [0.0], [0.0]],
         "distCoef": [0.01, -0.01, 0.0, 0.0, 0.0]},
        {"name": "b", "K": K, "R": np.eye(3).tolist(), "t": [[30.0], [0.0], [5.0]]}]}
    (tmp_path / "calib.json").write_text(json.dumps(calib))
    argv = _argv(on_tree, tmp_path / "out", "--prompt", "a scene",
                 "--calib_json", str(tmp_path / "calib.json"), "--source_cam", "a",
                 "--target_cam", "b", "--smooth", "--target_video", str(tgt))
    argv[argv.index("--video_path") + 1] = str(src)
    metrics = run_w_cam_poses.main(argv)
    run = tmp_path / "out/run"
    assert set(metrics["metrics"]) == {"PSNR", "SSIM", "MS_SSIM"}
    assert json.loads((run / "metrics.json").read_text())["metrics"] == metrics["metrics"]
    for name in MP4S:
        assert _frames(run / f"{name}.mp4") == (17 if name == "viz" else 9)
    assert _frames(run / "comparison_gen_vs_target_smooth.mp4") == 9


def test_orbits_test_run_writes_the_first_variant(on_tree, tmp_path):
    """No ``--prompt``: BLIP-2 captions; ``--test_run``: left30 only."""
    assert inference_orbits.main(_argv(on_tree, tmp_path, "--test_run")) == ["left30"]
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == ["left30"]
    for name in MP4S:
        assert _frames(tmp_path / "run/left30" / f"{name}.mp4") == (17 if name == "viz" else 9)


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda s: s.__name__.rsplit(".", 1)[1])
def test_scripts_refuse_to_start_without_a_card(tmp_path, monkeypatch, script):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(orchestrator, "build_models", None)  # nothing is built
    argv = ["--video_path", str(REPO / "test/videos/synth.mp4"), "--out_dir", str(tmp_path)]
    if script is run_w_cam_poses:
        argv += ["--calib_json", "c.json", "--source_cam", "a", "--target_cam", "b"]
    if script is probe_depth:
        argv = ["--data_dir", str(tmp_path), "--output_dir", str(tmp_path / "probes")]
    with pytest.raises(SystemExit, match="no CUDA device"):
        script.main(argv)
