"""The Gradio entry point of the port (trajectorycrafter_tpu_torch/scripts/
gradio_app.py) vs the root ``gradio_app.py``.

Neither machine has gradio, so the module must import without it (``import
gradio`` happens in ``build_app``); the presets, examples and page style are
the JAX module's; ``run_pipeline`` sets the config as the JAX one does (the
same fields after a call on a recording stand-in for ``TrajCrafter``, the
run directory under ``save_dir``, ``save_dir`` restored) and on the tiny CPU
stack writes the run's five mp4s; ``main`` refuses to start without a card.
"""

import os
import subprocess
import sys
import types
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import gradio_app as jax_gradio
from trajectorycrafter_tpu import cli as jax_cli
from trajectorycrafter_tpu_torch import cli, orchestrator
from trajectorycrafter_tpu_torch.scripts import gradio_app

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
VIDEO = str(REPO / "test/videos/synth.mp4")


def test_module_imports_without_gradio():
    code = ("import sys; import trajectorycrafter_tpu_torch.scripts.gradio_app as g; "
            "print(callable(g.build_app), 'gradio' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["True", "False"]


def test_presets_and_examples_are_the_jax_modules():
    assert gradio_app.TRAJ_PRESETS == jax_gradio.TRAJ_PRESETS
    assert list(gradio_app.TRAJ_PRESETS) == list(jax_gradio.TRAJ_PRESETS)
    assert gradio_app.TRAJ_EXAMPLES == jax_gradio.TRAJ_EXAMPLES
    assert gradio_app.VIDEO_EXAMPLES == jax_gradio.VIDEO_EXAMPLES
    assert gradio_app.CSS == jax_gradio.CSS and gradio_app.MAX_SEED == jax_gradio.MAX_SEED


def _fields(cfg):
    return (cfg.video_path, cfg.stride, cfg.seed, cfg.render.radius_scale, cfg.render.camera,
            tuple(cfg.render.target_pose), cfg.diffusion.num_inference_steps)


class _Recorder:
    """A stand-in for ``TrajCrafter``: records the config at ``infer_gradual``."""

    def __init__(self, cfg):
        self.cfg, self.seen = cfg, None

    def infer_gradual(self):
        self.seen = (_fields(self.cfg), self.cfg.save_dir)


@pytest.mark.parametrize("pose", ["0; -30; 0; 0; 0", "20, 40, 0.5, 2, 0", "0;0;-0.5;0;0"])
def test_run_pipeline_sets_the_config_as_jax(tmp_path, pose):
    base = ["--video_path", VIDEO, "--out_dir", str(tmp_path), "--exp_name", "g"]
    jcfg = jax_cli.config_from_args(jax_cli.get_parser().parse_args(base))
    cfg = cli.config_from_args(cli.get_parser().parse_args(base))
    seen = []
    for module, c in ((jax_gradio, jcfg), (gradio_app, cfg)):
        rec = _Recorder(c)
        out = module.run_pipeline("clip.mp4", 2.0, 0.7, pose, 3.0, 41.0, c, rec)
        run_dir = Path(rec.seen[1])
        assert out == str(run_dir / "viz.mp4") and run_dir.parent == Path(c.save_dir)
        assert run_dir.name.startswith("run_") and c.save_dir == str(tmp_path / "g")
        seen.append(rec.seen[0])
    assert seen[1] == seen[0]
    assert seen[1][:5] == ("clip.mp4", 2, 41, 0.7, "target")


def test_run_pipeline_writes_the_run_on_the_tiny_stack(tmp_path):
    cfg = cli.parse_config(["--video_path", VIDEO, "--camera", "target", "--target_pose",
                            "0", "0", "0", "0", "0", "--video_length", "9", "--sample_size",
                            "32", "48", "--prompt", "a scene", "--out_dir", str(tmp_path),
                            "--exp_name", "gradio"])
    cfg.warp_size = (48, 80)
    os.makedirs(cfg.save_dir, exist_ok=True)
    tc = orchestrator.TrajCrafter(cfg, models=orchestrator.build_dev_models(cfg, "cpu"))
    out = gradio_app.run_pipeline(VIDEO, 1, 1.0, gradio_app.TRAJ_PRESETS["Orbit Left"], 2, 43,
                                  cfg, tc)
    assert out.startswith(cfg.save_dir) and cfg.save_dir == str(tmp_path / "gradio")
    assert cfg.render.target_pose == (0.0, -30.0, 0.0, 0.0, 0.0)
    for name in ("input", "render", "mask", "gen", "viz"):
        path = Path(out).parent / f"{name}.mp4"
        frames = int(cv2.VideoCapture(str(path)).get(cv2.CAP_PROP_FRAME_COUNT))
        assert frames == (17 if name == "viz" else 9), name


def test_build_app_needs_gradio(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)  # not importable, as on both machines
    with pytest.raises(ImportError):
        gradio_app.build_app(types.SimpleNamespace())


def test_main_refuses_to_start_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(orchestrator, "build_models", None)
    with pytest.raises(SystemExit, match="no CUDA device"):
        gradio_app.main(["--out_dir", str(tmp_path), "--port", "0"])
    assert not any(tmp_path.iterdir())  # nothing written either


@pytest.mark.parametrize("flags", [["--mesh_sp", "2"], ["--mesh_dp", "2", "--mesh_tp", "2"]])
def test_main_refuses_the_mesh_flags_before_building_anything(tmp_path, monkeypatch, flags):
    """The app serves from one process: mesh flags stop it before the card
    check, any model or any directory, with the reason and the entry points
    that do shard."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(orchestrator, "build_models", None)
    monkeypatch.setattr(gradio_app, "build_app", None)
    with pytest.raises(SystemExit, match="serves from one process.*under torchrun"):
        gradio_app.main(["--out_dir", str(tmp_path), "--port", "0", *flags])
    assert not any(tmp_path.iterdir())
