"""The port's config, CLI and video I/O (trajectorycrafter_tpu_torch/config.py,
cli.py, utils/video.py) against the JAX package's modules they copy.

The same option strings, defaults, choices and types; the same config
(``dataclasses.asdict``) for several command lines; the same ``SystemExit``
messages from ``validate``; the same arrays from the video functions on the
repository's test clip and on random frames.  Everything is compared exactly.
Also: the port's CLI sends each mode through ``build_models`` to its
``infer_*``.
"""

import dataclasses
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from trajectorycrafter_tpu import cli as jax_cli
from trajectorycrafter_tpu import config as jax_config
from trajectorycrafter_tpu.utils import video as jax_video
from trajectorycrafter_tpu_torch import cli, config, orchestrator
from trajectorycrafter_tpu_torch.utils import video
from trajectorycrafter_tpu_torch.utils.timing import StageTimer

REPO = Path(__file__).resolve().parents[1]
CLIP = str(REPO / "test/videos/synth.mp4")
TRAJ = str(REPO / "test/trajs/loop1.txt")


def _options(parser):
    return {tuple(a.option_strings): (a.dest, a.default, a.choices, a.nargs, a.type, a.const)
            for a in parser._actions}


# the port's own options: the transport of a sharded run (the JAX package
# takes its devices and collectives from jax)
PORT_ONLY = {("--dist_backend",)}


def test_parser_has_the_jax_options_and_defaults():
    """Every JAX option with its default, and besides them only the
    transport option of the port's sharded runs."""
    got = _options(cli.get_parser())
    assert {k: v for k, v in got.items() if k not in PORT_ONLY} == \
        _options(jax_cli.get_parser())
    assert PORT_ONLY <= set(got)


@pytest.mark.parametrize("argv", [
    [],
    ["--camera", "target", "--target_pose", "10", "-5", "0.1", "0", "0", "--mode", "direct"],
    ["--quant", "none", "--quant_depth", "int8", "--sample_size", "32", "48",
     "--video_length", "9", "--diffusion_inference_steps", "2", "--prompt", "a scene",
     "--torch_rng_compat", "--mask", "--seed", "7", "--stride", "2"],
    ["--cpu_offload", "model", "--mesh_sp", "2", "--allow_dev_stubs",
     "--sampler_name", "Euler A", "--window_size", "60", "--overlap", "10"],
    ["--cpu_offload", "sequential", "--offload", "none", "--out_dir", "build/x"],
], ids=["defaults", "target", "quant_and_sizes", "aliases", "offload"])
def test_config_from_args_matches_jax(argv):
    argv = ["--video_path", CLIP, "--traj_txt", TRAJ, "--exp_name", "run", *argv]
    want = jax_cli.config_from_args(jax_cli.get_parser().parse_args(argv))
    got = cli.config_from_args(cli.get_parser().parse_args(argv))
    assert isinstance(got, config.TrajCrafterConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_config_defaults_and_overrides_match_jax():
    assert dataclasses.asdict(config.TrajCrafterConfig()) == \
        dataclasses.asdict(jax_config.TrajCrafterConfig())
    overrides = ["seed=3", "render.mask=true", "diffusion.sample_size=32,48",
                 "depth.guidance_scale=1.5", "diffusion.quant=none"]
    got = config.flatten_overrides(config.TrajCrafterConfig(), overrides)
    want = jax_config.flatten_overrides(jax_config.TrajCrafterConfig(), overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("argv", [
    [],
    ["--video_path", "missing.mp4"],
    ["--video_path", CLIP],
    ["--video_path", CLIP, "--traj_txt", "missing.txt"],
    ["--video_path", CLIP, "--camera", "target"],
    ["--video_path", CLIP, "--traj_txt", TRAJ, "--video_length", "57"],
    ["--video_path", CLIP, "--traj_txt", TRAJ, "--video_length", "10"],
], ids=["no_video", "video_missing", "no_traj", "traj_missing", "no_target_pose",
        "too_long", "not_8k_plus_1"])
def test_validate_raises_the_jax_messages(argv):
    argv = [*argv, "--exp_name", "run"]
    with pytest.raises(SystemExit) as want:
        jax_cli.validate(jax_cli.config_from_args(jax_cli.get_parser().parse_args(argv)))
    with pytest.raises(SystemExit) as got:
        cli.validate(cli.config_from_args(cli.get_parser().parse_args(argv)))
    assert str(got.value) == str(want.value)


def test_validate_passes_a_good_config():
    argv = ["--video_path", CLIP, "--traj_txt", TRAJ, "--exp_name", "run"]
    cli.validate(cli.config_from_args(cli.get_parser().parse_args(argv)))


def _refuse_builds(monkeypatch):
    def build(*args, **kwargs):
        raise AssertionError("a model was built")

    for name in ("build_models", "build_full_scale_models", "build_dev_models"):
        monkeypatch.setattr(orchestrator, name, build)


@pytest.mark.parametrize("mode", ["direct", "bullet", "zoom"])
def test_cli_sends_each_mode_through_build_models_to_its_infer(monkeypatch, tmp_path, mode):
    """``parse_config`` passes the three modes (``check_supported``), and
    ``main`` builds the models with the mode's config and calls the mode's
    ``infer_*`` (the card's check passed, the build and the mode recorded)."""
    calls = []

    def build(cfg, *args, **kwargs):
        calls.append(("build_models", cfg.render.mode))
        pipeline = types.SimpleNamespace(device=torch.device("cpu"), timer=StageTimer("cpu"))
        return orchestrator.ModelBundle(pipeline=pipeline, depth_infer=None,
                                        encode_prompt=None, get_caption=None)

    monkeypatch.setattr(orchestrator, "build_models", build)
    monkeypatch.setattr(cli.torch.cuda, "is_available", lambda: True)
    for name in ("gradual", "direct", "bullet", "zoom"):
        monkeypatch.setattr(orchestrator.TrajCrafter, f"infer_{name}",
                            lambda self, name=name: calls.append(("infer", name)))
    argv = ["--video_path", CLIP, "--traj_txt", TRAJ, "--exp_name", "run",
            "--out_dir", str(tmp_path / "out"), "--mode", mode]
    assert cli.parse_config(argv).render.mode == mode
    cli.main(argv)
    assert calls == [("build_models", mode), ("infer", mode)]
    assert (tmp_path / "out" / "run").is_dir()


def test_cli_passes_the_gradual_mode(monkeypatch):
    _refuse_builds(monkeypatch)
    argv = ["--video_path", CLIP, "--traj_txt", TRAJ, "--exp_name", "run", "--mode", "gradual"]
    cfg = cli.parse_config(argv)
    assert (cfg.render.mode, cfg.render.mask) == ("gradual", False)
    orchestrator.check_supported(cfg)


@pytest.mark.parametrize("kwargs", [
    dict(process_length=9), dict(process_length=5, stride=2, width=80, height=48),
    dict(process_length=-1, width=None, height=None),
], ids=["default_size", "strided_small", "native"])
def test_read_video_frames_matches_jax(kwargs):
    got = video.read_video_frames(CLIP, **kwargs)
    want = jax_video.read_video_frames(CLIP, **kwargs)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    np.testing.assert_array_equal(video.pad_to_length(got[:3], 7),
                                  jax_video.pad_to_length(want[:3], 7))
    np.testing.assert_array_equal(video.pad_to_length(got, 2), jax_video.pad_to_length(want, 2))


def test_pixel_conversions_and_saved_video_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    frames = rng.uniform(-0.2, 1.2, (4, 32, 48, 3)).astype(np.float32)
    np.testing.assert_array_equal(video.f01_to_u8(frames), jax_video.f01_to_u8(frames))
    u8 = rng.integers(0, 256, (4, 32, 48, 3), dtype=np.uint8)
    np.testing.assert_array_equal(video.u8_to_f01(u8), jax_video.u8_to_f01(u8))

    queue = video.VideoSaveQueue()
    queue.save(frames, str(tmp_path / "port.mp4"), fps=8)
    queue.join()
    jax_video.save_video(frames, str(tmp_path / "jax.mp4"), fps=8)
    read = lambda name: video.read_video_frames(str(tmp_path / name), -1, width=None,
                                                height=None)
    np.testing.assert_array_equal(read("port.mp4"), read("jax.mp4"))
    with pytest.raises(ValueError):
        video.save_video(frames[:0], str(tmp_path / "empty.mp4"))
