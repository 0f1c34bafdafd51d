"""The port's entry points beside the CLI under --mesh_dp/--mesh_sp/--mesh_tp
(trajectorycrafter_tpu_torch/scripts/, orchestrator.py's leader / follower
rule), on the CPU.

One real gloo world of 4 ranks (tests/torch_worlds.py, with a timeout of
its own; the ranks' side is tests/torch_parallel_workers.py
``entry_points``) under dp 1 x sp 2 x tp 2 runs each script's
``main(argv)`` on the tiny tree of tests/test_torch_scripts.py, each rank
applying the tiny-model patches itself (the world spawns its processes)
and writing under its own ``--out_dir``:

  * ``inference_autoregressive`` (v1) and ``autoregressive_global`` (v2),
    2 windows of 9 frames sharing 3;
  * ``run_w_cam_poses --smooth --target_video`` (the known cameras);
  * ``inference_orbits --test_run`` (no ``--prompt``: BLIP-2 captions on
    the leader, whose followers hold no captioner);
  * ``inference_alignment`` with a vits Video-Depth-Anything checkpoint
    (the VDA and its trainer on the leader alone) and without one (the
    DepthCrafter stage collective, its alignment on the leader), 2 stages.

The tree's bundle runs in fp32 with the DiT unquantized (loaded in bf16,
then upcast: tests/torch_parallel_workers.py ``fp32_bundle``; ``--quant
none``): the tiny int8 DiT flips codes on 1e-7 changes of its inputs, and
bf16 rounds the sharded sums' reassociation up to visible changes.  Each
script is held to its unsharded twin, run here: every generated segment of
the leader at its case's bound (``TWIN_DB``: within one uint8 level where
no sharded depth stage feeds the geometry, else near its dB reading), and,
fed the sharded stage's depths, the twin within one uint8 level; the first
segment's conditions within
tests/test_torch_modes.py ``_hold_warp``'s bounds, the same files, every
camera and metric of its files within ``CAMERA_TOL`` and
``METRIC_ATOL``; every rank gets each segment and the joined video back,
bit-equal to the leader's, and only the leader writes; the conditions
every rank hands to ``_diffuse_and_save`` and the latents after every
sampler step are bit-equal on every rank.  v1 and the known-camera modes
also run on the stub bundle of tests/test_torch_autoregressive.py and
tests/test_torch_known_poses.py (the plane depth, a fixed caption,
``_diffuse_and_save`` recorded and answering each segment with a seeded
video): the conditions of every rank against the JAX class's on the CPU,
within ``_hold_warp``'s bounds.

A second world plants a depth-stage failure on one rank in the orbit
sweep: under a mesh every rank ends (unsharded, the sweep goes on past a
failed variant, as the root script does).
"""

import functools
import importlib
import json
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from test_tokenizer import _synth_spiece
from test_torch_autoregressive import RUN, _gen
from test_torch_autoregressive import _run as run_autoregressive
from test_torch_checkpoints import (
    CLIP_TINY,
    SVD_VAE_TINY,
    T5_TINY,
    UNET_TINY,
    VAE_DEV,
    _tiny,
    write_tiny_tree,
)
from test_torch_consistent import _tiny_vda
from test_torch_known_poses import F as KNOWN_F
from test_torch_known_poses import H as KNOWN_H
from test_torch_known_poses import W as KNOWN_W
from test_torch_known_poses import _sample
from test_torch_known_poses import _stub as known_stub
from test_torch_modes import U8_ATOL, VALUE_ATOL, _hold_warp
from test_torch_modes import _argv as modes_argv
from torch_parallel_workers import _record_conditions as record_conditions
from torch_parallel_workers import entry_points, fp32_bundle, orbit_failure
from torch_worlds import run_world

from trajectorycrafter_tpu_torch import orchestrator
from trajectorycrafter_tpu_torch.scripts import inference_orbits
from trajectorycrafter_tpu_torch.utils import checkpoints
from trajectorycrafter_tpu_torch.utils.quality import psnr
from trajectorycrafter_tpu_torch.utils.video import save_video

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
WORLD = 4
MESH = (1, 2, 2)
MESH_ARGV = ["--mesh_dp", "1", "--mesh_sp", "2", "--mesh_tp", "2", "--dist_backend", "gloo"]
# the SVD UNet takes sides that are multiples of 64, and the sharded depth
# stage at least sp blocks of 8 latent rows (parallel/frames.py)
WARP_SIZE = (128, 128)
# the tree's T5 gives 226 text tokens: sp 2 splits the joint tokens so that
# each rank holds video tokens only where there are more than 226 of them
# (3 latent frames of 8 x 12 patches)
SAMPLE_SIZE = (128, 192)
WORLD_TIMEOUT = 900.0  # ~130 s alone; the suite runs beside it
# the constructors' tiny widths (tests/test_torch_checkpoints.py ``_tiny``)
DIMS = {"AutoencoderKLCogVideoX": VAE_DEV, "T5EncoderModel": T5_TINY,
        "UNetSpatioTemporalConditionModel": UNET_TINY,
        "AutoencoderKLTemporalDecoder": SVD_VAE_TINY, "CLIPVisionModelWithProjection": CLIP_TINY}
UINT8_LEVEL = 1.0 / 255.0 + 1e-6
# the leader's weakest segment against the twin's, in dB, each case's bound
# ~2 dB under its reading on the CPU (v1 41.5, v2 46.7, the known cameras
# 53.8, the orbit 51.6, consistent depth with the DepthCrafter stage 58.1):
# the sharded depth stage reassociates fp32 sums (~1e-6 of the depth),
# which moves knife-edge pixels of the warp and ties of the z-buffer
# (tests/test_torch_modes.py's bounds), each such pixel moving the segment
# around it by more than a uint8 level, and a later segment starts from the
# earlier one's.  Fed the sharded stage's depths, every twin is within one
# uint8 level (``test_fed_the_sharded_depth_every_twin_is_within_a_level``),
# and so is the run whose depth comes from the leader's VDA (None: held to
# a level itself).
TWIN_DB = {"v1": 39.0, "v2": 44.0, "known": 51.0, "orbits": 49.0, "consistent_vda": None,
           "consistent_depthcrafter": 56.0}
DEPTHCRAFTER_RUNS = [name for name, db in TWIN_DB.items() if db is not None]
# the cameras a run writes come from the poses of a radius that the depth
# stage's reassociated sums move by ~1e-6 of itself
CAMERA_TOL = dict(rtol=1e-5, atol=1e-6)
# the smooth fly's metrics score the last generated frame, which may move a
# pixel by a uint8 level against the twin's
METRIC_ATOL = {"PSNR": 0.05, "SSIM": 1e-3, "MS_SSIM": 1e-3}
# name -> (script module, its own flags, the joined video it writes or None)
SCRIPTS = {
    "v1": ("inference_autoregressive", ["--prompt", "a scene", "--n_splits", "2",
                                        "--overlap_frames", "3", "--total_theta", "20"],
           "autoregressive.mp4"),
    "v2": ("autoregressive_global", ["--prompt", "a scene", "--n_splits", "2",
                                     "--overlap_frames", "3", "--total_theta", "20",
                                     "--max_points", "4000"], "autoregressive_global.mp4"),
    "known": ("run_w_cam_poses", ["--prompt", "a scene", "--source_cam", "a", "--target_cam",
                                  "b", "--smooth"], None),
    "orbits": ("inference_orbits", ["--test_run"], None),
    "consistent_vda": ("inference_alignment", ["--prompt", "a scene", "--n_splits", "2",
                                               "--total_theta", "20", "--align_epochs", "2",
                                               "--vda_encoder", "vits"],
                       "autoregressive_aligned.mp4"),
    "consistent_depthcrafter": ("inference_alignment", [
        "--prompt", "a scene", "--n_splits", "2", "--total_theta", "20", "--align_epochs", "2"],
        "autoregressive_aligned.mp4"),
}
MP4S = ("input", "render", "mask", "gen", "viz")


def _frames(path) -> int:
    return int(cv2.VideoCapture(str(path)).get(cv2.CAP_PROP_FRAME_COUNT))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The tiny tree, the known-camera clips and calibration, the vits VDA
    checkpoint -> {name: argv without --out_dir's value}."""
    root = tmp_path_factory.mktemp("entry_inputs")
    with pytest.MonkeyPatch.context() as mp:
        _tiny(mp)
        _synth_spiece(root)
        write_tiny_tree(root / "tree", root)
    tree = root / "tree"
    rng = np.random.default_rng(13)
    for name in ("src", "tgt"):
        save_video(rng.uniform(0, 1, (9, 72, 120, 3)).astype(np.float32), str(root / f"{name}.mp4"))
    K = [[80.0, 0, 60.0], [0, 80.0, 36.0], [0, 0, 1]]
    (root / "calib.json").write_text(json.dumps({"cameras": [
        {"name": "a", "K": K, "R": np.eye(3).tolist(), "t": [[0.0], [0.0], [0.0]],
         "distCoef": [0.01, -0.01, 0.0, 0.0, 0.0]},
        {"name": "b", "K": K, "R": np.eye(3).tolist(), "t": [[30.0], [0.0], [5.0]]}]}))
    ckpt = root / "video_depth_anything_vits.pth"
    torch.save(checkpoints.vda_official_state_dict(_tiny_vda(encoder="vits").state_dict()), ckpt)
    argvs = {}
    for name, (_, extra, _) in SCRIPTS.items():
        video = root / "src.mp4" if name == "known" else REPO / "test/videos/synth.mp4"
        argv = ["--video_path", str(video), "--diffusion_inference_steps", "2",
                "--video_length", "9", "--sample_size", *map(str, SAMPLE_SIZE),
                "--depth_inference_steps", "2", "--model_name", str(tree / "CogVideoX-Fun"),
                "--transformer_path", str(tree / "TrajectoryCrafter"),
                "--unet_path", str(tree / "DepthCrafter"), "--pre_train_path", str(tree / "svd"),
                "--blip_path", str(tree / "blip2"), "--exp_name", "run", "--quant", "none", *extra]
        if name == "known":
            argv += ["--calib_json", str(root / "calib.json"), "--target_video",
                     str(root / "tgt.mp4")]
        if name == "consistent_vda":
            argv += ["--vda_ckpt", str(ckpt)]
        argvs[name] = argv
    return argvs


def _main(name):
    return importlib.import_module(f"trajectorycrafter_tpu_torch.scripts.{SCRIPTS[name][0]}")


def _patched_for_the_tree(mp):
    """tests/test_torch_scripts.py's patches, in this process."""
    from trajectorycrafter_tpu_torch.parallel import mesh

    _tiny(mp)
    mp.setattr(torch.cuda, "is_available", lambda: True)
    build = orchestrator.build_models
    mp.setattr(orchestrator, "build_models",
               lambda cfg, **kw: fp32_bundle(build(cfg, device="cpu", **kw)))
    mp.setattr(mesh, "make_mesh", functools.partial(mesh.make_mesh, device="cpu"))
    for name in SCRIPTS:
        module = _main(name)
        parse = module.config_from_args

        def at_warp_size(args, parse=parse):
            cfg = parse(args)
            cfg.warp_size = WARP_SIZE
            return cfg

        mp.setattr(module, "config_from_args", at_warp_size)


def _unsharded(inputs: dict, out: Path, depths=None) -> dict:
    """Each script of ``inputs`` unsharded, here, with the depth stage's
    answers taken from ``depths`` ({name: [depth, ...]}, in the order of the
    calls) where it is given -> {name: (what main returned, its run
    directory, the conditions of each segment)}."""
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        _patched_for_the_tree(mp)
        for name, argv in inputs.items():
            conditions, fed = [], iter(() if depths is None else depths[name])
            with record_conditions(conditions), pytest.MonkeyPatch.context() as stage:
                if depths is not None:
                    stage.setattr(orchestrator.TrajCrafter, "_estimate_depth",
                                  lambda self, frames: next(fed).copy())
                returned = _main(name).main(argv + ["--out_dir", str(out / name)])
            assert next(fed, None) is None  # every recorded depth was asked for
            got[name] = (returned, out / name / "run", conditions)
    return got


@pytest.fixture(scope="module")
def twins(inputs, tmp_path_factory):
    return _unsharded(inputs, tmp_path_factory.mktemp("unsharded"))


@pytest.fixture(scope="module")
def fed_twins(inputs, world, tmp_path_factory):
    """The twins of the scripts that run a DepthCrafter stage, each fed the
    depths the sharded leader's stage returned."""
    runs = world[0]
    fed = {name: argv for name, argv in inputs.items() if runs[0][name]["depths"]}
    return _unsharded(fed, tmp_path_factory.mktemp("fed"),
                      {name: runs[0][name]["depths"] for name in fed})


def _stubs(tmp_path, monkeypatch) -> tuple:
    """The stub runs' inputs for the world, and the JAX classes' recorded
    conditions on the same inputs."""
    jax_v1, _, jcfg = run_autoregressive("jax", "TrajCrafterAutoregressive", tmp_path / "jax_v1",
                                         monkeypatch)
    sample = _sample()
    frames, target_frames, depths, src, tgt = sample
    jax_known = {}
    for label, smooth, given in (("fixed", False, True), ("smooth", True, False)):
        calls = {}
        module, tc = known_stub("jax", tmp_path / "jax_known" / label, monkeypatch, calls)
        cams = [module.CalibratedCamera(**c) for c in (src, tgt)]
        d = depths if given else None
        if smooth:
            _, metrics = tc.infer_camera_poses_smooth(frames, d, *cams,
                                                      target_frames=target_frames)
        else:
            tc.infer_camera_poses(frames, d, *cams)
            metrics = None
        jax_known[label] = (calls, metrics)
    gen_known = np.random.default_rng(6).uniform(0, 1, (KNOWN_F, 32, 48, 3)).astype(np.float32)
    stubs = {"v1": (modes_argv(tmp_path / "stub_v1", "gradual"), (48, 80), RUN, _gen(jcfg)),
             "known": (sample, (KNOWN_F, KNOWN_H, KNOWN_W), str(tmp_path / "stub_known"),
                       gen_known)}
    return stubs, jax_v1, jax_known


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded")
    scripts = {name: (SCRIPTS[name][0], argv + MESH_ARGV + ["--out_dir", str(out / name)])
               for name, argv in inputs.items()}
    with pytest.MonkeyPatch.context() as mp:
        stubs, jax_v1, jax_known = _stubs(tmp_path_factory.mktemp("stubs"), mp)
    runs = run_world(entry_points, WORLD, tmp_path_factory.mktemp("entry_world"), DIMS,
                     WARP_SIZE, scripts, stubs, MESH, timeout=WORLD_TIMEOUT)
    return runs, out, jax_v1, jax_known


# ----------------------------------------------------------------------------
# the scripts on the tiny tree
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("name", SCRIPTS)
def test_only_the_leader_writes_and_its_files_are_the_twins(world, twins, name):
    runs, out, _, _ = world
    want_dir = twins[name][1]
    want_files = sorted(str(p.relative_to(want_dir.parent)) for p in want_dir.rglob("*")
                        if p.is_file())
    assert runs[0][name]["files"] == want_files and want_files
    for run in runs[1:]:
        assert run[name]["files"] == []
    joined = SCRIPTS[name][2]
    lead = out / name / "rank0" / "run"
    if joined:
        video = runs[0][name]["returned"]
        assert _frames(lead / joined) == _frames(want_dir / joined) == video.shape[0]
    for mp4 in (p for p in want_dir.rglob("*.mp4")):
        assert _frames(lead / mp4.relative_to(want_dir)) == _frames(mp4), mp4.name


def _hold_segments(got: list, want: list, db) -> None:
    """Each generated segment of ``got`` against ``want``'s: at ``db`` or
    better, or within one uint8 level where ``db`` is None."""
    assert len(got) == len(want)
    for mine, twin in zip(got, want):
        assert mine.shape == twin.shape == (9, *SAMPLE_SIZE, 3)
        if db is None:
            assert np.abs(mine - twin).max() <= UINT8_LEVEL
        else:
            assert psnr(mine, twin, peak=1.0) >= db


@pytest.mark.parametrize("name", SCRIPTS)
def test_every_rank_gets_the_leaders_video_and_it_holds_to_the_twins(world, twins, name):
    """Each generated segment: every rank's bit-equal to the leader's, and
    the leader's against the twin's at ``TWIN_DB``; the joined video is
    every rank's too."""
    runs, _, _, _ = world
    lead = [c["gen"] for c in runs[0][name]["conditions"]]
    assert len(lead) == (2 if SCRIPTS[name][2] else 1)
    _hold_segments(lead, [c["gen"] for c in twins[name][2]], TWIN_DB[name])
    for run in runs[1:]:
        for mine, first in zip(run[name]["conditions"], runs[0][name]["conditions"]):
            np.testing.assert_array_equal(mine["gen"], first["gen"])
        if SCRIPTS[name][2]:
            np.testing.assert_array_equal(run[name]["returned"], runs[0][name]["returned"])


@pytest.mark.parametrize("name", DEPTHCRAFTER_RUNS)
def test_fed_the_sharded_depth_every_twin_is_within_a_level(world, fed_twins, name):
    """The witness of ``TWIN_DB``'s cause: fed the depths the sharded
    leader's stage returned, the unsharded twin generates every segment
    within one uint8 level of the leader's (the sharded denoise and VAE
    move no pixel further)."""
    runs, _, _, _ = world
    assert runs[0][name]["depths"]
    for run in runs[1:]:  # every rank ends the stage with the same depth
        for mine, first in zip(run[name]["depths"], runs[0][name]["depths"]):
            np.testing.assert_array_equal(mine, first)
    _hold_segments([c["gen"] for c in runs[0][name]["conditions"]],
                   [c["gen"] for c in fed_twins[name][2]], None)


@pytest.mark.parametrize("name", SCRIPTS)
def test_the_first_conditions_hold_to_the_twins(world, twins, name):
    """The first segment's conditions on the leader against the twin's,
    within tests/test_torch_modes.py ``_hold_warp``'s bounds (the orbit
    run's fetched as uint8, as that file holds the modes')."""
    runs, _, _, _ = world
    got, want = runs[0][name]["conditions"][0], twins[name][2][0]
    assert got["cond"].shape == want["cond"].shape
    _hold_warp([got["cond"], got["masks"]], [want["cond"], want["masks"]],
               U8_ATOL if name == "orbits" else VALUE_ATOL)


def test_known_cameras_leader_scores_as_the_twin(world, twins):
    runs, out, _, _ = world
    want = twins["known"][0]
    got = runs[0]["known"]["returned"]
    assert json.loads((out / "known/rank0/run/metrics.json").read_text())["metrics"] == \
        got["metrics"]
    for key, atol in METRIC_ATOL.items():
        np.testing.assert_allclose(got["metrics"][key], want["metrics"][key], atol=atol, rtol=0)
    assert all(run["known"]["returned"] is None for run in runs[1:])


def test_orbits_returns_the_variant_on_every_rank(world, twins):
    runs, _, _, _ = world
    assert twins["orbits"][0] == ["left30"]
    assert all(run["orbits"]["returned"] == ["left30"] for run in runs)


@pytest.mark.parametrize("name", SCRIPTS)
def test_every_rank_hands_the_same_conditions_and_steps_the_same_latents(world, name):
    runs, _, _, _ = world
    lead = runs[0][name]
    windows = 2 if SCRIPTS[name][2] else 1
    assert len(lead["conditions"]) == windows
    assert len(lead["steps"]) == 2 * windows  # 2 DDIM steps a window
    for run in runs[1:]:
        got = run[name]
        assert len(got["conditions"]) == windows and len(got["steps"]) == 2 * windows
        for mine, first in zip(got["conditions"], lead["conditions"]):
            for key in ("frames", "cond", "masks"):
                np.testing.assert_array_equal(mine[key], first[key], err_msg=key)
            assert (mine["ref_slice"], mine["save_skip"]) == \
                (first["ref_slice"], first["save_skip"])
        for mine, first in zip(got["steps"], lead["steps"]):
            np.testing.assert_array_equal(mine, first)


@pytest.mark.parametrize("name", SCRIPTS)
def test_the_collective_steps_ran_on_the_mesh(world, name):
    """Every rank joined the pipeline's halos and norms and the ring; the
    warp's all_gather ran where the script warps (v1, the known cameras,
    the orbits); the depth stage's exchanges where a DepthCrafter stage
    runs (not under a VDA)."""
    runs, _, _, _ = world
    for run in runs:
        transport = run[name]["transport"]
        assert transport["halo direct"] > 0 and transport["norm direct"] > 0
        assert transport.get("warp direct", 0) == (2 if name == "v1" else
                                                  1 if name in ("known", "orbits") else 0)
        assert (transport.get("depth_latents direct", 0) > 0) is (name != "consistent_vda")


def test_the_stage_cameras_are_the_twins(world, twins):
    runs, out, _, _ = world
    for name in ("consistent_vda", "consistent_depthcrafter"):
        want_dir = twins[name][1]
        for stage in range(2):
            for cams in ("c2ws_target", "c2ws_source"):
                rel = f"stage_{stage:02d}/{cams}.npy"
                np.testing.assert_allclose(np.load(out / name / "rank0/run" / rel),
                                           np.load(want_dir / rel), **CAMERA_TOL)


def test_v2_scene_is_the_twins(world, twins):
    _, out, _, _ = world
    want = (twins["v2"][1] / "scene/points.ply").read_text().splitlines()
    got = (out / "v2/rank0/run/scene/points.ply").read_text().splitlines()
    assert got[2] == want[2] == "element vertex 4000"
    assert (out / "v2/rank0/run/scene/cameras.txt").read_text() == \
        (twins["v2"][1] / "scene/cameras.txt").read_text()


# ----------------------------------------------------------------------------
# v1 and the known cameras on the stub bundle, against JAX
# ----------------------------------------------------------------------------


def _hold_calls(got: list, want: list) -> None:
    assert len(got) == len(want)
    for td, jd in zip(got, want):
        np.testing.assert_array_equal(td["frames"], np.asarray(jd["frames"]))
        assert (td["ref_slice"], td.get("save_skip", 0)) == (jd["ref_slice"],
                                                              jd.get("save_skip", 0))
        _hold_warp([td["cond"], td["masks"]], [np.asarray(jd["cond"]), np.asarray(jd["masks"])],
                   VALUE_ATOL)


@pytest.mark.parametrize("case", ["v1", "known fixed", "known smooth"])
def test_stub_conditions_are_equal_on_every_rank_and_hold_to_jax(world, case):
    runs, _, jax_v1, jax_known = world
    lead = runs[0]["stubs"][case]["calls"]
    for run in runs[1:]:
        for mine, first in zip(run["stubs"][case]["calls"], lead):
            for key in ("frames", "cond", "masks"):
                np.testing.assert_array_equal(mine[key], first[key], err_msg=key)
    if case == "v1":
        _hold_calls(lead, jax_v1["diffuse"])
        assert lead[0]["prompt"].startswith("a scene")  # the leader's caption
        assert runs[1]["stubs"]["v1"]["calls"][0]["prompt"] is None
        assert runs[0]["stubs"]["v1"]["video"].shape == (2 * 9 - 3, 32, 48, 3)
    else:
        calls, metrics = jax_known[case.split()[1]]
        _hold_calls(lead, [calls["diffuse"]])
        files = runs[0]["stubs"][case]["files"]
        if metrics is not None:
            got = runs[0]["stubs"][case]["metrics"]["metrics"]
            for key in ("PSNR", "SSIM", "MS_SSIM"):
                np.testing.assert_allclose(got[key], metrics["metrics"][key], rtol=1e-6)
            assert "metrics.json" in files
        assert all(run["stubs"][case]["files"] == [] for run in runs[1:])


# ----------------------------------------------------------------------------
# a failed orbit variant
# ----------------------------------------------------------------------------


def test_a_failure_on_one_rank_ends_every_rank_under_a_mesh(inputs, tmp_path):
    """The depth stage of the first variant raises on rank 2 alone: that
    rank ends, and every other rank ends in the collective it no longer
    joins; none hangs (the world's own timeout would say so)."""
    argv = inputs["orbits"] + MESH_ARGV + ["--out_dir", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="ranks failed") as failed:
        run_world(orbit_failure, WORLD, tmp_path / "world", DIMS, WARP_SIZE, argv, 2,
                  timeout=300.0, linger=120.0)
    text = str(failed.value)
    assert "planted depth failure on rank 2" in text
    assert all(f"rank {r}:" in text for r in range(WORLD))


def test_unsharded_the_sweep_goes_on_past_a_failed_variant(inputs, tmp_path, monkeypatch,
                                                           capsys):
    _patched_for_the_tree(monkeypatch)
    first = list(inference_orbits.ORBIT_VARIANTS.items())[:2]
    monkeypatch.setattr(inference_orbits, "ORBIT_VARIANTS", dict(first))
    real, calls = orchestrator.TrajCrafter.infer_gradual, []

    def fails_first(self):
        calls.append(self.cfg.save_dir)
        if len(calls) == 1:
            raise RuntimeError("planted failure of the first variant")
        return real(self)

    monkeypatch.setattr(orchestrator.TrajCrafter, "infer_gradual", fails_first)
    argv = [a for a in inputs["orbits"] if a != "--test_run"]
    assert inference_orbits.main(argv + ["--out_dir", str(tmp_path)]) == [n for n, _ in first]
    assert f"[orbit {first[0][0]}] FAILED" in capsys.readouterr().out
    for name in MP4S:
        assert _frames(tmp_path / "run" / first[1][0] / f"{name}.mp4") == \
            (17 if name == "viz" else 9)

