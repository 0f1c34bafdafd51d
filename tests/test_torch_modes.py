"""The direct, bullet and zoom modes (trajectorycrafter_tpu_torch/orchestrator.py)
and the ``Warper`` facade (geometry/warper.py) vs the JAX package.

Each mode of the port and of the JAX ``TrajCrafter`` runs on the
repository's test clip with a stub bundle: the plane depth, a fixed
caption, and ``_diffuse_and_save`` recorded in place of the diffusion.
Compared:

  * the inputs each mode hands ``forward_warp_batch``: the gathered or
    tiled frames and depths exactly; poses to 1e-5 (tests/test_torch_warp.py);
    intrinsics to 2^-21 of the larger focal (below);
  * the warp's outputs within the bounds of tests/test_torch_warp.py (hole
    masks disagree on at most 0.5% of the pixels; where both are known,
    colour and depth agree to 1e-3 but on at most 3% knife-edge pixels);
  * the conditions the mode hands ``_diffuse_and_save`` (resized to
    sample_size and quantized to uint8 on both sides): the same frames,
    reference slice and ``save_skip``; the masks within 0.5%; the colours
    within one uint8 level plus 1e-3, but on at most 3% of the pixels.

``zoom_intrinsics``: the port takes the focal ramp in float64 and rounds it
once; ``jnp.linspace`` computes it in float32 as XLA folds and contracts it
(a rounded reciprocal of num - 1, fused multiply-adds on the CPU), which
leaves it up to a few float32 ulps of the larger focal from the exact ramp.
So the two agree to 2^-21 of the larger focal, and exactly at the ends.

Then each mode's tiny CPU ``infer_*`` writes its five mp4s with the frame
counts of the save scheme, and ``Warper.forward_warp`` agrees with the JAX
facade in every combination of a source mask, ``mask`` and ``twice``, and
with per-frame target intrinsics, within the same warp bounds.
"""

import types
from pathlib import Path

import cv2
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from trajectorycrafter_tpu import cli as jax_cli
from trajectorycrafter_tpu import orchestrator as jax_orchestrator
from trajectorycrafter_tpu.geometry.cameras import zoom_intrinsics as jax_zoom_intrinsics
from trajectorycrafter_tpu.geometry.warper import Warper as JaxWarper
from trajectorycrafter_tpu_torch import cli, orchestrator
from trajectorycrafter_tpu_torch.geometry.cameras import (
    default_c2w,
    intrinsics_matrix,
    zoom_intrinsics,
)
from trajectorycrafter_tpu_torch.geometry.trajectory import generate_traj_specified
from trajectorycrafter_tpu_torch.geometry.warper import Warper
from trajectorycrafter_tpu_torch.orchestrator import TrajCrafter, build_dev_models
from trajectorycrafter_tpu_torch.utils.timing import StageTimer

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
POSE_ATOL = 1e-5
FOCAL_RTOL = 2.0**-21
VALUE_ATOL = 1e-3
U8_ATOL = 1.0 / 255 + VALUE_ATOL
MASK_DISAGREE_MAX = 0.005
KNIFE_EDGE_MAX = 0.03
MODES = ["direct", "bullet", "zoom"]
MP4S = ("input", "render", "mask", "gen", "viz")


def _argv(tmp_path, mode, *extra):
    return ["--video_path", str(REPO / "test/videos/synth.mp4"), "--camera", "traj",
            "--traj_txt", str(REPO / "test/trajs/loop1.txt"), "--mode", mode,
            "--prompt", "a scene", "--diffusion_inference_steps", "2",
            "--video_length", "9", "--sample_size", "32", "48",
            "--out_dir", str(tmp_path), "--exp_name", mode, *extra]


def _recorded(module, tc, calls):
    """Record ``forward_warp_batch`` of ``module`` and ``tc._diffuse_and_save``."""
    warp = module.forward_warp_batch

    def recorded_warp(*args, **kwargs):
        out = warp(*args, **kwargs)
        calls["warp_in"], calls["warp_out"] = args, out
        return out

    def recorded_diffuse(frames, cond_video, cond_masks, prompt, ref_slice=slice(0, None),
                         save_skip=0):
        calls["diffuse"] = dict(frames=frames, cond=cond_video, masks=cond_masks,
                                prompt=prompt, ref_slice=ref_slice, save_skip=save_skip)
        return "recorded"

    tc._diffuse_and_save = recorded_diffuse
    return recorded_warp


def _run_jax(tmp_path, mode, monkeypatch):
    cfg = jax_cli.config_from_args(jax_cli.get_parser().parse_args(_argv(tmp_path, mode)))
    cfg.warp_size = (48, 80)
    models = jax_orchestrator.ModelBundle(
        pipeline=None, depth_infer=jax_orchestrator._plane_depth_infer, encode_prompt=None,
        get_caption=lambda frame: "a scene")
    tc = jax_orchestrator.TrajCrafter(cfg, models=models)
    calls = {}
    monkeypatch.setattr(jax_orchestrator, "forward_warp_batch",
                        _recorded(jax_orchestrator, tc, calls))
    assert getattr(tc, f"infer_{mode}")() == "recorded"
    return calls


def _run_port(tmp_path, mode, monkeypatch):
    cfg = cli.parse_config(_argv(tmp_path, mode))
    cfg.warp_size = (48, 80)
    pipeline = types.SimpleNamespace(device=torch.device("cpu"), timer=StageTimer("cpu"))
    models = orchestrator.ModelBundle(
        pipeline=pipeline, depth_infer=orchestrator._plane_depth_infer, encode_prompt=None,
        get_caption=lambda frame: "a scene")
    tc = TrajCrafter(cfg, models=models)
    calls = {}
    monkeypatch.setattr(orchestrator, "forward_warp_batch",
                        _recorded(orchestrator, tc, calls))
    assert getattr(tc, f"infer_{mode}")() == "recorded"
    assert {"read_frames", "caption", "depth", "poses", "warp"} <= set(tc.timer.seconds)
    return calls


def _hold_warp(got, want, value_atol):
    """(warped, mask[, depth]) of the port against the JAX package's."""
    warped, mask = got[0], got[1]
    disagree = np.mean(mask != want[1])
    assert disagree <= MASK_DISAGREE_MAX, disagree
    both = (mask > 0) & (want[1] > 0)
    assert both.mean() > 0.1  # the views overlap
    off = np.abs(warped - want[0]).max(-1) > value_atol
    if len(got) > 2:
        off |= np.abs(got[2] - want[2]) > value_atol
    assert off[both].mean() <= KNIFE_EDGE_MAX, off[both].mean()


@pytest.mark.parametrize("mode", MODES)
def test_mode_warp_inputs_and_conditions_match_jax(tmp_path, mode, monkeypatch):
    want = _run_jax(tmp_path / "jax", mode, monkeypatch)
    got = _run_port(tmp_path / "port", mode, monkeypatch)

    frames, depths, pose_s, pose_t, k1 = (np.asarray(x) for x in want["warp_in"][:5])
    tin = [None if x is None else x.numpy() for x in got["warp_in"]]
    tin += [None] * (6 - len(tin))
    np.testing.assert_array_equal(tin[0], frames)
    np.testing.assert_array_equal(tin[1], depths)
    np.testing.assert_allclose(tin[2], pose_s, atol=POSE_ATOL, rtol=0)
    np.testing.assert_allclose(tin[3], pose_t, atol=POSE_ATOL, rtol=0)
    focal_tol = FOCAL_RTOL * np.abs(k1).max()
    np.testing.assert_allclose(tin[4], k1, atol=focal_tol, rtol=0)
    if mode == "zoom":
        k2 = np.asarray(want["warp_in"][5])
        assert not np.array_equal(k2, k1)  # the target focal ramps
        np.testing.assert_allclose(tin[5], k2, atol=focal_tol, rtol=0)
    else:
        assert len(want["warp_in"]) == 5 and tin[5] is None
    if mode == "bullet":  # the last frame, frozen
        np.testing.assert_array_equal(tin[0], np.repeat(tin[0][-1:], 9, 0))

    _hold_warp([x.numpy() for x in got["warp_out"][:3]],
               [np.asarray(x) for x in want["warp_out"][:3]], VALUE_ATOL)

    jd, td = want["diffuse"], got["diffuse"]
    np.testing.assert_array_equal(td["frames"], jd["frames"])
    assert (td["prompt"], td["ref_slice"], td["save_skip"]) == \
        (jd["prompt"], jd["ref_slice"], jd["save_skip"])
    assert td["save_skip"] == (4 if mode == "direct" else 0)  # cut 20 clamped to 9 // 2
    assert td["cond"].shape == jd["cond"].shape == (9, 32, 48, 3)
    assert td["masks"].shape == jd["masks"].shape == (9, 32, 48)
    _hold_warp([td["cond"], td["masks"]], [jd["cond"], jd["masks"]], U8_ATOL)


@pytest.mark.parametrize("mode,counts", [
    ("direct", (5, 5, 5, 5, 9)), ("bullet", (9, 9, 9, 9, 17)), ("zoom", (9, 9, 9, 9, 17)),
], ids=MODES)
def test_mode_writes_five_mp4s_with_the_save_scheme(tmp_path, mode, counts):
    """``save_skip`` = cut = 4 at 9 frames in the direct mode: input keeps
    the first 5 frames, render / mask / gen drop the first 4, and viz plays
    the 5 pairs as a boomerang (2 x 5 - 1)."""
    cfg = cli.parse_config(_argv(tmp_path, mode))
    cfg.warp_size = (48, 80)
    tc = TrajCrafter(cfg, models=build_dev_models(cfg, "cpu"))
    gen = getattr(tc, f"infer_{mode}")()
    assert gen.shape == (9, 32, 48, 3)
    assert np.isfinite(gen).all() and 0.0 <= gen.min() and gen.max() <= 1.0
    got = tuple(int(cv2.VideoCapture(str(Path(cfg.save_dir) / f"{name}.mp4"))
                    .get(cv2.CAP_PROP_FRAME_COUNT)) for name in MP4S)
    assert got == counts
    assert {"warp", "vae_encode", "denoise", "vae_decode", "write_mp4"} <= set(tc.timer.seconds)


@pytest.mark.parametrize("f0,f1,num", [(500.0, 250.0, 49), (500.0, 300.0, 9),
                                       (123.4, 567.8, 17), (500.0, 250.0, 1)])
def test_zoom_intrinsics_match_jax(f0, f1, num):
    want = np.asarray(jax_zoom_intrinsics(f0, f1, num, 512.0, 288.0))
    got = zoom_intrinsics(f0, f1, num, 512.0, 288.0)
    assert got.dtype == torch.float32 and got.shape == want.shape == (num, 3, 3)
    got = got.numpy()
    np.testing.assert_allclose(got, want, atol=FOCAL_RTOL * max(f0, f1), rtol=0)
    np.testing.assert_array_equal(got[[0, -1]], want[[0, -1]])
    focal = np.asarray(want[:, 0, 0])
    off_focal = want.copy()
    off_focal[:, 0, 0] = off_focal[:, 1, 1] = 0.0
    np.testing.assert_array_equal(got * (off_focal != 0) + got * (want == 0), off_focal)
    np.testing.assert_array_equal(got[:, 1, 1], got[:, 0, 0])
    assert np.all(np.diff(focal) * np.sign(f1 - f0) >= 0)


def _warper_inputs(zoom: bool):
    n, h, w = 3, 24, 40
    rng = np.random.default_rng(3)
    frames = rng.uniform(-1, 1, (n, 3, h, w)).astype(np.float32)
    yy = np.mgrid[0:h, 0:w][0]
    depths = np.tile((2.0 + 2.0 * yy / h).astype(np.float32), (n, 1, 1, 1))
    depths += 0.05 * rng.standard_normal(depths.shape).astype(np.float32)
    src_mask = (rng.uniform(size=(n, 1, h, w)) > 0.1).astype(np.float32)
    # the targets skip the trajectory's first pose, the source pose itself:
    # there every pixel would land on an integer position, a knife edge
    poses = generate_traj_specified(default_c2w(), -8.0, 5.0, -0.2, 0.1, 0.05, n + 1)
    poses[:, 2, 3] += 3.0
    pose_s = poses[:1].repeat(n, 1, 1).numpy()
    poses = poses[1:]
    k1 = intrinsics_matrix(30.0, w / 2, h / 2)[None].repeat(n, 1, 1).numpy()
    k2 = zoom_intrinsics(30.0, 24.0, n, w / 2, h / 2).numpy() if zoom else None
    return frames, src_mask, depths, pose_s, poses.numpy(), k1, k2


@pytest.mark.parametrize("use_src_mask,mask,twice,zoom", [
    (False, False, False, False), (True, False, False, False), (False, True, False, False),
    (False, False, True, False), (True, True, True, False), (False, False, False, True),
], ids=["plain", "source_mask", "mask", "twice", "all", "intrinsic2"])
def test_warper_forward_warp_matches_jax(use_src_mask, mask, twice, zoom):
    frames, src_mask, depths, pose_s, pose_t, k1, k2 = _warper_inputs(zoom)
    m = src_mask if use_src_mask else None
    want = JaxWarper().forward_warp(
        jnp.asarray(frames), None if m is None else jnp.asarray(m), jnp.asarray(depths),
        jnp.asarray(pose_s), jnp.asarray(pose_t), jnp.asarray(k1),
        None if k2 is None else jnp.asarray(k2), mask=mask, twice=twice)
    t = lambda x: None if x is None else torch.from_numpy(x)
    got = Warper(resolution=(24, 40)).forward_warp(
        t(frames), t(m), t(depths), t(pose_s), t(pose_t), t(k1), t(k2), mask=mask, twice=twice)
    assert [None if x is None else tuple(x.shape) for x in got] == \
        [None if x is None else tuple(x.shape) for x in want]
    if not twice:
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=VALUE_ATOL, rtol=0)
    warped, mask2, wdepth = (x.numpy() for x in got[:3])
    _hold_warp([warped.transpose(0, 2, 3, 1), mask2[:, 0], wdepth[:, 0]],
               [np.asarray(want[0]).transpose(0, 2, 3, 1), np.asarray(want[1])[:, 0],
                np.asarray(want[2])[:, 0]], VALUE_ATOL)
    assert np.all(warped.transpose(0, 2, 3, 1)[mask2[:, 0] == 0] == -1.0) or mask
    assert tuple(Warper.create_grid(2, 24, 40).shape) == tuple(JaxWarper.create_grid(2, 24, 40).shape)
    np.testing.assert_array_equal(Warper.create_grid(2, 24, 40).numpy(),
                                  np.asarray(JaxWarper.create_grid(2, 24, 40)))


# ----------------------------------------------------------------------------
# _diffuse_and_save: the conditions it hands the pipeline
# ----------------------------------------------------------------------------


class _RecordingPipeline:
    """Records the pipeline's arguments; answers with a seeded video."""

    def __init__(self, device, answer):
        self.device, self.timer, self.answer, self.calls = device, StageTimer(device), answer, []

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        return self.answer


def _diffuse_inputs(size, f=9):
    rng = np.random.default_rng(11)
    h, w = size
    frames = rng.uniform(0, 1, (f, 48, 80, 3)).astype(np.float32)
    cond = rng.uniform(0, 1, (f, h, w, 3)).astype(np.float32)
    masks = (rng.uniform(size=(f, h, w)) > 0.3).astype(np.float32)
    return frames, cond, masks


def _port_diffuse(tmp_path, frames, cond, masks):
    cfg = cli.parse_config(_argv(tmp_path, "gradual"))
    answer = torch.from_numpy(np.random.default_rng(12).uniform(0, 1, (1, 9, 32, 48, 3))
                              .astype(np.float32))
    pipeline = _RecordingPipeline(torch.device("cpu"), answer)
    models = orchestrator.ModelBundle(
        pipeline=pipeline, depth_infer=None, get_caption=None,
        encode_prompt=lambda p, n: (torch.zeros(1, 4, 8), torch.ones(1, 4, 8)))
    tc = TrajCrafter(cfg, models=models)
    gen = tc._diffuse_and_save(frames, cond, masks, "a scene", ref_slice=slice(0, 5))
    (args, kwargs), = pipeline.calls
    return cfg, gen, args, kwargs


def test_diffuse_and_save_at_sample_size_is_bit_equal_to_before(tmp_path):
    """Conditions already at sample_size (the modes' case) reach the
    pipeline exactly as before the off-size resize existed: the condition
    video and the 255-valued hole mask as given, the reference frames
    resized by cv2, the same generated video back."""
    frames, cond, masks = _diffuse_inputs((32, 48))
    cfg, gen, args, kwargs = _port_diffuse(tmp_path, frames, cond, masks)
    frames_s = np.stack([cv2.resize(fr, (48, 32), interpolation=cv2.INTER_LINEAR)
                         for fr in frames])
    assert torch.equal(args[2], torch.from_numpy(cond[None]))
    assert torch.equal(args[3], torch.from_numpy((1.0 - masks)[None, ..., None] * 255.0))
    assert torch.equal(args[4], torch.from_numpy(frames_s[0:5][None]))
    answer = np.random.default_rng(12).uniform(0, 1, (9, 32, 48, 3)).astype(np.float32)
    np.testing.assert_array_equal(gen, np.round(answer * 255.0).astype(np.uint8) / np.float32(255))
    for name in MP4S:
        assert (Path(cfg.save_dir) / f"{name}.mp4").stat().st_size > 0


def test_diffuse_and_save_resizes_off_size_conditions_as_jax(tmp_path):
    """Conditions at warp size (the long-trajectory and known-pose paths):
    the videos by cv2 INTER_LINEAR and the masks by ``resize_nearest``, as
    the JAX ``_diffuse_and_save`` does -- the pipeline gets the JAX inputs
    exactly."""
    frames, cond, masks = _diffuse_inputs((48, 80))
    _, _, args, _ = _port_diffuse(tmp_path / "port", frames, cond, masks)

    cfg = jax_cli.config_from_args(jax_cli.get_parser().parse_args(_argv(tmp_path / "jax",
                                                                         "gradual")))
    seen = []

    def pipeline(*a, **kw):
        seen.append(a)
        return jnp.zeros((1, 9, 32, 48, 3))

    models = jax_orchestrator.ModelBundle(
        pipeline=pipeline, depth_infer=None, get_caption=None,
        encode_prompt=lambda p, n: (jnp.zeros((1, 4, 8)), jnp.ones((1, 4, 8))))
    jax_orchestrator.TrajCrafter(cfg, models=models)._diffuse_and_save(
        frames, cond, masks, "a scene", ref_slice=slice(0, 5))
    (want,) = seen
    assert tuple(args[2].shape) == (1, 9, 32, 48, 3) and tuple(args[3].shape) == (1, 9, 32, 48, 1)
    for got_x, want_x in zip(args[2:5], want[2:5]):
        np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
