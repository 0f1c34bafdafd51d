"""Autoregressive long trajectories (trajectorycrafter_tpu_torch/autoregressive.py)
and the scene export (utils/export.py) vs the JAX package.

* ``align_depth_scale`` and ``split_trajectory``: equal to the JAX functions.
* The export: the PLY, the COLMAP text model and the HTML viewer the port
  writes are the JAX package's files byte for byte, on the same cloud.
* v1 (``TrajCrafterAutoregressive``) and v2 (``TrajCrafterGlobalPointCloud``)
  on the repository's test clip with a stub bundle (the plane depth, a fixed
  caption, ``_diffuse_and_save`` recorded and answering every segment with
  one seeded video), in both packages, as tests/test_torch_modes.py records
  the modes: per segment, v1's warp inputs (frames and depths exactly, poses
  to 1e-5, intrinsics to 2^-21 of the focal) and outputs, v2's renders, and
  the conditions handed to ``_diffuse_and_save``, within the warp's bounds
  (masks disagree on at most 0.5% of the pixels; colour and depth within
  1e-3 where both are known, but on at most 3% of them).  v2's cloud is
  lifted from one camera over a plane, so its renders meet z ties; its
  ``max_points`` lies above the merged cloud (``jax.random.choice`` cannot be
  replayed in torch; tests/test_torch_pointcloud.py holds the downsample).
* Each variant's tiny CPU run (``build_dev_models``): the joined video has
  ``n_splits * (F - overlap) + overlap`` frames, every segment writes its
  mp4s, and v2 writes its scene with the cloud downsampled to ``max_points``.
"""

import filecmp
import types
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from test_torch_modes import FOCAL_RTOL, POSE_ATOL, VALUE_ATOL, _argv, _hold_warp

from trajectorycrafter_tpu import autoregressive as jax_ar
from trajectorycrafter_tpu import cli as jax_cli
from trajectorycrafter_tpu import orchestrator as jax_orchestrator
from trajectorycrafter_tpu.utils import export as jax_export
from trajectorycrafter_tpu_torch import autoregressive as ar
from trajectorycrafter_tpu_torch import cli, orchestrator
from trajectorycrafter_tpu_torch.utils import export
from trajectorycrafter_tpu_torch.utils.timing import StageTimer

torch.set_num_threads(1)
RUN = dict(n_splits=2, overlap_frames=3, theta=20.0, phi=-5.0, d_r=0.1)
TOTAL = 2 * (9 - 3) + 3


def test_align_depth_scale_matches_jax():
    rng = np.random.default_rng(0)
    ref = rng.uniform(1, 5, (3, 16, 20)).astype(np.float32)
    new = (ref / 1.7 * rng.uniform(0.9, 1.1, ref.shape)).astype(np.float32)
    new[0, :2] = 50.0  # outliers
    new[1, 0, :5] = 0.0  # not positive
    mask = (rng.uniform(size=ref.shape) > 0.2).astype(np.float32)
    for args in ((new, ref), (new, ref, mask), (new[:, :1, :4], ref[:, :1, :4]),
                 (np.ones(40, np.float32), np.full(40, 2.0, np.float32))):
        got = ar.align_depth_scale(*args)
        assert isinstance(got, float) and got == jax_ar.align_depth_scale(*args)
    assert ar.align_depth_scale(new[:, :1, :4], ref[:, :1, :4], mask[:, :1, :4] * 0) == 1.0


@pytest.mark.parametrize("n,n_splits,seg,overlap", [
    (41, 4, 17, 9), (90, 2, 49, 8), (15, 2, 9, 3), (9, 1, 9, 0), (30, 3, 9, 2), (5, 1, 9, 3)])
def test_split_trajectory_matches_jax(n, n_splits, seg, overlap):
    poses = np.zeros((n, 4, 4), np.float32)
    got = ar.split_trajectory(torch.from_numpy(poses), n_splits, seg, overlap)
    want = jax_ar.split_trajectory(jnp.asarray(poses), n_splits, seg, overlap)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_export_files_are_the_jax_bytes(tmp_path):
    rng = np.random.default_rng(1)
    n = 5000
    pts = (rng.standard_normal((n, 3)) * 3).astype(np.float32)
    pts[:3] = [[-0.0, 1e-7, -5e-7], [1234567.5, -5e-7, 5e-7], [0.5, -0.5, 2.5e-6]]
    cols = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    K = np.array([[500.0, 0, 512], [0, 500.0, 288], [0, 0, 1]], np.float32)
    c2ws = [np.eye(4, dtype=np.float32) for _ in range(4)]
    for i, c2w in enumerate(c2ws):
        c2w[:3, 3] = [0.1 * i, -0.2, 0.3 * i]
        c2w[:3, :3] = np.linalg.qr(rng.standard_normal((3, 3)))[0] * [1, 1, 1]
    for name, mod in (("jax", jax_export), ("port", export)):
        mod.save_ply(str(tmp_path / name / "points.ply"), pts, cols)
        mod.save_colmap(str(tmp_path / name), [K] * 4, c2ws, 1024, 576, pts, cols,
                        max_points=3000)
        mod.save_html_viewer(str(tmp_path / name / "viewer.html"), pts, cols, c2ws, [K] * 4,
                             height=576, max_points=2000)
        mod.save_colmap(str(tmp_path / name / "bare"), [K], c2ws[:1], 64, 32)
    for f in ("points.ply", "cameras.txt", "images.txt", "points3D.txt", "viewer.html",
              "bare/points3D.txt"):
        assert filecmp.cmp(tmp_path / "jax" / f, tmp_path / "port" / f, shallow=False), f
    header = (tmp_path / "port/points.ply").read_text().splitlines()
    assert header[2] == f"element vertex {n}" and len(header) == 10 + n


# ----------------------------------------------------------------------------
# the variants on a stub bundle, both packages
# ----------------------------------------------------------------------------


def _gen(cfg):
    """The seeded video every recorded ``_diffuse_and_save`` answers with."""
    hs, ws = cfg.diffusion.sample_size
    return np.random.default_rng(7).uniform(0, 1, (cfg.video_length, hs, ws, 3)).astype(
        np.float32)


def _record(module, tc, calls, gen):
    warp = getattr(module, "forward_warp_batch")

    def recorded_warp(*args, **kwargs):
        out = warp(*args, **kwargs)
        calls.setdefault("warp", []).append((args, out))
        return out

    def recorded_diffuse(frames, cond_video, cond_masks, prompt, ref_slice=slice(0, None),
                         save_skip=0):
        calls.setdefault("diffuse", []).append(dict(
            frames=np.asarray(frames), cond=np.asarray(cond_video),
            masks=np.asarray(cond_masks), prompt=prompt, ref_slice=ref_slice,
            save_skip=save_skip))
        return gen

    tc._diffuse_and_save = recorded_diffuse
    return recorded_warp


def _run(pkg, variant, tmp_path, monkeypatch, **kw):
    argv = _argv(tmp_path, "gradual")
    if pkg == "jax":
        cfg = jax_cli.config_from_args(jax_cli.get_parser().parse_args(argv))
        module, models = jax_ar, jax_orchestrator.ModelBundle(
            pipeline=None, depth_infer=jax_orchestrator._plane_depth_infer, encode_prompt=None,
            get_caption=lambda frame: "a scene")
    else:
        cfg = cli.parse_config(argv)
        pipeline = types.SimpleNamespace(device=torch.device("cpu"), timer=StageTimer("cpu"))
        module, models = ar, orchestrator.ModelBundle(
            pipeline=pipeline, depth_infer=orchestrator._plane_depth_infer, encode_prompt=None,
            get_caption=lambda frame: "a scene")
    cfg.warp_size = (48, 80)
    tc = getattr(module, variant)(cfg, models=models)
    calls = {}
    monkeypatch.setattr(module, "forward_warp_batch", _record(module, tc, calls, _gen(cfg)))
    out = tc.infer_autoregressive(**RUN, **kw)
    assert out.shape == (TOTAL, 32, 48, 3)
    np.testing.assert_array_equal(out[:9], _gen(cfg))
    return calls, tc, cfg


def test_v1_segments_match_jax(tmp_path, monkeypatch):
    want, _, _ = _run("jax", "TrajCrafterAutoregressive", tmp_path / "jax", monkeypatch)
    got, tc, _ = _run("port", "TrajCrafterAutoregressive", tmp_path / "port", monkeypatch)
    assert len(got["warp"]) == len(want["warp"]) == 2
    assert len(got["diffuse"]) == len(want["diffuse"]) == 2
    for (targs, tout), (jargs, jout) in zip(got["warp"], want["warp"]):
        frames, depths, pose_s, pose_t, k = (np.asarray(x) for x in jargs[:5])
        tin = [x.numpy() for x in targs[:5]]
        np.testing.assert_array_equal(tin[0], frames)
        np.testing.assert_array_equal(tin[1], depths)
        np.testing.assert_allclose(tin[2], pose_s, atol=POSE_ATOL, rtol=0)
        np.testing.assert_allclose(tin[3], pose_t, atol=POSE_ATOL, rtol=0)
        np.testing.assert_allclose(tin[4], k, atol=FOCAL_RTOL * np.abs(k).max(), rtol=0)
        np.testing.assert_array_equal(tin[2], np.repeat(tin[3][:1], 9, 0))  # the window's first
        _hold_warp([x.numpy() for x in tout[:3]], [np.asarray(x) for x in jout[:3]], VALUE_ATOL)
    for td, jd in zip(got["diffuse"], want["diffuse"]):
        np.testing.assert_array_equal(td["frames"], jd["frames"])
        assert (td["prompt"], td["ref_slice"], td["save_skip"]) == \
            (jd["prompt"], jd["ref_slice"], jd["save_skip"])
        assert td["cond"].shape == (9, 48, 80, 3) and td["masks"].shape == (9, 48, 80)
        _hold_warp([td["cond"], td["masks"]], [jd["cond"], jd["masks"]], VALUE_ATOL)
    # the second segment warps the first generated one, at warp size
    assert not np.array_equal(got["diffuse"][1]["frames"], got["diffuse"][0]["frames"])
    assert {"read_frames", "caption", "depth", "poses", "warp"} <= set(tc.timer.seconds)


def test_v2_renders_match_jax(tmp_path, monkeypatch):
    want, _, jcfg = _run("jax", "TrajCrafterGlobalPointCloud", tmp_path / "jax", monkeypatch)
    got, tc, cfg = _run("port", "TrajCrafterGlobalPointCloud", tmp_path / "port", monkeypatch)
    assert "warp" not in got and "warp" not in want
    assert len(got["diffuse"]) == len(want["diffuse"]) == 2
    for td, jd in zip(got["diffuse"], want["diffuse"]):
        assert td["cond"].shape == (9, 48, 80, 3) and td["masks"].shape == (9, 48, 80)
        np.testing.assert_array_equal(td["frames"], td["cond"])  # the renders are both
        assert (td["prompt"], td["ref_slice"]) == (jd["prompt"], jd["ref_slice"])
        _hold_warp([td["cond"], td["masks"]], [jd["cond"], jd["masks"]], VALUE_ATOL)
        assert np.all(td["cond"][td["masks"] == 0] == 0)
    assert {"render", "relift", "export", "depth"} <= set(tc.timer.seconds)
    # the scene: the merged cloud of both packages (9 frames lifted twice)
    for c in (cfg, jcfg):
        scene = Path(c.save_dir) / "scene"
        lines = (scene / "points.ply").read_text().splitlines()
        assert lines[2] == f"element vertex {2 * 9 * 48 * 80}"
        assert (scene / "viewer.html").stat().st_size > 0
        assert len((scene / "images.txt").read_text().splitlines()) == 1 + 2 * TOTAL
    port_pts = np.loadtxt(Path(cfg.save_dir) / "scene/points.ply", skiprows=10)
    jax_pts = np.loadtxt(Path(jcfg.save_dir) / "scene/points.ply", skiprows=10)
    np.testing.assert_allclose(port_pts[:, :3], jax_pts[:, :3], atol=1e-4, rtol=1e-5)
    assert np.mean(np.abs(port_pts[:, 3:] - jax_pts[:, 3:]) > 1) < 0.01


@pytest.mark.parametrize("variant", ["TrajCrafterAutoregressive", "TrajCrafterGlobalPointCloud"])
def test_variant_runs_the_tiny_stack_end_to_end(tmp_path, variant):
    cfg = cli.parse_config(_argv(tmp_path, "gradual"))
    cfg.warp_size = (48, 80)
    tc = getattr(ar, variant)(cfg, models=orchestrator.build_dev_models(cfg, "cpu"))
    kw = {"max_points": 5000} if variant == "TrajCrafterGlobalPointCloud" else {}
    out = tc.infer_autoregressive(**RUN, **kw)
    assert out.shape == (TOTAL, 32, 48, 3)
    assert np.isfinite(out).all() and 0.0 <= out.min() and out.max() <= 1.0
    for name in ("input", "render", "mask", "gen", "viz"):
        assert (Path(cfg.save_dir) / f"{name}.mp4").stat().st_size > 0, name
    assert {"vae_encode", "denoise", "vae_decode", "write_mp4"} <= set(tc.timer.seconds)
    if kw:  # 2 x 9 x 48 x 80 points merged, then downsampled
        lines = (Path(cfg.save_dir) / "scene/points.ply").read_text().splitlines()
        assert lines[2] == "element vertex 5000" and len(lines) == 10 + 5000
        assert len((Path(cfg.save_dir) / "scene/points3D.txt").read_text().splitlines()) == 5001
