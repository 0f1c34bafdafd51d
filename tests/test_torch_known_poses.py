"""Known camera poses (trajectorycrafter_tpu_torch/known_poses.py) vs the JAX
package's (trajectorycrafter_tpu/known_poses.py).

* The camera conversions, ``undistort_and_resize``, the iPhone, MVTracker
  and SoM loaders and ``rotate_for_aspect`` are the JAX module's host code:
  on fixture files the test writes, every array they return is the JAX one
  exactly.
* ``evaluate_target_view``: the metrics within 1e-6 of JAX's (the same numpy
  formulas in the port's utils/quality.py), the same files written; the
  timestamp is not compared.
* ``infer_camera_poses`` and ``infer_camera_poses_smooth`` on a stub bundle
  (plane depth when none is given, a fixed caption, ``_diffuse_and_save``
  recorded), in both packages: the warp's inputs (frames and depths
  exactly, the source camera's extrinsics and intrinsics exactly, the
  smooth path's per-frame cameras within 1e-6 of their magnitude:
  tests/test_torch_interpolate.py), the warp's outputs and the conditions
  handed to ``_diffuse_and_save`` within the bounds of
  tests/test_torch_warp.py, and the metrics of the smooth path.
"""

import json
import types
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation
from test_known_poses import _write_iphone_tree
from test_torch_modes import VALUE_ATOL, _hold_warp

from trajectorycrafter_tpu import known_poses as jkp
from trajectorycrafter_tpu import orchestrator as jax_orchestrator
from trajectorycrafter_tpu.config import TrajCrafterConfig as JaxConfig
from trajectorycrafter_tpu_torch import known_poses as kp
from trajectorycrafter_tpu_torch import orchestrator
from trajectorycrafter_tpu_torch.config import TrajCrafterConfig
from trajectorycrafter_tpu_torch.utils.timing import StageTimer

torch.set_num_threads(1)


def _same_camera(got, want):
    for name in ("K", "R", "t", "w2c", "c2w"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    if want.dist_coef is None:
        assert got.dist_coef is None
    else:
        np.testing.assert_array_equal(got.dist_coef, want.dist_coef)


def _same(got, want):
    if isinstance(want, jkp.CalibratedCamera):
        _same_camera(got, want)
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for key in want:
            _same(got[key], want[key])
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("dist", [None, [0.05, -0.02, 0.001, 0.002, 0.0]])
def test_panoptic_camera_and_undistortion_match_jax(dist):
    calib = {"K": [[60.0, 0, 39.5], [0, 61.0, 24.0], [0, 0, 1]],
             "R": Rotation.from_rotvec([0.1, -0.2, 0.05]).as_matrix().tolist(),
             "t": [[12.0], [-30.0], [250.0]], "distCoef": dist}
    got, want = kp.panoptic_to_camera(calib), jkp.panoptic_to_camera(calib)
    _same_camera(got, want)
    np.testing.assert_allclose(got.w2c @ got.c2w, np.eye(4), atol=1e-12)
    frames = np.random.default_rng(0).uniform(0, 1, (3, 48, 80, 3)).astype(np.float32)
    g_frames, g_k = kp.undistort_and_resize(frames, got, (32, 48))
    w_frames, w_k = jkp.undistort_and_resize(frames, want, (32, 48))
    _same(g_frames, w_frames)
    _same(g_k, w_k)


def test_iphone_loader_matches_jax(tmp_path):
    _write_iphone_tree(str(tmp_path), cams=(0, 1, 2))
    got = kp.load_iphone_sequence(str(tmp_path), "toy", camera_ids=(0, 1, 2),
                                  min_sequence_length=2)
    want = jkp.load_iphone_sequence(str(tmp_path), "toy", camera_ids=(0, 1, 2),
                                    min_sequence_length=2)
    assert got.frame_ids == want.frame_ids == [3, 4, 5]
    _same(got.frames, want.frames)
    _same(got.depths, want.depths)
    for cam in (0, 1, 2):
        for g, w in zip(got.cameras[cam], want.cameras[cam]):
            _same_camera(g, w)
    with pytest.raises(ValueError, match="no contiguous frame run"):
        kp.load_iphone_sequence(str(tmp_path), "toy", camera_ids=(0, 1),
                                min_sequence_length=4)
    params = {"focal_length": 90.0, "principal_point": [7.0, 5.0],
              "orientation": Rotation.from_rotvec([0.3, 0.1, -0.2]).as_matrix().tolist(),
              "position": [0.5, -0.25, 2.0]}
    _same_camera(kp.iphone_camera_from_json(params), jkp.iphone_camera_from_json(params))


@pytest.mark.parametrize("layout", ["channels_first_uint8", "channels_last_float"])
def test_mvtracker_loader_matches_jax(tmp_path, layout):
    rng = np.random.default_rng(1)
    V, T, H, W = 3, 5, 12, 16
    if layout == "channels_first_uint8":
        fields = dict(video=rng.integers(0, 256, (V, T, 3, H, W)).astype(np.uint8),
                      videodepth=rng.uniform(1, 3, (V, T, 1, H, W)).astype(np.float32),
                      intrs=rng.uniform(10, 20, (V, T, 3, 3)),
                      extrs=rng.standard_normal((V, T, 3, 4)))
    else:
        fields = dict(rgbs=rng.uniform(0, 1, (V, T, H, W, 3)).astype(np.float32),
                      depths=rng.uniform(1, 3, (V, T, H, W)).astype(np.float64),
                      intrinsics=rng.uniform(10, 20, (V, 3, 3)),
                      extrinsics=rng.standard_normal((V, 3, 4)))
    path = tmp_path / "sample.npz"
    np.savez(path, **fields)
    for views in ((0, 1), (2, 0)):
        _same(kp.load_mvtracker_npz(str(path), *views), jkp.load_mvtracker_npz(str(path), *views))
    np.savez(tmp_path / "bad.npz", video=fields.get("video", fields.get("rgbs")))
    with pytest.raises(KeyError):
        kp.load_mvtracker_npz(str(tmp_path / "bad.npz"))


@pytest.mark.parametrize("with_masks", [False, True])
@pytest.mark.parametrize("enable", [False, True])
def test_som_loader_and_rotation_match_jax(with_masks, enable):
    rng = np.random.default_rng(2)

    def item(i):
        w2c = np.eye(4)
        w2c[:3, :3] = Rotation.from_rotvec([0.0, 0.1 * i, 0.0]).as_matrix()
        w2c[:3, 3] = [0.1 * i, 0.0, 0.5]
        out = {"imgs": rng.uniform(0, 1, (20, 12, 3)), "depths": rng.uniform(1, 3, (20, 12)),
               "Ks": [[30.0, 0, 6.0], [0, 31.0, 10.0], [0, 0, 1]], "w2cs": w2c}
        if with_masks:
            out["masks"] = (rng.uniform(size=(20, 12)) > 0.5)
        return out

    src, tgt = [item(i) for i in range(4)], [item(i + 4) for i in range(4)]
    got, want = kp.load_som_sequence(src, tgt), jkp.load_som_sequence(src, tgt)
    _same(got, want)
    assert ("masks" in got) is with_masks
    rot_got = kp.rotate_for_aspect(got["frames"], got["source_cam"].K, (576, 1024), enable)
    rot_want = jkp.rotate_for_aspect(want["frames"], want["source_cam"].K, (576, 1024), enable)
    for g, w in zip(rot_got, rot_want):
        _same(g, w)
    assert rot_got[0].shape[1:3] == ((12, 20) if enable else (20, 12))
    with pytest.raises(ValueError):
        kp.load_som_sequence(src, tgt[:2])


def test_evaluate_target_view_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    gen = rng.uniform(0, 1, (5, 32, 48, 3)).astype(np.float32)
    target = np.clip(gen + 0.05 * rng.standard_normal(gen.shape), 0, 1).astype(np.float32)
    target = np.stack([cv2.resize(f, (64, 40)) for f in target])  # resized back to gen's size
    got = kp.evaluate_target_view(gen, target, str(tmp_path / "port"), seq_name="s", fps=8)
    want = jkp.evaluate_target_view(gen, target, str(tmp_path / "jax"), seq_name="s", fps=8)
    assert set(got) == set(want)
    got.pop("evaluation_timestamp"), want.pop("evaluation_timestamp")
    for key in ("PSNR", "SSIM", "MS_SSIM"):
        np.testing.assert_allclose(got["metrics"][key], want["metrics"][key], rtol=1e-6, atol=0)
    assert {k: v for k, v in got.items() if k != "metrics"} == \
        {k: v for k, v in want.items() if k != "metrics"}
    on_disk = json.loads((tmp_path / "port/metrics.json").read_text())
    assert on_disk["metrics"] == got["metrics"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert (tmp_path / "port/metrics_summary.txt").read_text() == \
        (tmp_path / "jax/metrics_summary.txt").read_text()


# ----------------------------------------------------------------------------
# the two known-pose modes on a stub bundle, both packages
# ----------------------------------------------------------------------------

F, H, W = 9, 48, 80


def _sample(seed=5):
    rng = np.random.default_rng(seed)
    frames = rng.uniform(0, 1, (F, H, W, 3)).astype(np.float32)
    target_frames = rng.uniform(0, 1, (F, H + 8, W + 16, 3)).astype(np.float32)
    yy = np.mgrid[0:H, 0:W][0]
    depths = np.tile((2.0 + 2.0 * yy / H).astype(np.float32), (F, 1, 1))
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]])
    src = dict(K=K, R=np.eye(3), t=np.zeros(3))
    tgt = dict(K=K * [[1.1, 1, 1.05], [1, 1.1, 0.95], [1, 1, 1]],
               R=Rotation.from_euler("y", 0.12).as_matrix(), t=np.array([0.25, 0.02, 0.05]))
    return frames, target_frames, depths, src, tgt


def _stub(pkg, tmp_path, monkeypatch, calls):
    if pkg == "jax":
        module, cfg = jkp, JaxConfig()
        models = jax_orchestrator.ModelBundle(
            pipeline=None, depth_infer=jax_orchestrator._plane_depth_infer, encode_prompt=None,
            get_caption=lambda frame: "a scene")
    else:
        module, cfg = kp, TrajCrafterConfig()
        pipeline = types.SimpleNamespace(device=torch.device("cpu"), timer=StageTimer("cpu"))
        models = orchestrator.ModelBundle(
            pipeline=pipeline, depth_infer=orchestrator._plane_depth_infer, encode_prompt=None,
            get_caption=lambda frame: "a scene")
    cfg.video_length, cfg.warp_size = F, (H, W)
    cfg.diffusion.sample_size = (32, 48)
    cfg.save_dir = str(tmp_path / pkg)
    tc = module.CameraPoseTrajCrafter(cfg, models=models)
    warp = module.forward_warp_batch

    def recorded_warp(*args, **kwargs):
        out = warp(*args, **kwargs)
        calls["warp"] = (args, out)
        return out

    def recorded_diffuse(frames, cond, masks, prompt, ref_slice=slice(0, None), save_skip=0):
        calls["diffuse"] = dict(frames=np.asarray(frames), cond=np.asarray(cond),
                                masks=np.asarray(masks), prompt=prompt, ref_slice=ref_slice)
        return np.random.default_rng(6).uniform(0, 1, (F, 32, 48, 3)).astype(np.float32)

    monkeypatch.setattr(module, "forward_warp_batch", recorded_warp)
    tc._diffuse_and_save = recorded_diffuse
    return module, tc


@pytest.mark.parametrize("smooth", [False, True], ids=["fixed", "smooth"])
@pytest.mark.parametrize("given_depth", [True, False], ids=["depth", "estimated"])
def test_known_pose_modes_match_jax(tmp_path, monkeypatch, smooth, given_depth):
    frames, target_frames, depths, src, tgt = _sample()
    out = {}
    for pkg in ("jax", "port"):
        calls = {}
        module, tc = _stub(pkg, tmp_path, monkeypatch, calls)
        cams = [module.CalibratedCamera(**c) for c in (src, tgt)]
        d = depths if given_depth else None
        if smooth:
            gen, metrics = tc.infer_camera_poses_smooth(frames, d, *cams,
                                                        target_frames=target_frames)
        else:
            gen, metrics = tc.infer_camera_poses(frames, d, *cams), None
        out[pkg] = calls, gen, metrics
    (jcalls, jgen, jmetrics), (tcalls, tgen, tmetrics) = out["jax"], out["port"]
    np.testing.assert_array_equal(tgen, jgen)
    jin = [np.asarray(x) for x in jcalls["warp"][0][:6]]
    tin = [x.numpy() for x in tcalls["warp"][0][:6]]
    np.testing.assert_array_equal(tin[0], jin[0])
    np.testing.assert_array_equal(tin[1], jin[1])
    np.testing.assert_array_equal(tin[2], jin[2])  # the source camera, fixed
    np.testing.assert_array_equal(tin[4], jin[4])
    for t, j in ((tin[3], jin[3]), (tin[5], jin[5])):
        np.testing.assert_allclose(t, j, atol=1e-6 * np.abs(j).max(), rtol=0)
    if smooth:  # the target camera flies from the source's to the target's
        np.testing.assert_allclose(tin[3][0], tin[2][0], atol=1e-6)
        assert not np.allclose(tin[3][-1], tin[2][-1])
    _hold_warp([x.numpy() for x in tcalls["warp"][1][:3]],
               [np.asarray(x) for x in jcalls["warp"][1][:3]], VALUE_ATOL)
    td, jd = tcalls["diffuse"], jcalls["diffuse"]
    np.testing.assert_array_equal(td["frames"], jd["frames"])
    assert (td["prompt"], td["ref_slice"]) == (jd["prompt"], jd["ref_slice"])
    assert td["cond"].shape == (F, H, W, 3) and td["masks"].shape == (F, H, W)
    _hold_warp([td["cond"], td["masks"]], [jd["cond"], jd["masks"]], VALUE_ATOL)
    if smooth:
        for key in ("PSNR", "SSIM", "MS_SSIM"):
            np.testing.assert_allclose(tmetrics["metrics"][key], jmetrics["metrics"][key],
                                       rtol=1e-6)
        assert (tmp_path / "port/metrics.json").stat().st_size > 0


def test_multiview_and_sample_dispatch(tmp_path, monkeypatch):
    frames, target_frames, depths, src, tgt = _sample()
    calls = {}
    _, tc = _stub("port", tmp_path, monkeypatch, calls)
    cams = [kp.CalibratedCamera(**c) for c in (src, tgt)]
    base = tc.cfg.save_dir
    outs = tc.infer_multiview(frames, depths, cams[0], [cams[1], cams[0]])
    assert len(outs) == 2 and tc.cfg.save_dir == base
    assert sorted(p.name for p in Path(base).iterdir()) == ["view_00", "view_01"]
    sample = {"frames": frames, "depths": depths, "source_cam": cams[0], "target_cam": cams[1],
              "target_frames": target_frames}
    assert tc.infer_sample(sample).shape == (F, 32, 48, 3)
    assert tc.infer_sample(sample, smooth=True).shape == (F, 32, 48, 3)
    assert (Path(base) / "metrics.json").stat().st_size > 0
    assert {"caption", "warp"} <= set(tc.timer.seconds)
