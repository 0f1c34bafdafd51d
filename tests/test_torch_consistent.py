"""The consistent-depth autoregressive path
(trajectorycrafter_tpu_torch/consistent_autoregressive.py) and its entry point
(scripts/inference_alignment.py) vs the JAX package.

* ``invert_depth_with_scale`` and ``_snap``: equal.
* ``lift_video_to_pcs`` with invalid (zero) depths parked at NaN, and
  ``render_video_from_pcs`` at point sizes 2 and 1 (mask opening 9 and 3):
  a cloud rendered into the cameras it was lifted from with the principal
  point a quarter pixel off, so no point lies on a rounding or frame edge:
  points 1e-5, renders exact, the NaN points culled.
* ``merge_pcs_downsample`` held to its properties (its draw is torch's):
  half of each frame's joined cloud, rows of that cloud, none twice.
* ``estimate_depth_with_prompt_alignment`` and the VDA branch of
  ``_segment_depth`` (reflect-padded to multiples of 14, cropped, inverted):
  1e-4 and 1e-5 of the depth's magnitude.
* ``infer_autoregressive`` with ``n_splits`` 2, with and without a VDA, in
  both packages on a stub bundle (plane depth, a fixed caption,
  ``_diffuse_and_save`` recorded and answering with one seeded video), the
  downsample patched in both modules with one shared numpy choice of rows:
  the conditions of each stage within the warp's bounds, the masks (opened
  with a 9 x 9 kernel, which spreads a flipped pixel over up to 17 x 17)
  disagreeing on at most 3%; the cameras written to ``stage_XX/`` to 1e-5.
* The tiny CPU stack end to end with a VDA; the script on a tiny tree with a
  vits ``.pth``, refusing a file that does not load (no fallback) and
  refusing to start without a card.
"""

import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_modes import POSE_ATOL, VALUE_ATOL, _argv
from test_torch_scripts import _tiny, tree  # noqa: F401  (the tiny tree fixture)
from test_torch_vda import tiny_pair

from trajectorycrafter_tpu import cli as jax_cli
from trajectorycrafter_tpu import consistent_autoregressive as jax_cons
from trajectorycrafter_tpu import depth_alignment as jax_da
from trajectorycrafter_tpu import orchestrator as jax_orchestrator
from trajectorycrafter_tpu_torch import cli, orchestrator
from trajectorycrafter_tpu_torch import consistent_autoregressive as cons
from trajectorycrafter_tpu_torch import depth_alignment as da
from trajectorycrafter_tpu_torch.models.vda import VideoDepthAnything, vda_config
from trajectorycrafter_tpu_torch.scripts import inference_alignment
from trajectorycrafter_tpu_torch.utils import checkpoints
from trajectorycrafter_tpu_torch.utils.timing import StageTimer

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
MASK_OPEN_DISAGREE_MAX = 0.03
KNIFE_EDGE_MAX = 0.03


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def test_invert_depth_and_snap_match_jax():
    d = np.asarray([[0.0, 2.0, 1e-9], [4.0, 0.0, 3e3]], np.float32)
    # one ulp: XLA may divide by multiplying with the reciprocal
    np.testing.assert_allclose(cons.invert_depth_with_scale(_t(d), 100.0).numpy(),
                               np.asarray(jax_cons.invert_depth_with_scale(jnp.asarray(d), 100.0)),
                               rtol=2.0**-23, atol=0)
    for v, m in ((288, 14), (512, 14), (5, 14), (14, 14), (300, 7)):
        assert cons._snap(v, m) == jax_cons._snap(v, m)


def _scene(f=3, h=12, w=16, seed=0):
    """Frames, depths with zeros, K, c2ws and K with the principal point a
    quarter pixel on."""
    rng = np.random.default_rng(seed)
    frames = rng.uniform(size=(f, h, w, 3)).astype(np.float32)
    depths = rng.uniform(2.0, 3.0, (f, h, w)).astype(np.float32)
    depths[:, 2:4, 5:9] = 0.0  # invalid: parked at NaN
    K = np.asarray([[14.0, 0, 8.0], [0, 14.0, 6.0], [0, 0, 1]], np.float32)
    c2ws = np.tile(np.eye(4, dtype=np.float32)[None], (f, 1, 1))
    c2ws[:, 0, 3] = np.arange(f) * 0.1
    k_lift = K.copy()
    k_lift[:2, 2] += 0.25
    return frames, depths, K, c2ws, k_lift


@pytest.mark.parametrize("point_size,kernel", [(2, 9), (1, 3)])
def test_lift_and_render_match_jax(point_size, kernel):
    frames, depths, K, c2ws, k_lift = _scene()
    pcs = cons.lift_video_to_pcs(_t(frames), _t(depths), _t(k_lift), _t(c2ws))
    jpcs = jax_cons.lift_video_to_pcs(jnp.asarray(frames), jnp.asarray(depths),
                                      jnp.asarray(k_lift), jnp.asarray(c2ws))
    for (p, c), (jp, jc) in zip(pcs, jpcs):
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        assert np.isnan(p.numpy()).any(axis=1).sum() == 2 * 4
    got = cons.render_video_from_pcs(pcs, _t(c2ws), _t(K), (12, 16), point_size=point_size,
                                     mask_kernel=kernel)
    want = jax_cons.render_video_from_pcs(jpcs, jnp.asarray(c2ws), jnp.asarray(K), (12, 16),
                                          point_size=point_size, mask_kernel=kernel)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w_), rtol=0, atol=1e-6)
    imgs, dpts, masks = got
    assert masks.mean() > 0.5 and np.isfinite(dpts).all()  # the NaN points culled
    assert np.all(imgs[masks == 0] == 0) and np.all(dpts[masks == 0] == 0)
    if point_size == 1:  # nothing covers the parked pixels
        assert not masks[0, 2:4, 5:9].any()


def test_merge_pcs_downsample_keeps_half_of_the_joined_rows_once():
    g = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(1)
    old = [(_t(rng.standard_normal((101, 3))), _t(rng.uniform(size=(101, 3)))) for _ in range(2)]
    new = [(_t(rng.standard_normal((60, 3))), _t(rng.uniform(size=(60, 3)))) for _ in range(2)]
    merged = cons.merge_pcs_downsample(old, new, g)
    for (p, c), (op, oc), (np_, nc) in zip(merged, old, new):
        assert p.shape == c.shape == ((101 + 60) // 2, 3)
        joined = torch.cat([torch.cat([op, np_]), torch.cat([oc, nc])], 1).numpy()
        rows = torch.cat([p, c], 1).numpy()
        idx = [np.flatnonzero((joined == r).all(1)) for r in rows]
        assert all(len(i) == 1 for i in idx)  # each a row of the joined cloud
        assert len({int(i[0]) for i in idx}) == len(rows)  # none twice


def metric_head(params, port, gain=2000.0, bias=3000.0):
    """The tiny VDA's last convolution scaled by ``gain`` with ``bias``, in
    both packages: inverse depths near 1,000-5,000 that vary enough for the
    closed-form fit to be well posed (about a constant, its determinant is
    lost to cancellation in fp32, and either package may take the singular
    fallback)."""
    conv = params["head"]["head_conv3"]
    conv["kernel"] = np.asarray(conv["kernel"]) * np.float32(gain)
    conv["bias"] = np.full((1,), bias, np.float32)
    with torch.no_grad():
        last = port.head.scratch.output_conv2[2]
        last.weight.mul_(gain)
        last.bias.fill_(bias)
    return params, port


def test_estimate_depth_with_prompt_alignment_matches_jax():
    jm, params, port = tiny_pair(seed=20)
    params, port = metric_head(params, port)
    rng = np.random.default_rng(21)
    f, h, w = 2, 60, 62
    frames = rng.uniform(size=(f, h, w, 3)).astype(np.float32)
    sparse = rng.uniform(2.0, 4.0, (f, h, w)).astype(np.float32)
    mask = np.zeros((f, h, w), np.float32)
    mask[:, ::3, ::2] = 1.0
    sparse *= mask
    K = np.asarray([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1.0]], np.float32)
    ext = np.tile(np.eye(4, dtype=np.float32)[None], (f, 1, 1))
    want = jax_cons.estimate_depth_with_prompt_alignment(
        frames, sparse, mask, K, ext, jax_da.DepthAlignmentTrainer(jm, params), epochs=3)
    got = cons.estimate_depth_with_prompt_alignment(
        frames, sparse, mask, K, ext, da.DepthAlignmentTrainer(port), epochs=3)
    assert got.shape == (f, h, w) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=1e-4 * np.abs(want).max())


def _stub(pkg, cfg, depth_infer=None):
    """A bundle with the plane depth, a fixed caption and no diffusion."""
    if pkg == "jax":
        return jax_orchestrator.ModelBundle(
            pipeline=None, depth_infer=depth_infer or jax_orchestrator._plane_depth_infer,
            encode_prompt=None, get_caption=lambda frame: "a scene")
    pipeline = types.SimpleNamespace(device=torch.device("cpu"), timer=StageTimer("cpu"))
    return orchestrator.ModelBundle(pipeline=pipeline, depth_infer=orchestrator._plane_depth_infer,
                                    encode_prompt=None, get_caption=lambda frame: "a scene")


def test_segment_depth_through_the_vda_matches_jax(tmp_path):
    jm, params, port = tiny_pair(seed=22)
    argv = _argv(tmp_path, "gradual")
    jtc = jax_cons.TrajCrafterConsistentDepth(
        jax_cli.config_from_args(jax_cli.get_parser().parse_args(argv)),
        models=_stub("jax", None), vda=(jm, params))
    cfg = cli.parse_config(argv)
    tc = cons.TrajCrafterConsistentDepth(cfg, models=_stub("port", cfg), vda=port)
    frames = np.random.default_rng(23).uniform(size=(5, 30, 44, 3)).astype(np.float32)
    want = jtc._segment_depth(frames)
    got = tc._segment_depth(frames)
    assert got.shape == (5, 30, 44) and (got >= 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def _gen(cfg):
    hs, ws = cfg.diffusion.sample_size
    return np.random.default_rng(7).uniform(0, 1, (cfg.video_length, hs, ws, 3)).astype(
        np.float32)


def _shared_downsample(module, monkeypatch):
    """``downsample_pointcloud`` of ``module`` drawing numpy's rows: the k-th
    call of either package takes the rows of ``default_rng(k)``."""
    calls = []

    def draw(points, colors, n, _key_or_generator):
        idx = np.random.default_rng(len(calls)).choice(points.shape[0], n, replace=False)
        calls.append(n)
        if isinstance(points, torch.Tensor):
            idx = torch.from_numpy(idx)
        return points[idx], colors[idx]

    monkeypatch.setattr(module, "downsample_pointcloud", draw)
    return calls


def _run(pkg, tmp_path, monkeypatch, vda):
    argv = _argv(tmp_path, "gradual")
    if pkg == "jax":
        cfg = jax_cli.config_from_args(jax_cli.get_parser().parse_args(argv))
        module = jax_cons
    else:
        cfg = cli.parse_config(argv)
        module = cons
    cfg.warp_size = (48, 80)
    # intrinsics of the warp size (the defaults are 576x1024's)
    cfg.render.focal, cfg.render.cx, cfg.render.cy = 60.0, 40.0, 24.0
    tc = module.TrajCrafterConsistentDepth(cfg, models=_stub(pkg, cfg), vda=vda, align_epochs=2)
    draws = _shared_downsample(module, monkeypatch)
    calls = []

    def recorded_diffuse(frames, cond_video, cond_masks, prompt, ref_slice=slice(0, None),
                         save_skip=0):
        calls.append(dict(frames=np.asarray(frames), cond=np.asarray(cond_video),
                          masks=np.asarray(cond_masks), prompt=prompt, ref_slice=ref_slice,
                          save_dir=cfg.save_dir))
        return _gen(cfg)

    tc._diffuse_and_save = recorded_diffuse
    out = tc.infer_autoregressive(n_splits=2, theta=20.0, phi=-5.0)
    assert out.shape == (18, 32, 48, 3)
    assert draws == [2 * 48 * 80 // 2] * 9  # each frame's joined cloud halved
    return calls, cfg


def _hold_render(got, want):
    """(render, mask) of a stage within the warp's bounds, the opened masks'
    disagreement to ``MASK_OPEN_DISAGREE_MAX``."""
    disagree = np.mean(got["masks"] != want["masks"])
    assert disagree <= MASK_OPEN_DISAGREE_MAX, disagree
    both = (got["masks"] > 0) & (want["masks"] > 0)
    assert both.mean() > 0.2
    off = np.abs(got["cond"] - want["cond"]).max(-1) > VALUE_ATOL
    assert off[both].mean() <= KNIFE_EDGE_MAX, off[both].mean()


@pytest.mark.parametrize("with_vda", [False, True], ids=["depthcrafter", "vda"])
def test_infer_autoregressive_matches_jax(tmp_path, monkeypatch, with_vda):
    jvda = pvda = None
    if with_vda:
        jm, params, pvda = tiny_pair(seed=24)
        params, pvda = metric_head(params, pvda)
        jvda = (jm, params)
    want, jcfg = _run("jax", tmp_path / "jax", monkeypatch, jvda)
    got, cfg = _run("port", tmp_path / "port", monkeypatch, pvda)
    assert len(got) == len(want) == 2
    for stage, (g, w_) in enumerate(zip(got, want)):
        assert (g["prompt"], g["ref_slice"]) == (w_["prompt"], w_["ref_slice"])
        assert Path(g["save_dir"]).name == f"stage_{stage:02d}"
        assert g["cond"].shape == (9, 48, 80, 3) and g["masks"].shape == (9, 48, 80)
        np.testing.assert_array_equal(g["frames"], w_["frames"])
        _hold_render(g, w_)
        for name in ("c2ws_target", "c2ws_source"):
            np.testing.assert_allclose(
                np.load(Path(cfg.save_dir) / f"stage_{stage:02d}/{name}.npy"),
                np.load(Path(jcfg.save_dir) / f"stage_{stage:02d}/{name}.npy"),
                rtol=0, atol=POSE_ATOL)
    # the second stage's source is the first generated segment at warp size
    assert not np.array_equal(got[1]["frames"], got[0]["frames"])


def _tiny_vda(seed=0, encoder=None):
    if encoder is None:
        return metric_head(*tiny_pair(seed)[1:])[1]
    torch.manual_seed(seed)
    model = VideoDepthAnything(vda_config(encoder)).eval()
    with torch.no_grad():  # torch's initialisation: the output varies by ~0.015
        last = model.head.scratch.output_conv2[2]
        last.weight.mul_(4e4)
        last.bias.fill_(3000.0)
    return model


def test_tiny_stack_runs_end_to_end_with_a_vda(tmp_path):
    cfg = cli.parse_config(_argv(tmp_path, "gradual"))
    cfg.warp_size = (48, 80)
    tc = cons.TrajCrafterConsistentDepth(cfg, models=orchestrator.build_dev_models(cfg, "cpu"),
                                         vda=_tiny_vda(), align_epochs=2)
    out = tc.infer_autoregressive(n_splits=2, theta=20.0)
    assert out.shape == (18, 32, 48, 3) and np.isfinite(out).all()
    assert 0.0 <= out.min() and out.max() <= 1.0
    assert len(tc.trainer.last_losses) == 2 and tc.trainer.last_prompt.abs().max() > 0
    for stage in range(2):
        d = Path(cfg.save_dir) / f"stage_{stage:02d}"
        for name in ("input", "render", "mask", "gen", "viz"):
            assert (d / f"{name}.mp4").stat().st_size > 0
        assert np.load(d / "c2ws_target.npy").shape == (9, 4, 4)
    assert {"depth", "relift", "align", "render", "denoise"} <= set(tc.timer.seconds)


@pytest.fixture
def on_tree(tree, monkeypatch):  # noqa: F811
    """The script builds the tree's models on the CPU at warp size 64 x 128."""
    _tiny(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(orchestrator, "build_models",
                        functools.partial(orchestrator.build_models, device="cpu"))
    parse = inference_alignment.config_from_args

    def at_warp_size(args):
        cfg = parse(args)
        cfg.warp_size = (64, 128)
        return cfg

    monkeypatch.setattr(inference_alignment, "config_from_args", at_warp_size)
    return tree


def _script_argv(tree, out, *extra):
    return ["--video_path", str(REPO / "test/videos/synth.mp4"), "--prompt", "a scene",
            "--diffusion_inference_steps", "2", "--video_length", "9",
            "--sample_size", "32", "48", "--depth_inference_steps", "2",
            "--model_name", str(tree / "CogVideoX-Fun"),
            "--transformer_path", str(tree / "TrajectoryCrafter"),
            "--unet_path", str(tree / "DepthCrafter"), "--pre_train_path", str(tree / "svd"),
            "--out_dir", str(out), "--exp_name", "run", "--n_splits", "2",
            "--total_theta", "20", "--align_epochs", "2", *extra]


def test_script_writes_the_joined_video_with_a_vda_checkpoint(on_tree, tmp_path):
    ckpt = tmp_path / "video_depth_anything_vits.pth"
    torch.save(checkpoints.vda_official_state_dict(_tiny_vda(encoder="vits").state_dict()), ckpt)
    out = inference_alignment.main(_script_argv(on_tree, tmp_path, "--vda_ckpt", str(ckpt),
                                                "--vda_encoder", "vits"))
    assert out.shape == (18, 32, 48, 3) and np.isfinite(out).all()
    run = tmp_path / "run"
    assert (run / "autoregressive_aligned.mp4").stat().st_size > 0
    for stage in range(2):
        assert (run / f"stage_{stage:02d}/gen.mp4").stat().st_size > 0


@pytest.mark.parametrize("damage,encoder,error", [
    ("missing_file", "vits", FileNotFoundError), ("other_depth", "vitl", ValueError),
    ("other_width", "vitb", RuntimeError)])
def test_script_refuses_a_vda_checkpoint_that_does_not_load(tmp_path, monkeypatch, damage,
                                                            encoder, error):
    """No fallback to DepthCrafter: the error stops the run before any model
    is built (a vits file read as vitl fails the key check, as vitb the
    shapes)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(orchestrator, "build_models", None)
    ckpt = tmp_path / "vda.pth"
    if damage != "missing_file":
        torch.save(checkpoints.vda_official_state_dict(_tiny_vda(encoder="vits").state_dict()), ckpt)
    argv = ["--video_path", str(REPO / "test/videos/synth.mp4"), "--out_dir", str(tmp_path),
            "--vda_ckpt", str(ckpt), "--vda_encoder", encoder]
    with pytest.raises(error):
        inference_alignment.main(argv)


def test_script_refuses_to_start_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(orchestrator, "build_models", None)
    with pytest.raises(SystemExit, match="no CUDA device"):
        inference_alignment.main(["--video_path", str(REPO / "test/videos/synth.mp4"),
                                  "--out_dir", str(tmp_path)])
