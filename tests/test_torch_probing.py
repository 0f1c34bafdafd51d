"""Port DiT feature probing (trajectorycrafter_tpu_torch/probing.py,
scripts/probe_depth.py, ops/resize.py ``resize_linear_jax``) vs the JAX
package's probing.py and the root probe_depth.py, on the CPU.

A tiny DiT (4 layers, 2 heads of 8, two Perceivers) gets the same seeded
weights on both sides (``jax_tree`` -> ``dit_from_jax``); flax probes are
carried across by ``probe_from_jax``.  Nothing drawn from a JAX key can be
replayed in torch: the collection's noise is the same numpy draw on both
sides (``jax.random.normal`` patched for the test's length in the JAX module,
``probing.draw_noise`` in the port), and the port's probe init is patched to
load the flax init of ``PRNGKey(0)``.

Tolerances:
  * ``resize_linear_jax``: 1e-6 absolute on values in [0, 1) (fp32; the two
    sum each output's few products in another order);
  * captured features at fp32 (JAX ``attention_impl="xla"``, the port's plain
    version): 1e-5 of the largest magnitude (fp32 rounding through 4 blocks);
  * probe forwards: 1e-5 of the largest magnitude; ten Adam steps: the
    losses within 1e-4 relatively, the weights within 1e-5 absolutely (optax
    takes Adam's bias corrections in fp32, torch in double);
  * the camera-motion filter and ``relative_depth_error``: equal (the same
    numpy arithmetic);
  * the entry points on a bf16 tree: features within 2^-5 of the largest
    magnitude, the first probe loss within 2^-5 relatively (bf16 rounding,
    XLA's against torch's, carried through 4 blocks).
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from safetensors.torch import save_file
from torch_parity import fill_from_numpy_, jax_tree

import trajectorycrafter_tpu.probing as jprobing
from trajectorycrafter_tpu.models.dit import CrossTransformer3DModel as JaxDiT
from trajectorycrafter_tpu.schedulers import CogVideoXDDIMScheduler as JaxDDIM
from trajectorycrafter_tpu.training.data import save_latent_sample
from trajectorycrafter_tpu.utils.convert import convert_dit
from trajectorycrafter_tpu_torch import probing as tprobing
from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel
from trajectorycrafter_tpu_torch.ops.resize import resize_linear_jax
from trajectorycrafter_tpu_torch.schedulers import CogVideoXDDIMScheduler
from trajectorycrafter_tpu_torch.utils.weights import dit_from_jax, probe_from_jax

torch.set_num_threads(1)
F, H, W, C = 2, 4, 4, 4
TEXT = (3, 8)
TINY = dict(num_attention_heads=2, attention_head_dim=8, in_channels=2 * C + 1,
            out_channels=C, time_embed_dim=16, text_embed_dim=TEXT[1], num_layers=4,
            max_text_seq_length=TEXT[0], cross_attn_dim_head=8, cross_attn_num_heads=2,
            use_rotary_positional_embeddings=True)
BLOCKS = [1, 3]
RESIZE_ATOL = 1e-6
FEATURE_REL = 1e-5
PROBE_REL = 1e-5
LOSS_RTOL, WEIGHT_ATOL = 1e-4, 1e-5
BF16_REL = 2.0 ** -5


def _rel_max(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def dit():
    params = jax_tree(CrossTransformer3DModel(**TINY), 0, convert_dit,
                      num_layers=TINY["num_layers"])
    port = CrossTransformer3DModel(**TINY)
    port.load_state_dict(dit_from_jax(params), strict=True)
    return dict(params=params, jax=JaxDiT(**TINY, attention_impl="xla"), port=port.eval())


def _inputs(rng):
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((1, F, H, W, C), (1, *TEXT), (1,), (1, F, H, W, C + 1), (1, 1, H, W, C))]


# ----------------------------------------------------------------------------
# resize
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [
    ((49, 96, 168), (13, 24, 42)),  # every axis shrinks, the frame axis too
    ((13, 48, 84), (13, 24, 42)),
    ((5, 7, 9), (11, 13, 17)),  # every axis grows
    ((6, 8, 10), (6, 8, 10)),  # identity
    ((7, 12, 20), (3, 30, 5)),  # mixed
])
def test_resize_linear_jax_matches_jax(src, dst):
    x = np.random.default_rng(0).uniform(0, 1, src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst, "linear"))
    got = resize_linear_jax(torch.from_numpy(x), dst).numpy()
    assert got.shape == want.shape == dst
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


# ----------------------------------------------------------------------------
# features and probes
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("cross", [True, False], ids=["perceiver", "no_cross_latents"])
def test_collect_features_matches_jax(dit, cross):
    args = _inputs(np.random.default_rng(1))
    args[2] = np.array([311.0], np.float32)
    if not cross:
        args = args[:4]
    want = jprobing.collect_features(dit["jax"], dit["params"], BLOCKS,
                                     *map(jnp.asarray, args))
    got = tprobing.collect_features(dit["port"], BLOCKS, *map(torch.from_numpy, args))
    assert list(got) == list(want) == [f"transformer_block_{i}" for i in BLOCKS]
    for key in want:
        w = np.asarray(want[key])
        assert got[key].shape == w.shape == (1, F * (H // 2) * (W // 2), 16)
        assert _rel_max(got[key].numpy(), w) <= FEATURE_REL, key
    # the capture precedes the Perceiver residual: with and without the
    # reference latents block 0's output is the same, block 1's is not
    if cross:
        no_ref = tprobing.collect_features(dit["port"], [0, 1],
                                           *map(torch.from_numpy, args[:4]))
        with_ref = tprobing.collect_features(dit["port"], [0, 1],
                                             *map(torch.from_numpy, args))
        assert torch.equal(no_ref["transformer_block_0"], with_ref["transformer_block_0"])
        assert not torch.equal(no_ref["transformer_block_1"], with_ref["transformer_block_1"])


def _probes(kind, hidden=16):
    jcls, tcls = {"conv": (jprobing.ConvProbe, tprobing.ConvProbe),
                  "mlp": (jprobing.MLPProbe, tprobing.MLPProbe)}[kind]
    return jcls(frames=3, height=4, width=6, hidden=hidden), tcls(3, 4, 6, hidden=hidden)


def _tokens(rng, n=2, d=12):
    return rng.standard_normal((n, 3 * 4 * 6, d)).astype(np.float32)


@pytest.mark.parametrize("kind", ["conv", "mlp"])
def test_probe_forward_matches_jax(kind):
    jprobe, tprobe = _probes(kind)
    tokens = _tokens(np.random.default_rng(2))
    params = jprobe.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]
    tprobe.load_state_dict(probe_from_jax(params), strict=True)
    want = np.asarray(jprobe.apply({"params": params}, jnp.asarray(tokens)))
    got = tprobe(torch.from_numpy(tokens)).detach().numpy()
    assert got.shape == want.shape == (2, 3, 4, 6)
    assert _rel_max(got, want) <= PROBE_REL


def _load_flax_init(monkeypatch, jprobe, tokens):
    """Patch the port's probe init to load the flax init of PRNGKey(0)."""
    params = jprobe.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]
    monkeypatch.setattr(tprobing, "init_probe_", lambda probe, generator:
                        probe.load_state_dict(probe_from_jax(params), strict=True))


@pytest.mark.parametrize("kind", ["conv", "mlp"])
def test_ten_trainer_steps_match_optax(kind, monkeypatch):
    rng = np.random.default_rng(3)
    jprobe, tprobe = _probes(kind)
    tokens, target = _tokens(rng), rng.uniform(1, 5, (2, 3, 4, 6)).astype(np.float32)
    _load_flax_init(monkeypatch, jprobe, tokens)
    jinit, jstep = jprobing.make_probe_trainer(jprobe, lr=1e-2)
    tinit, tstep = tprobing.make_probe_trainer(tprobe, lr=1e-2)
    jstate = jinit(jax.random.PRNGKey(0), jnp.asarray(tokens))
    tstate = tinit(torch.Generator().manual_seed(0), torch.from_numpy(tokens))
    jl, tl = [], []
    for _ in range(10):
        jstate, loss = jstep(jstate, jnp.asarray(tokens), jnp.asarray(target))
        jl.append(float(loss))
        tstate, loss = tstep(tstate, torch.from_numpy(tokens), torch.from_numpy(target))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0]
    want = probe_from_jax(jax.device_get(jstate.params))
    for key, value in tstate.params.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=0, atol=WEIGHT_ATOL,
                                   err_msg=key)


def test_init_draws_flax_default_statistics():
    _, tprobe = _probes("conv", hidden=64)
    init_fn, _ = tprobing.make_probe_trainer(tprobe)
    init_fn(torch.Generator().manual_seed(0), torch.zeros(1, 72, 256))
    w = tprobe.conv1.weight.detach()
    std = (1.0 / 256) ** 0.5
    assert w.shape == (64, 256, 1, 1) and abs(w.std().item() / std - 1) < 0.05
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978
    assert all(not b.any() for n, b in tprobe.named_parameters() if n.endswith("bias"))


# ----------------------------------------------------------------------------
# the camera-motion filter and the metric
# ----------------------------------------------------------------------------


def _poses(rng, n, t_step, r_step):
    """n c2w poses: each step a random direction of length ~t_step and a
    rotation of ~r_step radians about a random axis."""
    poses = [np.eye(4)]
    for _ in range(n - 1):
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        a = r_step * rng.uniform(0.5, 1.5)
        k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        rot = np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * k @ k
        m = poses[-1].copy()
        m[:3, :3] = rot @ m[:3, :3]
        m[:3, 3] += t_step * rng.uniform(0.5, 1.5) * rng.standard_normal(3) / np.sqrt(3)
        poses.append(m)
    return np.stack(poses).astype(np.float32)


def _same_verdict(poses, **thresholds):
    j = jprobing.CameraMotionFilter(**thresholds)
    t = tprobing.CameraMotionFilter(**thresholds)
    assert t.compute_motion_metrics(poses) == j.compute_motion_metrics(poses)
    verdict = t.is_low_motion(poses)
    assert verdict == j.is_low_motion(poses)
    return verdict[0]


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31), n=st.integers(2, 12), t_step=st.floats(0.0, 20.0),
       r_step=st.floats(0.0, 0.2))
def test_camera_motion_filter_matches_jax(seed, n, t_step, r_step):
    _same_verdict(_poses(np.random.default_rng(seed), n, t_step, r_step))


@pytest.mark.parametrize("t_step,r_step,kept", [(0.0, 0.0, False),  # static
                                                (3.0, 0.2, False),  # too much rotation
                                                (60.0, 0.01, False),  # too far
                                                (3.0, 0.02, True)])
def test_camera_motion_filter_gates_as_jax(t_step, r_step, kept):
    poses = _poses(np.random.default_rng(4), 8, t_step, r_step)
    assert _same_verdict(poses) is kept
    with pytest.raises(ValueError, match="n_frames, 4, 4"):
        tprobing.CameraMotionFilter().compute_motion_metrics(poses[:, :3])


@pytest.mark.parametrize("with_zeros", [False, True])
def test_relative_depth_error_matches_jax(with_zeros):
    rng = np.random.default_rng(5)
    target = rng.uniform(-2, 5, (2, 3, 4, 6)).astype(np.float32)
    if with_zeros:
        target[0, 0, :2] = 0.0
    pred = target + 0.1 * rng.standard_normal(target.shape).astype(np.float32)
    assert tprobing.relative_depth_error(pred, target) == \
        jprobing.relative_depth_error(pred, target)


# ----------------------------------------------------------------------------
# the collection harness
# ----------------------------------------------------------------------------


def _samples(rng, n=3):
    """n samples with poses; the last moves too far and is skipped; the
    second carries no depth."""
    out = []
    for i in range(n):
        s = {"name": f"s{i}",
             "gt_latents": rng.standard_normal((F, H, W, C)).astype(np.float32),
             "prompt_embeds": rng.standard_normal(TEXT).astype(np.float32),
             "ref_latents": rng.standard_normal((1, H, W, C)).astype(np.float32),
             "inpaint_latents": rng.standard_normal((F, H, W, C + 1)).astype(np.float32),
             "poses": _poses(rng, 5, 0.5 if i < n - 1 else 50.0, 0.02)}
        if i != 1:
            s["depth"] = rng.uniform(1, 5, (F, H, W)).astype(np.float32)
        out.append(s)
    return out


def _patch_noise(monkeypatch, draws):
    """The same numpy noise, in order, for both packages' draws."""
    jax_draws, port_draws = iter(draws), iter(draws)
    monkeypatch.setattr(jprobing.jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(next(jax_draws)))
    monkeypatch.setattr(tprobing, "draw_noise",
                        lambda generator, shape, device: torch.from_numpy(next(port_draws)))


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*")) if p.is_file()}


def test_collect_activation_dataset_matches_jax(dit, tmp_path, monkeypatch):
    rng = np.random.default_rng(6)
    samples = _samples(rng)
    draws = [rng.standard_normal((1, F, H, W, C)).astype(np.float32) for _ in samples]
    _patch_noise(monkeypatch, draws)
    filt = dict(min_total_translation=0.5, max_total_translation=10.0)
    jsched, tsched = JaxDDIM(), CogVideoXDDIMScheduler()
    want = jprobing.collect_activation_dataset(
        dit["jax"], dit["params"], jsched, jsched.set_timesteps(50), samples, [100, 800],
        BLOCKS, str(tmp_path / "jax"), motion_filter=jprobing.CameraMotionFilter(**filt))
    got = tprobing.collect_activation_dataset(
        dit["port"], tsched, tsched.set_timesteps(50), samples, [100, 800], BLOCKS,
        str(tmp_path / "port"), motion_filter=tprobing.CameraMotionFilter(**filt))
    assert got == want and got["kept"] == ["s0", "s1"] and got["files"] == 8
    assert [s["name"] for s in got["skipped"]] == ["s2"]
    jtree, ttree = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert list(ttree) == list(jtree)
    assert json.loads(ttree["manifest.json"].read_text()) == \
        json.loads(jtree["manifest.json"].read_text())
    for rel, path in ttree.items():
        if rel.endswith(".npy"):
            a, b = np.load(path), np.load(jtree[rel])
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            if "features" in rel:
                assert _rel_max(a, b) <= FEATURE_REL, rel
            else:
                assert np.array_equal(a, b), rel
    # the noise differs per timestep's q(x_t | x_0): so do the features
    a = np.load(ttree["s0/features/timestep_100/transformer_block_1.npy"])
    b = np.load(ttree["s0/features/timestep_800/transformer_block_1.npy"])
    assert np.abs(a - b).max() > 1e-3


def _write_features(root, names, timesteps=(7,), blocks=(0,), depth=True, manifest=None):
    rng = np.random.default_rng(7)
    for name in names:
        for t in timesteps:
            d = root / name / "features" / f"timestep_{t}"
            d.mkdir(parents=True, exist_ok=True)
            for b in blocks:
                np.save(d / f"transformer_block_{b}.npy", rng.standard_normal((4, 3)))
        if depth:
            (root / name / "depths").mkdir(exist_ok=True)
            np.save(root / name / "depths" / "depths.npy", rng.standard_normal((2, 2)))
    if manifest is not None:
        (root / "manifest.json").write_text(json.dumps({"kept": manifest}))


@pytest.mark.parametrize("case", ["stale_dir_under_manifest", "missing_file", "glob",
                                  "no_depth", "nothing"])
def test_activation_dataset_matches_jax(tmp_path, case):
    setups = {
        "stale_dir_under_manifest": dict(names=["s0", "s1", "s2"], manifest=["s2", "s1"]),
        "missing_file": dict(names=["s0"], manifest=["s0", "s1"]),
        "glob": dict(names=["s1", "s0"]),
        "no_depth": dict(names=["s0", "s1"], depth=False),
        "nothing": dict(names=[]),
    }
    _write_features(tmp_path, **setups[case])
    if case in ("missing_file", "nothing"):
        for cls in (jprobing.ActivationDataset, tprobing.ActivationDataset):
            with pytest.raises(FileNotFoundError, match="timestep=7 block=0"):
                cls(str(tmp_path), 7, 0)
        return
    j = jprobing.ActivationDataset(str(tmp_path), 7, 0)
    t = tprobing.ActivationDataset(str(tmp_path), 7, 0)
    assert t.items == j.items and len(t) == len(j)
    assert len(t) == {"stale_dir_under_manifest": 2, "glob": 2, "no_depth": 2}[case]
    tokens, depths = t.stacked()
    jtokens, jdepths = j.stacked()
    assert np.array_equal(tokens, jtokens)
    assert (depths is None) == (jdepths is None) == (case == "no_depth")
    if depths is not None:
        assert np.array_equal(depths, jdepths)
    for i in range(len(t)):
        assert all(np.array_equal(x, y) if x is not None else y is None
                   for x, y in zip(t[i], j[i]))


# ----------------------------------------------------------------------------
# the entry points on one tree
# ----------------------------------------------------------------------------

TREE_DIT = dict(num_attention_heads=4, attention_head_dim=16, num_layers=4, in_channels=9,
                out_channels=4, time_embed_dim=32, text_embed_dim=32, max_text_seq_length=16,
                cross_attn_dim_head=16, cross_attn_num_heads=4, cross_attn_interval=2,
                use_rotary_positional_embeddings=True)


@pytest.fixture(scope="module")
def probe_tree(tmp_path_factory):
    """A tiny DiT as safetensors + config.json, and three .npz samples: the
    first with a depth of another size and poses that pass the filter."""
    root = tmp_path_factory.mktemp("probe")
    dit = fill_from_numpy_(CrossTransformer3DModel(**TREE_DIT), 8)
    (root / "dit").mkdir()
    save_file({k: v.contiguous() for k, v in dit.state_dict().items()},
              str(root / "dit" / "model.safetensors"))
    (root / "dit" / "config.json").write_text(json.dumps(TREE_DIT))
    rng = np.random.default_rng(9)
    (root / "data").mkdir()
    for i in range(3):
        extra = {}
        if i == 0:
            extra = dict(depth=rng.uniform(1, 5, (5, 12, 20)).astype(np.float32),
                         poses=_poses(rng, 6, 3.0, 0.03))
        save_latent_sample(
            str(root / "data" / f"s{i}.npz"),
            gt_latents=rng.standard_normal((F, H, W, 4)).astype(np.float32),
            ref_latents=rng.standard_normal((1, H, W, 4)).astype(np.float32),
            inpaint_latents=rng.standard_normal((F, H, W, 5)).astype(np.float32),
            prompt_embeds=rng.standard_normal((16, 32)).astype(np.float32), **extra)
    return root


def _recorded_trainer(monkeypatch, module, losses):
    make = module.make_probe_trainer

    def recorded(probe, lr=1e-3):
        init_fn, step_fn = make(probe, lr=lr)
        run = []
        losses.append(run)

        def step(state, tokens, target):
            state, loss = step_fn(state, tokens, target)
            run.append(float(loss))
            return state, loss

        return init_fn, step

    monkeypatch.setattr(module, "make_probe_trainer", recorded)


@pytest.mark.parametrize("path", ["direct", "collect"])
def test_probe_depth_matches_the_root_script(probe_tree, tmp_path, monkeypatch, capsys, path):
    import probe_depth

    from trajectorycrafter_tpu_torch.scripts import probe_depth as tprobe_depth

    assert len(tprobe_depth.get_parser()._actions) == 11 + 1  # and -h
    rng = np.random.default_rng(10)
    _patch_noise(monkeypatch, [rng.standard_normal((1, F, H, W, 4)).astype(np.float32)
                               for _ in range(3)])
    # the port's probes start from flax's init of PRNGKey(0)
    tokens = np.zeros((1, F * (H // 2) * (W // 2), 64), np.float32)
    _load_flax_init(monkeypatch, jprobing.ConvProbe(frames=F, height=H // 2, width=W // 2),
                    tokens)
    jlosses, tlosses = [], []
    _recorded_trainer(monkeypatch, jprobing, jlosses)
    _recorded_trainer(monkeypatch, tprobing, tlosses)
    argv = ["--data_dir", str(probe_tree / "data"), "--transformer_path",
            str(probe_tree / "dit"), "--steps", "3"]
    if path == "collect":
        argv += ["--timesteps", "311", "811", "--motion_filter"]
    tags = ([f"t{t}_block{b}" for t in (311, 811) for b in BLOCKS] if path == "collect"
            else [f"block{b}" for b in BLOCKS])
    outs = {}
    for side, main in (("jax", lambda a: probe_depth.main(a)),
                       ("port", lambda a: tprobe_depth.main(a, device="cpu"))):
        out = tmp_path / side
        extra = ["--output_dir", str(out / "probes")]
        if path == "collect":
            extra += ["--collect_dir", str(out / "features")]
        main(argv + extra)
        outs[side] = out
        printed = capsys.readouterr().out
        assert all(f"{tag}: relative depth error" in printed for tag in tags)
        if path == "collect":
            assert "collected 12 feature files; kept 3, skipped 0" in printed
    assert sorted(p.name for p in (outs["jax"] / "probes").iterdir()) == \
        [f"probe_{tag}" for tag in sorted(tags)]
    assert sorted(p.name for p in (outs["port"] / "probes").iterdir()) == \
        [f"probe_{tag}.safetensors" for tag in sorted(tags)]
    assert len(jlosses) == len(tlosses) == len(tags)
    for j, t in zip(jlosses, tlosses):
        assert len(j) == len(t) == 3 and np.isfinite(t).all()
        assert abs(t[0] - j[0]) <= BF16_REL * abs(j[0]), (t, j)
    if path == "collect":
        jtree, ttree = _tree(outs["jax"] / "features"), _tree(outs["port"] / "features")
        assert list(ttree) == list(jtree) and len(jtree) == 12 + 2 + 1  # + depths, poses
        assert json.loads(ttree["manifest.json"].read_text()) == \
            json.loads(jtree["manifest.json"].read_text())
        for rel in ttree:
            if "features" in rel:
                assert _rel_max(np.load(ttree[rel]), np.load(jtree[rel])) <= BF16_REL, rel
