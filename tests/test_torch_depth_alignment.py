"""Consistent-depth alignment (trajectorycrafter_tpu_torch/depth_alignment.py)
vs the JAX package's (optax and ``jax.grad`` there, torch.optim and autograd
here).

* The closed-form ``compute_scale_and_shift`` (and its singular fallback),
  the SSI and frame-difference TAE losses, ``_bilinear_sample``,
  ``differentiable_tae`` and ``evaluate_tae``: 1e-5 relative.
* ``align_window`` after 10 Adam steps, and the windowed
  ``estimate_depth_with_alignment`` at 10 steps a window: 1e-5 of the
  depth's magnitude.  The L1 data term's gradient flips where a residual
  crosses zero, and Adam's normalised steps carry a flip on: once the fit
  nears its target (tens of steps here) the two packages' iterates part by
  1e-4-1e-3, so the default 200 steps are held to what they reach instead
  (the scale and shift recovered, as the JAX package's own test holds it);
  its last loss, a sum of L1 terms that partly cancel, to 1e-4.
* The trainer's loss and its gradient with respect to the prompt at one
  step, through a tiny Video-Depth-Anything and the closed-form fit, against
  ``jax.grad``: 1e-4 of the gradient's magnitude.
* ``DepthAlignmentTrainer`` over 3 epochs in VP and FT modes: the loss of
  every epoch (1e-4 relative), the corrected depth and, in VP mode, the
  prompt.  AdamW moves each prompt value by about lr a step whatever its
  gradient's size (its update is m / sqrt(v)), so a value whose gradient
  sits within float noise of zero can step the other way: the prompt is held
  to 2e-3 lr on 90% of its values, 2e-2 lr on 99% and 2 lr on all (3
  epochs: 8e-4, 6e-3 and 1.8 lr measured); the depth to 1e-4 of its
  magnitude.
* ``align_video_to_pointcloud`` on a cloud lifted from the same cameras
  (every point lands on a pixel centre): the aligned depth and the new
  cloud, 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_vda import tiny_pair

from trajectorycrafter_tpu import depth_alignment as jax_da
from trajectorycrafter_tpu_torch import depth_alignment as da

torch.set_num_threads(1)
REL = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


def test_compute_scale_and_shift_matches_jax():
    rng = np.random.default_rng(0)
    pred = rng.uniform(0.5, 3.0, (3, 6, 7)).astype(np.float32)
    target = (pred * rng.uniform(0.5, 2.0, (3, 1, 1)) - 0.25
              + 0.01 * rng.standard_normal(pred.shape)).astype(np.float32)
    mask = (rng.uniform(size=pred.shape) > 0.3).astype(np.float32)
    mask[2] = 0.0  # singular: the identity
    s, t = da.compute_scale_and_shift(_t(pred), _t(target), _t(mask))
    js, jt = jax_da.compute_scale_and_shift(jnp.asarray(pred), jnp.asarray(target),
                                            jnp.asarray(mask))
    # each a difference of products of masked sums over the determinant: held
    # to 1e-5 of its terms' size
    p, g, m = (x.astype(np.float64).reshape(3, -1) for x in (pred, target, mask))
    a00, a01, a11 = (m * p * p).sum(1), (m * p).sum(1), m.sum(1)
    b0, b1 = (m * p * g).sum(1), (m * g).sum(1)
    det = np.where(m.any(1), a00 * a11 - a01 * a01, 1.0)
    for got, want, terms in ((s, js, np.abs(a11 * b0) + np.abs(a01 * b1)),
                             (t, jt, np.abs(a01 * b0) + np.abs(a00 * b1))):
        assert np.all(np.abs(got.numpy() - np.asarray(want)) <= REL * terms / det)
    assert (s[2].item(), t[2].item()) == (1.0, 0.0)


def test_losses_match_jax():
    rng = np.random.default_rng(1)
    pred = rng.uniform(0.5, 4.0, (4, 9, 11)).astype(np.float32)
    target = rng.uniform(0.5, 4.0, (4, 9, 11)).astype(np.float32)
    mask = (rng.uniform(size=pred.shape) > 0.4).astype(np.float32)
    _close(da.scale_shift_invariant_loss(_t(pred), _t(target), _t(mask)),
           jax_da.scale_shift_invariant_loss(jnp.asarray(pred), jnp.asarray(target),
                                             jnp.asarray(mask)))
    _close(da.temporal_alignment_error(_t(pred)), jax_da.temporal_alignment_error(pred))
    u = rng.uniform(-2, 13, (9, 11)).astype(np.float32)
    v = rng.uniform(-2, 11, (9, 11)).astype(np.float32)
    _close(da._bilinear_sample(_t(pred[0]), _t(u), _t(v)),
           jax_da._bilinear_sample(jnp.asarray(pred[0]), jnp.asarray(u), jnp.asarray(v)))


def _cameras(f, moving=True):
    ext = np.tile(np.eye(4, dtype=np.float32)[None], (f, 1, 1))
    if moving:
        ext[:, 0, 3] = np.arange(f) * 0.05
        ext[:, 2, 3] = -np.arange(f) * 0.03
    return np.asarray([[20.0, 0, 11.0], [0, 21.0, 8.5], [0, 0, 1]], np.float32), ext


def test_differentiable_tae_and_evaluate_tae_match_jax():
    rng = np.random.default_rng(2)
    depth = rng.uniform(1.5, 3.0, (4, 16, 22)).astype(np.float32)
    depth[1, :3] = 0.0  # outside the validity window
    K, ext = _cameras(4)
    got = da.differentiable_tae(_t(depth), _t(K), _t(ext))
    _close(got, jax_da.differentiable_tae(jnp.asarray(depth), jnp.asarray(K), jnp.asarray(ext)))
    assert got.item() > 0.1
    assert abs(da.evaluate_tae(_t(depth), _t(K), _t(ext))
               - jax_da.evaluate_tae(jnp.asarray(depth), jnp.asarray(K), jnp.asarray(ext))) \
        <= REL * got.item()
    K, ext = _cameras(3, moving=False)
    assert da.evaluate_tae(torch.full((3, 8, 8), 1.5), _t(K), _t(ext)) < 1e-5


@pytest.mark.parametrize("ssi", [0.0, 0.5])
def test_align_window_matches_jax(ssi):
    rng = np.random.default_rng(3)
    depth = rng.uniform(1, 5, (5, 10, 12)).astype(np.float32)
    ref = (1.7 * depth + 0.4 + 0.05 * rng.standard_normal(depth.shape)).astype(np.float32)
    mask = (rng.uniform(size=depth.shape) > 0.25).astype(np.float32)
    got, loss = da.align_window(_t(depth), _t(ref), _t(mask), steps=10, lr=0.05,
                                tae_weight=0.1, ssi_weight=ssi)
    want, jloss = jax_da.align_window(jnp.asarray(depth), jnp.asarray(ref), jnp.asarray(mask),
                                      steps=10, lr=0.05, tae_weight=0.1, ssi_weight=ssi)
    _close(got, want)
    _close(loss, jloss, rel=1e-4)  # a sum of L1 terms that partly cancel


def test_align_window_recovers_scale_and_shift_when_run_long():
    """As the JAX package's test: ref = 1.7 depth + 0.4, 600 steps."""
    rng = np.random.default_rng(13)
    depth = rng.uniform(1, 5, (4, 12, 16)).astype(np.float32)
    ref = 1.7 * depth + 0.4
    got, _ = da.align_window(_t(depth), _t(ref), torch.ones(depth.shape), steps=600, lr=0.1,
                             tae_weight=0.0)
    assert np.abs(got.numpy() - ref).mean() < 0.05


def test_estimate_depth_with_alignment_matches_jax():
    rng = np.random.default_rng(4)
    depth = rng.uniform(1, 4, (20, 8, 8)).astype(np.float32)
    ref = (1.5 * depth + 0.2).astype(np.float32)
    mask = (rng.uniform(size=depth.shape) > 0.2).astype(np.float32)
    got = da.estimate_depth_with_alignment(depth, ref, mask, infer_len=8, overlap=3, steps=10)
    want = jax_da.estimate_depth_with_alignment(depth, ref, mask, infer_len=8, overlap=3,
                                                steps=10)
    _close(got, want)


def _trainer_inputs(seed=5, f=2, hw=(28, 28)):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((f, *hw, 3)).astype(np.float32)
    target = rng.uniform(0.5, 1.5, (f, *hw)).astype(np.float32)
    mask = rng.uniform(size=(f, *hw)) > 0.3
    return frames, target, mask


def test_trainer_loss_gradient_matches_jax_grad():
    jm, params, port = tiny_pair(seed=6)
    frames, target, mask = _trainer_inputs()
    prompt = 0.01 * np.random.default_rng(7).standard_normal(frames.shape).astype(np.float32)
    jt = jax_da.DepthAlignmentTrainer(jm, params)

    def jax_loss(p):
        d = jm.apply({"params": params}, (jnp.asarray(frames) + p)[None])[0]
        s, t = jax_da.compute_scale_and_shift(d.reshape(1, -1), jnp.asarray(target).reshape(1, -1),
                                              jnp.asarray(mask).reshape(1, -1))
        return jt._loss(d * s[0] + t[0], jnp.asarray(target), jnp.asarray(mask), None, None,
                        False)

    want_loss, want_grad = jax.jit(jax.value_and_grad(jax_loss))(jnp.asarray(prompt))
    trainer = da.DepthAlignmentTrainer(port)
    p = _t(prompt).permute(0, 3, 1, 2).requires_grad_(True)
    d, _, _ = trainer.predict(port, p, _t(frames).permute(0, 3, 1, 2), _t(target),
                              torch.from_numpy(mask))
    loss = trainer.loss(d, _t(target), torch.from_numpy(mask))
    loss.backward()
    _close(loss.detach(), want_loss, rel=1e-5)
    _close(p.grad.permute(0, 2, 3, 1), want_grad, rel=1e-4)
    assert np.abs(np.asarray(want_grad)).max() > 0


@pytest.mark.parametrize("mode", ["VP", "FT"])
def test_trainer_epochs_match_jax(mode):
    jm, params, port = tiny_pair(seed=8)
    frames, target, mask = _trainer_inputs(seed=9)
    lr = 2e-3
    jt = jax_da.DepthAlignmentTrainer(jm, params, lr=lr, mode=mode)
    jd, jprompt, js, jsh = jt.train(jnp.asarray(frames), jnp.asarray(target), jnp.asarray(mask),
                                    epochs=3)
    trainer = da.DepthAlignmentTrainer(port, lr=lr, mode=mode)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    d, prompt, s, sh = trainer.train(_t(frames).permute(0, 3, 1, 2), _t(target),
                                     torch.from_numpy(mask), epochs=3)
    assert trainer.last_losses.shape == (3,) and len(trainer.epoch_seconds) == 3
    _close(trainer.last_losses, jt._last_losses, rel=1e-4)
    assert trainer.last_losses[-1] != trainer.last_losses[0]
    _close(d.detach(), jd, rel=1e-4)
    assert abs(s - js) <= 1e-3 * abs(js) and abs(sh - jsh) <= 1e-3 * max(abs(jsh), 1.0)
    prompt = prompt.permute(0, 2, 3, 1).numpy()
    jprompt = np.asarray(jprompt)
    if mode == "VP":
        assert np.abs(jprompt).max() > 0
        diff = np.abs(prompt - jprompt)
        assert np.quantile(diff, 0.9) <= 2e-3 * lr and np.quantile(diff, 0.99) <= 2e-2 * lr
        assert diff.max() <= 2 * lr
    else:
        assert not prompt.any() and not jprompt.any()
    for key, t in port.state_dict().items():  # the model is never changed
        torch.testing.assert_close(t, before[key], rtol=0, atol=0)


def test_trainer_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        da.DepthAlignmentTrainer(tiny_pair()[2], mode="LoRA")


def test_align_video_to_pointcloud_matches_jax():
    """The cloud is lifted from the cameras it is rendered into with the
    principal point moved by a quarter pixel, so every point lands a quarter
    pixel off a pixel centre (the first row and column off the frame): no
    rounding or frame edge is near, and the renders agree exactly."""
    from trajectorycrafter_tpu.geometry.pointcloud import lift_video_to_pointcloud as jax_lift
    from trajectorycrafter_tpu_torch.geometry.pointcloud import lift_video_to_pointcloud

    rng = np.random.default_rng(10)
    f, h, w = 3, 12, 16
    frames = rng.uniform(size=(f, h, w, 3)).astype(np.float32)
    true = rng.uniform(2.0, 3.0, (f, h, w)).astype(np.float32)
    K = np.tile(np.asarray([[14.0, 0, 8.0], [0, 14.0, 6.0], [0, 0, 1]], np.float32), (f, 1, 1))
    c2ws = np.tile(np.eye(4, dtype=np.float32)[None], (f, 1, 1))
    k_lift = K.copy()
    k_lift[:, :2, 2] += 0.25
    pts, cols = lift_video_to_pointcloud(_t(frames), _t(true), _t(k_lift), _t(c2ws))
    jpts, jcols = jax_lift(jnp.asarray(frames), jnp.asarray(true), jnp.asarray(k_lift),
                           jnp.asarray(c2ws))
    est = (true / 1.3 + 0.1).astype(np.float32)
    aligned, (new_pts, new_cols) = da.align_video_to_pointcloud(
        _t(frames), est, _t(K), _t(c2ws), pts, cols, steps=10)
    jaligned, (jnew_pts, jnew_cols) = jax_da.align_video_to_pointcloud(
        frames, est, K, c2ws, jpts, jcols, steps=10)
    _close(aligned, jaligned)
    _close(new_pts, jnew_pts)
    np.testing.assert_array_equal(new_cols.numpy(), np.asarray(jnew_cols))
