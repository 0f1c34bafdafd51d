"""The global point cloud (trajectorycrafter_tpu_torch/geometry/pointcloud.py)
vs the JAX package's (trajectorycrafter_tpu/geometry/pointcloud.py).

* Lifting a frame and a clip: within 1e-5 of the JAX points (fp32 products
  in another order), the colours exactly.
* ``render_zbuffer`` at point sizes 1 and 3, on clouds that hold ties (the
  same point many times with other colours; a clip lifted from one camera
  over a plane, as the autoregressive v2 path lifts its 49 frames), points
  behind the camera and points outside the frame.  The projections differ
  from XLA's by ulps, so a point on a rounding boundary or a frame border
  can land one pixel off, as in the warp (tests/test_torch_warp.py): the
  masks disagree on at most 0.5% of the pixels, and where both have a point
  colour and depth agree to 1e-3 but on at most 3% of the pixels.  At
  integer pixel centres the tie rule -- the last winner in (offset, point
  index) order, which JAX's ``.at[].set`` keeps on the CPU -- gives exactly
  the JAX image.
* ``downsample_pointcloud`` cannot replay ``jax.random.choice``: it is held
  to its own properties (count; rows of the cloud; no row twice without
  replacement; replacement only above the cloud's size; zero weights never
  drawn, heavy weights drawn most).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from trajectorycrafter_tpu.geometry import pointcloud as jpc
from trajectorycrafter_tpu_torch.geometry import pointcloud as tpc

torch.set_num_threads(1)
LIFT_ATOL = 1e-5
VALUE_ATOL = 1e-3
MASK_DISAGREE_MAX = 0.005
KNIFE_EDGE_MAX = 0.03
H, W = 24, 32


def _camera(rng, yaw=0.2, t=(0.3, -0.1, 0.2)):
    c, s = np.cos(yaw), np.sin(yaw)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    c2w[:3, 3] = t
    K = np.array([[28.0, 0, W / 2], [0, 28.0, H / 2], [0, 0, 1]], np.float32)
    return K, c2w


def test_lift_matches_jax():
    rng = np.random.default_rng(0)
    K, c2w = _camera(rng)
    frame = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    depth = rng.uniform(1, 4, (H, W)).astype(np.float32)
    want = jpc.lift_to_pointcloud(*(jnp.asarray(x) for x in (frame, depth, K, c2w)))
    got = tpc.lift_to_pointcloud(*(torch.from_numpy(x) for x in (frame, depth, K, c2w)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=LIFT_ATOL, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].dtype == torch.float32 and got[0].shape == (H * W, 3)


def _clip(rng, f=4):
    frames = rng.uniform(0, 1, (f, H, W, 3)).astype(np.float32)
    depths = rng.uniform(1, 4, (f, H, W)).astype(np.float32)
    Ks = np.stack([_camera(rng)[0]] * f)
    c2ws = np.stack([_camera(rng, yaw=0.1 * i, t=(0.05 * i, 0, 0))[1] for i in range(f)])
    return frames, depths, Ks, c2ws


def test_lift_video_and_merge_match_jax():
    rng = np.random.default_rng(1)
    clip = _clip(rng)
    want = jpc.lift_video_to_pointcloud(*(jnp.asarray(x) for x in clip))
    got = tpc.lift_video_to_pointcloud(*(torch.from_numpy(x) for x in clip))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=LIFT_ATOL, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    wm = jpc.merge_pointclouds([want[0], want[0][:5]], [want[1], want[1][:5]])
    gm = tpc.merge_pointclouds([got[0], got[0][:5]], [got[1], got[1][:5]])
    assert gm[0].shape == wm[0].shape == (4 * H * W + 5, 3)
    np.testing.assert_array_equal(gm[1].numpy(), np.asarray(wm[1]))


def _cloud_with_ties(rng):
    """A clip lifted from one anchor camera over a plane (every frame's pixel
    lands on the same point and z: ties), then the same points again with
    other colours, random points in front, behind the camera (z <= 0.01) and
    outside the frame."""
    f = 5
    K, anchor = _camera(rng, yaw=0.0, t=(0.0, 0.0, 0.0))
    yy = np.mgrid[0:H, 0:W][0]
    plane = np.tile((2.0 + 2.0 * yy / H).astype(np.float32), (f, 1, 1))
    frames = rng.uniform(0, 1, (f, H, W, 3)).astype(np.float32)
    pts, cols = (np.asarray(x) for x in jpc.lift_video_to_pointcloud(
        jnp.asarray(frames), jnp.asarray(plane), jnp.asarray(np.stack([K] * f)),
        jnp.asarray(np.stack([anchor] * f))))
    extra = [
        (pts[:200], rng.uniform(0, 1, (200, 3))),  # exact duplicates, other colours
        (rng.uniform([-2, -2, 1], [2, 2, 6], (300, 3)), rng.uniform(0, 1, (300, 3))),
        (rng.uniform([-1, -1, -3], [1, 1, 0.01], (50, 3)), rng.uniform(0, 1, (50, 3))),
        (rng.uniform([20, 20, 1], [40, 40, 2], (50, 3)), rng.uniform(0, 1, (50, 3))),
    ]
    pts = np.concatenate([pts] + [p for p, _ in extra]).astype(np.float32)
    cols = np.concatenate([cols] + [c for _, c in extra]).astype(np.float32)
    return pts, cols, K


def _hold(got, want):
    img, depth, mask = (x.numpy() for x in got)
    wimg, wdepth, wmask = (np.asarray(x) for x in want)
    assert img.shape == wimg.shape == (H, W, 3) and mask.shape == depth.shape == (H, W)
    assert np.mean(mask != wmask) <= MASK_DISAGREE_MAX
    both = (mask > 0) & (wmask > 0)
    assert both.mean() > 0.3
    off = (np.abs(img - wimg).max(-1) > VALUE_ATOL) | (np.abs(depth - wdepth) > VALUE_ATOL)
    assert off[both].mean() <= KNIFE_EDGE_MAX, off[both].mean()
    assert np.all(depth[mask == 0] == 0) and np.all(img[mask == 0] == 0)


@pytest.mark.parametrize("point_size", [1, 3])
@pytest.mark.parametrize("view", ["anchor", "moved"])
def test_render_zbuffer_matches_jax(point_size, view):
    rng = np.random.default_rng(2)
    pts, cols, K = _cloud_with_ties(rng)
    c2w = _camera(rng, yaw=0.0 if view == "anchor" else 0.15,
                  t=(0.0, 0.0, 0.0) if view == "anchor" else (0.2, 0.05, -0.1))[1]
    w2c = np.linalg.inv(c2w).astype(np.float32)
    want = jpc.render_zbuffer(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(K),
                              jnp.asarray(w2c), H, W, point_size=point_size)
    got = tpc.render_zbuffer(torch.from_numpy(pts), torch.from_numpy(cols), torch.from_numpy(K),
                             torch.from_numpy(w2c), H, W, point_size=point_size)
    _hold(got, want)


@pytest.mark.parametrize("point_size", [1, 3])
def test_render_zbuffer_ties_take_the_last_winner_as_jax(point_size):
    """Points at integer pixel centres (no rounding boundary, no ulp
    question): many share a pixel and a z, some a pixel and a nearer z; the
    image, depth and mask equal JAX's exactly, and each tied pixel shows the
    colour of the highest point index (size 3: of the last offset)."""
    rng = np.random.default_rng(3)
    K = np.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1]], np.float32)
    n = 600
    px = rng.integers(0, W, n).astype(np.float32)
    py = rng.integers(0, H, n).astype(np.float32)
    z = rng.choice(np.array([1.0, 2.0, 4.0], np.float32), n)
    pts = np.stack([px * z, py * z, z], 1).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    eye = np.eye(4, dtype=np.float32)
    want = jpc.render_zbuffer(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(K),
                              jnp.asarray(eye), H, W, point_size=point_size)
    got = tpc.render_zbuffer(*(torch.from_numpy(x) for x in (pts, cols, K, eye)), H, W,
                             point_size=point_size)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if point_size == 1:
        img = got[0].numpy()
        for y, x in {(int(b), int(a)) for a, b in zip(px, py)}:
            on = np.flatnonzero((px == x) & (py == y))
            winners = on[z[on] == z[on].min()]
            np.testing.assert_array_equal(img[y, x], cols[winners.max()])


def test_render_culls_and_leaves_the_background():
    K = np.array([[10.0, 0, 2], [0, 10.0, 2], [0, 0, 1]], np.float32)
    pts = np.array([[0, 0, -1.0], [0, 0, 0.005], [5.0, 0, 1.0]], np.float32)
    cols = np.ones((3, 3), np.float32)
    img, depth, mask = tpc.render_zbuffer(torch.from_numpy(pts), torch.from_numpy(cols),
                                          torch.from_numpy(K), torch.eye(4), 5, 5,
                                          background=0.5)
    assert float(mask.sum()) == 0.0 and float(depth.abs().sum()) == 0.0
    assert torch.all(img == 0.5)


def test_facade_matches_the_functions():
    rng = np.random.default_rng(4)
    pts, cols, K = _cloud_with_ties(rng)
    t = lambda x: torch.from_numpy(x)
    warper = tpc.GlobalPointCloudWarper()
    got = warper.render_from_camera(t(pts), t(cols), t(K), torch.eye(4), H, W, point_size=3)
    want = tpc.render_zbuffer(t(pts), t(cols), t(K), torch.eye(4), H, W, point_size=3)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    frame, depth, c2w = t(_clip(rng)[0][0]), t(_clip(rng)[1][0]), torch.eye(4)
    assert all(torch.equal(a, b) for a, b in zip(
        warper.lift_to_3d_pointcloud(frame, depth, t(K), c2w),
        tpc.lift_to_pointcloud(frame, depth, t(K), c2w)))
    merged = warper.merge_pointclouds([t(pts), t(pts)], [t(cols), t(cols)])
    assert merged[0].shape == (2 * len(pts), 3)


def _rows(points):
    return {tuple(r) for r in points.tolist()}


@pytest.mark.parametrize("num", [1, 100, 999])
def test_downsample_draws_distinct_rows_of_the_cloud(num):
    n = 1000
    points = torch.arange(3 * n, dtype=torch.float32).reshape(n, 3)
    colors = points / (3 * n)
    gen = torch.Generator().manual_seed(0)
    p, c = tpc.downsample_pointcloud(points, colors, num, gen)
    assert p.shape == (num, 3) and c.shape == (num, 3)
    assert len(_rows(p)) == num  # without replacement
    assert _rows(p) <= _rows(points)
    assert torch.equal(c, p / (3 * n))  # colours travel with their points
    again = tpc.downsample_pointcloud(points, colors, num, torch.Generator().manual_seed(0))
    assert torch.equal(again[0], p)  # the generator decides the draw
    # the JAX draw takes as many rows, each a row of the cloud
    jp, _ = jpc.downsample_pointcloud(jnp.asarray(points.numpy()), jnp.asarray(colors.numpy()),
                                      num, jax.random.PRNGKey(0))
    assert jp.shape == p.shape and _rows(np.asarray(jp)) <= _rows(points)


def test_downsample_replaces_only_above_the_cloud_size():
    points = torch.arange(30, dtype=torch.float32).reshape(10, 3)
    p, _ = tpc.downsample_pointcloud(points, points, 25, torch.Generator().manual_seed(1))
    assert p.shape == (25, 3) and _rows(p) <= _rows(points) and len(_rows(p)) <= 10
    p, _ = tpc.downsample_pointcloud(points, points, 10, torch.Generator().manual_seed(1))
    assert len(_rows(p)) == 10


def test_downsample_follows_the_weights():
    n = 400
    points = torch.arange(3 * n, dtype=torch.float32).reshape(n, 3)
    weights = torch.zeros(n)
    weights[:10] = 100.0
    weights[10:200] = 1.0
    p, _ = tpc.downsample_pointcloud(points, points, 150, torch.Generator().manual_seed(2),
                                     weights=weights)
    idx = (p[:, 0] / 3).long()
    assert len(set(idx.tolist())) == 150  # without replacement
    assert idx.max() < 200  # zero weight: never drawn
    assert set(range(10)) <= set(idx.tolist())  # the heavy rows come first
    p, _ = tpc.downsample_pointcloud(points, points, 500, torch.Generator().manual_seed(2),
                                     weights=weights)
    assert p.shape == (500, 3) and (p[:, 0] / 3).long().max() < 200
