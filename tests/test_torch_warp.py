"""Port poses and forward splat (geometry/, ops/splat.py) vs the JAX package.

Poses: ``sphere2pose`` through ``generate_traj_txt`` / ``generate_traj_specified``
agree to 1e-5 absolute (fp32 4x4 products and trigonometry on both sides).

Warp: ``forward_warp_batch`` on seeded frames and a tilted depth plane.  The
projected coordinates differ by float rounding (matrix inverses, op order;
the flows agree to 1e-3), and the scatter-add sums in another order (float
atomics on the card), so:
  * the hole masks may disagree only where a landing position sits within
    rounding of a pixel edge: at most 0.5% of the pixels;
  * where both masks mark a pixel known, warped colour and depth agree to
    1e-3 absolute, except on knife edges: a source landing exactly on an
    integer position folds its ceil-corner weight into the floor corner (the
    reference's rule), so a 1-ulp coordinate change there changes the blend
    by O(0.01-0.1).  A pure yaw keeps the image-centre row on an integer y,
    so a whole row can sit on the edge: at most 3% of the known pixels may
    exceed 1e-3.
"""

from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from trajectorycrafter_tpu.geometry.cameras import default_c2w as jax_default_c2w
from trajectorycrafter_tpu.geometry.cameras import intrinsics_matrix as jax_intrinsics
from trajectorycrafter_tpu.geometry.trajectory import (
    generate_traj_specified as jax_traj_specified,
    generate_traj_txt as jax_traj_txt,
)
from trajectorycrafter_tpu.ops.splat import forward_warp_batch as jax_forward_warp_batch
from trajectorycrafter_tpu_torch.geometry.cameras import default_c2w, intrinsics_matrix
from trajectorycrafter_tpu_torch.geometry.trajectory import (
    generate_traj_specified,
    generate_traj_txt,
    load_traj_txt,
)
from trajectorycrafter_tpu_torch.ops.splat import forward_warp_batch

torch.set_num_threads(1)
POSE_ATOL = 1e-5
VALUE_ATOL = 1e-3
MASK_DISAGREE_MAX = 0.005
KNIFE_EDGE_MAX = 0.03


def test_traj_txt_poses_match_jax():
    theta, phi, r = load_traj_txt(str(Path(__file__).parents[1] / "test/trajs/loop1.txt"))
    r = [x * 2.5 for x in r]
    want = np.asarray(jax_traj_txt(jax_default_c2w(), phi, theta, r, 49))
    got = generate_traj_txt(default_c2w(), phi, theta, r, 49)
    assert got.dtype == torch.float32 and got.shape == (49, 4, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=POSE_ATOL, rtol=0)


def test_traj_specified_poses_match_jax():
    want = np.asarray(jax_traj_specified(jax_default_c2w(), 10.0, -25.0, 0.6, 0.1, -0.2, 9))
    got = generate_traj_specified(default_c2w(), 10.0, -25.0, 0.6, 0.1, -0.2, 9)
    np.testing.assert_allclose(got.numpy(), want, atol=POSE_ATOL, rtol=0)
    np.testing.assert_array_equal(intrinsics_matrix(500.0, 512.0, 288.0).numpy(),
                                  np.asarray(jax_intrinsics(500.0, 512.0, 288.0)))


@pytest.mark.parametrize("target", [(0.0, 12.0, 0.3, 0.0, 0.0), (-8.0, 5.0, -0.2, 0.1, 0.05)])
def test_forward_warp_batch_matches_jax(target):
    n, h, w = 3, 24, 40
    rng = np.random.default_rng(0)
    frames = rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32)
    yy = np.mgrid[0:h, 0:w][0]
    depths = np.tile((2.0 + 2.0 * yy / h).astype(np.float32), (n, 1, 1))
    depths += 0.05 * rng.standard_normal(depths.shape).astype(np.float32)
    poses = generate_traj_specified(default_c2w(), *target, n)
    poses[:, 2, 3] += 3.0
    pose_s = poses[:1].repeat(n, 1, 1)
    K = intrinsics_matrix(30.0, w / 2, h / 2)[None].repeat(n, 1, 1)

    want = [np.asarray(x) for x in jax_forward_warp_batch(
        *(jnp.asarray(np.asarray(x)) for x in (frames, depths, pose_s, poses, K)))]
    got = [x.numpy() for x in forward_warp_batch(
        torch.from_numpy(frames), torch.from_numpy(depths), pose_s, poses, K)]

    warped, mask, wdepth, flow = got
    assert warped.shape == (n, h, w, 3) and mask.shape == (n, h, w)
    np.testing.assert_allclose(flow, want[3], atol=VALUE_ATOL, rtol=0)
    disagree = np.mean(mask != want[1])
    assert disagree <= MASK_DISAGREE_MAX, disagree
    both = (mask > 0) & (want[1] > 0)
    assert both.mean() > 0.5  # the views overlap: most pixels are known
    off = (np.abs(warped - want[0]).max(-1) > VALUE_ATOL) | (np.abs(wdepth - want[2]) > VALUE_ATOL)
    assert off[both].mean() <= KNIFE_EDGE_MAX, off[both].mean()
    assert np.all(warped[mask == 0] == -1.0)



def test_forward_warp_batch_with_per_frame_target_intrinsics_matches_jax():
    """The zoom mode's warp: the source intrinsics of frame 0 for every frame,
    the target focal ramped per frame (``intrinsics2`` != ``intrinsics1``)."""
    n, h, w = 3, 24, 40
    rng = np.random.default_rng(1)
    frames = rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32)
    yy = np.mgrid[0:h, 0:w][0]
    depths = np.tile((2.0 + 2.0 * yy / h).astype(np.float32), (n, 1, 1))
    depths += 0.05 * rng.standard_normal(depths.shape).astype(np.float32)
    poses = generate_traj_specified(default_c2w(), 4.0, 7.0, 0.2, 0.0, 0.0, n + 1)
    poses[:, 2, 3] += 3.0
    pose_s, pose_t = poses[:1].repeat(n, 1, 1), poses[1:]
    k1 = intrinsics_matrix(30.0, w / 2, h / 2)[None].repeat(n, 1, 1)
    k2 = k1.clone()
    k2[:, 0, 0] = k2[:, 1, 1] = torch.tensor([33.0, 27.5, 24.0])

    want = [np.asarray(x) for x in jax_forward_warp_batch(
        *(jnp.asarray(np.asarray(x)) for x in (frames, depths, pose_s, pose_t, k1, k2)))]
    got = [x.numpy() for x in forward_warp_batch(
        torch.from_numpy(frames), torch.from_numpy(depths), pose_s, pose_t, k1, k2)]
    same_k = forward_warp_batch(torch.from_numpy(frames), torch.from_numpy(depths),
                                pose_s, pose_t, k1)
    assert np.abs(same_k[3].numpy() - got[3]).max() > 1.0  # the focal moves the flow

    warped, mask, wdepth, flow = got
    np.testing.assert_allclose(flow, want[3], atol=VALUE_ATOL, rtol=0)
    disagree = np.mean(mask != want[1])
    assert disagree <= MASK_DISAGREE_MAX, disagree
    both = (mask > 0) & (want[1] > 0)
    assert both.mean() > 0.5
    off = (np.abs(warped - want[0]).max(-1) > VALUE_ATOL) | (np.abs(wdepth - want[2]) > VALUE_ATOL)
    assert off[both].mean() <= KNIFE_EDGE_MAX, off[both].mean()
    assert np.all(warped[mask == 0] == -1.0)
