"""Camera-path interpolation (trajectorycrafter_tpu_torch/geometry/interpolate.py)
vs the JAX package's (trajectorycrafter_tpu/geometry/interpolate.py).

Tolerance 1e-6 of the compared values' largest magnitude: both sides are
float32 (quaternions and rotations of magnitude 1 agree to a few ulps); the
alphas i / (n - 1) are correctly rounded in the port, while ``jnp.linspace``
may sit an ulp off them, which moves an intrinsic of 500 by ~3e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
from scipy.spatial.transform import Rotation

from trajectorycrafter_tpu.geometry import interpolate as J
from trajectorycrafter_tpu_torch.geometry import interpolate as T

RTOL = 1e-6


def _close(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=RTOL * max(1.0, np.abs(want).max()), rtol=0)


def _branch_rotations():
    """Rotations whose largest pivot is each of w, x, y, z (the four
    branches), and random ones."""
    pivots = [np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
              np.diag([-1.0, -1.0, 1.0])]
    near = [Rotation.from_rotvec(np.pi * 0.97 * np.array(axis)).as_matrix()
            for axis in np.eye(3)]
    return np.stack(pivots + near + list(Rotation.random(24, random_state=1).as_matrix()))


def test_mat_to_quat_matches_jax_on_every_branch():
    R = _branch_rotations()
    want = np.asarray(J.mat_to_quat(jnp.asarray(R, jnp.float32)))
    _close(T.mat_to_quat(R), want)
    pivot = np.argmax(np.abs(want), axis=-1)
    assert set(pivot.tolist()) == {0, 1, 2, 3}


def test_quat_to_mat_matches_jax():
    q = np.random.default_rng(0).standard_normal((16, 4)).astype(np.float32)
    _close(T.quat_to_mat(q), J.quat_to_mat(jnp.asarray(q)))
    R = _branch_rotations()
    _close(T.quat_to_mat(T.mat_to_quat(R)), R.astype(np.float32))


@pytest.mark.parametrize("case", ["random", "far_hemisphere", "nearly_parallel"])
def test_slerp_matches_jax(case):
    rng = np.random.default_rng(1)
    q0 = rng.standard_normal(4)
    q0 /= np.linalg.norm(q0)
    if case == "random":
        q1 = rng.standard_normal(4)
        q1 /= np.linalg.norm(q1)
    elif case == "far_hemisphere":  # the dot is negative: q1 is negated
        q1 = -q0 + 0.3 * rng.standard_normal(4)
        q1 /= np.linalg.norm(q1)
        assert q0 @ q1 < 0
    else:  # |dot| > 0.9995: the normalised lerp
        q1 = q0 + 1e-3 * rng.standard_normal(4)
        q1 /= np.linalg.norm(q1)
        assert abs(q0 @ q1) > 0.9995
    alphas = np.linspace(0.0, 1.0, 11).astype(np.float32)
    got = T.slerp(q0, q1, alphas)
    _close(got, J.slerp(q0, q1, alphas))
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-6)


def _pose(rot, t):
    m = np.eye(4)
    m[:3, :3] = Rotation.from_rotvec(rot).as_matrix()
    m[:3, 3] = t
    return m


@pytest.mark.parametrize("n", [1, 2, 9, 49])
def test_interpolate_poses_and_intrinsics_match_jax(n):
    source = _pose([0.1, -0.3, 0.05], [0.2, -0.1, 1.5])
    target = _pose([-0.4, 0.9, 0.2], [-1.0, 0.4, 2.5])
    got = T.interpolate_poses(source, target, n)
    _close(got, J.interpolate_poses(source, target, n))
    np.testing.assert_allclose(got[0].numpy(), source.astype(np.float32), atol=1e-6)
    if n > 1:
        np.testing.assert_allclose(got[-1].numpy(), target.astype(np.float32), atol=1e-6)
    k0 = np.array([[500.0, 0, 512], [0, 500.0, 288], [0, 0, 1]])
    k1 = np.array([[320.0, 0, 480], [0, 330.0, 300], [0, 0, 1]])
    got_k = T.interpolate_intrinsics(k0, k1, n)
    _close(got_k, J.interpolate_intrinsics(k0, k1, n))
    np.testing.assert_array_equal(got_k[0].numpy(), k0.astype(np.float32))
    if n > 1:
        np.testing.assert_array_equal(got_k[-1].numpy(), k1.astype(np.float32))
