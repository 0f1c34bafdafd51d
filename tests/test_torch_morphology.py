"""The port's mask morphology (trajectorycrafter_tpu_torch/ops/morphology.py)
vs the JAX package's (trajectorycrafter_tpu/ops/morphology.py), and the
``--mask`` clean-up in ``forward_warp_batch``.

Every function is a max / min filter and comparisons of the same fp32
values, so on binary and on soft masks the port must equal JAX exactly.
``forward_warp_batch(use_mask_clean=True)`` is held to the JAX
``_forward_warp_batch_jit(..., use_mask_clean=True)`` within
tests/test_torch_warp.py's splat bounds; the clean-up itself, applied to
the port's own splat, must be JAX's ``clean_mask_batch`` of it exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from test_torch_warp import KNIFE_EDGE_MAX, MASK_DISAGREE_MAX, VALUE_ATOL

from trajectorycrafter_tpu.ops import morphology as jax_morph
from trajectorycrafter_tpu.ops.splat import _forward_warp_batch_jit
from trajectorycrafter_tpu_torch.geometry.cameras import default_c2w, intrinsics_matrix
from trajectorycrafter_tpu_torch.geometry.trajectory import generate_traj_specified
from trajectorycrafter_tpu_torch.ops import morphology
from trajectorycrafter_tpu_torch.ops.splat import forward_warp_batch

torch.set_num_threads(1)


def _masks(kind, shape=(37, 53), seed=0):
    rng = np.random.default_rng(seed)
    if kind == "binary":
        return (rng.uniform(0, 1, shape) > 0.7).astype(np.float32)
    return rng.uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["binary", "soft"])
@pytest.mark.parametrize("size,iterations", [(3, 1), (5, 1), (5, 2), (9, 1)])
def test_dilate_and_erode_equal_jax(kind, size, iterations):
    m = _masks(kind)
    for name in ("dilate", "erode"):
        want = np.asarray(getattr(jax_morph, name)(jnp.asarray(m), size=size,
                                                   iterations=iterations))
        got = getattr(morphology, name)(torch.from_numpy(m), size=size, iterations=iterations)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    # leading dimensions: each (h, w) plane on its own
    stack = np.stack([_masks(kind, seed=s) for s in range(3)])
    got = morphology.dilate(torch.from_numpy(stack), size=size, iterations=iterations).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i], np.asarray(jax_morph.dilate(
            jnp.asarray(stack[i]), size=size, iterations=iterations)))


@pytest.mark.parametrize("kind", ["binary", "soft"])
def test_mask_open_equals_jax(kind):
    m = _masks(kind, seed=1)
    for kwargs in (dict(), dict(size=5, n_erosion=2, n_dilation=1)):
        np.testing.assert_array_equal(morphology.mask_open(torch.from_numpy(m), **kwargs).numpy(),
                                      np.asarray(jax_morph.mask_open(jnp.asarray(m), **kwargs)))


@pytest.mark.parametrize("kind", ["binary", "soft"])
def test_clean_mask_single_and_batch_equal_jax(kind):
    rng = np.random.default_rng(2)
    warped = rng.uniform(-1, 1, (4, 37, 53, 3)).astype(np.float32)
    masks = np.stack([_masks(kind, seed=s) for s in range(4)])
    # one function, clean_mask, for a frame and for a clip: JAX's single and batch
    w0, m0 = morphology.clean_mask(torch.from_numpy(warped[0]), torch.from_numpy(masks[0]))
    jw0, jm0 = jax_morph.clean_mask_single(jnp.asarray(warped[0]), jnp.asarray(masks[0]))
    np.testing.assert_array_equal(w0.numpy(), np.asarray(jw0))
    np.testing.assert_array_equal(m0.numpy(), np.asarray(jm0))
    wb, mb = morphology.clean_mask(torch.from_numpy(warped), torch.from_numpy(masks))
    jwb, jmb = jax_morph.clean_mask_batch(jnp.asarray(warped), jnp.asarray(masks))
    np.testing.assert_array_equal(wb.numpy(), np.asarray(jwb))
    np.testing.assert_array_equal(mb.numpy(), np.asarray(jmb))
    # the holes only grow: a pixel unknown before is unknown after
    assert (mb.numpy()[masks < 0.5] == 0).all() and mb.numpy().mean() < (masks >= 0.5).mean()


def _warp_inputs(target=(-8.0, 5.0, -0.2, 0.1, 0.05)):
    n, h, w = 3, 24, 40
    rng = np.random.default_rng(0)
    frames = rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32)
    yy = np.mgrid[0:h, 0:w][0]
    depths = np.tile((2.0 + 2.0 * yy / h).astype(np.float32), (n, 1, 1))
    depths += 0.05 * rng.standard_normal(depths.shape).astype(np.float32)
    poses = generate_traj_specified(default_c2w(), *target, n)
    poses[:, 2, 3] += 3.0
    K = intrinsics_matrix(30.0, w / 2, h / 2)[None].repeat(n, 1, 1)
    pose_s = poses[:1].repeat(n, 1, 1)
    return frames, depths, pose_s.numpy(), poses.numpy(), K.numpy()


@pytest.mark.parametrize("target", [(0.0, 12.0, 0.3, 0.0, 0.0), (-8.0, 5.0, -0.2, 0.1, 0.05)])
def test_forward_warp_with_mask_clean_matches_jax(target):
    frames, depths, pose_s, pose_t, K = _warp_inputs(target)
    args = (frames, depths, pose_s, pose_t, K, K)
    want = [np.asarray(x) for x in _forward_warp_batch_jit(*map(jnp.asarray, args),
                                                           use_mask_clean=True)]
    plain = [np.asarray(x) for x in _forward_warp_batch_jit(*map(jnp.asarray, args),
                                                            use_mask_clean=False)]
    got = [x.numpy() for x in forward_warp_batch(*map(torch.from_numpy, args),
                                                 use_mask_clean=True)]
    unclean = [x.numpy() for x in forward_warp_batch(*map(torch.from_numpy, args))]
    warped, mask = got[0], got[1]
    assert 0.0 < mask.mean() < plain[1].mean()  # the clean-up removed known pixels
    assert np.mean(mask != want[1]) <= MASK_DISAGREE_MAX
    both = (mask > 0) & (want[1] > 0)
    off = np.abs(warped - want[0]).max(-1) > VALUE_ATOL
    assert off[both].mean() <= KNIFE_EDGE_MAX, off[both].mean()
    assert np.all(warped[mask == 0] == -1.0)
    np.testing.assert_array_equal(got[2], unclean[2])  # depth and flow are not cleaned
    np.testing.assert_array_equal(got[3], unclean[3])
    # the clean-up of the port's own splat is JAX's, exactly
    jw, jm = jax.vmap(jax_morph.clean_mask_single)(jnp.asarray(unclean[0]),
                                                    jnp.asarray(unclean[1]))
    np.testing.assert_array_equal(warped, np.asarray(jw))
    np.testing.assert_array_equal(mask, np.asarray(jm))
