"""The port's ring attention (trajectorycrafter_tpu_torch/ops/ring_attention.py)
vs the JAX package's (trajectorycrafter_tpu/ops/ring_attention.py), on the CPU.

The ring runs in real multi-process gloo worlds (tests/torch_worlds.py: 8
ranks started by ``file://`` under the test's tmp_path, joined with a
timeout); the rings of sp 2 and 4 run on meshes that leave the other ranks
of the world idle.  Each rank's rows are joined in sp order and held
against the JAX unsharded ``_attention_with_lse`` on the same numpy inputs,
and one case against JAX ``ring_attention`` itself on the 8-device CPU mesh.

Tolerance: 1e-5 absolute and relative.  Both sides are fp32; the ring
merges its partials by logsumexp in another order than one softmax over
every key, which moves O(1) outputs by ~1e-7.  A merge that ignores the
logsumexps (the planted fault) moves them by ~1e-1.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_parallel_workers import ring_cases
from torch_worlds import run_world
from trajectorycrafter_tpu.ops import ring_attention as jax_ra
from trajectorycrafter_tpu.parallel import make_mesh as jax_make_mesh
from trajectorycrafter_tpu_torch.ops import ring_attention as ra
from trajectorycrafter_tpu_torch.parallel.sharding import shard_sizes

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
WORLD = 8
# (sp, S): uneven shards everywhere; S = 13 at sp 4 is 4 + 4 + 4 + 1 tokens,
# at sp 8 the last rank holds none
CASES = [(2, 13), (4, 13), (8, 13), (8, 64)]


def _qkv(seed, s, b=2, h=3, d=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))


def _jax_exact(q, k, v, scale):
    out, _ = jax_ra._attention_with_lse(*(jnp.asarray(x) for x in (q, k, v)), scale)
    return np.asarray(out)


def _joined(rows, sp):
    """The ranks' rows in sp order."""
    parts = sorted(r for r in rows if r is not None)
    assert [i for i, _ in parts] == list(range(sp))
    return np.concatenate([o for _, o in parts], axis=2)


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    cases = [(sp, *_qkv(i, s), 16 ** -0.5) for i, (sp, s) in enumerate(CASES)]
    tmp = tmp_path_factory.mktemp("ring")
    runs = run_world(ring_cases, WORLD, tmp, cases)
    fault = run_world(ring_cases, 4, tmp, cases[1:2], True)
    return cases, runs, fault


def test_shard_sizes_split_as_shard_map():
    """ceil(S / sp) tokens a shard, the last ones shorter (JAX pads S to a
    multiple of sp and masks the padding; the port passes the real tokens)."""
    assert shard_sizes(13, 4) == [4, 4, 4, 1]
    assert shard_sizes(13, 8) == [2, 2, 2, 2, 2, 2, 1, 0]
    assert shard_sizes(13330, 2) == [6665, 6665]
    assert sum(shard_sizes(30178, 4)) == 30178


def test_attention_with_lse_matches_jax():
    q, k, v = _qkv(0, 13)
    mask = np.arange(13) < 10
    for key_mask in (None, mask):
        want = jax_ra._attention_with_lse(*(jnp.asarray(x) for x in (q, k, v)), 0.25,
                                          key_mask=None if key_mask is None
                                          else jnp.asarray(key_mask))
        got = ra._attention_with_lse(*(torch.from_numpy(x) for x in (q, k, v)), 0.25,
                                     key_mask=None if key_mask is None
                                     else torch.from_numpy(key_mask))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_combine_matches_jax(rng):
    o1, o2 = (rng.standard_normal((2, 3, 5, 16)).astype(np.float32) for _ in range(2))
    l1, l2 = (rng.standard_normal((2, 3, 5)).astype(np.float32) * 4 for _ in range(2))
    want = jax_ra._combine(*(jnp.asarray(x) for x in (o1, l1, o2, l2)))
    got = ra._combine(*(torch.from_numpy(x) for x in (o1, l1, o2, l2)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)
    # the first partial merged into the empty state (0, -inf) is itself
    o, lse = ra._combine(torch.zeros(2, 3, 5, 16), torch.full((2, 3, 5), -float("inf")),
                         torch.from_numpy(o1), torch.from_numpy(l1))
    assert torch.equal(o, torch.from_numpy(o1)) and torch.equal(lse, torch.from_numpy(l1))


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"sp{sp}_S{s}" for sp, s in CASES])
def test_ring_matches_jax_attention_with_lse(ring_runs, case):
    cases, runs, _ = ring_runs
    sp, q, k, v, scale = cases[case]
    got = _joined([r[case] for r in runs], sp)
    np.testing.assert_allclose(got, _jax_exact(q, k, v, scale), **TOL)


def test_ring_matches_jax_ring_attention(ring_runs):
    """S = 13 at sp 4 against JAX ``ring_attention`` on a 4-device sp axis
    of the CPU mesh (pad-and-mask there, real keys only in the port)."""
    cases, runs, _ = ring_runs
    sp, q, k, v, scale = cases[1]
    mesh = jax_make_mesh(dp=1, sp=sp, tp=1, devices=jax.devices()[:sp])
    want = np.asarray(jax_ra.ring_attention(*(jnp.asarray(x) for x in (q, k, v)), mesh,
                                            scale=scale))
    np.testing.assert_allclose(_joined([r[1] for r in runs], sp), want, **TOL)


def test_ring_rejects_a_merge_without_the_logsumexp(ring_runs):
    cases, _, fault = ring_runs
    sp, q, k, v, scale = cases[1]
    err = np.abs(_joined([r[0] for r in fault], sp) - _jax_exact(q, k, v, scale)).max()
    assert err > 1e-2


def test_ring_refuses_shards_that_do_not_match_the_sequence():
    """A rank's q, k, v must be its shard of ``s_true`` tokens."""
    from trajectorycrafter_tpu_torch.parallel.distributed import Axis

    axis = Axis("sp", 4, 3, (0, 1, 2, 3))
    q = torch.zeros(1, 2, 4, 16)
    with pytest.raises(ValueError, match="holds 1 of 13 tokens"):
        ra.ring_attention(q, q, q, axis, 13)
