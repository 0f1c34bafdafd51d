"""The port's LoRA training with the token stream on sp (training/step.py
under a dp x sp x tp mesh, models/dit.py's forward with ``sp``, the
differentiable ring of ops/ring_attention.py, the sp gather of
parallel/distributed.py) vs the JAX package's ``make_train_step`` on the
``shard_activations=True`` DiT under the same ``make_mesh(...)``, on the CPU.

One real 4-rank gloo world (tests/torch_worlds.py; the ranks' side is
tests/torch_parallel_workers.py ``training_sp``) runs every sharded case;
JAX runs on the virtual devices of tests/conftest.py.  The model is
tests/test_torch_training.py's tiny DiT (2 layers, 2 heads of 8, one
Perceiver; fp32): 3 text + 8 video tokens, so sp 2 holds 6 and 5 joint
tokens a rank (3 and 5 video).  Both sides get the same seeded weights and
adapters and the batches of 2 with ``timesteps`` and ``noise`` supplied at
dropout 0 (torch cannot replay a JAX key).

  * ``RingAttentionFunction``'s output and dq, dk, dv at sp 2 and 4 over
    13 tokens (7 + 6; 4 + 4 + 4 + 1: the last shard shorter) against the
    unsharded ``FlashAttentionFunction`` within 1e-5 relative L2 (fp32; the
    ring merges its partials and sums its hops in another order);
  * the step under (dp 1, sp 2, tp 2) with the motion term and under (dp 2,
    sp 2, tp 1) with accumulation 2: test_torch_training.py's tolerances
    (loss 1e-5 relative, gradients and grad norm 1e-4 relative L2, the
    adapters after two AdamW steps within 1e-5 absolutely plus 1e-4
    relatively), the adapters bit-equal on every rank after every step;
  * one batch's reduced adapter gradients under (dp 1, sp 2, tp 2) against
    ``jax.grad`` of JAX's loss under the same mesh, sound and with each
    planted fault of ``SP_FAULTS``, which must read at least 10x the sound
    reading on the adapters it touches (the card's run T2 holds the same
    faults to the same ratio).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_training import (
    ALPHA,
    GRAD_REL_L2,
    LOSS_RTOL,
    RANK,
    STEP_ATOL,
    STEP_RTOL,
    TINY,
    _batch,
    _jax_lora,
    _lora_np,
    _rel_l2,
)
from torch_parallel_workers import SP_FAULTS, training_sp
from torch_parity import jax_tree
from torch_worlds import run_world

from trajectorycrafter_tpu.models.dit import CrossTransformer3DModel as JaxDiT
from trajectorycrafter_tpu.parallel import dit_param_sharding, shard_batch
from trajectorycrafter_tpu.parallel import make_mesh as jax_make_mesh
from trajectorycrafter_tpu.schedulers import CogVideoXDDIMScheduler as JaxDDIM
from trajectorycrafter_tpu.training import TrainState as JaxTrainState
from trajectorycrafter_tpu.training import step as jstep
from trajectorycrafter_tpu.utils.convert import convert_dit
from trajectorycrafter_tpu_torch.models.dit import CrossTransformer3DModel
from trajectorycrafter_tpu_torch.ops.attention import FlashAttentionFunction
from trajectorycrafter_tpu_torch.parallel.sharding import shard_sizes
from trajectorycrafter_tpu_torch.utils.weights import lora_to_jax

torch.set_num_threads(1)
FAULT_RATIO = 10.0
RING_REL_L2 = 1e-5
RING_SPS = (2, 4)
RING_S = 13
STEP = dict(rank=RANK, alpha=ALPHA, seed=0, dropout=0.0)
# name -> (mesh (dp, sp, tp), the step's settings)
CASES = {"dp1 sp2 tp2, motion": ((1, 2, 2), dict(STEP, accum=1, motion=True)),
         "dp2 sp2 tp1, accumulation 2": ((2, 2, 1), dict(STEP, accum=2, motion=False))}
GRAD_MESH = (1, 2, 2)


def _ring_cases():
    rng = np.random.default_rng(22)
    arrays = [rng.standard_normal((2, 3, RING_S, 8)).astype(np.float32) for _ in range(4)]
    return [(RING_S, *arrays, 8 ** -0.5)]


def _batches():
    rng = np.random.default_rng(22)
    return [_batch(rng, 2) for _ in range(2)]


@pytest.fixture(scope="module")
def setup():
    params = jax_tree(CrossTransformer3DModel(**TINY), 0, convert_dit,
                      num_layers=TINY["num_layers"])
    sched = JaxDDIM()
    return dict(params=params, jsched=sched, jstate=sched.set_timesteps(50),
                jmodel=JaxDiT(**TINY, attention_impl="xla", shard_activations=True),
                lora=_lora_np(params))


@pytest.fixture(scope="module")
def world(setup, tmp_path_factory):
    common = (setup["params"], TINY, setup["lora"])
    steps = {name: (shape, *common, case, _batches()) for name, (shape, case) in CASES.items()}
    grad = (GRAD_MESH, *common, dict(STEP), _batches()[0])
    return run_world(training_sp, 4, tmp_path_factory.mktemp("train_sp"), RING_SPS,
                     _ring_cases(), steps, grad)


def _jax_mesh(shape):
    return jax_make_mesh(*shape, devices=jax.devices()[:int(np.prod(shape))])


# ----------------------------------------------------------------------------
# the differentiable ring
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("sp", RING_SPS)
def test_ring_gradients_match_the_unsharded_function(world, sp):
    """The ranks' rows of the output and their shards' dq, dk and dv, joined
    in sp order, against ``FlashAttentionFunction`` on the whole sequence
    (its plain versions on the CPU)."""
    assert shard_sizes(RING_S, sp)[-1] < shard_sizes(RING_S, sp)[0]  # the last is shorter
    parts = sorted(run["ring"][sp] for run in world if run["ring"][sp] is not None)
    assert [i for i, _ in parts] == list(range(sp))
    for c, (s, q, k, v, dout, scale) in enumerate(_ring_cases()):
        qs, ks, vs = (torch.from_numpy(x).transpose(1, 2).requires_grad_() for x in (q, k, v))
        out = FlashAttentionFunction.apply(qs, ks, vs, scale)
        grads = torch.autograd.grad(out, [qs, ks, vs], torch.from_numpy(dout).transpose(1, 2))
        want = [x.detach().transpose(1, 2).numpy() for x in (out, *grads)]
        for i, name in enumerate(("out", "dq", "dk", "dv")):
            got = np.concatenate([p[c][i] for _, p in parts], axis=2)
            assert got.shape == want[i].shape
            assert _rel_l2(got, want[i]) <= RING_REL_L2, name


# ----------------------------------------------------------------------------
# the step against JAX's under the same mesh
# ----------------------------------------------------------------------------


def _jax_sharded_steps(setup, shape, case, batches):
    mesh = _jax_mesh(shape)
    params = jax.device_put(setup["params"], dit_param_sharding(setup["params"], mesh))
    opt = jstep.make_optimizer(lr=1e-3, grad_accum_steps=case["accum"])
    lora = _jax_lora(setup["lora"])
    state = JaxTrainState(lora=lora, opt_state=opt.init(lora), step=jnp.zeros((), jnp.int32))
    fn = jstep.make_train_step(setup["jmodel"], params, setup["jsched"], setup["jstate"], opt,
                               cfg_dropout_prob=0.0, motion_sub_loss=case["motion"],
                               lora_alpha=ALPHA, lora_rank=RANK)
    loss_fn = jstep.make_loss_fn(setup["jmodel"], params, setup["jsched"], setup["jstate"],
                                 cfg_dropout_prob=0.0, motion_sub_loss=case["motion"],
                                 lora_alpha=ALPHA, lora_rank=RANK)
    metrics, micro = [], []
    with jax.set_mesh(mesh):
        jfn, jgrad = jax.jit(fn), jax.jit(jax.grad(loss_fn))
        for b in batches:
            batch = jax.device_put({k: jnp.asarray(v) for k, v in b.items()},
                                   shard_batch(b, mesh))
            if case["accum"] > 1:  # the micro-gradients at the adapters they accumulate for
                micro.append(jgrad(lora, batch, jax.random.PRNGKey(0)))
            state, m = jfn(state, batch, jax.random.PRNGKey(0))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    # with accumulation: the norm of the micro-gradients' mean, which the update clips
    mean_norm = float(optax.global_norm(jax.tree.map(lambda *g: sum(g) / len(g), *micro))) \
        if micro else None
    return jax.tree.map(np.asarray, state.lora), metrics, mean_norm


@pytest.mark.parametrize("name", CASES)
def test_sp_step_matches_jax_shard_activations(setup, world, name):
    """Two steps: the loss (the mean over dp; every sp rank's is the same)
    of each step, the grad norm where it updates (NaN at accumulation's
    first micro-step, as the dp x tp step reports it; JAX's MultiSteps
    reports the micro-gradient's there; at the update, the norm of the mean
    of JAX's micro-gradients) and the adapters after them against JAX's
    step on the same mesh; every rank holds the same adapters, bit for
    bit, after every step."""
    shape, case = CASES[name]
    got = world[0]["steps"][name]
    for run in world[1:]:
        assert run["steps"][name]["sums"] == got["sums"]
        for k, v in run["steps"][name]["lora"].items():
            np.testing.assert_array_equal(v, got["lora"][k])
    want_lora, want_metrics, mean_norm = _jax_sharded_steps(setup, shape, case, _batches())
    losses, gnorms = np.asarray(got["metrics"]).T
    np.testing.assert_allclose(losses, np.asarray(want_metrics)[:, 0], rtol=LOSS_RTOL)
    if case["accum"] == 1:
        np.testing.assert_allclose(gnorms, np.asarray(want_metrics)[:, 1], rtol=GRAD_REL_L2)
    else:
        assert np.isnan(gnorms[0])
        np.testing.assert_allclose(gnorms[1], mean_norm, rtol=GRAD_REL_L2)
    flat = lora_to_jax({k: torch.from_numpy(v) for k, v in got["lora"].items()})
    assert set(flat) == set(want_lora)
    for key in want_lora:
        for part in ("a", "b"):
            np.testing.assert_allclose(flat[key][part], want_lora[key][part], atol=STEP_ATOL,
                                       rtol=STEP_RTOL, err_msg=f"{key} {part}")


# ----------------------------------------------------------------------------
# the reduced gradients and the planted faults
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_grads(setup):
    """JAX's adapter gradients of one batch under GRAD_MESH (JAX's tree:
    path -> {"a", "b"})."""
    mesh = _jax_mesh(GRAD_MESH)
    params = jax.device_put(setup["params"], dit_param_sharding(setup["params"], mesh))
    fn = jstep.make_loss_fn(setup["jmodel"], params, setup["jsched"], setup["jstate"],
                            cfg_dropout_prob=0.0, lora_alpha=ALPHA, lora_rank=RANK)
    b = _batches()[0]
    with jax.set_mesh(mesh):
        batch = jax.device_put({k: jnp.asarray(v) for k, v in b.items()}, shard_batch(b, mesh))
        grads = jax.jit(jax.grad(fn))(_jax_lora(setup["lora"]), batch, jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, grads)


def test_reduced_gradients_match_jax(world, jax_grads):
    """Under dp 1 x sp 2 x tp 2 every rank's reduced adapter gradients (every
    adapter summed over sp, the tp-sharded ones over tp, not the replicated
    top-level ``proj_out``) against ``jax.grad`` of JAX's loss, adapter by
    adapter."""
    for run in world:
        sound = lora_to_jax({k: torch.from_numpy(v) for k, v in run["grads"][None].items()})
        assert set(sound) == set(jax_grads)
        for key in jax_grads:
            for part in ("a", "b"):
                assert _rel_l2(sound[key][part], jax_grads[key][part]) <= GRAD_REL_L2, (key, part)
        np.testing.assert_array_equal(
            np.concatenate([v.ravel() for v in run["grads"][None].values()]),
            np.concatenate([v.ravel() for v in world[0]["grads"][None].values()]))


def _touched(fault: str, keys) -> list:
    """The adapters (port names) a planted fault moves: every adapter, or
    the blocks' k and v projections' for the ring's dK / dV."""
    if fault.startswith("ring"):
        return [k for k in keys if ".attn1.to_k." in k or ".attn1.to_v." in k]
    return list(keys)


@pytest.mark.parametrize("fault", SP_FAULTS)
def test_planted_sp_fault_reads_10x_the_sound_reading(world, jax_grads, fault):
    """Each planted fault, in every rank, against JAX's gradients on the
    adapters it touches: at least 10x the sound reading there."""
    for run in world:
        keys = _touched(fault, run["grads"][None])
        assert keys
        sound = _adapters_rel_l2(run["grads"][None], jax_grads, keys)
        wrong = _adapters_rel_l2(run["grads"][fault], jax_grads, keys)
        assert wrong >= FAULT_RATIO * max(sound, 1e-7), (fault, sound, wrong)


def _adapters_rel_l2(got: dict, want: dict, keys) -> float:
    """The relative L2 error of the port's gradients ``got`` (port names,
    numpy) over the adapters ``keys`` against JAX's ``want``."""
    flat = lora_to_jax({k: torch.from_numpy(got[k]) for k in keys})
    cat = lambda tree: np.concatenate([tree[j][p].ravel() for j in sorted(flat)
                                       for p in ("a", "b") if p in flat[j]])
    return _rel_l2(cat(flat), cat(want))
