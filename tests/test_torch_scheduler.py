"""The port's six samplers (trajectorycrafter_tpu_torch/schedulers/) vs JAX.

Same schedule tables (timesteps exactly, coefficients to fp32 rounding) and
the same step / add_noise on numpy inputs, for every name of
``SCHEDULER_REGISTRY`` with its deployed config, and for the two classes
that stand outside it (``CogVideoXDPMScheduler`` and Euler's ``log_linear``
sigmas).  Tolerance 1e-6 absolute
and relative: both sides are fp32 elementwise arithmetic; the port takes
the per-step scalars (square roots, sigma ratios, expm1) in double before
the fp32 multiply.  Euler's first sigma is ~4,096 (the zero-SNR terminal
abar = 2^-24), so its inputs there are drawn at that scale, as the
pipeline's initial latents are.

Whole loops: PNDM through its 12 pseudo-RK calls into PLMS, and DPM++ from
``first_index`` > 0, each with a model stand-in that depends on the sample,
so an error in any entry carries forward; 1e-5 absolute and relative over
the loop (each step's ~1e-7 fp32 rounding, carried through 6 to 15 linear
updates).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from trajectorycrafter_tpu.schedulers import SCHEDULER_REGISTRY as JAX_REGISTRY
from trajectorycrafter_tpu.schedulers.ddim import DDIMScheduler as JaxDDIM
from trajectorycrafter_tpu.schedulers.dpm import CogVideoXDPMScheduler as JaxCogDPM
from trajectorycrafter_tpu.schedulers.euler import EulerDiscreteScheduler as JaxEuler
from trajectorycrafter_tpu.schedulers.pndm import PNDMLoopState as JaxPNDMLoop
from trajectorycrafter_tpu_torch.schedulers import SCHEDULER_REGISTRY
from trajectorycrafter_tpu_torch.schedulers.ddim import DDIMScheduler
from trajectorycrafter_tpu_torch.schedulers.dpm import CogVideoXDPMScheduler
from trajectorycrafter_tpu_torch.schedulers.euler import EulerDiscreteScheduler
from trajectorycrafter_tpu_torch.schedulers.pndm import PNDMLoopState

torch.set_num_threads(1)
TOL = dict(atol=1e-6, rtol=1e-6)
LOOP_TOL = dict(atol=1e-5, rtol=1e-5)
NAMES = ["Euler", "Euler A", "DPM++", "PNDM", "DDIM_Cog", "DDIM_Origin"]
SHAPE = (1, 3, 4, 6, 4)
_LOG_LINEAR = dict(timestep_spacing="trailing", steps_offset=0, rescale_betas_zero_snr=True,
                   interpolation_type="log_linear")
# case -> (JAX constructor, port constructor, the registry name whose step
# interface it has): the six registry entries, and the two classes outside
# the registry (the Cog DPM++ and Euler's log-linear sigmas)
CASES = {name: (JAX_REGISTRY[name], SCHEDULER_REGISTRY[name], name) for name in NAMES}
CASES["CogVideoXDPM"] = (JaxCogDPM, CogVideoXDPMScheduler, "DPM++")
CASES["Euler log_linear"] = (lambda: JaxEuler(**_LOG_LINEAR),
                             lambda: EulerDiscreteScheduler(**_LOG_LINEAR), "Euler")


def test_registry_has_the_jax_names():
    assert sorted(SCHEDULER_REGISTRY) == sorted(JAX_REGISTRY) == sorted(NAMES)


@pytest.mark.parametrize("steps", [2, 50])
def test_schedule_tables_match_jax(steps):
    want = JaxDDIM().set_timesteps(steps)
    got = DDIMScheduler().set_timesteps(steps)
    np.testing.assert_array_equal(got.timesteps, np.asarray(want.timesteps))
    np.testing.assert_array_equal(got.alpha_prod_t, np.asarray(want.alpha_prod_t))
    np.testing.assert_array_equal(got.alpha_prod_prev, np.asarray(want.alpha_prod_prev))
    np.testing.assert_array_equal(got.alphas_cumprod, np.asarray(want.alphas_cumprod))


@pytest.mark.parametrize("steps", [4, 50])
@pytest.mark.parametrize("name", list(CASES))
def test_registry_schedule_tables_match_jax(name, steps):
    jax_cls, torch_cls, _ = CASES[name]
    want = jax_cls().set_timesteps(steps)
    got = torch_cls().set_timesteps(steps)
    assert got._fields == want._fields
    for field in want._fields:
        w, g = np.asarray(getattr(want, field)), np.asarray(getattr(got, field))
        if field == "timesteps":
            np.testing.assert_array_equal(g, w)
        else:  # stored as float32 on both sides, from the same float64 tables
            np.testing.assert_allclose(g, w, rtol=2**-24, atol=0, err_msg=field)
    jsched, tsched = jax_cls(), torch_cls()
    if hasattr(jsched, "num_loop_steps"):
        assert tsched.num_loop_steps(steps) == jsched.num_loop_steps(steps)
    else:
        assert tsched.num_loop_steps(steps) == steps


def _draws(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    f32 = lambda: rng.standard_normal(SHAPE).astype(np.float32)
    return f32() * np.float32(scale), f32(), f32(), f32()


def _jax_step(name, sched, state, out, i, sample, extra):
    """One JAX step -> (sample, what the loop carries)."""
    j = jnp.asarray
    if name == "Euler A":
        return sched.step(state, j(out), i, j(sample), noise=j(extra)), None
    if name == "DPM++":
        return sched.step(state, j(out), i, j(sample), prev_x0=j(extra[0]),
                          num_steps=extra[1], first_index=extra[2])
    if name == "PNDM":
        return sched.step(state, j(out), i, j(sample), extra)
    return sched.step(state, j(out), i, j(sample)), None


def _torch_step(name, sched, state, out, i, sample, extra):
    t = torch.from_numpy
    if name == "Euler A":
        return sched.step(state, t(out), i, t(sample), noise=t(extra)), None
    if name == "DPM++":
        return sched.step(state, t(out), i, t(sample), prev_x0=t(extra[0]),
                          num_steps=extra[1], first_index=extra[2])
    if name == "PNDM":
        return sched.step(state, t(out), i, t(sample), extra)
    return sched.step(state, t(out), i, t(sample)), None


def _pndm_loops(counter, rng):
    """The same PNDM loop state for both packages, after ``counter`` calls."""
    ets = rng.standard_normal((4, *SHAPE)).astype(np.float32)
    cur = rng.standard_normal(SHAPE).astype(np.float32)
    acc = rng.standard_normal(SHAPE).astype(np.float32)
    return (JaxPNDMLoop(jnp.asarray(ets), jnp.asarray(counter, jnp.int32), jnp.asarray(cur),
                        jnp.asarray(acc)),
            PNDMLoopState(torch.from_numpy(ets), counter, torch.from_numpy(cur),
                          torch.from_numpy(acc)))


@pytest.mark.parametrize("prediction_type", ["v_prediction", "epsilon", "sample"])
def test_step_matches_jax(prediction_type):
    rng = np.random.default_rng(0)
    sample = rng.standard_normal((1, 3, 4, 6, 4)).astype(np.float32)
    model_out = rng.standard_normal((1, 3, 4, 6, 4)).astype(np.float32)
    jsched = JaxDDIM(prediction_type=prediction_type)
    tsched = DDIMScheduler(prediction_type=prediction_type)
    jstate, tstate = jsched.set_timesteps(10), tsched.set_timesteps(10)
    for i in (0, 4, 9):  # first, middle and the last (alpha_prev = 1) step
        want = np.asarray(jsched.step(jstate, jnp.asarray(model_out), i, jnp.asarray(sample)))
        got = tsched.step(tstate, torch.from_numpy(model_out), i, torch.from_numpy(sample))
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_registry_step_matches_jax(case):
    """The step at the first, a middle and the last index of a 10-step run
    (PNDM: of its 19-entry loop, so the first RK call, a PLMS entry and the
    last one, each with a seeded loop state of that counter)."""
    jax_cls, torch_cls, name = CASES[case]
    jsched, tsched = jax_cls(), torch_cls()
    steps = 10
    jstate, tstate = jsched.set_timesteps(steps), tsched.set_timesteps(steps)
    last = tsched.num_loop_steps(steps) - 1
    rng = np.random.default_rng(7)
    for i in (0, last // 2, last):
        scale = tstate.init_noise_sigma if i == 0 else 1.0
        sample, out, noise, prev_x0 = _draws(i, scale)
        if name == "Euler A":
            jx = tx = noise
        elif name == "DPM++":
            jx = tx = (prev_x0, steps, 0)
        elif name == "PNDM":
            jx, tx = _pndm_loops(i, rng)
        else:
            jx = tx = None
        want, jcarry = _jax_step(name, jsched, jstate, out, i, sample, jx)
        got, tcarry = _torch_step(name, tsched, tstate, out, i, sample, tx)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=f"step {i}")
        if name == "DPM++":
            np.testing.assert_allclose(tcarry.numpy(), np.asarray(jcarry), **TOL)
        if name == "PNDM":
            assert tcarry.counter == int(jcarry.counter) == i + 1
            for field in ("ets", "cur_sample", "acc"):
                np.testing.assert_allclose(getattr(tcarry, field).numpy(),
                                           np.asarray(getattr(jcarry, field)), **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_registry_add_noise_matches_jax(name):
    jsched, tsched = JAX_REGISTRY[name](), SCHEDULER_REGISTRY[name]()
    jstate, tstate = jsched.set_timesteps(10), tsched.set_timesteps(10)
    x0, noise, _, _ = _draws(1)
    for k in (0, 3):
        t = tstate.timesteps[k]
        want = np.asarray(jsched.add_noise(jstate, jnp.asarray(x0), jnp.asarray(noise),
                                           jnp.asarray(t)))
        got = tsched.add_noise(tstate, torch.from_numpy(x0), torch.from_numpy(noise), t)
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=f"timestep {t}")


def test_add_noise_matches_jax():
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((1, 2, 4, 4, 4)).astype(np.float32)
    noise = rng.standard_normal((1, 2, 4, 4, 4)).astype(np.float32)
    jsched, tsched = JaxDDIM(), DDIMScheduler()
    jstate, tstate = jsched.set_timesteps(10), tsched.set_timesteps(10)
    t = int(tstate.timesteps[3])
    want = np.asarray(jsched.add_noise(jstate, jnp.asarray(x0), jnp.asarray(noise),
                                       jnp.asarray(t)))
    got = tsched.add_noise(tstate, torch.from_numpy(x0), torch.from_numpy(noise), t)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _model(sample, i):
    """A model stand-in for the loops: depends on the sample and the entry."""
    rng = np.random.default_rng(100 + i)
    return 0.3 * sample + rng.standard_normal(SHAPE).astype(np.float32)


def test_pndm_loop_through_the_prk_to_plms_switch_matches_jax():
    steps = 6
    jsched, tsched = JAX_REGISTRY["PNDM"](), SCHEDULER_REGISTRY["PNDM"]()
    jstate, tstate = jsched.set_timesteps(steps), tsched.set_timesteps(steps)
    n = tsched.num_loop_steps(steps)
    assert n == 12 + steps - 3 == len(tstate.timesteps)
    sample = _draws(3)[0]
    jx, jloop = jnp.asarray(sample), jsched.init_loop_state(SHAPE)
    tx = torch.from_numpy(sample)
    tloop = tsched.init_loop_state(tx)
    for i in range(n):
        jx, jloop = jsched.step(jstate, jnp.asarray(_model(np.asarray(jx), i)), i, jx, jloop)
        tx, tloop = tsched.step(tstate, torch.from_numpy(_model(tx.numpy(), i)), i, tx, tloop)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **LOOP_TOL, err_msg=f"entry {i}")
    assert tloop.counter == n


def test_pndm_needs_four_steps_as_in_jax():
    with pytest.raises(ValueError, match="num_inference_steps >= 4"):
        JAX_REGISTRY["PNDM"]().set_timesteps(3)
    with pytest.raises(ValueError, match="num_inference_steps >= 4"):
        SCHEDULER_REGISTRY["PNDM"]().set_timesteps(3)


@pytest.mark.parametrize("first_index", [0, 2])
def test_dpm_loop_from_first_index_matches_jax(first_index):
    """The first executed step is first order, later ones second order, the
    last first order again.  The JAX side is handed a stale ``prev_x0`` at
    the first executed step, which it must not use."""
    steps = 6
    jsched, tsched = JAX_REGISTRY["DPM++"](), SCHEDULER_REGISTRY["DPM++"]()
    jstate, tstate = jsched.set_timesteps(steps), tsched.set_timesteps(steps)
    sample = _draws(4)[0]
    jx, jprev = jnp.asarray(sample), jnp.asarray(_draws(5)[0])
    tx, tprev = torch.from_numpy(sample), None
    for i in range(first_index, steps):
        jx, jprev = jsched.step(jstate, jnp.asarray(_model(np.asarray(jx), i)), i, jx,
                                prev_x0=jprev, num_steps=steps, first_index=first_index)
        tx, tprev = tsched.step(tstate, torch.from_numpy(_model(tx.numpy(), i)), i, tx,
                                prev_x0=tprev, num_steps=steps, first_index=first_index)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **LOOP_TOL, err_msg=f"step {i}")
