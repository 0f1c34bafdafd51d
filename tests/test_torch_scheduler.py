"""Port DDIM_Origin (trajectorycrafter_tpu_torch/schedulers/ddim.py) vs JAX.

Same schedule tables (timesteps exactly, coefficients to fp32 rounding) and
the same step / add_noise on numpy inputs.  Tolerance 1e-6 absolute and
relative: both sides are fp32 elementwise arithmetic; the port takes its
square roots of the fp32 coefficients in double before the fp32 multiply.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from trajectorycrafter_tpu.schedulers.ddim import DDIMScheduler as JaxDDIM
from trajectorycrafter_tpu_torch.schedulers.ddim import DDIMScheduler

torch.set_num_threads(1)
TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("steps", [2, 50])
def test_schedule_tables_match_jax(steps):
    want = JaxDDIM().set_timesteps(steps)
    got = DDIMScheduler().set_timesteps(steps)
    np.testing.assert_array_equal(got.timesteps, np.asarray(want.timesteps))
    np.testing.assert_array_equal(got.alpha_prod_t, np.asarray(want.alpha_prod_t))
    np.testing.assert_array_equal(got.alpha_prod_prev, np.asarray(want.alpha_prod_prev))
    np.testing.assert_array_equal(got.alphas_cumprod, np.asarray(want.alphas_cumprod))


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
