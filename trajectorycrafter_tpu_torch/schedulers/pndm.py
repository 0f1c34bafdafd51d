"""PNDM sampler: a pseudo Runge-Kutta warm-up, then linear multistep (PLMS).

Counterpart of trajectorycrafter_tpu/schedulers/pndm.py ``PNDMScheduler``
('PNDM' of the sampler menu).  The CogVideoX-Fun checkpoint's scheduler
config has no ``skip_prk_steps`` key, so the deployed sampler takes the
diffusers default (False) and runs the full pseudo-RK4 warm-up: 3 RK steps
of 4 model calls over the first schedule intervals, then 4th-order
Adams-Bashforth.  A run of S steps makes ``num_loop_steps(S) = 12 + (S - 3)``
model calls, and needs S >= 4.  The JAX class also offers
``skip_prk_steps=True`` (a PLMS-only warm-up); nothing deploys it, and the
port does not keep it.

As in diffusers and the JAX package, the multistep and RK combinations are
taken on the raw model outputs, and v-prediction is converted to epsilon
once, inside the x_{t-1} formula, at the entry's effective timestep with
the integration-base sample.  The loop carries a small ``PNDMLoopState``;
``step`` returns the new sample and the new loop state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from trajectorycrafter_tpu_torch.schedulers.betas import make_betas, spaced_timesteps

PRK_CALLS = 12  # 3 pseudo-RK4 steps x 4 model calls


class PNDMState(NamedTuple):
    timesteps: np.ndarray  # (L,) int64 model-facing timestep of each loop entry
    alpha_prod_t: np.ndarray  # (L,) float32 abar at each entry's effective timestep
    alpha_prod_prev: np.ndarray  # (L,) float32 abar at that entry's target timestep
    alphas_cumprod: np.ndarray  # (T,) float32
    init_noise_sigma: float


class PNDMLoopState(NamedTuple):
    ets: torch.Tensor  # (4, *shape) raw model-output history, newest last
    counter: int  # model calls done
    cur_sample: torch.Tensor  # the stashed integration-base sample
    acc: torch.Tensor  # the RK accumulator


class PNDMScheduler:
    def __init__(
        self,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        beta_schedule: str = "scaled_linear",
        prediction_type: str = "v_prediction",
        timestep_spacing: str = "trailing",
        steps_offset: int = 0,
        set_alpha_to_one: bool = True,
    ):
        if prediction_type not in ("epsilon", "v_prediction"):
            raise ValueError(f"unknown prediction_type {prediction_type!r}")
        self.num_train_timesteps = num_train_timesteps
        self.prediction_type = prediction_type
        self.timestep_spacing = timestep_spacing
        self.steps_offset = steps_offset
        betas = make_betas(num_train_timesteps, beta_start, beta_end, beta_schedule)
        self.alphas_cumprod = np.cumprod(1.0 - betas).astype(np.float64)
        self.final_alpha_cumprod = 1.0 if set_alpha_to_one else float(self.alphas_cumprod[0])

    def set_timesteps(self, num_inference_steps: int) -> PNDMState:
        base = spaced_timesteps(num_inference_steps, self.num_train_timesteps,
                                self.timestep_spacing, self.steps_offset)  # descending
        if num_inference_steps < 4:
            raise ValueError("PRK warmup needs num_inference_steps >= 4")
        delta = self.num_train_timesteps // num_inference_steps
        asc = base[::-1]
        delta2 = delta // 2
        # the last 4 ascending timesteps -> 12 RK calls
        prk = np.repeat(asc[-4:], 2) + np.tile(np.array([0, delta2]), 4)
        prk = np.repeat(prk[:-1], 2)[1:-1][::-1].copy()
        plms = asc[:-3][::-1].copy()
        ts = np.concatenate([prk, plms])
        src, tgt = ts.copy(), np.empty_like(ts)
        for i in range(PRK_CALLS):
            # an RK call's effective t is its RK step's start; its target
            # alternates half step / hold
            src[i] = prk[(i // 4) * 4]
            tgt[i] = prk[i] - (delta2 if i % 2 == 0 else 0)
        tgt[PRK_CALLS:] = plms - delta
        alpha_prev = np.where(tgt >= 0, self.alphas_cumprod[np.clip(tgt, 0, None)],
                              self.final_alpha_cumprod)
        return PNDMState(
            timesteps=ts.astype(np.int64),
            alpha_prod_t=self.alphas_cumprod[src].astype(np.float32),
            alpha_prod_prev=alpha_prev.astype(np.float32),
            alphas_cumprod=self.alphas_cumprod.astype(np.float32),
            init_noise_sigma=1.0,
        )

    @staticmethod
    def num_loop_steps(num_inference_steps: int) -> int:
        return PRK_CALLS + (num_inference_steps - 3)

    @staticmethod
    def init_loop_state(sample: torch.Tensor) -> PNDMLoopState:
        """The loop state before the first call, fp32 like ``sample``'s shape."""
        zeros = torch.zeros(sample.shape, dtype=torch.float32, device=sample.device)
        return PNDMLoopState(ets=torch.zeros((4, *sample.shape), dtype=torch.float32,
                                             device=sample.device),
                             counter=0, cur_sample=zeros, acc=zeros)

    @staticmethod
    def scale_model_input(state: PNDMState, sample: torch.Tensor, i: int) -> torch.Tensor:
        return sample

    def _prev_sample(self, state: PNDMState, sample, i: int, model_output):
        """x_{t-1} (diffusers ``_get_prev_sample``), converting v-prediction
        once at the effective timestep with the base sample."""
        a_t, a_prev = float(state.alpha_prod_t[i]), float(state.alpha_prod_prev[i])
        b_t, b_prev = 1.0 - a_t, 1.0 - a_prev
        if self.prediction_type == "v_prediction":
            model_output = a_t**0.5 * model_output + b_t**0.5 * sample
        sample_coeff = (a_prev / a_t) ** 0.5
        denom = a_t * b_prev**0.5 + (a_t * b_t * a_prev) ** 0.5
        return sample_coeff * sample - (a_prev - a_t) * model_output / denom

    def step(self, state: PNDMState, model_output: torch.Tensor, i: int,
             sample: torch.Tensor, loop: PNDMLoopState):
        """Loop entry ``i`` (of ``num_loop_steps``) -> (new sample, new loop state)."""
        x, mo = sample.float(), model_output.float()
        n = loop.counter
        pushed = lambda: torch.cat([loop.ets[1:], mo[None]], dim=0)
        if n < PRK_CALLS:  # the pseudo-RK4 warm-up
            m = n % 4
            ets = pushed() if m == 0 else loop.ets  # one push per RK step
            # the accumulator: +1/6, +1/3, +1/3, +1/6; at m == 3 it holds the
            # RK4 combination, and resets
            acc = loop.acc + (mo / 6.0 if m in (0, 3) else mo / 3.0)
            cur_sample = x if m == 0 else loop.cur_sample
            prev = self._prev_sample(state, cur_sample, i, acc if m == 3 else mo)
            acc = torch.zeros_like(acc) if m == 3 else acc
            return prev.to(sample.dtype), PNDMLoopState(ets, n + 1, cur_sample, acc)

        ets = pushed()
        e1, e2, e3, e4 = ets[3], ets[2], ets[1], ets[0]
        combo = (55 * e1 - 59 * e2 + 37 * e3 - 9 * e4) / 24.0
        prev = self._prev_sample(state, x, i, combo)
        return prev.to(sample.dtype), PNDMLoopState(ets, n + 1, loop.cur_sample, loop.acc)

    def add_noise(self, state: PNDMState, original: torch.Tensor, noise: torch.Tensor,
                  timestep) -> torch.Tensor:
        a = float(state.alphas_cumprod[int(timestep)])
        return a**0.5 * original + (1.0 - a) ** 0.5 * noise
