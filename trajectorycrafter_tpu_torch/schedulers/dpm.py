"""DPM-Solver++ (2M) multistep sampler and its CogVideoX variant ('DPM++').

Counterpart of trajectorycrafter_tpu/schedulers/dpm.py
``DPMSolverMultistepScheduler`` and ``CogVideoXDPMScheduler``.  The
coefficients are precomputed on the host at ``set_timesteps`` into a
``DPMState`` of numpy arrays; ``step`` works in fp32 and returns the new
sample with this step's x0 prediction, which the caller passes back as
``prev_x0`` at the next step.  It is second order only: the JAX class's
``solver_order`` argument, which nothing sets, is not kept.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from trajectorycrafter_tpu_torch.schedulers.betas import (
    make_betas,
    rescale_zero_terminal_snr,
    snr_shift,
    spaced_timesteps,
)


class DPMState(NamedTuple):
    timesteps: np.ndarray  # (S,) int64, descending
    alpha_t: np.ndarray  # (S + 1,) float32 sqrt(abar) at each step boundary (last = 1)
    sigma_t: np.ndarray  # (S + 1,) float32 sqrt(1 - abar)
    lambda_t: np.ndarray  # (S + 1,) float32 log(alpha / sigma)
    alphas_cumprod: np.ndarray  # (T,) float32
    init_noise_sigma: float


class DPMSolverMultistepScheduler:
    """DPM-Solver++ 2M (midpoint, lower order at the last step), in the
    data-prediction form."""

    def __init__(
        self,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        beta_schedule: str = "scaled_linear",
        prediction_type: str = "v_prediction",
        timestep_spacing: str = "trailing",
        steps_offset: int = 0,
        rescale_betas_zero_snr: bool = True,
        snr_shift_scale: Optional[float] = None,
    ):
        if prediction_type not in ("epsilon", "v_prediction", "sample"):
            raise ValueError(f"unknown prediction_type {prediction_type!r}")
        self.num_train_timesteps = num_train_timesteps
        self.prediction_type = prediction_type
        self.timestep_spacing = timestep_spacing
        self.steps_offset = steps_offset
        betas = make_betas(num_train_timesteps, beta_start, beta_end, beta_schedule)
        abar = np.cumprod(1.0 - betas)
        if snr_shift_scale is not None:
            abar = snr_shift(abar, snr_shift_scale)
        if rescale_betas_zero_snr:
            abar = rescale_zero_terminal_snr(abar)
            abar[-1] = max(abar[-1], 2**-24)  # keeps lambda finite at the last step
        self.alphas_cumprod = abar.astype(np.float64)

    def set_timesteps(self, num_inference_steps: int) -> DPMState:
        ts = spaced_timesteps(num_inference_steps, self.num_train_timesteps,
                              self.timestep_spacing, self.steps_offset)
        abar = self.alphas_cumprod[ts]
        # the boundary after the last step: fully denoised
        alpha = np.concatenate([np.sqrt(abar), [1.0]])
        sigma = np.concatenate([np.sqrt(1 - abar), [1e-12]])
        lam = np.log(alpha) - np.log(np.maximum(sigma, 1e-12))
        return DPMState(
            timesteps=ts.astype(np.int64),
            alpha_t=alpha.astype(np.float32),
            sigma_t=sigma.astype(np.float32),
            lambda_t=lam.astype(np.float32),
            alphas_cumprod=self.alphas_cumprod.astype(np.float32),
            init_noise_sigma=1.0,
        )

    @staticmethod
    def num_loop_steps(num_inference_steps: int) -> int:
        return num_inference_steps

    @staticmethod
    def scale_model_input(state: DPMState, sample: torch.Tensor, i: int) -> torch.Tensor:
        return sample

    def _predict_x0(self, a: float, s: float, out: torch.Tensor, x: torch.Tensor):
        if self.prediction_type == "epsilon":
            return (x - s * out) / a
        if self.prediction_type == "v_prediction":
            return a * x - s * out
        return out  # "sample"

    def step(self, state: DPMState, model_output: torch.Tensor, i: int, sample: torch.Tensor,
             prev_x0: Optional[torch.Tensor] = None, num_steps: Optional[int] = None,
             first_index: int = 0):
        """One 2M update -> (new sample, x0).  ``prev_x0`` is the previous
        step's x0 (None at the first executed step).  The first executed
        step, ``first_index`` (the loop's start under img2img strength), is
        first order: the warm-up counts executed steps, not absolute
        indices.  With ``num_steps`` the last step is first order too."""
        x = sample.float()
        x0 = self._predict_x0(float(state.alpha_t[i]), float(state.sigma_t[i]),
                              model_output.float(), x)
        lam_s, lam_t = float(state.lambda_t[i]), float(state.lambda_t[i + 1])
        a_t, s_t, s_s = (float(state.alpha_t[i + 1]), float(state.sigma_t[i + 1]),
                         float(state.sigma_t[i]))
        h = lam_t - lam_s
        first_order = (s_t / s_s) * x - a_t * math.expm1(-h) * x0
        second = prev_x0 is not None and i > first_index and \
            (num_steps is None or i < num_steps - 1)
        if not second:
            return first_order.to(sample.dtype), x0
        r = (lam_s - float(state.lambda_t[max(i - 1, 0)])) / h
        d1 = (x0 - prev_x0.float()) / r
        return (first_order - 0.5 * a_t * math.expm1(-h) * d1).to(sample.dtype), x0

    def add_noise(self, state: DPMState, original: torch.Tensor, noise: torch.Tensor,
                  timestep) -> torch.Tensor:
        a = float(state.alphas_cumprod[int(timestep)])
        return math.sqrt(a) * original + math.sqrt(1.0 - a) * noise


class CogVideoXDPMScheduler(DPMSolverMultistepScheduler):
    """DPM++ with the CogVideoX SNR shift (the two-sample step interface of
    the reference denoise loop)."""

    def __init__(self, *args, snr_shift_scale: float = 3.0, **kwargs):
        super().__init__(*args, snr_shift_scale=snr_shift_scale, **kwargs)
