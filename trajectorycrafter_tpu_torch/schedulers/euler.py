"""Euler discrete sampler in the sigma parametrisation.

Counterpart of trajectorycrafter_tpu/schedulers/euler.py
``EulerDiscreteScheduler`` and ``karras_sigmas``, as DepthCrafter inherits
it from the SVD pipeline shell: continuous ``0.25 * log(sigma)`` timesteps,
Karras sigma spacing, v-prediction (``svd_euler_scheduler`` in
pipelines/depth.py holds that configuration).  The sigma tables are built
on the host in float64 numpy, as the JAX package builds them, and stored
as float32; ``step`` works in fp32.  The ancestral variant ('Euler A') is
not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from trajectorycrafter_tpu_torch.schedulers.betas import make_betas, spaced_timesteps


class EulerState(NamedTuple):
    timesteps: np.ndarray  # (S,) float32 model-facing timesteps (may be continuous)
    sigmas: np.ndarray  # (S + 1,) float32, trailing zero
    init_noise_sigma: float


def karras_sigmas(sigma_min: float, sigma_max: float, n: int, rho: float = 7.0) -> np.ndarray:
    ramp = np.linspace(0, 1, n)
    inv_rho = 1.0 / rho
    return (sigma_max**inv_rho + ramp * (sigma_min**inv_rho - sigma_max**inv_rho)) ** rho


class EulerDiscreteScheduler:
    def __init__(
        self,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        beta_schedule: str = "scaled_linear",
        prediction_type: str = "v_prediction",
        timestep_spacing: str = "leading",
        timestep_type: str = "discrete",  # 'discrete' | 'continuous' (SVD)
        use_karras_sigmas: bool = False,
        sigma_min: Optional[float] = None,
        sigma_max: Optional[float] = None,
        steps_offset: int = 1,
    ):
        if prediction_type not in ("epsilon", "v_prediction", "sample"):
            raise ValueError(f"unknown prediction_type {prediction_type!r}")
        self.num_train_timesteps = num_train_timesteps
        self.prediction_type = prediction_type
        self.timestep_spacing = timestep_spacing
        self.timestep_type = timestep_type
        self.use_karras_sigmas = use_karras_sigmas
        self.sigma_min = sigma_min
        self.sigma_max = sigma_max
        self.steps_offset = steps_offset
        betas = make_betas(num_train_timesteps, beta_start, beta_end, beta_schedule)
        abar = np.cumprod(1.0 - betas)
        self.train_sigmas = np.sqrt((1 - abar) / abar)

    def set_timesteps(self, num_inference_steps: int) -> EulerState:
        ts = spaced_timesteps(num_inference_steps, self.num_train_timesteps,
                              self.timestep_spacing, self.steps_offset).astype(np.float64)
        # linear interpolation of the training sigmas at the spaced timesteps
        sigmas = np.interp(ts, np.arange(len(self.train_sigmas)), self.train_sigmas)
        if self.use_karras_sigmas:
            smin = self.sigma_min if self.sigma_min is not None else float(sigmas[-1])
            smax = self.sigma_max if self.sigma_max is not None else float(sigmas[0])
            sigmas = karras_sigmas(smin, smax, num_inference_steps)
            # map back to (possibly fractional) training timesteps
            log_train = np.log(self.train_sigmas)
            ts = np.array([np.interp(np.log(s), log_train, np.arange(len(log_train)))
                           for s in sigmas])
        timesteps = 0.25 * np.log(sigmas) if self.timestep_type == "continuous" else ts
        if self.timestep_spacing in ("linspace", "trailing"):
            init_noise_sigma = float(sigmas.max())
        else:
            init_noise_sigma = float((sigmas.max() ** 2 + 1) ** 0.5)
        return EulerState(
            timesteps=np.asarray(timesteps, np.float32),
            sigmas=np.concatenate([sigmas, [0.0]]).astype(np.float32),
            init_noise_sigma=float(np.float32(init_noise_sigma)),
        )

    @staticmethod
    def scale_model_input(state: EulerState, sample: torch.Tensor, i: int) -> torch.Tensor:
        sigma = float(state.sigmas[i])
        return sample / (sigma**2 + 1) ** 0.5

    def step(self, state: EulerState, model_output: torch.Tensor, i: int,
             sample: torch.Tensor) -> torch.Tensor:
        """x at sigmas[i] -> x at sigmas[i + 1], computed in fp32."""
        sigma, sigma_next = float(state.sigmas[i]), float(state.sigmas[i + 1])
        x, out = sample.float(), model_output.float()
        if self.prediction_type == "epsilon":
            denoised = x - sigma * out
        elif self.prediction_type == "v_prediction":
            denoised = out * (-sigma / (sigma**2 + 1) ** 0.5) + x / (sigma**2 + 1)
        else:  # "sample"
            denoised = out
        return (x + (x - denoised) / sigma * (sigma_next - sigma)).to(sample.dtype)
