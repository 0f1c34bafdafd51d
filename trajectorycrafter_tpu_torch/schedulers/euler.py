"""Euler discrete and Euler ancestral samplers in the sigma parametrisation.

Counterpart of trajectorycrafter_tpu/schedulers/euler.py
``EulerDiscreteScheduler``, ``EulerAncestralDiscreteScheduler`` and
``karras_sigmas``.  The class serves two callers:

  * the sampler menu ('Euler', 'Euler A'), with the CogVideoX-Fun
    checkpoint's configuration (schedulers/__init__.py: trailing spacing,
    steps_offset 0, the zero-terminal-SNR rescale with the terminal
    abar = 2^-24, so sigma_max ~ 4,096 and ``init_noise_sigma`` equals it);
  * DepthCrafter, which inherits it from the SVD pipeline shell: continuous
    ``0.25 * log(sigma)`` timesteps, Karras sigma spacing, v-prediction
    (``svd_euler_scheduler`` in pipelines/depth.py holds that configuration).

The sigma tables are built on the host in float64 numpy, as the JAX package
builds them, and stored as float32; ``step`` works in fp32.

'Euler A' draws fresh noise at every step.  Its ``step`` takes that noise as
an explicit tensor: the pipeline draws it from its ``torch.Generator`` (or
takes it from ``ancestral_noise_override``).  The JAX package draws it with
``fold_in(step_key, i)``, which torch cannot replay, so a seeded 'Euler A'
run of the port differs from the JAX run by design; the two agree when both
are given the same noise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from trajectorycrafter_tpu_torch.schedulers.betas import (
    make_betas,
    rescale_zero_terminal_snr,
    spaced_timesteps,
)


class EulerState(NamedTuple):
    timesteps: np.ndarray  # (S,) float32 model-facing timesteps (may be continuous)
    sigmas: np.ndarray  # (S + 1,) float32, trailing zero
    init_noise_sigma: float
    alphas_cumprod: np.ndarray  # (T,) float32


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
        interpolation_type: str = "linear",  # 'linear' | 'log_linear'
        use_karras_sigmas: bool = False,
        sigma_min: Optional[float] = None,
        sigma_max: Optional[float] = None,
        steps_offset: int = 1,
        rescale_betas_zero_snr: bool = False,
    ):
        if prediction_type not in ("epsilon", "v_prediction", "sample"):
            raise ValueError(f"unknown prediction_type {prediction_type!r}")
        if interpolation_type not in ("linear", "log_linear"):
            raise ValueError(f"unknown interpolation_type {interpolation_type!r}")
        self.num_train_timesteps = num_train_timesteps
        self.prediction_type = prediction_type
        self.timestep_spacing = timestep_spacing
        self.timestep_type = timestep_type
        self.interpolation_type = interpolation_type
        self.use_karras_sigmas = use_karras_sigmas
        self.sigma_min = sigma_min
        self.sigma_max = sigma_max
        self.steps_offset = steps_offset
        betas = make_betas(num_train_timesteps, beta_start, beta_end, beta_schedule)
        abar = np.cumprod(1.0 - betas)
        if rescale_betas_zero_snr:
            # zero terminal SNR, with the terminal sigma kept finite
            abar = rescale_zero_terminal_snr(abar)
            abar[-1] = 2.0**-24
        self.alphas_cumprod = abar.astype(np.float64)
        self.train_sigmas = np.sqrt((1 - abar) / abar)

    def set_timesteps(self, num_inference_steps: int) -> EulerState:
        ts = spaced_timesteps(num_inference_steps, self.num_train_timesteps,
                              self.timestep_spacing, self.steps_offset).astype(np.float64)
        if self.interpolation_type == "linear":
            sigmas = np.interp(ts, np.arange(len(self.train_sigmas)), self.train_sigmas)
        else:  # log_linear
            sigmas = np.exp(np.linspace(np.log(self.train_sigmas[-1]),
                                        np.log(self.train_sigmas[0]),
                                        num_inference_steps + 1))[::-1][:num_inference_steps]
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
            alphas_cumprod=self.alphas_cumprod.astype(np.float32),
        )

    @staticmethod
    def num_loop_steps(num_inference_steps: int) -> int:
        return num_inference_steps

    @staticmethod
    def scale_model_input(state: EulerState, sample: torch.Tensor, i: int) -> torch.Tensor:
        sigma = float(state.sigmas[i])
        return sample / (sigma**2 + 1) ** 0.5

    def _denoised(self, sigma: float, out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if self.prediction_type == "epsilon":
            return x - sigma * out
        if self.prediction_type == "v_prediction":
            return out * (-sigma / (sigma**2 + 1) ** 0.5) + x / (sigma**2 + 1)
        return out  # "sample"

    def step(self, state: EulerState, model_output: torch.Tensor, i: int,
             sample: torch.Tensor) -> torch.Tensor:
        """x at sigmas[i] -> x at sigmas[i + 1], computed in fp32."""
        sigma, sigma_next = float(state.sigmas[i]), float(state.sigmas[i + 1])
        x = sample.float()
        denoised = self._denoised(sigma, model_output.float(), x)
        return (x + (x - denoised) / sigma * (sigma_next - sigma)).to(sample.dtype)

    def add_noise(self, state: EulerState, original: torch.Tensor, noise: torch.Tensor,
                  timestep) -> torch.Tensor:
        """x = x0 + sigma(t) * noise at a model-facing timestep value (the
        sigma looked up by timestep, as the other samplers' add_noise)."""
        t = float(timestep)
        if self.timestep_type == "continuous":
            sigma = float(np.exp(4.0 * t))  # t = 0.25 * log(sigma)
        else:
            sigma = float(np.interp(t, np.arange(len(self.train_sigmas)), self.train_sigmas))
        return original + sigma * noise


class EulerAncestralDiscreteScheduler(EulerDiscreteScheduler):
    """'Euler A': the stochastic sigma_up / sigma_down split of each step."""

    def step(self, state: EulerState, model_output: torch.Tensor, i: int,
             sample: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if noise is None:
            raise ValueError("Euler ancestral needs the step's noise")
        sigma, sigma_next = float(state.sigmas[i]), float(state.sigmas[i + 1])
        x = sample.float()
        denoised = self._denoised(sigma, model_output.float(), x)
        var_up = sigma_next**2 * (sigma**2 - sigma_next**2) / max(sigma**2, 1e-20)
        sigma_up = max(var_up, 0.0) ** 0.5
        sigma_down = max(sigma_next**2 - sigma_up**2, 0.0) ** 0.5
        prev = x + (x - denoised) / sigma * (sigma_down - sigma)
        return (prev + noise.float() * sigma_up).to(sample.dtype)
