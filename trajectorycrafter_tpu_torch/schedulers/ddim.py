"""DDIM sampler ('DDIM_Origin', diffusers DDIMScheduler semantics).

Counterpart of trajectorycrafter_tpu/schedulers/ddim.py ``DDIMScheduler``.
The per-step coefficients are precomputed on the host at ``set_timesteps``
into a ``DDIMState`` of numpy arrays; ``step`` is deterministic (eta = 0,
the reference default) and works in fp32.  Like the JAX package, plain DDIM
ignores the checkpoint's ``snr_shift_scale`` (only the Cog variant, not
ported yet, applies it).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from trajectorycrafter_tpu_torch.schedulers.betas import (
    make_betas,
    rescale_zero_terminal_snr,
    spaced_timesteps,
)


class DDIMState(NamedTuple):
    timesteps: np.ndarray  # (S,) int64, descending
    alpha_prod_t: np.ndarray  # (S,) float32
    alpha_prod_prev: np.ndarray  # (S,) float32
    alphas_cumprod: np.ndarray  # (T,) float32 full table (add_noise / img2img)
    init_noise_sigma: float


class DDIMScheduler:
    """diffusers-compatible DDIM; prediction_type epsilon|v_prediction|sample."""

    def __init__(
        self,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        beta_schedule: str = "scaled_linear",
        clip_sample: bool = False,
        clip_sample_range: float = 1.0,
        set_alpha_to_one: bool = True,
        steps_offset: int = 0,
        prediction_type: str = "v_prediction",
        timestep_spacing: str = "trailing",
        rescale_betas_zero_snr: bool = True,
    ):
        if prediction_type not in ("epsilon", "v_prediction", "sample"):
            raise ValueError(f"unknown prediction_type {prediction_type!r}")
        self.num_train_timesteps = num_train_timesteps
        self.clip_sample = clip_sample
        self.clip_sample_range = clip_sample_range
        self.steps_offset = steps_offset
        self.prediction_type = prediction_type
        self.timestep_spacing = timestep_spacing

        betas = make_betas(num_train_timesteps, beta_start, beta_end, beta_schedule)
        alphas_cumprod = np.cumprod(1.0 - betas)
        if rescale_betas_zero_snr:
            alphas_cumprod = rescale_zero_terminal_snr(alphas_cumprod)
        self.alphas_cumprod = alphas_cumprod.astype(np.float32)
        self.final_alpha_cumprod = 1.0 if set_alpha_to_one else float(alphas_cumprod[0])

    def set_timesteps(self, num_inference_steps: int) -> DDIMState:
        ts = spaced_timesteps(num_inference_steps, self.num_train_timesteps,
                              self.timestep_spacing, self.steps_offset)
        prev_ts = ts - self.num_train_timesteps // num_inference_steps
        alpha_prev = np.where(prev_ts >= 0,
                              self.alphas_cumprod[np.clip(prev_ts, 0, None)],
                              self.final_alpha_cumprod)
        return DDIMState(
            timesteps=ts.astype(np.int64),
            alpha_prod_t=self.alphas_cumprod[ts].astype(np.float32),
            alpha_prod_prev=alpha_prev.astype(np.float32),
            alphas_cumprod=self.alphas_cumprod,
            init_noise_sigma=1.0,
        )

    def _predict_x0_eps(self, a_t: float, model_output, sample):
        b_t = 1.0 - a_t
        if self.prediction_type == "epsilon":
            x0 = (sample - math.sqrt(b_t) * model_output) / math.sqrt(a_t)
            eps = model_output
        elif self.prediction_type == "v_prediction":
            x0 = math.sqrt(a_t) * sample - math.sqrt(b_t) * model_output
            eps = math.sqrt(a_t) * model_output + math.sqrt(b_t) * sample
        else:  # "sample"
            x0 = model_output
            eps = (sample - math.sqrt(a_t) * x0) / math.sqrt(b_t)
        if self.clip_sample:
            x0 = x0.clamp(-self.clip_sample_range, self.clip_sample_range)
            eps = (sample - math.sqrt(a_t) * x0) / math.sqrt(b_t)
        return x0, eps

    def step(self, state: DDIMState, model_output: torch.Tensor, i: int,
             sample: torch.Tensor) -> torch.Tensor:
        """x_t -> x_{t-1} at step index ``i`` (eta = 0), computed in fp32."""
        a_t = float(state.alpha_prod_t[i])
        a_prev = float(state.alpha_prod_prev[i])
        x0, eps = self._predict_x0_eps(a_t, model_output.float(), sample.float())
        prev = math.sqrt(a_prev) * x0 + math.sqrt(1.0 - a_prev) * eps
        return prev.to(sample.dtype)

    def add_noise(self, state: DDIMState, original: torch.Tensor, noise: torch.Tensor,
                  timestep: int) -> torch.Tensor:
        a = float(state.alphas_cumprod[timestep])
        return math.sqrt(a) * original + math.sqrt(1.0 - a) * noise
