"""Noise-schedule construction shared by all samplers (numpy, host-side).

Counterpart of trajectorycrafter_tpu/schedulers/betas.py, which cannot be
imported from here: its package's ``__init__`` imports jax.  Implements
the beta schedules, the CogVideoX SNR shift and the zero-terminal-SNR
rescale used by the CogVideoX-Fun checkpoints (beta 0.00085->0.012
scaled_linear, snr_shift_scale 3.0, rescale_betas_zero_snr, v-prediction,
trailing spacing).
"""

from __future__ import annotations

import numpy as np


def make_betas(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
) -> np.ndarray:
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    if beta_schedule == "scaled_linear":
        return (
            np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64) ** 2
        )
    if beta_schedule == "squaredcos_cap_v2":
        t = np.arange(num_train_timesteps, dtype=np.float64)

        def bar(x):
            return np.cos((x / num_train_timesteps + 0.008) / 1.008 * np.pi / 2) ** 2

        return np.minimum(1 - bar(t + 1) / bar(t), 0.999)
    raise ValueError(f"unknown beta schedule {beta_schedule}")


def snr_shift(alphas_cumprod: np.ndarray, snr_shift_scale: float) -> np.ndarray:
    """CogVideoX SNR shift: abar <- abar / (s - (s-1) * abar)."""
    return alphas_cumprod / (snr_shift_scale - (snr_shift_scale - 1.0) * alphas_cumprod)


def rescale_zero_terminal_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    """Shift the sqrt(abar) schedule so the terminal step has zero SNR
    (Lin et al., 'Common Diffusion Noise Schedules ... are Flawed')."""
    abar_sqrt = np.sqrt(alphas_cumprod)
    a0 = abar_sqrt[0].copy()
    aT = abar_sqrt[-1].copy()
    abar_sqrt = abar_sqrt - aT
    abar_sqrt = abar_sqrt * a0 / (a0 - aT)
    return abar_sqrt**2


def spaced_timesteps(
    num_inference_steps: int,
    num_train_timesteps: int = 1000,
    spacing: str = "trailing",
    steps_offset: int = 0,
) -> np.ndarray:
    """Descending inference timesteps for 'leading'/'trailing'/'linspace'."""
    if spacing == "linspace":
        ts = np.linspace(0, num_train_timesteps - 1, num_inference_steps)
        ts = ts.round()[::-1].astype(np.int64)
    elif spacing == "leading":
        ratio = num_train_timesteps // num_inference_steps
        ts = (np.arange(num_inference_steps) * ratio).round()[::-1].astype(np.int64)
        ts = ts + steps_offset
    elif spacing == "trailing":
        ratio = num_train_timesteps / num_inference_steps
        ts = np.round(np.arange(num_train_timesteps, 0, -ratio)).astype(np.int64)
        ts = ts - 1
    else:
        raise ValueError(f"unknown timestep spacing {spacing}")
    return ts.copy()
