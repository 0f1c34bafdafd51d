"""The six samplers of the ``--sampler_name`` menu.

Counterpart of trajectorycrafter_tpu/schedulers/__init__.py: the same names,
each mapped to a constructor with the CogVideoX-Fun checkpoint's scheduler
config.  'Euler' and 'Euler A' take the deployed settings (trailing
spacing, steps_offset 0, the zero-terminal-SNR rescale); the class defaults
stay generic because the depth stage reuses ``EulerDiscreteScheduler`` with
the SVD config (pipelines/depth.py ``svd_euler_scheduler``).
"""

from __future__ import annotations

from typing import Any, Protocol

import torch

from trajectorycrafter_tpu_torch.schedulers.ddim import CogVideoXDDIMScheduler, DDIMScheduler
from trajectorycrafter_tpu_torch.schedulers.dpm import (
    CogVideoXDPMScheduler,
    DPMSolverMultistepScheduler,
)
from trajectorycrafter_tpu_torch.schedulers.euler import (
    EulerAncestralDiscreteScheduler,
    EulerDiscreteScheduler,
)
from trajectorycrafter_tpu_torch.schedulers.pndm import PNDMScheduler


class Scheduler(Protocol):
    """What the denoise loop calls on a sampler.  ``step`` takes more
    arguments for some samplers: DPM++ the previous x0, Euler A the step's
    noise, PNDM its loop state (pipelines/trajcrafter.py)."""

    def set_timesteps(self, num_inference_steps: int) -> Any: ...

    def num_loop_steps(self, num_inference_steps: int) -> int: ...

    def scale_model_input(self, state: Any, sample: torch.Tensor, i: int) -> torch.Tensor: ...

    def step(self, state: Any, model_output: torch.Tensor, i: int, sample: torch.Tensor,
             *args, **kwargs) -> Any: ...

    def add_noise(self, state: Any, original: torch.Tensor, noise: torch.Tensor,
                  timestep) -> torch.Tensor: ...


def _euler_deployed() -> EulerDiscreteScheduler:
    return EulerDiscreteScheduler(timestep_spacing="trailing", steps_offset=0,
                                  rescale_betas_zero_snr=True)


def _euler_a_deployed() -> EulerAncestralDiscreteScheduler:
    return EulerAncestralDiscreteScheduler(timestep_spacing="trailing", steps_offset=0,
                                           rescale_betas_zero_snr=True)


SCHEDULER_REGISTRY = {
    "Euler": _euler_deployed,
    "Euler A": _euler_a_deployed,
    "DPM++": DPMSolverMultistepScheduler,
    "PNDM": PNDMScheduler,
    "DDIM_Cog": CogVideoXDDIMScheduler,
    "DDIM_Origin": DDIMScheduler,
}

__all__ = ["SCHEDULER_REGISTRY", "Scheduler", "CogVideoXDDIMScheduler", "CogVideoXDPMScheduler",
           "DDIMScheduler", "DPMSolverMultistepScheduler", "EulerAncestralDiscreteScheduler",
           "EulerDiscreteScheduler", "PNDMScheduler"]
