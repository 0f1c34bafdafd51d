"""Plain reference of the sampling step the denoise mix times: the CFG pair
through the reference DiT, the guidance combine, and DDIM_Origin's update
(diffusers DDIMScheduler with the CogVideoX-Fun checkpoint's settings:
scaled-linear betas 0.00085 -> 0.012 over 1,000 steps, rescaled to zero
terminal SNR, trailing spacing, v-prediction, eta 0, the final alpha 1).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.dit import ReferenceDiT


def ddim_origin_tables(num_steps: int, train_steps: int = 1000):
    """-> (timesteps, alpha_cumprod at each, alpha_cumprod at the previous one)."""
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, train_steps, dtype=np.float64) ** 2
    root = np.sqrt(np.cumprod(1.0 - betas))
    first, last = root[0].copy(), root[-1].copy()
    alphas = (((root - last) * first / (first - last)) ** 2).astype(np.float32)
    steps = np.round(np.arange(train_steps, 0, -train_steps / num_steps)).astype(np.int64) - 1
    prev = steps - train_steps // num_steps
    alpha_prev = np.where(prev >= 0, alphas[np.clip(prev, 0, None)], 1.0).astype(np.float32)
    return steps, alphas[steps], alpha_prev


@torch.no_grad()
def cfg_ddim_step(model: ReferenceDiT, latents, index: int, text, negative, inpaint, reference,
                  rope, guidance=None):
    """Latents (1, F, H, W, C) at loop entry ``index`` of the configuration's
    schedule -> (the latents after that step, the guidance term), float32.

    The guidance term is the part of the new latents that the guidance adds
    to the conditional branch alone: the update's coefficient on the model's
    output times (scale - 1) (cond - uncond).  ``guidance``, the term of the
    steps before, is carried on by this step's coefficient on the latents."""
    cfg = model.cfg
    steps, alpha, alpha_prev = ddim_origin_tables(cfg["num_inference_steps"])
    t = float(steps[index])
    a, a_prev = float(alpha[index]), float(alpha_prev[index])
    x = latents.float()
    out = model.forward(torch.cat([x, x]), torch.cat([negative, text]),
                        torch.full((2,), t, device=x.device), torch.cat([inpaint, inpaint]),
                        torch.cat([reference, reference]), rope)
    uncond, cond = out.chunk(2)
    scale = cfg["guidance_scale"]
    v = uncond + scale * (cond - uncond)
    x0 = math.sqrt(a) * x - math.sqrt(1.0 - a) * v
    eps = math.sqrt(a) * v + math.sqrt(1.0 - a) * x
    on_x = math.sqrt(a_prev * a) + math.sqrt((1.0 - a_prev) * (1.0 - a))
    on_v = math.sqrt((1.0 - a_prev) * a) - math.sqrt(a_prev * (1.0 - a))
    term = on_v * (scale - 1.0) * (cond - uncond)
    if guidance is not None:
        term = term + on_x * guidance
    return math.sqrt(a_prev) * x0 + math.sqrt(1.0 - a_prev) * eps, term
