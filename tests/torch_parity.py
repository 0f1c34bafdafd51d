"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Weights are drawn with numpy from a seed straight into a port module, then
turned into the JAX package's parameter tree by its own converter
(``utils/convert.py``); that tree goes back into a fresh port module through
``utils/weights.py`` in the tests.  Building the JAX tree this way costs no
flax ``init`` compile.
"""

import numpy as np
import torch


@torch.no_grad()
def fill_from_numpy_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Weights N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    for name, p in module.named_parameters():
        if p.dim() >= 2:
            values = rng.standard_normal(p.shape) / np.sqrt(p[0].numel())
        elif name.endswith("weight"):
            values = 1.0 + 0.1 * rng.standard_normal(p.shape)
        else:
            values = 0.1 * rng.standard_normal(p.shape)
        p.copy_(torch.from_numpy(values.astype(np.float32)))
    return module


def jax_tree(module: torch.nn.Module, seed: int, convert, **convert_kwargs):
    """Seeded weights for ``module``'s architecture as a JAX parameter tree."""
    fill_from_numpy_(module, seed)
    sd = {k: v.numpy() for k, v in module.state_dict().items()}
    return convert(sd, **convert_kwargs)
