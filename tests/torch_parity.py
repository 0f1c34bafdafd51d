"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Weights are drawn with numpy from a seed straight into a port module, then
turned into the JAX package's parameter tree by its own converter
(``utils/convert.py``); that tree goes back into a fresh port module through
``utils/weights.py`` in the tests.  Building the JAX tree this way costs no
flax ``init`` compile.
"""

import numpy as np
import torch

from trajectorycrafter_tpu_torch.ops.int8_matmul import ieee_div


@torch.no_grad()
def fill_from_numpy_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Weights N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2);
    the SVD blocks' spatial/temporal mix factors U(-1.5, 1.5), so that a
    blend taken the wrong way round cannot pass as sigmoid(0) = 1/2."""
    rng = np.random.default_rng(seed)
    for name, p in module.named_parameters():
        if name.endswith("mix_factor"):
            values = rng.uniform(-1.5, 1.5, p.shape)
        elif p.dim() >= 2:
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


def per_tensor_quantize_rows(x: torch.Tensor):
    """Planted fault for the int8 tests: one activation scale for the whole
    tensor in place of one per row (patched over
    ``ops.int8_matmul.quantize_rows_reference``)."""
    xf = x.float()
    xs = ieee_div(xf.abs().amax().clamp_min(1e-8), 127.0).expand(x.shape[0]).contiguous()
    return torch.clamp(torch.round(xf / xs[:, None]), -127, 127).to(torch.int8), xs
