"""Command line for the PyTorch port: ``python -m trajectorycrafter_tpu_torch.cli``.

Takes the JAX package's flag surface and validation (``get_parser``,
``config_from_args``, ``validate`` in trajectorycrafter_tpu/cli.py, which
import no jax) and runs the port's ``TrajCrafter`` on the CUDA card.
"""

from __future__ import annotations

import os

import torch

from trajectorycrafter_tpu.cli import config_from_args, get_parser, validate
from trajectorycrafter_tpu.config import TrajCrafterConfig
from trajectorycrafter_tpu_torch.orchestrator import TrajCrafter, check_supported


def parse_config(argv=None) -> TrajCrafterConfig:
    """A validated config from a command line; raises for what the port does
    not run yet, before anything is built (int8 never becomes bf16)."""
    cfg = config_from_args(get_parser().parse_args(argv))
    validate(cfg)
    check_supported(cfg)
    return cfg


def main(argv=None) -> None:
    cfg = parse_config(argv)
    if not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device is available; the port runs on a CUDA card")
    os.makedirs(cfg.save_dir, exist_ok=True)
    tc = TrajCrafter(cfg)
    modes = {"gradual": tc.infer_gradual, "direct": tc.infer_direct,
             "bullet": tc.infer_bullet, "zoom": tc.infer_zoom}
    modes[cfg.render.mode]()
    print(f"outputs written to {cfg.save_dir}")


if __name__ == "__main__":
    main()
