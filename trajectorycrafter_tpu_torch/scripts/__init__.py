"""Entry points of the port beside the CLI, one module per script of the
repository's root (``python -m trajectorycrafter_tpu_torch.scripts.<name>``),
with the root script's flags; each runs on the CUDA card."""
