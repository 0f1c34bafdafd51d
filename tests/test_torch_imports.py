"""Importing the PyTorch port never imports jax (nor triton, nor builds a kernel).

Runs in a fresh interpreter: this test process has jax loaded already
(tests/conftest.py).  The port may import the JAX package's JAX-free host
modules (config, cli, utils/video), so the check is on ``sys.modules``.
"""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import trajectorycrafter_tpu_torch

REPO = Path(__file__).resolve().parents[1]


def test_port_modules_import_without_jax():
    modules = sorted(m.name for m in pkgutil.walk_packages(
        trajectorycrafter_tpu_torch.__path__, "trajectorycrafter_tpu_torch."))
    for name in ("ops.kernels", "cli", "models.depthcrafter", "models.svd_vae", "models.clip",
                 "models.t5", "pipelines.depth", "schedulers.euler", "ops.resize",
                 "ops.int8", "ops.int8_matmul", "utils.quality"):
        assert f"trajectorycrafter_tpu_torch.{name}" in modules
    code = (
        "import importlib, json, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps(sorted(m for m in ('jax', 'jaxlib', 'flax', 'triton') "
        "if m in sys.modules)))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
