"""The PyTorch port stands alone: importing it loads no jax (nor triton), no
module of the JAX package, and builds no kernel.

Runs in a fresh interpreter: this test process has jax and the JAX package
loaded already (tests/conftest.py and the other tests), so the check is on
``sys.modules`` after importing every module of the port.  The port's
scripts outside the package (``chip_smoke.py``, ``tools/profile_dit_step.py``,
``tools/int8_gemm_ab.py``, ``tools/flash_pv8_ab.py``,
``tools/int8_attention_ab.py``, ``tools/flash_bwd_ab.py``) are checked statically:
no import statement of theirs names jax or the JAX package.
"""

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import trajectorycrafter_tpu_torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "triton", "trajectorycrafter_tpu")


def test_port_modules_import_without_jax():
    modules = sorted(m.name for m in pkgutil.walk_packages(
        trajectorycrafter_tpu_torch.__path__, "trajectorycrafter_tpu_torch."))
    for name in ("ops.kernels", "cli", "config", "utils.video", "models.depthcrafter",
                 "models.svd_vae", "models.clip", "models.t5", "pipelines.depth",
                 "schedulers.euler", "ops.resize", "ops.int8", "ops.int8_matmul",
                 "ops.attention_variants", "bench_attention", "utils.quality",
                 "utils.checkpoints", "utils.tokenizer", "utils.bpe", "utils.caption",
                 "models.blip2", "ops.morphology", "schedulers", "schedulers.dpm",
                 "schedulers.pndm", "geometry.warper", "geometry.pointcloud",
                 "geometry.interpolate", "utils.export", "autoregressive", "known_poses",
                 "scripts.inference_autoregressive", "scripts.autoregressive_global",
                 "scripts.run_w_cam_poses", "scripts.inference_orbits", "models.vda",
                 "depth_alignment", "consistent_autoregressive",
                 "scripts.inference_alignment", "scripts.gradio_app", "training",
                 "training.lora", "training.step", "training.data", "training.validation",
                 "datagen", "scripts.train_lora"):
        assert f"trajectorycrafter_tpu_torch.{name}" in modules
    code = (
        "import importlib, json, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        f"print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def _imported_roots(path: Path) -> set:
    """The top-level package of every import statement in ``path``."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("script", ["chip_smoke.py", "tools/profile_dit_step.py",
                                    "tools/int8_gemm_ab.py", "tools/flash_pv8_ab.py",
                                    "tools/int8_attention_ab.py", "tools/flash_bwd_ab.py"])
def test_port_scripts_import_neither_jax_nor_the_jax_package(script):
    roots = _imported_roots(REPO / script)
    assert "trajectorycrafter_tpu_torch" in roots or "torch" in roots
    assert not roots & set(FORBIDDEN), roots & set(FORBIDDEN)
