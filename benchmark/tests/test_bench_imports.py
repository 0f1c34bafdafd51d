"""Nothing under benchmark/ imports the JAX stack or the JAX package (top-level
names compared whole), and the reference imports nothing of the program."""

import ast
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT

FILES = sorted((ROOT / "benchmark").rglob("*.py"))


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not imported(path) & {"jax", "jaxlib", "flax", "trajectorycrafter_tpu"}


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    assert "trajectorycrafter_tpu_torch" not in imported(path)


def test_loaded_modules():
    code = ("import sys; sys.path.insert(0, '.');"
            "import benchmark.reference.step, benchmark.weights, benchmark.work;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert "trajectorycrafter_tpu_torch" not in out and "'jax'" not in out
