"""On the card: a cell's run at two layers and a small frame, every width as
published, through the port's kernels, comes out correct, and with its state
left unchanged by the step, not correct."""

import time

import pytest

from benchmark import harness
from benchmark.tests.conftest import NARROW, bench_with, cut

CELLS = {"int8_384.denoise": "tc5b-int8-384x672", "bf16_576.denoise": "tc5b-bf16-576x1024"}


def run(tmp_path, workload):
    bench = bench_with(tmp_path, workload, cut(CELLS[workload], **NARROW))
    return harness.run_cell(workload, 2 ** 33 + 5, 1.0, True, time.perf_counter(),
                            device="cuda", bench=bench)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_cell_on_the_card(cuda_card, tmp_path, workload):
    result = run(tmp_path, workload)
    assert result["correct"], result["check"]
    assert result["device"]["busy_s"] > 0 and result["metrics"]["attn_roofline.step"] < 105


@pytest.mark.cuda
def test_unchanged_state_on_the_card(cuda_card, tmp_path, monkeypatch):
    from benchmark.faults import state_unchanged

    state_unchanged(monkeypatch.setattr)
    assert not run(tmp_path, "bf16_576.denoise")["correct"]
