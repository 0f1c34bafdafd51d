"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU (every width as published, two layers, a small frame, no
warm-up calls), with the cell's own limits.  The faults a denoise cell can have: a step that returns
its state unchanged; half of the CFG batch left out, the kept half standing
in for the whole; an answer altered where it is produced.  The exchange
between chips is not a fault of a one-card cell."""

import time

import pytest

from benchmark import harness
from benchmark.faults import FAULTS
from benchmark.tests.conftest import NARROW, bench_with, cut

CELLS = {"int8_384.denoise": "tc5b-int8-384x672", "bf16_576.denoise": "tc5b-bf16-576x1024"}


def run(tmp_path, workload, monkeypatch):
    mix_of = harness.mix_of
    monkeypatch.setattr(harness, "mix_of", lambda name: dict(mix_of(name), warmup_calls=0))
    bench = bench_with(tmp_path, workload, cut(CELLS[workload], **NARROW))
    return harness.run_cell(workload, 2 ** 40 + 9, 0.01, False, time.perf_counter(),
                            device="cpu", bench=bench)


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct(tmp_path, monkeypatch, workload):
    result = run(tmp_path, workload, monkeypatch)
    assert result["correct"], result["check"]


@pytest.mark.parametrize("workload", sorted(CELLS))
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(tmp_path, monkeypatch, workload, fault):
    FAULTS[fault](monkeypatch.setattr)
    result = run(tmp_path, workload, monkeypatch)
    assert not result["correct"], result["check"]
