"""The readers of the program's spans (benchmark/spans.py and the metrics
that use it) on a synthetic trace and span record: known values in, None
where the record holds another number of ``sampler.step`` calls than the
traced units or the program has no tracer, the program's idle within the
trace's; and once through a whole traced run on the CPU at tiny widths."""

import time

import pytest

from benchmark import harness, spans, work
from benchmark.harness import Context
from benchmark.tests.conftest import TINY, bench_with, cut
from benchmark.trace import Trace

CELL, CONFIG = "int8_384.denoise", "tc5b-int8-384x672"
RECORD = ["sampler_ms.step", "dit_norm_ms.step", "dit_attn_prep_ms.step",
          "dit_other_span_ms.step", "attn_span_roofline.step", "linear_span_roofline.step"]
HOST = ["host_enqueue_ms.step", "program_idle_ms.step"]
MS = 1_000_000  # ns


def reader(name):
    return harness.load_file(harness.BENCH_DIR / "metrics" / f"{name}.py", f"m_{name}").read


def record(steps):
    """Self seconds and calls of ``steps`` traced steps (a step: 1 ms of
    sampler, 2 of norms, 3 of attention prep, 4 of the other dit.* spans,
    8 of attention, 16 of linears)."""
    per_step = {"sampler.step": (1e-3, 1), "dit.norm": (2e-3, 106), "dit.joint_attn": (2e-3, 42),
                "dit.perceiver": (1e-3, 21), "dit.block": (3e-3, 42), "dit.forward": (5e-4, 1),
                "dit.embed": (5e-4, 1), "attention": (8e-3, 63), "linear": (16e-3, 404)}
    return {name: (s * steps, n * steps) for name, (s, n) in per_step.items()}


US = 1_000  # ns


def trace(steps):
    """Two steps of 40 ms, each in a host ``sampler.step`` range; each step's
    device busy but a 1 ms gap in its middle; a 2 ms gap between the steps,
    while the host is outside any step.  In each step the host launches once
    in the gap (10 us: a launch's own cost), once into a full queue (5 ms:
    4.99 ms of waiting, a driver call nested in it) and copies once (its
    name's only cost, 0.5 ms); outside the steps it launches once more."""
    device, host = [], []
    for i in range(steps):
        t0 = i * 42 * MS
        host += [("sampler.step", t0, t0 + 40 * MS),
                 ("aten::addmm", t0 + 5 * MS, t0 + 6 * MS),
                 ("cudaLaunchKernel", t0 + 20 * MS + 200 * US, t0 + 20 * MS + 210 * US),
                 ("cudaLaunchKernel", t0 + 30 * MS, t0 + 35 * MS),
                 ("cuLaunchKernel", t0 + 31 * MS, t0 + 32 * MS),
                 ("cudaMemcpyAsync", t0 + 36 * MS, t0 + 36 * MS + 500 * US),
                 ("cudaLaunchKernel", t0 + 40 * MS + 100 * US, t0 + 41 * MS)]
        device += [("kernel_a", t0, t0 + 20 * MS), ("kernel_b", t0 + 21 * MS, t0 + 40 * MS)]
    return Trace(0, steps * 42 * MS - 2 * MS, device, host)


@pytest.fixture
def ctx(monkeypatch):
    monkeypatch.setattr(spans, "program_totals", lambda: record(2))
    return Context(cut(CONFIG), CELL, trace=trace(2), traced_units=2)


def test_known_values(ctx):
    cfg = ctx.cfg
    expected = {
        "sampler_ms.step": 1.0, "dit_norm_ms.step": 2.0, "dit_attn_prep_ms.step": 3.0,
        "dit_other_span_ms.step": 9.0,
        "attn_span_roofline.step": 100 * work.least_seconds(cfg, "attention") / 8e-3,
        "linear_span_roofline.step": 100 * work.least_seconds(cfg, "linear") / 16e-3,
        "host_enqueue_ms.step": 40.0 - 4.99, "program_idle_ms.step": 1.0,
    }
    for name, value in expected.items():
        assert reader(name)(ctx) == pytest.approx(value), name


@pytest.mark.parametrize("name", RECORD)
def test_none_when_the_record_is_not_the_traced_steps(ctx, monkeypatch, name):
    monkeypatch.setattr(spans, "program_totals", lambda: record(3))
    assert reader(name)(ctx) is None
    monkeypatch.setattr(spans, "program_totals", lambda: None)  # a program with no tracer
    assert reader(name)(ctx) is None


@pytest.mark.parametrize("name", HOST)
def test_none_without_a_step_range_a_unit(ctx, name):
    ctx.trace.host_ops = [op for op in ctx.trace.host_ops if op[0] != "sampler.step"][:1]
    assert reader(name)(ctx) is None


def test_host_waits_are_the_calls_beyond_their_own_cost(ctx):
    """Only the launch into a full queue waits, 4.99 ms a step; the nested
    driver call, the copy and the launch outside the steps add nothing."""
    ranges = spans.step_ranges(ctx)
    assert spans.host_waits(ctx.trace, ranges) == pytest.approx(2 * 4.99e-3)
    ctx.trace.host_ops = [op for op in ctx.trace.host_ops if not op[0].startswith("cu")]
    assert spans.host_waits(ctx.trace, ranges) == 0.0


def test_program_idle_within_the_traces(ctx):
    idle_s = ctx.trace.window_s - ctx.trace.busy_s
    assert idle_s == pytest.approx(2 * 1e-3 + 2e-3)  # the steps' gaps and the one between
    assert reader("program_idle_ms.step")(ctx) * ctx.traced_units / 1000 <= idle_s


def test_whole_traced_run_on_the_cpu(tmp_path, monkeypatch):
    """A traced run reads every new metric from the program's own spans."""
    from trajectorycrafter_tpu_torch.utils import timing

    mix_of = harness.mix_of
    monkeypatch.setattr(harness, "mix_of", lambda name: dict(mix_of(name), warmup_calls=0))
    bench = bench_with(tmp_path, CELL, cut(CONFIG, **TINY))
    timing.reset_spans()
    result = harness.run_cell(CELL, 2 ** 34 + 11, 0.01, True, time.perf_counter(),
                              device="cpu", bench=bench)
    timing.reset_spans()
    metrics = result["metrics"]
    assert set(RECORD + HOST) <= set(metrics), sorted(metrics)
    value = {name: m["value"] for name, m in metrics.items()}
    assert value["host_enqueue_ms.step"] > value["sampler_ms.step"] > 0
