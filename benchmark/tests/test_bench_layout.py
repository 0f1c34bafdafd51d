"""BENCHMARK.json against the rules it is checked by (names, units, keys,
bounds), and every name found as a file."""

import json
import re

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic", *entry.get("reduced", [])):
        assert NAME.match(entry.get(key, key))
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        assert key not in entry or 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_found_by_name(entry):
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and entry["file"].startswith("benchmark/")
    assert set(entry["reduced"]) == set(cfg["reduced"])
    assert not any(k.endswith(("_dim", "_rank")) for k in entry["reduced"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_found_by_name(cell):
    mix = harness.mix_of(cell["traffic"])
    assert (harness.BENCH_DIR / "drivers" / f"{mix['driver']}.py").is_file()
    assert harness.limits_of(cell["name"])
    assert cell["chips"] == 1
    reported = {m["name"] for m in harness.metrics_for(BENCH, cell["name"], False)}
    assert "setup_s" in reported and len(reported) >= 2
    assert harness.metrics_for(BENCH, cell["name"], True)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_found_by_name(metric):
    reader = harness.load_file(harness.BENCH_DIR / "metrics" / f"{metric['name']}.py", "m")
    assert callable(reader.read)
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        moves = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        for cell in metric.get("workloads", [c["name"] for c in BENCH["workloads"]]):
            assert cell in moves.get("workloads", [cell])


def test_layers_named_in_perf_md():
    perf = (ROOT / "PERF.md").read_text()
    for metric in BENCH["per_layer"]:
        assert metric["layer"] in perf
