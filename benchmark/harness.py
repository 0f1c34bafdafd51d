"""Run one cell of the benchmark once and print its result line.

Everything that belongs to one configuration, traffic mix or metric is a file
found by its name in BENCHMARK.json:

- ``configs[].file``: the configuration's sizes;
- ``benchmark/mixes/<traffic>.json``: the mix's parameters; its ``driver``
  names ``benchmark/drivers/<driver>.py``, which builds the program, runs
  one unit of work a call and checks the outputs against the reference;
- ``benchmark/metrics/<metric>.py``: a reader ``read(ctx)`` that returns the
  metric's value or None where it finds nothing to read;
- ``benchmark/limits/<workload>.json``: each compared number's limit in that
  cell.

A run: set-up (the driver builds the program and warms every shape the cell
uses), then calls for ``--seconds`` (with ``--trace 1`` the first
``trace_steps`` units under ``torch.profiler``), then the peak memory, the
program freed, and the comparison with the reference.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names that must not be loaded: the JAX stack and the JAX
# package the port was made from (compared whole: the port's name begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "trajectorycrafter_tpu")


class Refused(Exception):
    """The run cannot give a result (no card, a forbidden module, a bad name)."""


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_of(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise Refused(f"no workload {workload!r} in BENCHMARK.json")


def config_of(bench: dict, name: str, root: Path = ROOT) -> dict:
    for entry in bench["configs"]:
        if entry["name"] == name:
            return json.loads((root / entry["file"]).read_text())
    raise Refused(f"no configuration {name!r} in BENCHMARK.json")


def mix_of(traffic: str) -> dict:
    return json.loads((BENCH_DIR / "mixes" / f"{traffic}.json").read_text())


def limits_of(workload: str) -> Dict[str, float]:
    return json.loads((BENCH_DIR / "limits" / f"{workload}.json").read_text())


def load_file(path: Path, name: str):
    """Import a module from ``path`` (a metric's name holds dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metrics_for(bench: dict, workload: str, trace: bool) -> list:
    """The cell's metrics: its end-to-end ones, or with ``trace`` its per-layer ones."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card_settings() -> str:
    """The card's name, power limit, clocks and temperature as ``nvidia-smi`` reads them."""
    fields = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.splitlines()[0] if out else "nvidia-smi gave no output"


@dataclass
class Context:
    """What a metric's reader sees."""

    cfg: dict
    workload: str
    setup_s: float = 0.0
    window_s: float = 0.0  # the whole measured window, host clock
    units: int = 0  # units of work (steps, clips) completed in the window
    peak_bytes: int = 0
    trace: object = None  # benchmark.trace.Trace of the traced units, with --trace 1
    traced_units: int = 0
    driver: object = None  # the cell's driver (its program freed): its own readings


def read_metrics(bench: dict, ctx: Context, trace: bool) -> Dict[str, dict]:
    out = {}
    for metric in metrics_for(bench, ctx.workload, trace):
        reader = load_file(BENCH_DIR / "metrics" / f"{metric['name']}.py",
                           f"benchmark_metric_{len(out)}")
        value = reader.read(ctx)
        if value is not None:
            out[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, started: float,
             device: Optional[str] = None, bench: Optional[dict] = None) -> dict:
    """One run of ``workload``; returns the result line's object.  ``device``
    other than a card is for the tests alone: a measured run takes the card."""
    import torch

    bench = bench or load_benchmark()
    cell = cell_of(bench, workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"{workload} needs {cell['chips']} CUDA card(s); found "
                          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = "cuda"
        torch.cuda.reset_peak_memory_stats()
    cfg, mix = config_of(bench, cell["config"]), mix_of(cell["traffic"])
    driver = load_file(BENCH_DIR / "drivers" / f"{mix['driver']}.py",
                       f"benchmark_driver_{mix['driver']}").Driver(cfg, mix, seed, device)
    ctx = Context(cfg, workload)
    driver.warm()
    card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    sync()
    ctx.setup_s = time.perf_counter() - started

    prof, index = None, 0
    t0 = time.perf_counter()
    if trace:
        prof, ctx.traced_units, index = _traced_calls(driver, mix["trace_steps"], card, sync)
    while time.perf_counter() - t0 < seconds or ctx.units + ctx.traced_units == 0:
        ctx.units += driver.call(index)
        index += 1
        sync()
    ctx.window_s = time.perf_counter() - t0
    ctx.units += ctx.traced_units
    ctx.driver = driver
    ctx.peak_bytes = torch.cuda.max_memory_allocated() if card else 0
    found = forbidden_modules()
    if found:
        raise Refused(f"forbidden modules loaded: {found}")
    if prof is not None:
        from benchmark.trace import Trace

        ctx.trace = Trace.from_profiler(prof)
        del prof

    driver.release()
    if card:
        torch.cuda.empty_cache()
    limits = limits_of(workload)
    t_check = time.perf_counter()
    readings = driver.check()
    print(f"benchmark: {workload} seed {seed}: setup {ctx.setup_s:.3f} s, window "
          f"{ctx.window_s:.3f} s, {ctx.units} units in {index} calls, check "
          f"{time.perf_counter() - t_check:.3f} s; {card_settings() if card else 'cpu'}",
          file=sys.stderr)
    check = {name: {"value": readings.get(name, float("nan")), "limit": limit}
             for name, limit in limits.items()}
    # a comparison with no reading, or a NaN, fails: NaN <= limit is false
    correct = all(c["value"] <= c["limit"] for c in check.values())
    result = {
        "correct": bool(correct),
        "attempted": index,
        "failed": 0,  # a call that fails ends the run without a result
        "metrics": read_metrics(bench, ctx, trace),
        "device": _device(torch, device, cell, ctx, trace),
    }
    if trace:
        result["breakdown"] = {"device_ops": ctx.trace.top_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    result["check"] = check
    return result


def _traced_calls(driver, steps: int, card: bool, sync):
    """The window's first calls until ``steps`` units, under the profiler,
    inside one ``bench.traced`` span; -> (profiler, units, calls made)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.trace import SPAN

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    prof = profile(activities=activities)
    prof.start()
    units = index = 0
    with record_function(SPAN):
        while units < steps:
            units += driver.call(index)
            index += 1
            sync()
    prof.stop()
    return prof, units, index


def _device(torch, device: str, cell: dict, ctx: Context, trace: bool) -> dict:
    if torch.device(device).type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": cell["chips"], "memory_peak_bytes": int(ctx.peak_bytes)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if trace:
        info.update(busy_s=ctx.trace.busy_s, window_s=ctx.trace.window_s)
    return info


def cache_dirs() -> None:
    """Fix every build and kernel cache inside the checkout (the port's nvcc
    builds already go to its build/ directory)."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
