"""The program's own spans, as the per-layer readers take them.

The port's tracer (``trajectorycrafter_tpu_torch/utils/timing.py``) times
spans only while a profiler records, which in a run is the traced window
alone: ``span_totals()`` gives, per span name, its self device seconds (the
time while it was the innermost open span) and its calls.  Its host side is
a ``record_function`` range per call, which the trace keeps among its host
operations.

A reader of the record gets None where the program has no tracer (an older
version) or where the record does not hold exactly one ``sampler.step`` a
traced unit; a reader of the host ranges where the trace does not.
"""

from __future__ import annotations

import re
from bisect import bisect_right
from statistics import median
from typing import Dict, Iterable, List, Optional, Tuple

STEP = "sampler.step"  # one entry of the sampling loop: one CFG step
CUDA_CALL = re.compile(r"cu(da)?[A-Z]")  # a call into the CUDA runtime or driver


def program_totals() -> Optional[dict]:
    """{span name: (self seconds, calls)} from the program's tracer, or None."""
    try:
        from trajectorycrafter_tpu_torch.utils.timing import span_totals
    except ImportError:
        return None
    return span_totals()


def record(ctx) -> Optional[Dict[str, Tuple[float, int]]]:
    """The program's span record of the traced units, or None."""
    if ctx.trace is None or not ctx.traced_units:
        return None
    totals = program_totals()
    if not totals or STEP not in totals or totals[STEP][1] != ctx.traced_units:
        return None
    return totals


def self_ms(ctx, names: Iterable[str]) -> Optional[float]:
    """The summed self time of ``names`` in ms a traced unit, or None."""
    totals = record(ctx)
    if totals is None:
        return None
    return 1000.0 * sum(totals[n][0] for n in names if n in totals) / ctx.traced_units


def dit_names(ctx) -> List[str]:
    """Every ``dit.*`` span in the record."""
    return [n for n in record(ctx) or () if n.startswith("dit.")]


def step_ranges(ctx) -> Optional[List[Tuple[int, int]]]:
    """The host's ``sampler.step`` ranges in the trace (ns, sorted), or None
    unless there is one a traced unit."""
    if ctx.trace is None or not ctx.traced_units:
        return None
    ranges = sorted((s, e) for name, s, e in ctx.trace.host_ops if name == STEP)
    return ranges if len(ranges) == ctx.traced_units else None


def idle_gaps(trace) -> List[Tuple[int, int]]:
    """The window's stretches that no device operation covers (ns)."""
    bounds = [trace.start, *(t for iv in trace.intervals() for t in iv), trace.end]
    return [(bounds[i], bounds[i + 1]) for i in range(0, len(bounds), 2)
            if bounds[i + 1] > bounds[i]]


def idle_inside(trace, ranges: List[Tuple[int, int]]) -> float:
    """Seconds of the device's idle gaps whose middle falls inside one of the
    sorted, disjoint host ``ranges``."""
    inside = _within(ranges)
    return sum(b - a for a, b in idle_gaps(trace) if inside((a + b) // 2)) / 1e9


def _within(ranges: List[Tuple[int, int]]):
    """A test of whether a time falls inside one of the sorted, disjoint
    ``ranges``."""
    starts = [s for s, _ in ranges]

    def inside(t: int) -> bool:
        i = bisect_right(starts, t) - 1
        return i >= 0 and t < ranges[i][1]

    return inside


def host_waits(trace, ranges: List[Tuple[int, int]]) -> float:
    """Seconds the host spent inside the sorted, disjoint ``ranges`` waiting
    in its calls into the CUDA runtime or driver (a launch that finds the
    device's queue full returns only when a slot frees).  A call that
    starts while the device is idle finds the queue empty, so the median of
    a name's such calls is that name's own cost (a name with none: its
    shortest call); a call's time beyond its name's cost is a wait.  Calls
    nested in another call count once, in the outer one."""
    in_range, idle = _within(ranges), _within(idle_gaps(trace))
    calls, started_idle, end = [], {}, None
    for name, s, e in sorted((op for op in trace.host_ops if CUDA_CALL.match(op[0])),
                             key=lambda op: op[1]):
        if (end is None or s >= end) and in_range(s):
            calls.append((name, e - s))
            end = e
            if idle(s):
                started_idle.setdefault(name, []).append(e - s)
    own = {name: median(ns) for name, ns in started_idle.items()}
    for name, ns in calls:
        if name not in started_idle:
            own[name] = min(own.get(name, ns), ns)
    return sum(max(0.0, ns - own[name]) for name, ns in calls) / 1e9
