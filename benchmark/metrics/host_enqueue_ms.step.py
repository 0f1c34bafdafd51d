"""host_enqueue_ms.step: the host's own time issuing one CFG step's work: its
time inside the program's ``sampler.step`` ranges of the trace, less the
waits inside its calls into the CUDA runtime or driver (a launch finding
the device's queue full; benchmark/spans.py ``host_waits``), in ms a traced
step.  Under the step's time by the headroom the host has before it sets
the pace."""

from benchmark import spans


def read(ctx):
    ranges = spans.step_ranges(ctx)
    if ranges is None:
        return None
    inside_s = sum(e - s for s, e in ranges) / 1e9
    return 1000.0 * (inside_s - spans.host_waits(ctx.trace, ranges)) / ctx.traced_units
