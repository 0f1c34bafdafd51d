"""program_idle_ms.step: the device's idle time in the traced window (the
gaps the union of its operations leaves) whose middle the host spent inside
one of the program's ``sampler.step`` ranges, in ms a traced step: the part
of idle_share.step that the program's own loop holds, not the benchmark's
loop around it or the profiler.  It holds the tracer's own cost too: the
spans' events and profiler ranges slow the host where the device waits on
it, at each call's start (on an H100, about 4.5-5 ms a step of the traced
window's idle in both denoise cells, read with the spans against without)."""

from benchmark import spans


def read(ctx):
    ranges = spans.step_ranges(ctx)
    if ranges is None:
        return None
    return 1000.0 * spans.idle_inside(ctx.trace, ranges) / ctx.traced_units
