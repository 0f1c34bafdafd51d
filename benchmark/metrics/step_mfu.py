"""step_mfu: the whole CFG step's least time on the card (every linear layer
and attention, benchmark/work.py, at the data-sheet peaks) over the step's
time in the traced run, in %.  It bounds a gain in any one kernel group."""

from benchmark import work


def read(ctx):
    if ctx.trace is None or not ctx.traced_units:
        return None
    return 100.0 * work.least_seconds(ctx.cfg) / (ctx.trace.window_s / ctx.traced_units)
