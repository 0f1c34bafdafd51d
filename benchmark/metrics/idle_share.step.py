"""idle_share.step: the share of the traced steps' window in which no
operation ran on the card (the union of the device's operation intervals),
in %."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
