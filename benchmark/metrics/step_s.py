"""step_s: seconds per unit of the cell's loop (one CFG denoise step), the
whole window over every unit completed in it, host clock ending in a
synchronize."""


def read(ctx):
    return ctx.window_s / ctx.units if ctx.units else None
