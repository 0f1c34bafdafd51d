"""attn_roofline.step: the attention's least time in a step (the blocks'
joint self-attention and the Perceivers', benchmark/work.py) over the device
time of the attention kernels in the traced steps, in %."""

from benchmark import work
from benchmark.trace import ATTENTION


def read(ctx):
    if ctx.trace is None or not ctx.traced_units:
        return None
    seconds = ctx.trace.seconds(ATTENTION)
    if seconds <= 0:
        return None
    return 100.0 * work.least_seconds(ctx.cfg, "attention") * ctx.traced_units / seconds
