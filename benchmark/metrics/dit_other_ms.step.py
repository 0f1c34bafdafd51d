"""dit_other_ms.step: the device's busy time per traced step less the
attention kernels' and the GEMM kernels' time: the DiT's norms, modulation,
RoPE, elementwise work and copies, in ms a step."""

from benchmark.trace import ATTENTION, LINEAR


def read(ctx):
    if ctx.trace is None or not ctx.traced_units:
        return None
    t = ctx.trace
    other = t.busy_s - t.seconds(ATTENTION) - t.seconds(LINEAR)
    return 1000.0 * other / ctx.traced_units
