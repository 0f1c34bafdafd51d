"""linear_roofline.step: the linear layers' least time in a step (int8 layers
at the int8 peak under the int8 configuration, the rest at the bf16 peak,
benchmark/work.py) over the device time of the GEMM kernels (the int8 row
quantization and GEMMs, cuBLAS's bf16 GEMMs) in the traced steps, in %."""

from benchmark import work
from benchmark.trace import LINEAR


def read(ctx):
    if ctx.trace is None or not ctx.traced_units:
        return None
    seconds = ctx.trace.seconds(LINEAR)
    if seconds <= 0:
        return None
    return 100.0 * work.least_seconds(ctx.cfg, "linear") * ctx.traced_units / seconds
