"""linear_span_roofline.step: the linear layers' least time in a step
(benchmark/work.py) over the self time of the program's ``linear`` spans
(every linear layer of the DiT: the int8 row quantization and GEMM, or
cuBLAS) in the traced steps, in %.  The span twin of
linear_roofline.step."""

from benchmark import spans, work


def read(ctx):
    totals = spans.record(ctx)
    if totals is None or totals.get("linear", (0.0, 0))[0] <= 0:
        return None
    return 100.0 * work.least_seconds(ctx.cfg, "linear") * ctx.traced_units / \
        totals["linear"][0]
