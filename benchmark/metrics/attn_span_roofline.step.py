"""attn_span_roofline.step: the attention's least time in a step
(benchmark/work.py) over the self time of the program's ``attention`` spans
(every call of its attention dispatch, whatever kernel it runs) in the
traced steps, in %.  The span twin of attn_roofline.step."""

from benchmark import spans, work


def read(ctx):
    totals = spans.record(ctx)
    if totals is None or totals.get("attention", (0.0, 0))[0] <= 0:
        return None
    return 100.0 * work.least_seconds(ctx.cfg, "attention") * ctx.traced_units / \
        totals["attention"][0]
