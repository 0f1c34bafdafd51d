"""dit_other_span_ms.step: the self time of every ``dit.*`` span of the
program (the DiT's work outside its linear layers and attention, whatever
its kernels are called), in ms a traced step.  The span twin of
dit_other_ms.step."""

from benchmark import spans


def read(ctx):
    names = spans.dit_names(ctx)
    return spans.self_ms(ctx, names) if names else None
