"""dit_norm_ms.step: the self time of the program's ``dit.norm`` spans (the
DiT's fp32 layer norms and their adaLN modulation: each block's two
LayerNormZero, each Perceiver's two norms, the head's two; their modulation
linears are ``linear`` spans of their own), in ms a traced step."""

from benchmark import spans


def read(ctx):
    return spans.self_ms(ctx, ["dit.norm"])
