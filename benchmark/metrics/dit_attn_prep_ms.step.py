"""dit_attn_prep_ms.step: the self time of the program's ``dit.joint_attn``
and ``dit.perceiver`` spans (around the attention and the linears: the
[text; video] cat, the QK layer norms, RoPE and its cats, the output
slices, the Perceiver's views), in ms a traced step."""

from benchmark import spans


def read(ctx):
    return spans.self_ms(ctx, ["dit.joint_attn", "dit.perceiver"])
