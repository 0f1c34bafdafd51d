"""sampler_ms.step: the self time of the program's ``sampler.step`` span (the
sampling loop's own work around the DiT: the CFG cat, scale_model_input,
the timestep vector, the output's cast, the guidance combine, the sampler's
update, and the launch gaps between them), in ms a traced step."""

from benchmark import spans


def read(ctx):
    return spans.self_ms(ctx, [spans.STEP])
