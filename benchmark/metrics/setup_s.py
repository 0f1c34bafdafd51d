"""setup_s: seconds from the start of the process to the window's start:
imports, the card, the program's build (and, in a fresh checkout, the
kernels' compilation), the inputs, the warm-up."""


def read(ctx):
    return ctx.setup_s
