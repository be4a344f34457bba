"""Seconds from the harness's start to the first timed request: CUDA's
start, the kernels loaded (built, in a checkout's first run), the weights
made on the card, the warm-up of the cell's shapes."""


def read(ctx):
    return ctx.setup_s
