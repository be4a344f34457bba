"""``torch.cuda.max_memory_allocated()`` over the window, after a reset at
its start, in GiB: the weights and everything the requests held."""


def read(ctx):
    return ctx.peak_bytes / 2**30
