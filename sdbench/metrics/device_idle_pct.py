"""The share of the traced slice in which no kernel, copy or set ran on
the card (``trace.split``)."""


def read(ctx):
    if ctx.split is None or ctx.split["idle_share"] is None:
        return None
    return 100.0 * ctx.split["idle_share"]
