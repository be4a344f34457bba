"""Requests over device batches in the window (``ServingEngine.stats()``)."""


def read(ctx):
    s = ctx.window.engine_stats
    if not s or not s.get("batches"):
        return None
    return s["requests"] / s["batches"]
