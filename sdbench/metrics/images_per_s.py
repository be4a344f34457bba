"""Images of the requests finished in the window over the window's wall
time (first dispatch to last fetch): all the work over all the time."""


def read(ctx):
    if ctx.window.seconds <= 0:
        return None
    return sum(1 for r in ctx.window.records if r.image is not None) / ctx.window.seconds
