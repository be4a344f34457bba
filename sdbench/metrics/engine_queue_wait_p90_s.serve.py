"""The 90th percentile (nearest rank) of the serving engine's queue waits
in the traced slice: the durations of the ``engine.queued`` spans (a
request's submit to the start of its chunk's dispatch) that the program
recorded (``sdtpu_torch.utils.profiling.spans``, us on the profiler's
clock) and whose start lies in the slice.  None where the program records
no such span."""

import math


def read(ctx):
    if ctx.view is None:
        return None
    from sdtpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    lo, hi = ctx.view.lo, ctx.view.hi
    waits = sorted(s["dur"] for s in spans()
                   if s["name"] == "engine.queued" and lo <= s["ts"] <= hi)
    if not waits:
        return None
    return waits[max(0, math.ceil(0.9 * len(waits)) - 1)] / 1e6
