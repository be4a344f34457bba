"""The 90th percentile (nearest rank), over every request due in the
window, of its finish time less the time it was due on the open-loop
schedule.  A request that failed or never finished counts as missing: it
ranks above every finished one and, where it sets the percentile, reads as
the longest wait the run allows."""

import math


def read(ctx):
    recs = ctx.window.records
    if not recs:
        return None
    worst = ctx.window.seconds + ctx.wait_past_close_s
    lat = sorted((r.done - r.due) if r.image is not None else math.inf for r in recs)
    v = lat[max(0, math.ceil(0.9 * len(lat)) - 1)]
    return worst if math.isinf(v) else v
