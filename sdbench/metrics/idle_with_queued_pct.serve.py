"""The share of the traced slice in which the card runs nothing (no
kernel, copy or set: the union of ``ctx.view.device`` clipped to the
slice, as ``trace.split`` builds it) while at least one request waits in
the serving engine (an ``engine.queued`` span that the program recorded,
``sdtpu_torch.utils.profiling.spans``, is open).  The rest of the idle
share waits for arrivals or for the host.  None where the program records
no such span in the slice."""


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _clipped(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals if min(b, hi) > max(a, lo)]


def read(ctx):
    if ctx.view is None:
        return None
    from sdtpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    lo, hi = ctx.view.lo, ctx.view.hi
    queued = _union(_clipped([(s["ts"], s["ts"] + s["dur"]) for s in spans()
                              if s["name"] == "engine.queued"], lo, hi))
    if not queued or hi <= lo:
        return None
    busy = _union(_clipped([(e["ts"], e["ts"] + e["dur"]) for e in ctx.view.device], lo, hi))
    overlap, j = 0.0, 0
    for a, b in queued:  # both sorted and disjoint: one sweep
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < b:
            overlap += min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
    waiting = sum(b - a for a, b in queued)
    return 100.0 * (waiting - overlap) / (hi - lo)
