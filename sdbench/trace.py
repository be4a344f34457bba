"""The traced slice of a ``--trace 1`` run and the arithmetic over it.

A ``torch.profiler`` run (host and card) covers a slice of whole requests
(``sdbench/traffic/<kind>.py`` says where); its activities become
Chrome-trace records (``cat``, ``name``, ``ts`` and ``dur`` in us,
``corr``, ``tid``) taken straight from kineto's results.  The arithmetic is the port's own
``tools/summarize_trace.py`` (``trace_split``'s busy time, idle share and
gaps; the attribution of device time to the host span that launched it),
copied here so that the yardstick stays fixed.

The harness marks request i's dispatch (``sdbench.request.<i>``) and fetch
(``sdbench.fetch.<i>``) and the slice itself (``sdbench.slice``); a request
is whole in the trace when both of its marks are in it.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

STAGES = ("tokenize", "noise", "clip", "vae_encode", "precompute", "unet_step", "vae_decode",
          "to_uint8")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel|cudaGraphLaunch|cuGraphLaunch)")


class Tracer:
    """Starts and stops one profiler run; a no-op when ``enabled`` is
    false.  ``warm()`` runs the profiler once, so that its first start
    costs nothing inside the traced slice.  The drivers call it just before
    the first window they trace: once a profiler has run, every launch of
    the process costs more (SDXL's untraced window, after a warm-up in
    set-up, lost half its rate), so a closed loop warms after its window."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.done = None  # the stopped profiler, read after the window

    @property
    def events(self):
        return None if self.done is None else kineto_events(self.done)

    def _profile(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def warm(self) -> None:
        if not self.enabled:
            return
        import torch

        with self._profile():
            if torch.cuda.is_available():
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()

    def start(self) -> None:
        if self.enabled and self.prof is None and self.done is None:
            self.prof = self._profile()
            self.prof.start()

    @property
    def active(self) -> bool:
        return self.prof is not None

    def stop(self) -> None:
        if self.prof is None:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        self.done, self.prof = self.prof, None


def mark(name: str):
    """A harness span in the trace (cheap when no profiler runs)."""
    import torch

    return torch.profiler.record_function(name)


def kineto_events(prof) -> list:
    """The profiler's activities as Chrome-trace records."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        cat = e.activity_type() if hasattr(e, "activity_type") else None
        name = e.name()
        if e.device_type() == cuda and (e.is_user_annotation() or name in STAGES
                                        or name.startswith("sdbench.")):
            cat = "gpu_user_annotation"  # a host span's image on the card's timeline
        elif not cat:
            if e.device_type() == cuda:
                cat = ("gpu_memcpy" if "Memcpy" in name else "gpu_memset" if "Memset" in name
                       else "kernel")
            elif e.is_user_annotation():
                cat = "user_annotation"
            elif name.startswith("cu"):
                cat = "cuda_runtime"
            else:
                cat = "cpu_op"
        out.append({"cat": cat, "name": name, "ts": e.start_ns() / 1e3,
                    "dur": e.duration_ns() / 1e3, "corr": e.correlation_id(),
                    "tid": e.start_thread_id()})
    return out


def _spans(events, name):
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e["cat"] == "user_annotation" and e["name"] == name)


def _inside(starts, spans, t) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t < spans[i][1]


class View:
    """A trace reduced to what the metrics read: the slice, the whole
    requests' dispatch spans, their ``unet_step`` and VAE spans, the
    launch calls and the device activities each with the host time of its
    launch."""

    def __init__(self, events: list):
        self.events = events
        self.device = [e for e in events if e["cat"] in DEVICE_CATS]
        launches = {e["corr"]: e for e in events
                    if e["cat"] in ("cuda_runtime", "cuda_driver") and e["corr"]}
        self.launch_calls = [e for e in launches.values() if LAUNCH.match(e["name"])]
        self.launched_at = {id(d): launches[d["corr"]]["ts"] for d in self.device
                            if d["corr"] in launches}
        marks = {}
        for e in events:
            if e["cat"] == "user_annotation" and e["name"].startswith("sdbench."):
                marks.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
        requests = {n.rsplit(".", 1)[1]: s[0] for n, s in marks.items()
                    if n.startswith("sdbench.request.")}
        fetched = {n.rsplit(".", 1)[1] for n in marks if n.startswith("sdbench.fetch.")}
        self.whole = sorted(s for i, s in requests.items() if i in fetched)
        if "sdbench.slice" in marks:
            self.lo, self.hi = marks["sdbench.slice"][0]
        elif events:
            self.lo = min(e["ts"] for e in events)
            self.hi = max(e["ts"] + e["dur"] for e in events)
        else:
            self.lo = self.hi = 0.0
        self.steps = [s for s in _spans(events, "unet_step")
                      if any(a <= s[0] < b for a, b in self.whole)]
        self.decodes = [s for s in _spans(events, "vae_decode")
                        if any(a <= s[0] < b for a, b in self.whole)]
        self.encodes = [s for s in _spans(events, "vae_encode")
                        if any(a <= s[0] < b for a, b in self.whole)]

    def device_in(self, spans, pattern=None) -> float:
        """Device seconds of activities launched inside ``spans`` whose
        name matches ``pattern`` (a compiled regex; all when None)."""
        total, starts = 0.0, [a for a, _ in spans]
        for d in self.device:
            t = self.launched_at.get(id(d))
            if t is None or not _inside(starts, spans, t):
                continue
            if pattern is None or pattern.search(d["name"]):
                total += d["dur"]
        return total / 1e6

    def launches_in(self, spans) -> int:
        starts = [a for a, _ in spans]
        return sum(1 for e in self.launch_calls if _inside(starts, spans, e["ts"]))


def split(view: View) -> dict:
    """``trace_split``'s arithmetic over the slice: the union of the card's
    activity intervals, the idle share, the device time by op inside the
    slice, and the longest idle gaps with the host stage each falls in."""
    lo, hi = view.lo, view.hi
    merged = []
    for e in sorted(view.device, key=lambda e: e["ts"]):
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    window = hi - lo
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    stage_spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in view.events
                   if e["cat"] == "user_annotation" and e["name"] in STAGES]

    def stage_at(t):
        names = [n for a, b, n in stage_spans if a <= t <= b]
        return names[-1] if names else "between stages"

    by_name = defaultdict(float)
    for e in view.device:
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b > a:
            by_name[e["name"]] += b - a
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy / 1e6, "window_s": window / 1e6,
        "idle_share": 1.0 - busy / window if window > 0 else None,
        "device_ops": [[n, t / 1e6] for n, t in top],
        "idle_gaps": [[stage_at(t + g / 2), g / 1e6] for g, t in gaps],
    }

