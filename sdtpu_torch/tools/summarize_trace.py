"""Summarize a profiler trace that ``utils/profiling.trace`` wrote
(``DIR/trace.json``, Chrome trace format): the counterpart of the JAX
package's ``tools/summarize_trace.py``, which read an XProf trace::

    python -m sdtpu_torch.tools.summarize_trace DIR_OR_TRACE_JSON [--top 40] [--steps 25]
        [--outside] [--raw] [--split]

It reads the stored file and needs no profiler object, so it runs on any
host, the CPU included.  Each ``ph: "X"`` record is a span; its ``cat``
tells the card's kernels, copies and sets (``kernel``, ``gpu_memcpy``,
``gpu_memset``) from the host's ops (``cpu_op``), CUDA API calls
(``cuda_runtime``, ``cuda_driver``) and ``utils/profiling.stage`` spans
(``user_annotation``, from the thread that started the profiler).  The
spans the program recorded itself, from every thread, have their own
process row (``program_span``); they label the idle gaps of ``--split``.

* default -- SELF-TIME attribution inside the denoise loop, the
  counterpart of the JAX tool's scan window: the window is the union of
  the ``unet_step`` stage spans (the JAX tool took the longest while-op);
  on each lane (a host thread, a card stream) a stack sweep subtracts the
  nested children, so that every microsecond counts once.  A card
  activity belongs to the window if the host launched it inside a
  ``unet_step`` span (matched by its ``correlation`` id; else by its own
  start), a host span if it starts inside one.  It prints the card's self
  ms in total and per step, by kind (:func:`device_category`) and by op,
  and the host's self ms by op over the same window: on this card the
  host's line sets the pace (an eager step enqueues ~1540 launches), as
  the "XLA Ops" line does on the TPU.  Without ``unet_step`` spans the
  whole trace is the window.
* ``--outside`` -- the same attribution outside the window (CLIP, the VAE,
  the draws).
* ``--raw`` -- per-name duration sums over every span of every lane, no
  sweep (nested spans count more than once: for spotting, not attribution).
* ``--split`` -- :func:`trace_split`'s summary of one image: device-busy
  time, idle share, device time by kind, the longest idle gaps with the
  host stage each falls in and the program span open at its middle
  (``chip_smoke.py`` phase 13 prints it).

``--steps`` divides the window's totals into a per-step column; ``--top``
limits every list.
"""

from __future__ import annotations

import argparse
import bisect
import functools
import glob
import json
import os
import re
from collections import defaultdict

STAGES = ("tokenize", "noise", "clip", "vae_encode", "precompute", "unet_step", "vae_decode",
          "to_uint8")
WINDOW = "unet_step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def load_trace(path: str) -> list:
    """The ``ph: "X"`` records of a Chrome trace: ``path`` is the file or
    the directory ``profiling.trace`` wrote it into (``DIR/trace.json``)."""
    if os.path.isdir(path):
        path = os.path.join(path, "trace.json")
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


@functools.lru_cache(maxsize=1)
def hand_kernel_names() -> tuple:
    """The ``__global__`` functions of ``sdtpu_torch/csrc/*.cu``."""
    import sdtpu_torch

    names = set()
    for path in glob.glob(os.path.join(os.path.dirname(sdtpu_torch.__file__), "csrc", "*.cu")):
        with open(path) as f:
            names.update(re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))? (\w+)",
                                    f.read()))
    return tuple(sorted(names))


def device_category(name: str) -> str:
    """A device activity's kind: the port's hand-written kernels (the
    ``__global__`` functions of ``sdtpu_torch/csrc``, in its anonymous
    namespaces), the libraries' GEMMs, convolutions and attention,
    PyTorch's own elementwise and reduction kernels, copies."""
    # the qualified function name: up to its template arguments or parameters
    head = re.sub(r"\(anonymous namespace\)", "anon", name.removeprefix("void "))
    head = re.split(r"[<(]", head, maxsplit=1)[0]
    if (head.startswith("anon::")
            and any(head.endswith(f"::{k}") for k in hand_kernel_names())):
        return "hand-written kernels"
    if any(t in name.lower() for t in ("gemm", "xmma", "cutlass", "cudnn", "conv", "sm90",
                                       "fmha", "flash", "attention")):
        return "library GEMM, conv and attention"
    if "Memcpy" in name or "Memset" in name:
        return "copies and sets"
    if "at::native" in name:
        return "PyTorch elementwise and reductions"
    return "other"


def _span(e):
    return e["ts"], e["ts"] + e["dur"], e["name"]


def gap_labeller(events):
    """A function of an idle gap ``(start, end)`` (us) that names the
    program span open at its middle: on the thread that launched the
    device activity right after the gap (or, at the trace's end, right
    before it) the innermost one, else the innermost on any thread, else
    ``"no program span"``.  A launch call names its thread by its
    ``threading.get_ident()`` (or its low 32 bits), a span row by its
    native id; the spans' ``ident`` joins the two."""
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"], e.get("tid")) for e in events
             if e.get("cat") == "program_span"]
    native = {}
    for e in events:
        ident = e.get("args", {}).get("ident") if e.get("cat") == "program_span" else None
        if ident is not None:
            native[ident] = native[ident & 0xFFFFFFFF] = e.get("tid")
    launcher = {e["args"]["correlation"]: native.get(e.get("tid"), e.get("tid")) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    dev = sorted((e["ts"], e["ts"] + e["dur"], launcher.get(e.get("args", {}).get("correlation")))
                 for e in events if e.get("cat") in DEVICE_CATS)
    starts = [d[0] for d in dev]

    def label(a, b):
        i = bisect.bisect_left(starts, b)
        tid = dev[i][2] if i < len(dev) else next(
            (d[2] for d in reversed(dev) if d[1] <= a), None)
        mid = (a + b) / 2
        open_ = [s for s in spans if s[0] <= mid <= s[1]]
        own = [s for s in open_ if tid is not None and s[3] == tid]
        pick = own or open_
        if not pick:
            return "no program span"
        return max(pick, key=lambda s: (s[0], -s[1]))[2]

    return label


def trace_split(events, wall_s):
    """From a trace of one image (:func:`load_trace`'s records): the window
    (first stage start to last event end; the program's own stage spans
    where kineto has none, as for the serving engine's worker), the device-busy time (the union
    of the card's activity intervals), the idle share, the device time by
    kind of activity, the ten device ops with the most total time, and the
    five longest device-idle gaps with the host stage each falls in and
    the program span open at its middle (:func:`gap_labeller`)."""
    dev, spans = [], []
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] in STAGES:
            spans.append(_span(e))
        elif e.get("cat") in DEVICE_CATS:
            dev.append(_span(e))
    if not spans:  # the stages ran on a thread the profiler does not see: the program's spans
        spans = [_span(e) for e in events
                 if e.get("cat") == "program_span" and e["name"] in STAGES]
    if not spans:
        raise AssertionError("the trace holds none of the pipeline's stages")
    lo = min(s[0] for s in spans)
    hi = max([s[1] for s in spans] + [d[1] for d in dev])
    merged = []
    for a, b, _ in sorted(dev):
        a, b = max(a, lo), min(b, hi)
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
                   if edges[i + 1] > edges[i]), reverse=True)[:5]

    def stage_at(t):
        names = [n for a, b, n in spans if a <= t <= b]
        return names[-1] if names else "between stages"

    span_at = gap_labeller(events)
    by_name = {}
    for a, b, n in dev:
        tot, cnt = by_name.get(n, (0.0, 0))
        by_name[n] = (tot + (b - a), cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    stage_sum = {}
    for a, b, n in spans:
        stage_sum[n] = stage_sum.get(n, 0.0) + (b - a)
    kinds = {}
    for n, (t, c) in by_name.items():
        k = kinds.setdefault(device_category(n), [0.0, 0])
        k[0] += t / 1e3
        k[1] += c
    return {
        "device_ms_by_kind": {k: {"ms": v[0], "count": v[1]} for k, v in kinds.items()},
        "wall_ms": wall_s * 1e3, "window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / window if window > 0 else None,
        "device_events": len(dev),
        "top_device_ops": [{"name": n, "total_ms": t / 1e3, "count": c} for n, (t, c) in top],
        "longest_idle_gaps": [{"ms": g / 1e3, "at_ms": (t - lo) / 1e3,
                               "stage": stage_at(t + g / 2), "span": span_at(t, t + g)}
                              for g, t in gaps],
        "host_stage_ms": {n: v / 1e3 for n, v in stage_sum.items()},
    }


def self_times(events, keep) -> tuple:
    """``({name: self us}, {name: count})`` over the spans for which
    ``keep(event)`` holds: on each lane (pid, tid) a stack sweep gives every
    span its duration less its nested children's, over all the lane's
    spans (a kept child of a dropped parent still counts its own time)."""
    lanes = defaultdict(list)
    for e in events:
        lanes[(e.get("pid"), e.get("tid"))].append(e)
    self_us, counts = defaultdict(float), defaultdict(int)
    for evs in lanes.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []  # [end, event, child us]

        def pop_until(t):
            while stack and stack[-1][0] <= t:
                end, e, child = stack.pop()
                if keep(e):
                    self_us[e["name"]] += e["dur"] - child
                    counts[e["name"]] += 1
                if stack:
                    stack[-1][2] += e["dur"]

        for e in evs:
            pop_until(e["ts"])
            stack.append([e["ts"] + e["dur"], e, 0.0])
        pop_until(float("inf"))
    return dict(self_us), dict(counts)


def attribute(events, outside: bool = False) -> dict:
    """Self-time attribution inside (or, with ``outside``, outside) the
    ``unet_step`` window: ``{"spans", "window_ms", "device" / "host":
    ({name: self ms}, {name: count})}``."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation" and e["name"] == WINDOW)
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    starts = [s for s, _ in spans]

    def in_window(e):
        if not spans:
            return not outside
        t = e["ts"]
        if e.get("cat") in DEVICE_CATS:
            t = launch.get(e.get("args", {}).get("correlation"), t)
        i = bisect.bisect_right(starts, t) - 1
        inside = i >= 0 and t < spans[i][1]
        return inside != outside

    out = {"spans": len(spans), "window_ms": sum(b - a for a, b in spans) / 1e3}
    for side, cats in (("device", DEVICE_CATS), ("host", HOST_CATS)):
        evs = [e for e in events if e.get("cat") in cats]
        us, counts = self_times(evs, in_window)
        out[side] = ({n: v / 1e3 for n, v in us.items()}, counts)
    return out


def summarize(events, top: int = 40, steps: int = 25, outside: bool = False) -> dict:
    """Print the self-time attribution (module docstring) and return
    :func:`attribute`'s dict with ``device_by_kind`` ({kind: [ms,
    count]}) added."""
    res = attribute(events, outside)
    where = "outside the unet_step window" if outside else "in the unet_step window"
    if res["spans"]:
        print(f"window: {res['spans']} unet_step spans, {res['window_ms']:.3f} ms of host time")
    else:
        print("(no unet_step stage found; summarizing the whole trace)")
    dev_ms, dev_n = res["device"]
    total = sum(dev_ms.values())
    print(f"device self time {where}: {total:.3f} ms ({total / steps:.3f} ms/step at "
          f"--steps {steps})")
    kinds = defaultdict(lambda: [0.0, 0])
    for n, ms in dev_ms.items():
        k = kinds[device_category(n)]
        k[0] += ms
        k[1] += dev_n[n]
    res["device_by_kind"] = {k: v for k, v in kinds.items()}
    print("\n-- device by kind (self ms total / per step) --")
    for k, (ms, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        print(f"{ms:9.3f} ms ({ms / steps:7.3f}/step) x{n:7d}  {k}")
    print("\n-- top device ops (self time) --")
    for n, ms in sorted(dev_ms.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{ms:9.3f} ms ({ms / steps:7.3f}/step) x{dev_n[n]:7d}  {n[:130]}")
    host_ms, host_n = res["host"]
    print(f"\n-- host self time by op {where}: {sum(host_ms.values()):.3f} ms "
          f"({sum(host_ms.values()) / steps:.3f} ms/step) --")
    for n, ms in sorted(host_ms.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{ms:9.3f} ms ({ms / steps:7.3f}/step) x{host_n[n]:7d}  {n[:130]}")
    return res


def raw(events, top: int = 40) -> dict:
    """Per-name duration sums over every span, by category; printed and
    returned as ``{cat: {name: [ms, count]}}``."""
    sums = defaultdict(lambda: defaultdict(lambda: [0.0, 0]))
    for e in events:
        s = sums[e.get("cat", "?")][e["name"]]
        s[0] += e["dur"] / 1e3
        s[1] += 1
    for cat, names in sorted(sums.items()):
        print(f"\n== {cat}: {len(names)} distinct names (RAW sums; nested spans count "
              f"more than once -- do not attribute) ==")
        for n, (ms, c) in sorted(names.items(), key=lambda kv: -kv[1][0])[:top]:
            print(f"{ms:9.3f} ms  x{c:6d}  {n[:110]}")
    return {cat: {n: list(v) for n, v in names.items()} for cat, names in sums.items()}


def print_split(split: dict, label: str = "trace") -> None:
    """The lines ``chip_smoke.py`` phase 13 prints of :func:`trace_split`."""
    print(f"{label}: wall {split['wall_ms']:.1f} ms, window {split['window_ms']:.1f} ms, device "
          f"busy {split['device_busy_ms']:.1f} ms (union of {split['device_events']} device "
          f"activities), idle share "
          + ("none" if split["idle_share"] is None else f"{split['idle_share']:.4f}"))
    print(f"{label} device ms by kind: " + ", ".join(
        f"{k} {v['ms']:.1f} (x{v['count']})" for k, v in split["device_ms_by_kind"].items()))
    print(f"{label} host stage ms: " + ", ".join(
        f"{n} {v:.1f}" for n, v in split["host_stage_ms"].items()))
    for op in split["top_device_ops"]:
        print(f"{label} device op {op['total_ms']:9.3f} ms x{op['count']:5d} {op['name'][:110]}")
    for g in split["longest_idle_gaps"]:
        print(f"{label} idle gap {g['ms']:8.3f} ms at +{g['at_ms']:.1f} ms, host in "
              f"{g['stage']}, program span {g['span']}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="trace.json or the directory holding it")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--raw", action="store_true",
                    help="per-name duration sums (nested spans count more than once)")
    ap.add_argument("--steps", type=int, default=25, help="divides the window's totals")
    ap.add_argument("--outside", action="store_true",
                    help="attribute self time OUTSIDE the unet_step window instead")
    ap.add_argument("--split", action="store_true",
                    help="device-busy time, idle share and idle gaps of the traced span")
    args = ap.parse_args(argv)

    events = load_trace(args.trace)
    print(f"# {args.trace}: {len(events)} spans")
    if args.raw:
        return raw(events, args.top)
    if args.split:
        split = trace_split(events, 0.0)
        print_split(split)
        return split
    return summarize(events, args.top, args.steps, outside=args.outside)


if __name__ == "__main__":
    main()
