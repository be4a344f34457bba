"""Tracing and profiling: the counterpart of ``sdtpu/utils/profiling.py``.

* :func:`stage` labels a region: a ``torch.profiler.record_function`` span
  in a profiler trace and, where a card is in use, an NVTX range.  Inside
  :meth:`StageTimer.record` it is also timed.  While spans are recorded
  (below) it also records one.
* :func:`trace` records a ``torch.profiler`` trace (host and card) and
  writes it as a Chrome trace, the recorded spans beside kineto's events.
* :class:`StageTimer` accumulates host-clock stage times, each ended by a
  device sync (``runtime.device_sync``).
* :func:`checked` raises on a non-finite floating output: the counterpart
  of the JAX package's ``checkify`` float checks.

The pipeline's stages are ``tokenize``, ``clip``, ``precompute`` (the
cross-attention K/V and the time projections), ``unet_step`` (once per
step), ``vae_decode`` and ``to_uint8``; its host spans ``request`` (one per
``generate``/``generate_batch`` call, the others' root), ``prepare`` and
``upload``; the serving engine's ``engine.queued``, ``engine.collect``,
``engine.dispatch``, ``engine.fetch`` and ``engine.retry``; the UNet's
``unet.plain_resnet`` (a resnet the slab rule refused on the kernel route,
GroupNorm -> SiLU -> conv2d, with its map's ``hw``).

**The span recorder.**  ``torch.profiler`` records a ``record_function``
span only on the thread that started it, so a span of the serving
engine's worker never reaches its trace.  The recorder keeps the
program's own spans, from every thread: while a profiler session runs
anywhere in the process (``torch.autograd.profiler._is_profiler_enabled``,
a process-wide flag) or inside :func:`record_spans`, each :func:`stage`
appends one record (its name, span id, the id of the span enclosing it on
its thread, request ids, thread id, start, end, a few attrs), and
:func:`record_span` one for a span that opens on one thread and closes on
another.  Off, a stage pays one check.  Spans are stamped on
``time.perf_counter_ns`` (:func:`clock_ns`) and converted to the
profiler's clock (Unix-epoch ns, as kineto's ``start_ns`` reads) with an
offset taken when recording starts (a :func:`record_spans` block, or the
first span after a second without one).  The newest ``SPAN_BUFFER`` spans are kept; :func:`spans` returns
them in us on the profiler's clock.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
import itertools
import json
import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

from sdtpu_torch.utils.runtime import device_sync

_active_timer: contextvars.ContextVar = contextvars.ContextVar("stage_timer", default=None)

# -- the span recorder --------------------------------------------------------

SPAN_BUFFER = 1 << 16  # spans kept; the oldest are dropped
SPANS_PID = "sdtpu_torch spans"  # the Chrome-trace process row of :func:`trace`'s spans
clock_ns = time.perf_counter_ns  # the recorder's clock

_spans: "collections.deque[tuple]" = collections.deque(maxlen=SPAN_BUFFER)
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
# the span open on this thread (its record), the parent of the next
_open_span: contextvars.ContextVar = contextvars.ContextVar("open_span", default=None)
_lock = threading.Lock()
_thread = threading.local()  # .tid: the native id, read once (a system call)
_idents: Dict[int, int] = {}  # native id -> threading.get_ident(), as CUPTI names a thread
_record_depth = 0  # record_spans() blocks open
_epoch = [0, -(1 << 62)]  # [profiler clock - recorder clock, last span's end], ns

# a span's record: [name, id, parent id, request ids, thread id, start, end, attrs],
# and the clock offset once it closes
_NAME, _ID, _START, _END = 0, 1, 5, 6


def recording() -> bool:
    """Whether spans are recorded: a profiler session runs in the process,
    or a :func:`record_spans` block is open."""
    return bool(_record_depth or getattr(_autograd_profiler, "_is_profiler_enabled", False))


def thread_id() -> int:
    """The calling thread's native id, as the trace shows its rows."""
    try:
        return _thread.tid
    except AttributeError:
        _thread.tid = threading.get_native_id()
        _idents[_thread.tid] = threading.get_ident()
        return _thread.tid


def new_request_id() -> int:
    """A process-wide request id (the serving engine's per request, the
    pipeline's per call)."""
    return next(_request_ids)


def _epoch_offset(now: int) -> int:
    """The profiler clock's offset from the recorder's, retaken when
    recording starts: the first span after a second without one."""
    if now - _epoch[1] > 1_000_000_000:
        _epoch[0] = time.time_ns() - clock_ns()
    _epoch[1] = now
    return _epoch[0]


def _append(rec: list) -> None:
    rec.append(_epoch_offset(rec[_END]))
    _spans.append(tuple(rec))


def record_span(name: str, start_ns: int, end_ns: int, *, requests=(),
                tid: Optional[int] = None, **attrs) -> None:
    """Record a span between two :func:`clock_ns` stamps that need not
    have been taken on one thread (``tid``: the thread it is shown on, by
    default the caller's; no parent); nothing when not :func:`recording`."""
    if not recording():
        return
    _append([name, next(_span_ids), 0, tuple(requests),
             thread_id() if tid is None else tid, start_ns, end_ns, attrs])


def in_span(name: str) -> bool:
    """Whether a recorded span called ``name`` is open on this thread."""
    rec = _open_span.get()
    return rec is not None and rec[_NAME] == name


@contextlib.contextmanager
def record_spans():
    """Record spans inside the block, with or without a profiler."""
    global _record_depth
    with _lock:
        _record_depth += 1
        _epoch[1] = -(1 << 62)  # recording starts: a fresh offset
    try:
        yield
    finally:
        with _lock:
            _record_depth -= 1


def spans() -> list:
    """The recorded spans, oldest first, as dicts: ``name``, ``id``,
    ``parent`` (0: none), ``requests``, ``tid`` (the native thread id),
    ``ts`` and ``dur`` in us on the profiler's clock, ``attrs``."""
    return [{"name": r[0], "id": r[1], "parent": r[2], "requests": r[3], "tid": r[4],
             "ts": (r[5] + r[8]) / 1e3, "dur": (r[6] - r[5]) / 1e3, "attrs": r[7]}
            for r in list(_spans)]


def clear_spans() -> None:
    """Drop every recorded span."""
    _spans.clear()


@contextlib.contextmanager
def stage(name: str, *, requests=(), **attrs):
    """Label a region in a profiler trace (and as an NVTX range on a card);
    time it into the :class:`StageTimer` being recorded, if any; record it
    while :func:`recording`, with ``requests`` (ids) and ``attrs``.  Yields
    the span's start (:func:`clock_ns`) when it is recorded, else None."""
    timer = _active_timer.get()
    nvtx = torch.cuda.is_available()
    rec = token = None
    if _record_depth or getattr(_autograd_profiler, "_is_profiler_enabled", False):
        parent = _open_span.get()
        rec = [name, next(_span_ids), 0 if parent is None else parent[_ID], tuple(requests),
               thread_id(), clock_ns(), 0, attrs]
        token = _open_span.set(rec)
    try:
        with torch.profiler.record_function(name):
            if nvtx:
                torch.cuda.nvtx.range_push(name)
            try:
                start = None if rec is None else rec[_START]
                if timer is None:
                    yield start
                else:
                    with timer.time(name, sync=True):
                        yield start
            finally:
                if nvtx:
                    torch.cuda.nvtx.range_pop()
    finally:
        if rec is not None:
            rec[_END] = clock_ns()
            _open_span.reset(token)
            _append(rec)


@contextlib.contextmanager
def untimed():
    """Stages entered inside the block are not timed into the
    :class:`StageTimer` being recorded (whose device syncs a CUDA graph
    capture cannot hold); they are still labelled and recorded."""
    token = _active_timer.set(None)
    try:
        yield
    finally:
        _active_timer.reset(token)


def _chrome_events(recorded: list, base_ns: int = 0) -> list:
    """:func:`spans`' records as Chrome-trace events: their own process row
    (``SPANS_PID``), one row per thread, ``ts`` in us after ``base_ns``
    (the ``baseTimeNanoseconds`` of the trace they join).  Each span's
    ``args`` carry its thread's ``threading.get_ident()`` (``ident``): the
    CUDA API calls of the trace name their thread by it, not by its native
    id."""
    out = [{"ph": "M", "name": "process_name", "pid": SPANS_PID, "tid": 0,
            "args": {"name": SPANS_PID}}]
    for tid in sorted({s["tid"] for s in recorded}):
        out.append({"ph": "M", "name": "thread_name", "pid": SPANS_PID, "tid": tid,
                    "args": {"name": f"thread {tid}"}})
    for s in recorded:
        out.append({"ph": "X", "cat": "program_span", "name": s["name"], "pid": SPANS_PID,
                    "tid": s["tid"], "ts": s["ts"] - base_ns / 1e3, "dur": s["dur"],
                    "args": {"id": s["id"], "parent": s["parent"],
                             "requests": list(s["requests"]), "ident": _idents.get(s["tid"]),
                             **s["attrs"]}})
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (the host, and the card where there is one) and
    write the trace to ``log_dir/trace.json`` (Chrome trace format) on
    exit, with the spans recorded during the block (their own process row,
    ``SPANS_PID``, one row per thread); yields the ``torch.profiler.profile``
    object, whose ``events()`` and ``key_averages()`` are read after the
    block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    first = next(_span_ids)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    ours = [s for s in spans() if s["id"] > first]
    data["traceEvents"].extend(_chrome_events(ours, int(data.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(data, f)


class StageTimer:
    """Host-clock stage accumulator; a stage ends with a device sync when
    asked to, so that its time includes its device work."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def time(self, name: str, result_holder: Optional[list] = None, *, sync: bool = False):
        """Time the block; ``result_holder[0]`` (a tensor the block put
        there), or the current card when ``sync``, is synchronised first."""
        t0 = time.perf_counter()
        yield
        if result_holder:
            device_sync(result_holder[0])
        elif sync:
            device_sync()
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def record(self):
        """Time every :func:`stage` entered in this context (thread or
        task) while the block runs, each ended by a device sync."""
        token = _active_timer.set(self)
        try:
            yield self
        finally:
            _active_timer.reset(token)

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items()):
            n = self.counts[name]
            lines.append(f"{name:24s} {total*1000:9.2f} ms total  "
                         f"{total/n*1000:8.2f} ms/call  x{n}")
        return "\n".join(lines)


def _float_leaves(x, path=()):
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _float_leaves(v, path + (k,))
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _float_leaves(v, path + (i,))
    elif isinstance(x, torch.Tensor) and x.is_floating_point():
        yield path, x
    elif isinstance(x, np.ndarray) and np.issubdtype(x.dtype, np.floating):
        yield path, torch.from_numpy(x)


def checked(fn):
    """Wrap ``fn`` so that a NaN or infinity in any floating output (a
    tensor or numpy array, or a tree of them) raises ``FloatingPointError``
    naming where.  The check reads the values, so on a card it waits for
    them."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        bad = [path for path, t in _float_leaves(out) if not bool(torch.isfinite(t).all())]
        if bad:
            raise FloatingPointError(
                f"{getattr(fn, '__name__', fn)}: non-finite values in output at {bad}")
        return out

    return wrapper
