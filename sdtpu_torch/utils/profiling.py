"""Tracing and profiling: the counterpart of ``sdtpu/utils/profiling.py``.

* :func:`stage` labels a region: a ``torch.profiler.record_function`` span
  in a profiler trace and, where a card is in use, an NVTX range.  Inside
  :meth:`StageTimer.record` it is also timed.
* :func:`trace` records a ``torch.profiler`` trace (host and card) and
  writes it as a Chrome trace.
* :class:`StageTimer` accumulates host-clock stage times, each ended by a
  device sync (``runtime.device_sync``).
* :func:`checked` raises on a non-finite floating output: the counterpart
  of the JAX package's ``checkify`` float checks.

The pipeline's stages are ``tokenize``, ``clip``, ``precompute`` (the
cross-attention K/V and the time projections), ``unet_step`` (once per
step), ``vae_decode`` and ``to_uint8``.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from sdtpu_torch.utils.runtime import device_sync

_active_timer: contextvars.ContextVar = contextvars.ContextVar("stage_timer", default=None)


@contextlib.contextmanager
def stage(name: str):
    """Label a region in a profiler trace (and as an NVTX range on a card);
    time it into the :class:`StageTimer` being recorded, if any."""
    timer = _active_timer.get()
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            if timer is None:
                yield
            else:
                with timer.time(name, sync=True):
                    yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (the host, and the card where there is one) and
    write the trace to ``log_dir/trace.json`` (Chrome trace format) on
    exit; yields the ``torch.profiler.profile`` object, whose ``events()``
    and ``key_averages()`` are read after the block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
