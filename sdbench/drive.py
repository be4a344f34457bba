"""What the drivers of ``sdbench/traffic/<kind>.py`` share: the record of
each request (when it was due, when it finished, what it returned), the
window, the run's inputs, the program's generation arguments, and the
closed loop.

The closed loop keeps ``in_flight`` device requests in the program: request
N + 1 is dispatched before request N is fetched.  Dispatch stops when the
window's seconds have passed; the window ends when the last request in
flight has been fetched, so a rate is all the work over all the time.  With
a tracer, the same loop runs once more after the window, at the window's
load, and traces one request from its dispatch to its fetch.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np

from sdbench import spec, traffic
from sdbench.trace import mark

WAIT_PAST_CLOSE_S = 60.0
# the warm-up's requests: indices no window reaches
WARM_INDEX = 1 << 40


@dataclasses.dataclass
class Record:
    req: dict
    rows: int = 1
    batch: int = None  # the device request it rode in, where the driver batches
    due: float = 0.0
    done: float = None
    image: np.ndarray = None
    error: str = None


@dataclasses.dataclass
class Window:
    records: list
    t0: float
    t1: float
    engine_stats: dict = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def gen_kwargs(cfg: dict) -> dict:
    """The program's arguments for the configuration's size, steps,
    sampler and guidance."""
    return dict(num_inference_steps=cfg["steps"], image_size=cfg["image_size"],
                cfg=spec.guided(cfg), cfg_scale=cfg["cfg_scale"], sampler=cfg["sampler"])


class Inputs:
    """Request i of the run, made on first use (the host's share of making
    them is a token row and a seed)."""

    def __init__(self, seed: int, mix: dict, cfg: dict):
        self.seed, self.mix = seed, mix
        self.text = cfg.get("clip") or cfg["clip_2"]
        self.images = (traffic.image_pool(seed, mix, cfg["image_size"])
                       if "init_image" in mix else None)

    def __call__(self, i: int) -> dict:
        r = traffic.request(self.seed, i, self.mix, self.text)
        if self.images is not None:
            r["image"] = self.images[r["image_index"]]
        return r


def warm_closed(call, mix, inputs) -> None:
    """Every shape a closed loop uses, once each: one device request of
    the mix's rows, its fetch included."""
    call([inputs(WARM_INDEX + j) for j in range(mix.get("batch", 1))]).cpu()


def _loop(call, rows, depth, inputs, first, more, tracer=None, traced=None) -> tuple:
    """Requests ``first``, ``first + 1``, ... each of ``rows`` rows, each
    dispatched while ``depth - 1`` others are in flight and fetched
    oldest first, dispatching while ``more(i)`` holds; request ``traced``
    is traced from its dispatch to its fetch.  Returns (records, next i)."""
    records, inflight = [], collections.deque()
    i = first
    while True:
        if more(i):
            batch = [inputs(i * rows + j) for j in range(rows)]
            if i == traced:
                tracer.start()
                slice_mark = mark("sdbench.slice")
                slice_mark.__enter__()
            now = time.perf_counter()
            recs = [Record(req=r, rows=rows, batch=i, due=now) for r in batch]
            with mark(f"sdbench.request.{i}"):
                out = call(batch)
            inflight.append((i, recs, out))
            records += recs
            i += 1
            if len(inflight) < depth:
                continue
        if not inflight:
            return records, i
        k, recs, out = inflight.popleft()
        with mark(f"sdbench.fetch.{k}"):
            images = out.cpu().numpy()
        done = time.perf_counter()
        for j, r in enumerate(recs):
            r.done, r.image = done, images[j]
        if k == traced:
            slice_mark.__exit__(None, None, None)
            tracer.stop()


def run_closed(call, mix, inputs, seconds, tracer) -> Window:
    """The window of a closed loop; with a tracer, then one request traced
    at the window's load (``in_flight`` requests ahead of it, as many
    after), its images not the window's, so the profiler's cost stays out
    of the window.  The profiler starts once before that, not in set-up:
    a profiler session slows every later launch of the process."""
    rows, depth = mix.get("batch", 1), mix["in_flight"]
    t0 = time.perf_counter()
    records, n = _loop(call, rows, depth, inputs, 0,
                       lambda i: time.perf_counter() < t0 + seconds)
    window = Window(records=records, t0=t0, t1=time.perf_counter())
    if tracer.enabled:
        tracer.warm()
        traced = n + depth
        _loop(call, rows, depth, inputs, n, lambda i: i < traced + depth, tracer, traced)
    return window
