"""``ServingEngine.submit`` of one request each at open-loop arrival times;
a request's latency runs from when it was due.  The window's requests are
waited for up to a minute past its close.  With a tracer, the arrivals of
40% to 60% of the window are sent again after it and traced, the engine
idle when the profiler starts and stops.

Parameters: ``rate_per_s`` and ``arrival_seed`` (the arrivals, below),
``max_batch_size``, ``device_batch_size``, ``max_wait_ms`` (the engine's
settings) and ``warm_batch_sizes`` (the device batch sizes set-up warms).
"""

from __future__ import annotations

import concurrent.futures
import threading
import time

import numpy as np

from sdbench import drive, spec
from sdbench.trace import mark
from sdbench.traffic import batched

PER_ROW = True
call = batched.call  # the engine's device batches are generate_batch calls


def arrivals(mix: dict, seconds: float) -> np.ndarray:
    """Open-loop arrival offsets in [0, seconds): n = rate * seconds
    requests whose gaps are the n quantiles of the exponential
    distribution at (k + 1/2)/n, in the order ``arrival_seed`` draws,
    scaled to fill the window.  The run's seed does not move them: where
    it ordered the gaps, the order alone moved the 90th percentile by a
    third between seeds at one rate."""
    n = max(1, int(round(mix["rate_per_s"] * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    rng = np.random.default_rng([int(mix["arrival_seed"]), 0xA441])
    gaps = rng.permutation(gaps) * (seconds / gaps.sum())
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def warm(pipe, cfg, mix, inputs=None) -> None:
    """The engine's device batch sizes, each once (``warmup``)."""
    pipe.warmup(image_sizes=(cfg["image_size"],), step_counts=(cfg["steps"],),
                batch_sizes=tuple(mix["warm_batch_sizes"]), cfg=spec.guided(cfg),
                sampler=cfg["sampler"])


def _serve(engine, inputs, offsets, first, kw, t0) -> tuple:
    """Request ``first + k`` submitted at ``t0 + offsets[k]``, each record
    filled in when its future resolves.  Returns (records, futures)."""
    lock = threading.Lock()
    records, futures = [], []
    for k, off in enumerate(offsets):
        r = inputs(first + k)
        rec = drive.Record(req=r, due=t0 + float(off))
        records.append(rec)
        delay = rec.due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        fut = engine.submit("", token_ids=r["ids"], seed=r["seed"], **kw)

        def finished(f, rec=rec):
            t = time.perf_counter()
            with lock:
                rec.done = t
                if f.exception() is not None:
                    rec.error = repr(f.exception())
                else:
                    rec.image = f.result()

        fut.add_done_callback(finished)
        futures.append(fut)
    return records, futures


def _wait(futures, until) -> bool:
    """Wait for every future up to ``until``; whether all resolved."""
    try:
        for fut in futures:
            fut.exception(timeout=max(0.0, until - time.perf_counter()))
    except concurrent.futures.TimeoutError:
        return False
    return True


def _settle(engine, served, limit_s=5.0) -> bool:
    """Wait until the engine has counted ``served`` requests: its worker
    has left the last batch and waits for the queue, launching nothing."""
    end = time.perf_counter() + limit_s
    while time.perf_counter() < end:
        s = engine.stats()
        if s["requests"] + s["failures"] >= served:
            return True
        time.sleep(0.005)
    return False


def _traced_slice(engine, inputs, offsets, seconds, kw, tracer) -> None:
    """The arrivals that the window had between 40% and 60% of its length,
    sent again as new requests (indices past the window's) with the engine
    idle at the profiler's start and stop: a profiler started or stopped
    while the engine's worker launches can bring the process down.  The
    slice mark spans those 20% of the window; the requests then finish
    before the profiler stops."""
    lo, hi = 0.4 * seconds, 0.6 * seconds
    part = offsets[(offsets >= lo) & (offsets < hi)]
    if not part.size:
        return
    tracer.warm()
    tracer.start()
    with mark("sdbench.slice"):
        t0 = time.perf_counter()
        _, futures = _serve(engine, inputs, part - lo, len(offsets), kw, t0)
        time.sleep(max(0.0, t0 + (hi - lo) - time.perf_counter()))
    done = _wait(futures, time.perf_counter() + drive.WAIT_PAST_CLOSE_S)
    if done:
        _settle(engine, len(offsets) + len(futures))
    tracer.stop()


def run(pipe, cfg, mix, inputs, seconds, tracer, offsets=None) -> drive.Window:
    """The window at ``offsets`` (by default ``arrivals(mix, seconds)``);
    with a tracer, then the traced slice, once every request of the window
    has finished."""
    from sdtpu_torch.pipeline.serving import ServingEngine

    offsets = arrivals(mix, seconds) if offsets is None else offsets
    kw = drive.gen_kwargs(cfg)
    engine = ServingEngine(pipe, max_batch_size=mix["max_batch_size"],
                           max_wait_ms=mix["max_wait_ms"],
                           device_batch_size=mix["device_batch_size"])
    try:
        t0 = time.perf_counter()
        records, futures = _serve(engine, inputs, offsets, 0, kw, t0)
        done = _wait(futures, t0 + seconds + drive.WAIT_PAST_CLOSE_S)
        t1 = time.perf_counter()
        stats = engine.stats()
        if tracer.enabled and done and _settle(engine, len(offsets)):
            _traced_slice(engine, inputs, offsets, seconds, kw, tracer)
    finally:
        engine.shutdown()
    for rec in records:
        if rec.done is None and rec.error is None:
            rec.error = "not finished a minute past the close"
    return drive.Window(records=records, t0=t0, t1=max(t1, t0 + seconds), engine_stats=stats)
