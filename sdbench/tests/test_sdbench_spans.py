"""The serve cell's engine metrics on a synthetic trace and synthetic
program spans: the queue wait's 90th percentile over the slice's
``engine.queued`` spans, and the slice's idle share while a request waits;
both None without a trace or without spans (a program that records
none)."""

import types

import pytest

from sdbench import work
from sdbench.tests.tiny import TINY
from sdbench.trace import View, split
from sdtpu_torch.utils import profiling


def _metric(name):
    from sdbench.run import load_metric

    return load_metric(name)


def ev(name, ts, dur, cat="user_annotation"):
    return {"cat": cat, "name": name, "ts": float(ts), "dur": float(dur), "corr": 0, "tid": 1}


def queued(ts, dur):
    return {"name": "engine.queued", "id": 0, "parent": 0, "requests": (1,), "tid": 1,
            "ts": float(ts), "dur": float(dur), "attrs": {}}


def trace():
    """A slice [1000, 2000) us; the card busy in [1100, 1300), [1250, 1400)
    and [1800, 1900), and before the slice."""
    return [ev("sdbench.slice", 1000, 1000), ev("k", 900, 150, "kernel"),
            ev("k", 1100, 200, "kernel"), ev("k", 1250, 150, "kernel"),
            ev("m", 1800, 100, "gpu_memcpy")]


SPANS = [queued(500, 800),    # starts before the slice: waits [1000, 1300) inside it
         queued(1050, 100),   # [1050, 1150)
         queued(1350, 250),   # [1350, 1600)
         queued(1500, 400),   # [1500, 1900)
         queued(1950, 300),   # runs past the slice's end: [1950, 2000)
         {**queued(1000, 5000), "name": "engine.dispatch"}]


def _ctx(view):
    return types.SimpleNamespace(cfg=TINY, mix={"batch": 1}, view=view,
                                 split=split(view) if view else None, work=work)


@pytest.fixture
def spans(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))


def test_queue_wait_p90_takes_the_slices_queued_spans(spans):
    # the four queued spans that start in the slice: 100, 250, 300, 400 us;
    # nearest rank ceil(0.9 * 4) = 4
    assert _metric("engine_queue_wait_p90_s.serve")(_ctx(View(trace()))) == \
        pytest.approx(400e-6)


def test_idle_with_queued_share(spans):
    # waiting: [1000, 1300) + [1350, 1900) + [1950, 2000) = 900 us; busy in it:
    # [1000, 1050) + [1100, 1300) + [1350, 1400) + [1800, 1900) = 400 us
    assert _metric("idle_with_queued_pct.serve")(_ctx(View(trace()))) == \
        pytest.approx(100 * 500 / 1000)


@pytest.mark.parametrize("name", ["engine_queue_wait_p90_s.serve",
                                  "idle_with_queued_pct.serve"])
def test_engine_readers_return_nothing_without_spans(name, monkeypatch):
    ctx = _ctx(View(trace()))
    assert _metric(name)(_ctx(None)) is None
    monkeypatch.setattr(profiling, "spans", lambda: [SPANS[-1]])
    assert _metric(name)(ctx) is None  # no engine.queued span
    monkeypatch.delattr(profiling, "spans")  # a program without the recorder
    assert _metric(name)(ctx) is None
