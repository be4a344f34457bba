"""The generator: requests and arrival schedules reproducible from the
seed, arrivals that the mix fixes, and an open loop that times a
request from when it was due, so a stall lands in later requests'
latency."""

import threading
import time
import types

import numpy as np
import pytest
import torch

from sdbench import drive, spec, traffic
from sdbench.tests.tiny import TINY, mix
from sdbench.trace import Tracer
from sdbench.traffic import open_loop

SEED = 2**31 + 12345


def test_requests_are_reproducible_and_distinct():
    m = mix("batch8")
    a = [traffic.request(SEED, i, m, TINY["clip"]) for i in range(16)]
    b = [traffic.request(SEED, i, m, TINY["clip"]) for i in range(16)]
    for x, y in zip(a, b):
        assert x["seed"] == y["seed"] and np.array_equal(x["ids"], y["ids"])
    assert len({r["seed"] for r in a}) == 16
    assert len({r["ids"].tobytes() for r in a}) == 16
    for r in a:
        ids = r["ids"]
        vocab = TINY["clip"]["vocab_size"]
        assert ids.shape == (77,) and ids[0] == vocab - 2 and ids[-1] == vocab - 1
        eos = int(np.argmax(ids == vocab - 1))
        assert 6 <= eos <= 61 and (ids[eos:] == vocab - 1).all() and (ids[1:eos] < vocab - 2).all()
    other = traffic.request(SEED + 1, 0, m, TINY["clip"])
    assert other["seed"] != a[0]["seed"]


def test_arrivals_are_the_mix_s_own():
    m = {"rate_per_s": 4.0, "arrival_seed": 1}
    a = open_loop.arrivals(m, 40.0)
    assert np.array_equal(a, open_loop.arrivals(dict(m), 40.0))
    assert len(a) == 160 and a[0] == 0.0 and a[-1] < 40.0 and (np.diff(a) > 0).all()
    # another order of the same gaps for another arrival seed
    b = open_loop.arrivals(dict(m, arrival_seed=2), 40.0)
    np.testing.assert_allclose(np.sort(np.diff(np.append(a, 40.0))),
                               np.sort(np.diff(np.append(b, 40.0))), rtol=1e-9)
    assert not np.array_equal(a, b)
    # exponential gaps: the coefficient of variation near 1
    gaps = np.diff(np.append(a, 40.0))
    assert 0.85 < gaps.std() / gaps.mean() < 1.1
    assert gaps.mean() == pytest.approx(1 / 4.0)


def test_image_pool_is_seeded():
    m = mix("i2i-batch8")
    a = traffic.image_pool(SEED, m, 32)
    b = traffic.image_pool(SEED, m, 32)
    assert len(a) == m["init_image"]["pool"]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert a[0].dtype == np.uint8 and a[0].shape == (32, 32, 3) and a[0].std() > 10


class StallingPipe:
    """A stand-in for the pipeline behind the engine: a device batch takes
    ``step_s``; the batch that starts after ``stall_at`` takes ``stall_s``
    more, once."""

    def __init__(self, step_s=0.01, stall_at=None, stall_s=0.0):
        self.config = spec.pipeline_config(TINY)
        self.tokenizer = None
        self.step_s, self.stall_at, self.stall_s = step_s, stall_at, stall_s
        self.t0 = None
        self.lock = threading.Lock()

    def generate_batch(self, prompts, output="uint8", **kw):
        time.sleep(self.step_s)
        with self.lock:
            if self.stall_at is not None and time.perf_counter() - self.t0 >= self.stall_at:
                self.stall_at = None
                time.sleep(self.stall_s)
        return torch.zeros((len(prompts), 4, 4, 3), dtype=torch.uint8)


def _latencies(pipe, seconds=1.5, rate=20.0):
    m = mix("poisson-b8", rate_per_s=rate)
    inputs = drive.Inputs(SEED, m, TINY)
    pipe.t0 = time.perf_counter()
    w = open_loop.run(pipe, TINY, m, inputs, seconds, Tracer(False))
    return w, [r.done - r.due for r in w.records]


def _reader(name):
    from sdbench.run import load_metric

    return load_metric(name)


def test_a_stall_lands_in_later_requests_latency():
    w, calm = _latencies(StallingPipe())
    assert len(w.records) == 30 and all(r.image is not None for r in w.records)
    stalled, lat = _latencies(StallingPipe(stall_at=0.5, stall_s=0.5))
    due = np.array([r.due - stalled.t0 for r in stalled.records])
    after = np.array(lat)[(due > 0.55) & (due < 0.9)]
    # requests due while the engine was stalled waited for it, from when due
    assert after.size and after.min() > 0.1 and max(calm) < 0.2
    ctx = types.SimpleNamespace(window=stalled, wait_past_close_s=60.0)
    assert _reader("latency_p90_s")(ctx) >= 0.2
    ctx_calm = types.SimpleNamespace(window=w, wait_past_close_s=60.0)
    assert _reader("latency_p90_s")(ctx_calm) < 0.2
    rows = _reader("engine_batch_rows.serve")(types.SimpleNamespace(window=stalled))
    assert rows > 1.0  # the stall's backlog coalesced


def test_a_failed_request_counts_as_missing():
    recs = [drive.Record(req={}, due=0.0, done=0.1 * i, image=np.zeros(1)) for i in range(9)]
    recs.append(drive.Record(req={}, due=0.0, error="boom"))
    w = drive.Window(records=recs, t0=0.0, t1=2.0)
    read = _reader("latency_p90_s")
    # nearest rank 9 of 10: the ninth finished one
    assert read(types.SimpleNamespace(window=w, wait_past_close_s=60.0)) == pytest.approx(0.8)
    recs[-2] = drive.Record(req={}, due=0.0, error="boom")
    assert read(types.SimpleNamespace(window=w, wait_past_close_s=60.0)) == 62.0


def test_the_open_loop_traces_its_slice_after_the_window_with_the_engine_idle():
    """With a tracer the window is unchanged (its records and the engine's
    counts are the window's alone); the slice's arrivals are sent again
    after it as new requests, and the profiler starts and stops when every
    row sent has been made."""
    m = mix("poisson-b8", rate_per_s=20.0)
    pipe = StallingPipe()
    inputs = drive.Inputs(SEED, m, TINY)
    made, seen = [0], []
    generate = pipe.generate_batch

    def counted(prompts, **kw):
        out = generate(prompts, **kw)
        made[0] += len(prompts)
        return out

    pipe.generate_batch = counted
    tracer = Tracer(True)
    start, stop = tracer.start, tracer.stop
    tracer.start = lambda: (seen.append(made[0]), start())
    tracer.stop = lambda: (seen.append(made[0]), stop())
    pipe.t0 = time.perf_counter()
    w = open_loop.run(pipe, TINY, m, inputs, 1.5, tracer)
    assert len(w.records) == 30 and all(r.image is not None for r in w.records)
    assert w.engine_stats["requests"] == 30
    a = open_loop.arrivals(m, 1.5)
    n_slice = int(((a >= 0.6) & (a < 0.9)).sum())
    assert n_slice and seen == [30, 30 + n_slice] and tracer.done is not None
    assert "sdbench.slice" in {e["name"] for e in tracer.events}
