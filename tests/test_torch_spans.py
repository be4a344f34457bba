"""The span recorder of ``sdtpu_torch/utils/profiling.py`` on the CPU: off
it records nothing; during a ``torch.profiler`` session it records the
spans of every thread, on the profiler's clock; the serving engine's
spans (``engine.queued``, ``engine.collect``, ``engine.dispatch``,
``engine.fetch``) and the pipeline's (``request``, ``prepare``,
``upload``, the stages) with their parents; ``stats()`` latencies from the
same stamps; the spans in ``profiling.trace``'s ``trace.json`` and the
idle gaps ``tools/summarize_trace`` labels with them."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from sdtpu_torch import StableDiffusionPipeline
from sdtpu_torch.pipeline.serving import ServingEngine
from sdtpu_torch.tools import summarize_trace
from sdtpu_torch.utils import profiling
from test_pipeline import TINY, TOKENS
from test_torch_ops import port_config

torch.set_num_threads(1)

TIMEOUT = 120
INIT = np.random.default_rng(22).integers(0, 256, (32, 32, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def pipe():
    return StableDiffusionPipeline.from_random(port_config(TINY), seed=0, device="cpu")


@pytest.fixture(autouse=True)
def _empty():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def by_name(recorded, name):
    return [s for s in recorded if s["name"] == name]


def test_stage_records_nothing_when_off():
    assert not profiling.recording()
    with profiling.stage("off_probe", rows=1) as start:
        assert start is None
    profiling.record_span("off_explicit", 0, 1)
    assert profiling.spans() == []
    with profiling.record_spans():
        assert profiling.recording()
        with profiling.stage("on_probe", requests=(7,), rows=1) as start:
            assert isinstance(start, int)
            with profiling.stage("inner"):
                pass
    assert not profiling.recording()
    inner, outer = profiling.spans()
    assert (outer["name"], outer["requests"], outer["attrs"]) == ("on_probe", (7,), {"rows": 1})
    assert inner["parent"] == outer["id"] and outer["parent"] == 0
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert inner["tid"] == outer["tid"] == threading.get_native_id()
    assert profiling.SPAN_BUFFER == 1 << 16


def test_a_thread_started_before_the_profiler_is_recorded():
    """``record_function`` on a thread that already ran when the profiler
    started is missing from kineto's events; the recorder has it."""
    go, done = threading.Event(), threading.Event()

    def worker():
        go.wait(TIMEOUT)
        with profiling.stage("worker_span"):
            torch.ones(8).add_(1)
        done.set()

    th = threading.Thread(target=worker)
    th.start()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert profiling.recording()
        go.set()
        assert done.wait(TIMEOUT)
    th.join(TIMEOUT)
    assert not profiling.recording()
    (span,) = by_name(profiling.spans(), "worker_span")
    assert span["tid"] == th.native_id and span["parent"] == 0
    assert "worker_span" not in {e.name() for e in prof.profiler.kineto_results.events()}


def test_spans_enclose_their_kineto_spans_on_one_clock():
    """Each program span encloses the block's ``record_function`` span, as
    kineto stamps it (Unix-epoch ns), to within 1 ms at both ends."""
    names = [f"clock_probe_{i}" for i in range(5)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for name in names:
            with profiling.stage(name):
                torch.ones(256).mul_(2)
                time.sleep(0.002)
    kineto = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name() in names}
    ours = {s["name"]: s for s in profiling.spans()}
    slack = 50.0  # us: the two clocks' offset is read as two stamps in turn
    for name in names:
        k, s = kineto[name], ours[name]
        k_start, k_end = k.start_ns() / 1e3, (k.start_ns() + k.duration_ns()) / 1e3
        assert s["ts"] - slack <= k_start < s["ts"] + 1000.0
        assert s["ts"] + s["dur"] + slack >= k_end > s["ts"] + s["dur"] - 1000.0


@pytest.fixture(scope="module")
def served(pipe):
    """Four requests through an engine of batches of two, recorded: the
    spans, the stats, the per-request latencies and the client's stamps."""
    profiling.clear_spans()
    engine = ServingEngine(pipe, max_batch_size=2, max_wait_ms=500, device_batch_size=2)
    try:
        with profiling.record_spans():
            t_before = profiling.clock_ns()
            futures = [engine.submit("p", token_ids=TOKENS[0], seed=30 + i,
                                     num_inference_steps=1, image_size=32) for i in range(4)]
            for f in futures:
                f.result(timeout=TIMEOUT)
            t_after = profiling.clock_ns()
            recorded = profiling.spans()
        stats = engine.stats()
        latencies = list(engine._latencies)
    finally:
        engine.shutdown()
    return dict(spans=recorded, stats=stats, latencies=latencies, stamps=(t_before, t_after))


def test_engine_spans_per_request_and_chunk(served):
    spans, stats = served["spans"], served["stats"]
    assert stats["requests"] == 4 and stats["batches"] == 2 and stats["failures"] == 0
    queued = by_name(spans, "engine.queued")
    dispatch = by_name(spans, "engine.dispatch")
    assert len(by_name(spans, "engine.collect")) == len(dispatch) == 2
    assert len(by_name(spans, "engine.fetch")) == 2 and not by_name(spans, "engine.retry")
    assert [c["attrs"]["rows"] for c in by_name(spans, "engine.collect")] == [2, 2]
    ids = sorted(r for q in queued for r in q["requests"])
    assert len(queued) == 4 and len(set(ids)) == 4
    assert sorted(r for d in dispatch for r in d["requests"]) == ids
    for d in dispatch:
        fetch = [f for f in by_name(spans, "engine.fetch") if f["attrs"] == d["attrs"]]
        assert len(fetch) == 1 and fetch[0]["requests"] == d["requests"]
        assert fetch[0]["ts"] >= d["ts"] + d["dur"]
        for q in queued:
            if q["requests"][0] in d["requests"]:
                assert q["ts"] + q["dur"] == pytest.approx(d["ts"], abs=1.0)
                assert q["tid"] == threading.get_native_id() != d["tid"]


def test_pipeline_spans_have_the_dispatch_as_parent(served):
    spans = served["spans"]
    index = {s["id"]: s for s in spans}
    for d in by_name(spans, "engine.dispatch"):
        (req,) = [s for s in by_name(spans, "request") if s["parent"] == d["id"]]
        children = {s["name"] for s in spans if s["parent"] == req["id"]}
        assert {"tokenize", "prepare", "upload", "noise", "clip", "precompute", "unet_step",
                "vae_decode", "to_uint8"} <= children
    for s in spans:
        if s["name"] == "unet_step":  # every stage descends from one dispatch
            while s["parent"]:
                s = index[s["parent"]]
            assert s["name"] == "engine.dispatch"


def test_stats_latencies_are_submit_to_resolve(served):
    """Each latency runs from its request's submit stamp (the queued span's
    start) to a resolve just after its batch's fetch."""
    spans, lat = served["spans"], sorted(served["latencies"])
    t_before, t_after = served["stamps"]
    fetch_end = {r: f["ts"] + f["dur"] for f in by_name(spans, "engine.fetch")
                 for r in f["requests"]}
    spanned = sorted((fetch_end[q["requests"][0]] - q["ts"]) / 1e6
                     for q in by_name(spans, "engine.queued"))
    assert len(lat) == 4
    for got, want in zip(lat, spanned):
        assert 0.0 <= got - want < 0.05
        assert got <= (t_after - t_before) / 1e9
    stats = served["stats"]
    assert stats["request_latency_p50_s"] == lat[2]
    assert "batch_seconds" not in stats and "mean_batch_latency_s" not in stats


def test_generate_calls_are_request_spans(pipe):
    with profiling.record_spans():
        pipe.generate(token_ids=TOKENS, num_inference_steps=1, seed=1, num_images=2)
        pipe.generate(token_ids=TOKENS[:1], num_inference_steps=1, seed=1, init_image=INIT,
                      strength=0.5, image_size=32)
    spans = profiling.spans()
    batch, single = by_name(spans, "request")  # num_images=2 runs inside its own request
    assert batch["parent"] == single["parent"] == 0 and batch["requests"] != single["requests"]
    for req, uploads in ((batch, 1), (single, 2)):  # the image goes up after the noise
        kids = [s["name"] for s in spans if s["parent"] == req["id"]]
        assert kids.count("prepare") == 1 and kids.count("upload") == uploads
        assert kids.count("tokenize") == 1 and "vae_decode" in kids


def test_trace_json_holds_the_program_spans(pipe, tmp_path):
    """``profiling.trace`` writes the spans as their own process row, one
    row per thread, on the trace's own time base; the split labels the
    CPU run's one idle gap with a program span."""
    with profiling.trace(str(tmp_path)):
        pipe.generate(token_ids=TOKENS, num_inference_steps=2, seed=1)
    with open(tmp_path / "trace.json") as f:
        data = json.load(f)
    ours = [e for e in data["traceEvents"] if e.get("pid") == profiling.SPANS_PID]
    rows = {e["tid"] for e in ours if e["ph"] == "M" and e["name"] == "thread_name"}
    assert rows == {threading.get_native_id()}
    spans = [e for e in ours if e["ph"] == "X"]
    assert {e["cat"] for e in spans} == {"program_span"}
    assert {e["args"]["ident"] for e in spans} == {threading.get_ident()}
    assert [e["name"] for e in spans].count("unet_step") == 2
    assert {"request", "prepare", "upload"} <= {e["name"] for e in spans}
    kineto = sorted(e["ts"] for e in data["traceEvents"]
                    if e.get("cat") == "user_annotation" and e["name"] == "unet_step")
    mine = sorted(e["ts"] for e in spans if e["name"] == "unet_step")
    assert len(kineto) == 2 and all(abs(a - b) < 1000.0 for a, b in zip(kineto, mine))
    events = summarize_trace.load_trace(str(tmp_path))
    split = summarize_trace.trace_split(events, 0.0)
    assert split["host_stage_ms"]["unet_step"] > 0  # the kineto stages, counted once
    (gap,) = split["longest_idle_gaps"]
    assert gap["span"] in {e["name"] for e in spans}


def test_idle_gaps_take_the_launching_threads_innermost_span():
    """Thread 2 launches (its calls named by the low 32 bits of its
    ``get_ident``); thread 1 holds a long queued span that starts later.
    A gap inside thread 2's collect takes it, one where thread 2 has no
    span takes thread 1's, one with none says so."""
    def x(name, ts, dur, cat, tid, **kw):
        return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat, "tid": tid, **kw}

    ident = (7 << 32) | 1234
    ev = [x("engine.queued", 120, 180, "program_span", 1, args={"ident": 99}),
          x("engine.dispatch", 0, 40, "program_span", 2, args={"ident": ident}),
          x("engine.collect", 100, 100, "program_span", 2, args={"ident": ident}),
          x("unet_step", 110, 15, "program_span", 2, args={"ident": ident}),
          x("cudaLaunchKernel", 10, 1, "cuda_runtime", 1234, args={"correlation": 1}),
          x("cudaLaunchKernel", 20, 1, "cuda_runtime", 1234, args={"correlation": 2}),
          x("cudaLaunchKernel", 30, 1, "cuda_runtime", 1234, args={"correlation": 3}),
          x("k1", 50, 10, "kernel", 7, args={"correlation": 1}),
          x("k2", 200, 10, "kernel", 7, args={"correlation": 2}),
          x("k3", 400, 10, "kernel", 7, args={"correlation": 3})]
    label = summarize_trace.gap_labeller(ev)
    assert label(60, 200) == "engine.collect"   # middle 130: unet_step is not open
    assert label(110, 130) == "unet_step"       # the innermost
    assert label(210, 280) == "engine.queued"   # thread 2 holds nothing
    assert label(310, 400) == "no program span"


def test_split_of_stages_that_ran_on_another_thread():
    """With no kineto stage span (the engine's worker), the split's window
    and host stage times come from the program's stage spans."""
    def x(name, ts, dur, cat, tid=2, **kw):
        return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat, "tid": tid, **kw}

    ev = [x("engine.dispatch", 0, 100, "program_span"), x("unet_step", 10, 40, "program_span"),
          x("unet_step", 50, 40, "program_span"),
          x("cudaLaunchKernel", 15, 1, "cuda_runtime", args={"correlation": 1}),
          x("k", 20, 30, "kernel", 7, args={"correlation": 1})]
    split = summarize_trace.trace_split(ev, 0.0)
    assert split["window_ms"] == pytest.approx(0.080)
    assert split["host_stage_ms"] == pytest.approx({"unet_step": 0.080})
    assert [(round(g["ms"], 6), g["span"]) for g in split["longest_idle_gaps"]] == [
        (0.040, "unet_step"), (0.010, "unet_step")]
