"""Run one cell of the benchmark once and print its result line.

    python -m sdbench.run --workload NAME --seed N --seconds S --trace 0|1

Set-up makes the weights on the card from ``--seed``, builds the pipeline
and warms the cell's own shapes; then the cell's traffic runs for
``--seconds`` (the mix's kind, ``sdbench/traffic/<kind>.py``); then a
sample of the finished requests is checked against the plain float32
reference (``check.py``).  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer ones from a profiler trace of a slice
of whole requests (``trace.py``).  Each metric is read by
``sdbench/metrics/<name>.py``; a metric ``<base>.<part>`` without a file of
its own is read by its base's (``images_per_s.sdxl`` by
``images_per_s.py``): the same quantity under a name, and a bound, of the
cells it lists.  The last line on standard output is the result's JSON;
the numbers compared, each beside its limit, are the last lines on
standard error and the line's last key.

It exits with 2, printing no result, without as many CUDA cards as the
cell asks for, and with 3 if a JAX module was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

from sdbench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sdtpu")
CACHE = spec.ROOT / "build" / "sdbench-cache"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_metric(name: str):
    path = spec.HERE / "metrics" / f"{name}.py"
    while not path.exists() and "." in name:
        name = name.rsplit(".", 1)[0]
        path = spec.HERE / "metrics" / f"{name}.py"
    mod_name = "sdbench_metric_" + name.replace(".", "_")
    s = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi: {exc}"


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = None) -> dict:
    """Set up, run the window, check: the result line's dict."""
    import torch

    from sdbench import check, drive, traffic, work
    from sdbench.trace import Tracer, View, split
    from sdbench.weights import pipeline_params
    from sdtpu_torch import StableDiffusionPipeline

    t_start = T_START if t_start is None else t_start
    device = torch.device(device)
    cuda = device.type == "cuda"
    cfg, mix = cell.config, cell.traffic
    pconfig = spec.pipeline_config(cfg)
    t0 = time.perf_counter()
    params = pipeline_params(pconfig, seed, device)
    pipe = StableDiffusionPipeline(pconfig, params, device=device)
    inputs = drive.Inputs(seed, mix, cfg)
    kind = traffic.kind(mix)
    tracer = Tracer(trace and cuda)
    t1 = time.perf_counter()
    log(f"set-up: start {t0 - t_start:.3f} s, weights and inputs {t1 - t0:.3f} s")
    kind.warm(pipe, cfg, mix, inputs)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s (warm-up {time.perf_counter() - t1:.3f} s); "
        f"window of {seconds} s")
    window = kind.run(pipe, cfg, mix, inputs, seconds, tracer)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = sum(1 for r in window.records if r.image is None)
    log(f"window {window.seconds:.3f} s: {len(window.records)} requests, {failed} failed")

    t0 = time.perf_counter()
    events = tracer.events
    view = View(events) if events is not None else None
    sp = split(view) if view is not None else None
    if view is not None:
        log(f"trace: {len(events)} records read in {time.perf_counter() - t0:.3f} s; "
            f"{len(view.whole)} whole requests launched {view.device_in(view.whole):.6f} "
            f"device s in a slice of {sp['window_s']:.6f} s")
    ctx = types.SimpleNamespace(cfg=cfg, mix=mix, window=window, view=view, split=sp,
                                work=work, peak_bytes=peak, setup_s=setup_s,
                                wait_past_close_s=drive.WAIT_PAST_CLOSE_S)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_metric(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the program's state goes before the reference runs; the weights are
    # the benchmark's own
    del pipe, tracer, view, events
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sampled = check.sample(window.records, seed, cell.check["sample"])
    refs = check.references(sampled, params, cfg, per_row=kind.PER_ROW, device=device)
    limits = cell.check["limits"]
    readings = check.readings([r.image for r in sampled], refs, limits)
    log(f"reference: {len(sampled)} requests in {time.perf_counter() - t0:.3f} s")
    ok, rows = check.judge(readings, limits)
    result = {"correct": bool(ok and failed == 0 and sampled), "attempted": len(window.records),
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": torch.cuda.get_device_name(device) if cuda else str(device),
                         "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if sp is not None:
        result["device"].update(busy_s=sp["busy_s"], window_s=sp["window_s"])
        result["breakdown"] = {"device_ops": sp["device_ops"], "idle_gaps": sp["idle_gaps"]}
    result["check"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {power_line()}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {found}")
        return 3
    for name, c in result["check"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # every thread and child has ended and the result is out: leave without
    # the interpreter's teardown, where the profiler's CUDA libraries may
    # still be torn down after a traced run
    os._exit(rc)
