"""Find the highest rate an open-loop cell's system sustains: the cell's
traffic at each of several fixed rates, in one process on one set of
weights, each for ``--seconds``:

    python -m sdbench.sweep --workload tinysd-serve --rates 3 3.5 4 4.5 5 --seconds 40

Per rate it prints the requests offered, those still unfinished at the
window's close (the backlog), the mean latency of the first and of the
last quarter of the arrivals (a queue that grows makes the second the
larger), the 90th percentile latency and the engine's rows per batch.  The
knee is the highest rate whose backlog stays about one device batch and
whose last quarter waits no longer than its first; the cell's rate is set
at 0.8 of it, in the traffic file.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from sdbench import spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=2_900_000_003)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the sweep needs a CUDA card", file=sys.stderr)
        return 2
    from sdbench import drive, traffic
    from sdbench.trace import Tracer
    from sdbench.weights import pipeline_params
    from sdtpu_torch import StableDiffusionPipeline

    cell = spec.load_cell(args.workload)
    cfg = cell.config
    pconfig = spec.pipeline_config(cfg)
    pipe = StableDiffusionPipeline(pconfig, pipeline_params(pconfig, args.seed, "cuda"),
                                   device="cuda")
    kind = traffic.kind(cell.traffic)
    kind.warm(pipe, cfg, cell.traffic)
    for k, rate in enumerate(args.rates):
        mix = dict(cell.traffic, rate_per_s=rate)
        seed = args.seed + k
        w = kind.run(pipe, cfg, mix, drive.Inputs(seed, mix, cfg), args.seconds, Tracer(False))
        close = w.t0 + args.seconds
        lat = np.array([(r.done - r.due) if r.image is not None else np.inf
                        for r in w.records])
        q = max(1, len(lat) // 4)
        s = w.engine_stats or {}
        print(json.dumps({
            "rate_per_s": rate, "offered": len(w.records),
            "backlog_at_close": sum(1 for r in w.records if r.done is None or r.done > close),
            "first_quarter_mean_s": float(lat[:q].mean()),
            "last_quarter_mean_s": float(lat[-q:].mean()),
            "p90_s": float(np.sort(lat)[int(np.ceil(0.9 * len(lat))) - 1]),
            "rows_per_batch": s["requests"] / s["batches"] if s.get("batches") else None,
            "failed": sum(1 for r in w.records if r.image is None)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
