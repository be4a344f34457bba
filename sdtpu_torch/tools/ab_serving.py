"""Serving against single requests in one process, the counterpart of the
JAX package's ``tools/ab_serving.py``::

    python -m sdtpu_torch.tools.ab_serving [--preset tiny-sd] [--steps 25]
        [--image-size 512] [--sampler ddpm] [--no-cfg] [--requests 32]
        [--batches 1 2 4 8] [--engine-batches 8 2] [--repeats 6]
        [--device-batch N] [--device cuda]

Three measurements on zero weights of the preset's shapes, in one process
(two calls' hosts can differ by more than the effect):

1. each ``--batches`` size as a pipelined stream of ``generate_batch(...,
   output="device")`` requests: the per-image gap shows whether a larger
   request is cheaper per image;
2. the ``ServingEngine`` at each ``--engine-batches`` ``max_batch_size``
   over ``--requests`` requests (and at the largest with
   ``--device-batch`` rows per device request, where given);
3. a ``generate_async`` loop of single requests over as many requests.

Prints one JSON line.  On the card by default (it exits non-zero without
one); ``--device cpu`` is for the tests.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="tiny-sd")
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--sampler", default="ddpm")
    ap.add_argument("--no-cfg", action="store_true",
                    help="no CFG (guidance-embedding presets)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--batches", type=int, nargs="*", default=[1, 2, 4, 8])
    ap.add_argument("--engine-batches", type=int, nargs="*", default=[8, 2])
    ap.add_argument("--repeats", type=int, default=6,
                    help="stream length per generate_batch size")
    ap.add_argument("--device-batch", type=int, default=None,
                    help="an engine device_batch_size to test as well")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the three measurements; prints the JSON line and returns it."""
    args = parse_args(argv)
    cfg = not args.no_cfg

    import numpy as np
    import torch

    from sdtpu_torch.config import get_preset
    from sdtpu_torch.pipeline.pipeline import StableDiffusionPipeline
    from sdtpu_torch.pipeline.serving import ServingEngine
    from sdtpu_torch.tools import require_cuda
    from sdtpu_torch.utils.weights import zero_pipeline_params

    device = torch.device(args.device)
    if device.type == "cuda":
        require_cuda("ab_serving")
    config = get_preset(args.preset)
    pipe = StableDiffusionPipeline(config, zero_pipeline_params(config, device=device),
                                   device=device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[{name}] preset={args.preset} {args.image_size}px {args.steps}-step "
          f"{args.sampler}", file=sys.stderr)
    rng = np.random.default_rng(40)
    vocab, max_len = config.text_config.vocab_size, config.text_config.max_length
    results = {"device": name, "preset": args.preset, "steps": args.steps,
               "size": args.image_size}
    kw = dict(num_inference_steps=args.steps, image_size=args.image_size,
              sampler=args.sampler, cfg=cfg)

    # 1. each request size as a pipelined stream
    raw = {}
    for b in args.batches:
        ids = rng.integers(1, vocab, (b, max_len))

        def run(seed, b=b, ids=ids):
            return pipe.generate_batch(["ab"] * b, token_ids=ids, output="device",
                                       seeds=[seed + i for i in range(b)], **kw)

        t0 = time.perf_counter()
        run(0).cpu()
        print(f"batch {b}: first {time.perf_counter() - t0:.1f}s", file=sys.stderr)
        marks = []
        pending = run(100)
        for i in range(args.repeats):
            nxt = run(200 + 100 * i)
            pending.cpu()
            marks.append(time.perf_counter())
            pending = nxt
        pending.cpu()
        marks.append(time.perf_counter())
        p50 = statistics.median([y - x for x, y in zip(marks, marks[1:])])
        raw[b] = {"p50_batch_s": round(p50, 4), "per_image_s": round(p50 / b, 4),
                  "images_per_sec": round(b / p50, 3)}
        print(f"batch {b}: p50 {p50 * 1000:.1f} ms ({p50 / b * 1000:.1f} ms/image, "
              f"{b / p50:.3f} img/s)", file=sys.stderr)
    results["raw_program"] = raw

    # 2. the engine at each max_batch_size
    def drive_engine(max_bs, device_bs=None):
        n = args.requests
        ids = rng.integers(1, vocab, (n, max_len))
        extra = {} if device_bs is None else {"device_batch_size": device_bs}
        engine = ServingEngine(pipe, max_batch_size=max_bs, max_wait_ms=5.0, **extra)
        try:
            t0 = time.perf_counter()
            futs = [engine.submit("ab", token_ids=ids[i], seed=i, **kw) for i in range(n)]
            for f in futs:
                f.result(timeout=1200)
            wall = time.perf_counter() - t0
            stats = engine.stats()
        finally:
            engine.shutdown()
        return {"images_per_sec": round(n / wall, 3), "wall_s": round(wall, 3),
                "batches": stats["batches"],
                "p50_request_latency_s": round(stats.get("request_latency_p50_s",
                                                         float("nan")), 3)}

    engine_res = {}
    for mb in args.engine_batches:
        engine_res[f"engine_b{mb}"] = drive_engine(mb)
        print(f"engine max_batch={mb}: {engine_res[f'engine_b{mb}']}", file=sys.stderr)
    if args.device_batch is not None:
        key = f"engine_b{max(args.engine_batches)}_db{args.device_batch}"
        engine_res[key] = drive_engine(max(args.engine_batches), device_bs=args.device_batch)
        print(f"{key}: {engine_res[key]}", file=sys.stderr)
    results["engine"] = engine_res

    # 3. single requests, pipelined with generate_async
    n = args.requests
    ids1 = rng.integers(1, vocab, (2 if cfg else 1, max_len))
    pipe.generate_async("ab", token_ids=ids1, seed=999, **kw).result()  # warm, untimed
    t0 = time.perf_counter()
    pending = pipe.generate_async("ab", token_ids=ids1, seed=0, **kw)
    for i in range(1, n):
        nxt = pipe.generate_async("ab", token_ids=ids1, seed=i, **kw)
        pending.result()
        pending = nxt
    pending.result()
    wall = time.perf_counter() - t0
    results["single_shot_async"] = {"images_per_sec": round(n / wall, 3),
                                    "wall_s": round(wall, 3)}
    print(f"single-shot async loop: {n / wall:.3f} img/s", file=sys.stderr)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
