"""Capture a profiler trace of the bench's workload for
``tools/summarize_trace.py``: the counterpart of the JAX package's
``tools/capture_trace.py``::

    python -m sdtpu_torch.tools.capture_trace [--preset tiny-sd] [--image-size 512]
        [--steps 25] [--sampler ddpm] [--no-cfg] [--int8] [--int8-transformer]
        [--int8-transformer-full] [--int8-vae] [--encoder-cache K] [--batch 1]
        [--repeats 3] [--out build/trace/capture] [--device cuda]
    python -m sdtpu_torch.tools.summarize_trace build/trace/capture --steps 25

The workload is ``python -m sdtpu_torch.bench``'s: the preset's zero
weights (speed does not depend on the values), quantized with the int8
flags, fixed token ids, ``generate_batch`` of ``--batch`` rows with
``output="device"``.  One request runs outside the trace (the kernels'
build and the allocator's warm-up), then ``--repeats + 1`` requests run
pipelined under ``utils/profiling.trace(--out)``, which writes
``--out/trace.json``: request N+1 is dispatched before request N is
fetched, as the bench times them.  On the CPU (``--device cpu``, the tests)
the trace holds the host's ops only; without a card ``--device cuda``
exits non-zero.  ``main()`` returns the trace's path.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="tiny-sd")
    ap.add_argument("--image-size", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--sampler", default=None)
    ap.add_argument("--no-cfg", action="store_true")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--int8-transformer", action="store_true")
    ap.add_argument("--int8-transformer-full", action="store_true")
    ap.add_argument("--int8-vae", action="store_true")
    ap.add_argument("--encoder-cache", type=int, default=1)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=os.path.join("build", "trace", "capture"))
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> str:
    args = parse_args(argv)

    import numpy as np

    from sdtpu_torch import StableDiffusionPipeline
    from sdtpu_torch.config import get_preset
    from sdtpu_torch.tools import card_line, device_arg
    from sdtpu_torch.utils import profiling
    from sdtpu_torch.utils.weights import zero_pipeline_params

    device = device_arg("capture_trace", args.device)
    if device.type == "cuda":
        print(card_line(), flush=True)
    config = get_preset(args.preset)
    steps = args.steps if args.steps is not None else config.default_steps
    sampler = args.sampler or config.default_sampler
    cfg = False if args.no_cfg else config.default_cfg
    size = args.image_size or config.default_image_size

    pipe = StableDiffusionPipeline(config, zero_pipeline_params(config, device=device),
                                   device=device)
    if args.int8 or args.int8_transformer or args.int8_transformer_full:
        transformer = ("full" if args.int8_transformer_full
                       else bool(args.int8_transformer))
        pipe.quantize_int8(transformer=transformer, vae=args.int8_vae)
    elif args.int8_vae:
        pipe.quantize_int8(vae=True)

    rng = np.random.default_rng(40)
    b = args.batch
    ids = rng.integers(1, config.text_config.vocab_size, (b, config.text_config.max_length))

    def run(seed):
        return pipe.generate_batch(
            ["trace"] * b, token_ids=ids, num_inference_steps=steps, image_size=size,
            sampler=sampler, cfg=cfg, seeds=[seed + i for i in range(b)], output="device",
            encoder_cache_interval=args.encoder_cache)

    t0 = time.perf_counter()
    run(0).cpu()  # the kernels' build and warm-up outside the trace
    print(f"first request {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    with profiling.trace(args.out):
        pending = run(100)
        for i in range(args.repeats):
            nxt = run(200 + 100 * i)
            pending.cpu()
            pending = nxt
        pending.cpu()
    path = os.path.join(args.out, "trace.json")
    print(f"trace written to {path} ({args.repeats + 1} pipelined generations, {steps} steps, "
          f"batch {b}, {sampler}, cfg={cfg})", flush=True)
    return path


if __name__ == "__main__":
    main()
