"""Benchmark of the port: Tiny-SD 512x512 txt2img, 25 DDPM steps, CFG 7.5,
batch 1 on one NVIDIA card, the counterpart of the JAX package's
``bench.py`` with the same flags and the same one JSON line::

    python -m sdtpu_torch.bench [--repeats 5] [--int8] [--no-overlap] ...
    {"metric": ..., "value": N, "unit": "images/sec", "vs_baseline": N, ...}

It adds ``--device`` (default ``cuda``; ``cpu`` for the tests, which then
report no MFU).  ``--preset`` takes any preset at its native size, steps,
sampler and guidance: ``sdxl`` (1024x1024, 25 steps, CFG), ``sdxl-turbo``
(512x512, 4 Euler steps, no CFG), ``sdxl-refiner`` (a whole schedule from
noise), ``sdxl-inpaint``, ``lcm-sd15`` (4 LCM steps, the guidance as an
embedding).  ``--img2img`` VAE-encodes an init image first (at
``--strength``); a 9-channel inpaint preset also takes a mask (the right
half) at strength 1, an 8-channel InstructPix2Pix preset an init image.
``--batch`` > 1 runs ``generate_batch``; ``--serving`` drives ``--requests``
requests through the ``ServingEngine`` (``--batch`` coalesced,
``--device-batch`` rows per device request) and prints the serving line.
``--controlnet`` attaches a ControlNet of zeros with the preset's shapes
(in its parameter dtype) and conditions every request on a seeded uint8
control map; ``--pag-scale`` adds Perturbed-Attention Guidance's third
branch; ``--encoder-cache k`` runs the UNet's encoder once per k steps.
``--sampler`` takes any of the 13 names of
``sdtpu_torch.samplers.SAMPLERS``; another name raises ``ValueError``.

The parameters are zeros of the init shapes (speed does not depend on the
weight values), quantized with ``--int8``; ``SDTPU_PACKED_OUT_PROJ=1`` in
the environment switches the flash route's out-projections to kernel G.
The token ids are fixed; timing covers tokens -> uint8 image on the host.
By default it is pipelined: request N+1 is dispatched (``output="device"``)
before request N is fetched, and an image's time is the gap between
successive fetches; ``--no-overlap`` times each request alone.  The
analytic FLOP count covers no conditioned UNet (9 or 8 input channels),
whose line then has no ``program_tflops`` and ``mfu_pct``, as in the JAX
package's; nor a ControlNet, PAG's third branch or the encoder cache,
whose line has them null (the JAX bench gives none).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

# H100 SXM dense bf16 tensor-core peak at its 700 W power limit (NVIDIA
# data sheet): the base of ``mfu_pct``
PEAK_FLOPS = 989e12


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="tiny-sd")
    ap.add_argument("--image-size", type=int, default=None,
                    help="default: the preset's native size")
    ap.add_argument("--steps", type=int, default=None,
                    help="default: the preset's native step count")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--attention-impl", default=None, choices=["auto", "xla", "flash"])
    ap.add_argument("--sampler", default=None, help="default: the preset's native sampler")
    ap.add_argument("--img2img", action="store_true",
                    help="VAE-encode an init image first")
    ap.add_argument("--strength", type=float, default=0.75)
    ap.add_argument("--no-cfg", action="store_true", help="force guidance off")
    ap.add_argument("--int8", action="store_true",
                    help="W8A8-quantize the UNet resnet convs (kernel D)")
    ap.add_argument("--int8-transformer", action="store_true",
                    help="with --int8: also quantize the post-LN transformer matmuls")
    ap.add_argument("--int8-transformer-full", action="store_true",
                    help="with --int8: transformer='full' (also the out-projections and "
                         "the GeGLU down-projection, with run-time row scales)")
    ap.add_argument("--int8-vae", action=argparse.BooleanOptionalAction, default=None,
                    help="with --int8: also quantize the VAE decoder's resnet convs "
                         "(default: on for few-step presets)")
    ap.add_argument("--controlnet", action="store_true",
                    help="attach a zero ControlNet and condition on a control image")
    ap.add_argument("--pag-scale", type=float, default=0.0,
                    help="Perturbed-Attention Guidance scale")
    ap.add_argument("--encoder-cache", type=int, default=1,
                    help="encoder-feature reuse interval")
    ap.add_argument("--no-overlap", action="store_true",
                    help="time each request alone instead of pipelined")
    ap.add_argument("--serving", action="store_true",
                    help="drive requests through the micro-batching serving engine")
    ap.add_argument("--requests", type=int, default=32, help="request count for --serving")
    ap.add_argument("--device-batch", type=int, default=None,
                    help="rows per device program for --serving")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the tests)")
    args = ap.parse_args(argv)
    if args.device_batch is not None and args.device_batch < 1:
        ap.error("--device-batch must be >= 1 (rows per device program)")
    return args


def main(argv=None) -> dict:
    """Run the benchmark; prints the JSON line and returns it as a dict."""
    args = parse_args(argv)

    import numpy as np
    import torch

    from sdtpu_torch import StableDiffusionPipeline
    from sdtpu_torch.config import get_preset
    from sdtpu_torch.pipeline.pipeline import check_features
    from sdtpu_torch.samplers import get_sampler
    from sdtpu_torch.utils.flops import pipeline_flops
    from sdtpu_torch.utils.runtime import device_sync
    from sdtpu_torch.utils.weights import zero_controlnet_params, zero_pipeline_params

    config = get_preset(args.preset)
    if args.attention_impl:
        config = config.replace(attention_impl=args.attention_impl)
    steps = args.steps if args.steps is not None else config.default_steps
    sampler = args.sampler or config.default_sampler
    cfg = False if args.no_cfg else config.default_cfg
    if args.image_size is None:
        args.image_size = config.default_image_size
    get_sampler(sampler)  # an unknown name raises before any parameter is made
    # as do the step features' invalid values, with the JAX package's messages
    check_features(args.encoder_cache, args.controlnet, 0.0, args.pag_scale, None, cfg,
                   config.unet.in_channels == 2 * config.vae.latent_channels)
    device = torch.device(args.device)
    dev_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else str(device))
    print(f"device={dev_name}, preset={config.name}, {args.image_size}px, {steps} steps "
          f"({sampler}, {'cfg' if cfg else 'no-cfg'}), batch={args.batch}", file=sys.stderr)

    t0 = time.perf_counter()
    pipe = StableDiffusionPipeline(config, zero_pipeline_params(config, device=device),
                                   device=device)
    if args.int8:
        transformer = "full" if args.int8_transformer_full else args.int8_transformer
        pipe.quantize_int8(transformer=transformer, vae=args.int8_vae)
    device_sync(pipe.params["unet"]["conv_in"]["bias"])
    print(f"params materialized in {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    rng = np.random.default_rng(40)
    # conditioned UNets take their inputs: a 9-channel inpaint UNet an init
    # image and a mask, at strength 1; an 8-channel editing UNet an init image
    latent_ch = config.vae.latent_channels
    bench_mask = None
    if config.unet.in_channels == 2 * latent_ch + 1:
        args.img2img = True
        bench_mask = np.zeros((args.image_size, args.image_size), np.uint8)
        bench_mask[:, args.image_size // 2:] = 255
        args.strength = 1.0
    elif config.unet.in_channels == 2 * latent_ch:
        args.img2img = True
    control_image = None
    if args.controlnet:
        pipe.load_controlnet(zero_controlnet_params(config, device=device))
        control_image = rng.integers(0, 255, (args.image_size, args.image_size, 3),
                                     dtype=np.uint8)
    features = dict(pag_scale=args.pag_scale, encoder_cache_interval=args.encoder_cache)
    if args.serving:
        return _bench_serving(args, pipe, config, rng, dev_name, steps, sampler, cfg,
                              control_image, features)
    init_image = (rng.integers(0, 255, (args.image_size, args.image_size, 3), dtype=np.uint8)
                  if args.img2img else None)
    if args.batch == 1:
        ids = rng.integers(1, config.text_config.vocab_size,
                           (2 if cfg else 1, config.text_config.max_length))

        def run(seed: int, output: str = "uint8"):
            return pipe.generate("bench", token_ids=ids, num_inference_steps=steps, seed=seed,
                                 image_size=args.image_size, output=output, sampler=sampler,
                                 cfg=cfg, init_image=init_image, strength=args.strength,
                                 mask_image=bench_mask, control_image=control_image,
                                 **features)
    else:
        ids = rng.integers(1, config.text_config.vocab_size,
                           (args.batch, config.text_config.max_length))

        def run(seed: int, output: str = "uint8"):
            return pipe.generate_batch(
                ["bench"] * args.batch, token_ids=ids, num_inference_steps=steps, seed=seed,
                image_size=args.image_size, output=output, sampler=sampler, cfg=cfg,
                init_images=[init_image] * args.batch if init_image is not None else None,
                mask_images=[bench_mask] * args.batch if bench_mask is not None else None,
                strength=args.strength,
                control_images=([control_image] * args.batch if control_image is not None
                                else None), **features)

    t0 = time.perf_counter()
    run(0)
    print(f"first run: {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    mode = "sequential" if args.no_overlap else "pipelined"
    if args.no_overlap:
        times = []
        for i in range(args.repeats):
            t0 = time.perf_counter()
            run(i + 1)
            times.append(time.perf_counter() - t0)
            print(f"run {i}: {times[-1] * 1000:.1f} ms", file=sys.stderr)
    else:
        # dispatch image N+1 before fetching image N, so that the host's
        # work for one request overlaps the card's for the other; the time
        # per image is the gap between successive fetches (the first gap
        # still holds the un-overlapped dispatch)
        marks, dispatches = [], []
        t0 = time.perf_counter()
        dispatches.append(t0)
        pending = run(1, output="device")
        for i in range(args.repeats):
            dispatches.append(time.perf_counter())
            nxt = run(i + 2, output="device")
            pending.cpu()  # fetch image i
            marks.append(time.perf_counter())
            pending = nxt
        pending.cpu()
        marks.append(time.perf_counter())  # the last image in flight
        times = [b - a for a, b in zip(marks, marks[1:])] or [marks[0] - t0]
        # per request, dispatch -> fetched: under depth-1 pipelining longer
        # than the gap by the time it queued behind its predecessor
        request_times = [m - d for d, m in zip(dispatches, marks)]
        for i, t in enumerate(times):
            print(f"gap {i}: {t * 1000:.1f} ms", file=sys.stderr)
        print(f"request latency p50: {statistics.median(request_times) * 1000:.1f} ms",
              file=sys.stderr)

    p50 = statistics.median(times)
    images_per_sec = args.batch / p50
    variant = ("int8 " if args.int8 else "") + ("controlnet " if args.controlnet else "") + (
        f"enc-cache{args.encoder_cache} " if args.encoder_cache > 1 else "") + (
        "img2img " if args.img2img else "")
    guidance = "CFG" if cfg else "no-CFG"
    result = {
        "metric": f"{args.preset} {args.image_size}x{args.image_size} "
                  f"{variant}{steps}-step {sampler} {guidance} images/sec/chip",
        "value": round(images_per_sec, 4),
        "unit": "images/sec",
        "vs_baseline": round(images_per_sec / 1.0, 4),
        "baseline_definition": "north-star target 1.0 img/s (reference publishes none)",
        "p50_latency_s": round(p50, 4),
        # pipelined: the steady-state gap between fetches (a throughput
        # basis), not a request latency, which is reported below
        "p50_latency_semantics": ("inter_completion_gap" if mode == "pipelined"
                                  else "request_wall"),
        "timing_mode": mode,
        "batch": args.batch,
        "device": dev_name,
    }
    if mode == "pipelined":
        result["p50_request_latency_s"] = round(statistics.median(request_times), 4)
    if config.unet.in_channels == latent_ch and (
            args.controlnet or args.pag_scale > 0.0 or args.encoder_cache > 1):
        # the FLOP count covers neither the ControlNet, PAG's branch nor
        # the encoder cache: no share of the peak rather than a wrong one
        result["program_tflops"] = result["mfu_pct"] = None
    elif config.unet.in_channels == latent_ch:
        flops = pipeline_flops(pipe.config, args.image_size, steps, args.batch, cfg=cfg,
                               img2img=args.img2img, strength=args.strength)
        result["program_tflops"] = round(flops / 1e12, 2)
        # a share of the card's peak; a CPU run measures no card
        result["mfu_pct"] = (round(100.0 * flops / p50 / PEAK_FLOPS, 1)
                             if device.type == "cuda" else None)
    print(json.dumps(result))
    return result


def _bench_serving(args, pipe, config, rng, dev_name, steps, sampler, cfg, control_image,
                   features) -> dict:
    """Requests through the ServingEngine (queueing, coalescing, per-request
    keys and two batches in flight included), after a warmup of the device
    request sizes it will run: the serving JSON line.  Every request and
    the warmup carry ``control_image`` and the step ``features``."""
    import numpy as np

    from sdtpu_torch.pipeline.serving import DEFAULT_DEVICE_BATCH, ServingEngine

    n = args.requests - args.requests % args.batch or args.batch
    ids = rng.integers(1, config.text_config.vocab_size, (n, config.text_config.max_length))
    init_image = mask_image = None
    latent_ch = config.vae.latent_channels
    if config.unet.in_channels != latent_ch:
        init_image = rng.integers(0, 255, (args.image_size, args.image_size, 3), dtype=np.uint8)
        if config.unet.in_channels == 2 * latent_ch + 1:
            mask_image = np.zeros((args.image_size, args.image_size), np.uint8)
            mask_image[:, args.image_size // 2:] = 255
    strength = 1.0 if mask_image is not None else args.strength
    # every request is submitted at once, so the device requests are
    # min(db, batch) rows and the remainder batch % db: both warmed
    db = args.device_batch if args.device_batch is not None else DEFAULT_DEVICE_BATCH
    warm = sorted({min(db, args.batch)} | ({args.batch % db} if args.batch % db else set()))
    pipe.warmup(image_sizes=(args.image_size,), step_counts=(steps,), batch_sizes=tuple(warm),
                cfg=cfg, sampler=sampler, img2img=init_image is not None,
                inpaint=mask_image is not None, strength=strength, control_image=control_image,
                **features)
    engine = ServingEngine(pipe, max_batch_size=args.batch, max_wait_ms=5.0,
                           device_batch_size=db)
    try:
        t0 = time.perf_counter()
        futs = [engine.submit("bench", token_ids=ids[i], seed=i, num_inference_steps=steps,
                              sampler=sampler, cfg=cfg, image_size=args.image_size,
                              init_image=init_image, mask_image=mask_image, strength=strength,
                              control_image=control_image, **features)
                for i in range(n)]
        for f in futs:
            f.result(timeout=600)
        wall = time.perf_counter() - t0
        stats = engine.stats()
    finally:
        engine.shutdown()
    result = {
        "metric": f"{args.preset} {args.image_size}x{args.image_size} {steps}-step {sampler} "
                  f"{'CFG' if cfg else 'no-CFG'} serving images/sec/chip",
        "value": round(n / wall, 4),
        "unit": "images/sec",
        "vs_baseline": round(n / wall / 1.0, 4),
        "baseline_definition": "north-star target 1.0 img/s (reference publishes none)",
        "requests": n,
        "mean_batch_size": round(stats["mean_batch_size"], 2),
        "batches": stats["batches"],
        "wall_s": round(wall, 3),
        "device": dev_name,
    }
    for k in ("request_latency_p50_s", "request_latency_p95_s"):
        if k in stats:
            result[k] = round(stats[k], 4)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
