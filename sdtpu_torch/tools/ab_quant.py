"""Same-process A/B of quantization variants on one workload, the
counterpart of the JAX package's ``tools/ab_quant.py``::

    python -m sdtpu_torch.tools.ab_quant [--preset lcm-sd15] [--steps N] [--sampler S]
        [--no-cfg|--cfg] [--image-size 512] [--repeats 8]
        [--variants bf16 int8 int8+vae int8+t ...] [--device cuda]

Variant grammar: ``bf16``, or ``int8[+t|+tfull][+vae]`` (the UNet's resnet
convs in int8, ``+t`` the post-LN transformer matmuls too, ``+tfull`` also
the out-projections with run-time row scales, ``+vae`` the VAE decoder's
resnet convs), or ``vae`` (the VAE decoder alone).  Seconds per image move
between processes by up to ~70% on the card's machine (the host sets the
pace), so every variant is measured in one process, with the bench's
pipelined timing: a first request, then ``--repeats`` requests each
dispatched (``output="device"``) before the previous one is fetched; the
line is the median gap between fetches.  Every variant runs its own
pipeline over one zero tree resident on the device (speed does not depend
on the weight values), its quantized leaves made for it and freed after
it is measured.  Prints one JSON line; without a card ``--device cuda``
exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time


def parse_variant(variant: str) -> dict:
    """``quantize_int8``'s arguments for a variant, or ``{"vae_only": True}``
    for ``vae``, or {} for ``bf16``; anything else raises ValueError."""
    if variant == "bf16":
        return {}
    flags = set(variant.split("+"))
    if not flags <= {"int8", "t", "tfull", "vae"} or ("int8" not in flags and flags != {"vae"}):
        raise ValueError(f"unknown variant {variant!r}: bf16, int8[+t|+tfull][+vae] or vae")
    if "int8" not in flags:
        return {"vae_only": True}
    return {"transformer": "full" if "tfull" in flags else "t" in flags, "vae": "vae" in flags}


def variant_pipeline(config, base_params: dict, variant: str, device):
    """A pipeline over ``base_params`` quantized as ``variant`` says."""
    from sdtpu_torch import StableDiffusionPipeline
    from sdtpu_torch.utils.quant import quantize_vae_decoder_int8

    pipe = StableDiffusionPipeline(config, base_params, device=device)
    kw = parse_variant(variant)
    if kw.pop("vae_only", False):
        pipe.params = dict(pipe.params, vae_decoder=quantize_vae_decoder_int8(
            pipe.params["vae_decoder"]))
    elif kw:
        pipe.quantize_int8(**kw)
    return pipe


def pipelined_p50(run, repeats: int) -> tuple:
    """(median gap between fetches of ``repeats`` pipelined requests, first
    request's seconds): request i + 1 is dispatched before request i is
    fetched, as the JAX tool times it."""
    t0 = time.perf_counter()
    run(0).cpu()
    first = time.perf_counter() - t0
    marks = []
    pending = run(100)
    for i in range(repeats):
        nxt = run(200 + 100 * i)
        pending.cpu()
        marks.append(time.perf_counter())
        pending = nxt
    pending.cpu()
    gaps = [b - a for a, b in zip(marks, marks[1:])]
    return statistics.median(gaps), first


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="lcm-sd15")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--sampler", default=None)
    ap.add_argument("--image-size", type=int, default=None)
    ap.add_argument("--no-cfg", action="store_true")
    ap.add_argument("--cfg", action="store_true")
    ap.add_argument("--repeats", type=int, default=8)
    ap.add_argument("--variants", nargs="*", default=["bf16", "int8", "int8+vae"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.repeats < 2:
        ap.error("--repeats must be >= 2: the line is the median gap between fetches")

    import numpy as np

    from sdtpu_torch.config import get_preset
    from sdtpu_torch.tools import device_arg
    from sdtpu_torch.utils.weights import zero_pipeline_params

    for variant in args.variants:  # a bad name raises before any tree is made
        parse_variant(variant)
    device = device_arg("ab_quant", args.device)
    config = get_preset(args.preset)
    steps = args.steps if args.steps is not None else config.default_steps
    sampler = args.sampler or config.default_sampler
    cfg = True if args.cfg else False if args.no_cfg else config.default_cfg
    size = args.image_size or config.default_image_size
    base_params = zero_pipeline_params(config, device=device)
    rng = np.random.default_rng(40)
    ids = rng.integers(1, config.text_config.vocab_size, (1, config.text_config.max_length))
    print(f"[{device}] {args.preset} {size}px {steps}-step {sampler} cfg={cfg}",
          file=sys.stderr)

    results = {"preset": args.preset, "steps": steps, "size": size, "sampler": sampler,
               "cfg": cfg}
    for variant in args.variants:
        pipe = variant_pipeline(config, base_params, variant, device)

        def run(seed, pipe=pipe):
            return pipe.generate_batch(["ab"], token_ids=ids, num_inference_steps=steps,
                                       image_size=size, sampler=sampler, cfg=cfg,
                                       seeds=[seed], output="device")

        p50, first = pipelined_p50(run, args.repeats)
        results[variant] = {"p50_s": round(p50, 4), "images_per_sec": round(1.0 / p50, 3)}
        print(f"{variant:12s} p50 {p50 * 1000:7.1f} ms ({1.0 / p50:6.3f} img/s)  "
              f"first {first:.1f}s", file=sys.stderr)
        del pipe, run  # free the quantized leaves before the next variant's
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
