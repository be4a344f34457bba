"""Same-process A/B of UNet-step routes, the counterpart of the JAX
package's ``tools/ab_unet.py``::

    python -m sdtpu_torch.tools.ab_unet [preset] [image_size] [chain_len] [--device cuda]

Each variant runs a chain of ``chain_len`` (default 25) CFG-batched UNet
steps, each step's output fed back as the next step's latents, with one
sync at the end, on zero weights of the preset's shapes (speed does not
depend on the weight values); the chain is timed 5 times after a first
chain, and the median and the best per step are printed.  Variants:
attention ``xla`` (SDPA) or ``flash`` (kernel C) times conv ``xla``
(cuDNN) or ``gemm`` (kernels A and B), and flash + gemm with the hoists
(``precompute_cross_kv`` and ``precompute_time_projections`` once per
chain, as the pipeline does per request).

The port's chain is eager: every step's ~1540 launches (tiny-sd) are
enqueued by the host, and at these sizes the host's enqueue takes most of
a step's time (``PERF.md`` section 5), so the chain's time is mostly the
host's until the denoise loop is captured in CUDA graphs; this is the
yardstick for that work.  Times are CUDA events on a card, the host clock
on the CPU (``--device cpu``, the tests).  Without a card ``--device
cuda`` exits non-zero.  ``main()`` returns ``{variant: median seconds}``.
"""

from __future__ import annotations

import argparse
import statistics

import torch

ROUTES = (("attn=xla   conv=xla ", "xla", "xla", False),
          ("attn=flash conv=xla ", "flash", "xla", False),
          ("attn=flash conv=gemm", "flash", "gemm", False),
          ("attn=xla   conv=gemm", "xla", "gemm", False),
          ("flash+gemm + hoists ", "flash", "gemm", True))
TIMED = 5


def make_chain(config, params, x0, ts, ctx, added, *, attn: str, conv: str, hoist: bool,
               chain: int):
    """A function of no arguments that runs ``chain`` UNet steps from
    ``x0``, each output (cast to the latents' dtype) the next input."""
    from sdtpu_torch.models.unet import (
        precompute_cross_kv,
        precompute_time_projections,
        time_cache_step,
        unet_forward,
    )

    ucfg = config.unet

    def run():
        kw = {}
        tcache = None
        if hoist:
            kw["cross_kv"] = precompute_cross_kv(ctx, params, ucfg)
            tcache = precompute_time_projections(
                torch.linspace(999.0, 1.0, chain, device=x0.device), params, ucfg,
                batch=x0.shape[0], added_cond=added, dtype=config.compute_dtype)
        x = x0
        for i in range(chain):
            if tcache is not None:
                kw["time_cache"] = time_cache_step(tcache, i)
            x = unet_forward(x, ts, ctx, params, ucfg, attention_impl=attn, conv_impl=conv,
                             added_cond=None if hoist else added, **kw).to(x.dtype)
        return x

    return run


def chain_inputs(config, image_size: int, device):
    """``(unet params, x0, ts, ctx, added)`` for a CFG-batched chain at
    ``image_size``: zero weights of the preset's shapes, zero latents and
    context, t = 500, and zero micro-conditioning for an SDXL UNet (else
    None)."""
    from sdtpu_torch.utils.weights import zero_pipeline_params

    lat = image_size // config.vae.downscale_factor
    params = zero_pipeline_params(config, device=device)["unet"]
    ucfg = config.unet
    cd = config.compute_dtype
    x0 = torch.zeros((2, lat, lat, ucfg.in_channels), dtype=cd, device=device)
    ts = torch.full((2,), 500.0, device=device)
    ctx = torch.zeros((2, 77, ucfg.cross_attention_dim), dtype=cd, device=device)
    added = None
    if ucfg.addition_embed_dim is not None:  # an SDXL UNet: zero micro-conditioning
        n_ids = 5 if config.requires_aesthetics_score else 6
        added = {"text_embeds": torch.zeros(
                     (2, ucfg.addition_embed_dim - n_ids * ucfg.addition_time_embed_dim),
                     dtype=cd, device=device),
                 "time_ids": torch.zeros((2, n_ids), device=device)}
    return params, x0, ts, ctx, added


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("preset", nargs="?", default="tiny-sd")
    ap.add_argument("image_size", nargs="?", type=int, default=512)
    ap.add_argument("chain", nargs="?", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from sdtpu_torch.config import get_preset
    from sdtpu_torch.tools import card_line, device_arg, seconds

    device = device_arg("ab_unet", args.device)
    if device.type == "cuda":
        print(card_line(), flush=True)
    config = get_preset(args.preset)
    params, x0, ts, ctx, added = chain_inputs(config, args.image_size, device)
    results = {}
    with torch.inference_mode():
        for name, attn, conv, hoist in ROUTES:
            fn = make_chain(config, params, x0, ts, ctx, added, attn=attn, conv=conv,
                            hoist=hoist, chain=args.chain)
            first = seconds(fn, device)
            times = [seconds(fn, device) for _ in range(TIMED)]
            med = statistics.median(times)
            results[name] = med
            print(f"{name}: {med * 1000:8.1f} ms / {args.chain} steps = "
                  f"{med / args.chain * 1000:6.2f} ms/step   (first {first:.1f}s, "
                  f"min {min(times) / args.chain * 1000:6.2f})", flush=True)
    base = results[ROUTES[0][0]]
    for name, med in results.items():
        print(f"{name}: {base / med:5.2f}x vs dense-xla")
    return results


if __name__ == "__main__":
    main()
