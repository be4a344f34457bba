"""Kernel D (the int8 slab conv) against kernel A (the bf16 slab conv) at
each SD-family resnet conv shape, alone: the counterpart of the JAX
package's ``tools/probe_int8_slab.py``::

    python -m sdtpu_torch.tools.probe_int8_slab [chain] [BxHxWxCIxCO ...] [--device cuda]

At each shape both variants run a chain of ``chain`` calls (default 30),
each call's output fed back into the next call's input through a
nonlinear coupling (``x + 1e-6 * mean(out, channels)``), on zero inputs
and weights with the GroupNorm prologue on, as the JAX probe runs them.
The chain is timed with CUDA events after a first chain that builds the
kernels and D's K-major weight copy; the median of 3 chains per call is
printed beside its share of the card's dense peak (989 TFLOP/s bf16 for
A, 1979 TOP/s int8 for D) and the split S of its K loop.  There is no
relay to subtract, so no round-trip floor is taken off.  A shape that
``slab_plan_ok`` refuses is printed as "no slab plan"; a kernel that fails
ends the run with its exception (the JAX probe printed FAIL and went on).
Without a card ``--device cuda`` exits non-zero; ``--device cpu`` times
the plain versions on the host clock (the tests).  ``main()`` returns the
launches of each kernel counter its calls make on the card.
"""

from __future__ import annotations

import argparse
import statistics
from collections import Counter

import torch

from sdtpu_torch.tools import PEAK_BF16_FLOPS, PEAK_INT8_OPS, card_line, device_arg, seconds

# (b, h, w, ci, co): the distinct resblock conv shapes across the family
SHAPES = [
    (2, 64, 64, 640, 640),     # SDXL level-1
    (2, 64, 64, 1920, 640),
    (2, 32, 32, 1280, 1280),   # SDXL level-2 / SD1.5+SD2.1 level-3
    (2, 32, 32, 2560, 1280),
    (2, 64, 64, 320, 320),     # tiny-sd / SD1.5 level-0 at 512px
    (2, 128, 128, 320, 320),   # SDXL level-0 at 1024px
]
REPEATS = 3


def chain_seconds(fn, x, chain: int) -> float:
    """Seconds of ``chain`` calls fed back (``x + 1e-6 * mean(fn(x), -1)``),
    by CUDA events on a card, else by the host clock."""
    def run():
        c = x
        for _ in range(chain):
            o = fn(c)
            c = c + (o.float().mean(dim=-1, keepdim=True) * 1e-6).to(c.dtype)

    return seconds(run, x.device)


def variants(shape, device):
    """``[(name, kernel, extra kwargs, peak, split S, launch counters of one
    call)]``: A on a bf16 kernel, D on an int8 one with unit scales."""
    from sdtpu_torch.kernels.conv2d import (
        conv3x3_int8_launches,
        conv3x3_launches,
        plan_conv3x3_int8_split,
        plan_conv3x3_split,
    )

    b, h, w, ci, co = shape
    ones, zeros = torch.ones(ci, device=device), torch.zeros(ci, device=device)
    return [
        ("bf16", torch.zeros((3, 3, ci, co), dtype=torch.bfloat16, device=device), {},
         PEAK_BF16_FLOPS, plan_conv3x3_split(b, h, w, ci, co),
         conv3x3_launches("conv3x3_slab", (b, h, w, ci), co, prologue=True)),
        ("int8", torch.zeros((3, 3, ci, co), dtype=torch.int8, device=device),
         {"act_inv_scale": ones, "act_zp": zeros, "w_scale": torch.ones(co, device=device)},
         PEAK_INT8_OPS, plan_conv3x3_int8_split(b, h, w, ci, co),
         conv3x3_int8_launches((b, h, w, ci), co)),
    ]


def probe(shape, chain: int, device, calls: Counter) -> dict:
    """Both variants at one shape; prints a line each and returns
    ``{name: ms per conv}``, or {} where the slab rule refuses the shape."""
    from sdtpu_torch.kernels.conv2d import conv3x3_slab
    from sdtpu_torch.utils.quant import slab_plan_ok

    b, h, w, ci, co = shape
    if not slab_plan_ok((b, h, w, ci), (3, 3, ci, co)):
        print(f"{h}x{w} {ci}->{co}: no slab plan", flush=True)
        return {}
    x = torch.zeros((b, h, w, ci), dtype=torch.bfloat16, device=device)
    cb = torch.zeros(co, device=device)
    a, bb = torch.ones((b, ci), device=device), torch.zeros((b, ci), device=device)
    flops = 2 * b * h * w * 9 * ci * co
    out = {}
    for name, kern, extra, peak, splits, keys in variants(shape, device):
        def fn(c, kern=kern, extra=extra):
            return conv3x3_slab(c, kern, cb, prologue_scale=a, prologue_bias=bb, **extra)

        first = chain_seconds(fn, x, chain)
        per = statistics.median(chain_seconds(fn, x, chain) for _ in range(REPEATS)) / chain
        if device.type == "cuda":
            calls.update({k: v * chain * (1 + REPEATS) for k, v in keys.items()})
        out[name] = per * 1e3
        print(f"{h}x{w} {ci}->{co} S={splits} {name}: {per * 1e3:8.3f} ms/conv "
              f"({flops / per / peak * 100:5.1f}% of the {name} peak; first chain "
              f"{first:.2f}s)", flush=True)
    return out


def main(argv=None) -> Counter:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("chain", nargs="?", type=int, default=30)
    ap.add_argument("shapes", nargs="*", help="BxHxWxCIxCO (default: the six SD-family shapes)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = device_arg("probe_int8_slab", args.device)
    if device.type == "cuda":
        print(card_line(), flush=True)
    shapes = ([tuple(int(v) for v in s.split("x")) for s in args.shapes] if args.shapes
              else SHAPES)
    calls = Counter()
    for shape in shapes:
        probe(shape, args.chain, device, calls)
    return calls


if __name__ == "__main__":
    main()
