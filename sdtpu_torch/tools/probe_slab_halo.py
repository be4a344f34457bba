"""Probe: the slab conv (kernel A) at large UNet and VAE-decoder maps, and
the fused nearest-2x upsample conv (kernel B) against upsample + A: the
counterpart of the JAX package's ``tools/probe_slab_halo.py``::

    python -m sdtpu_torch.tools.probe_slab_halo [chain]    (default 30)

On the TPU the probe priced the slab kernel's halo rows (views of the
neighbouring slabs against materialized copies) and the fused upsample.
On this card A has no slabs: it is an implicit GEMM over the whole map,
each block's 128 output pixels reading their 3x3 neighbourhood tap by tap
through ``cp.async`` (the halo rows are read again by the neighbouring
blocks), behind the pre-pass that applies the GroupNorm+SiLU prologue once
per element; ``HALO_SHAPES``
times A with the prologue at the JAX probe's maps (Ci = Co, so the chain
feeds back).  ``UP_SHAPES``: B (``upsample=True``, the small map read and
expanded in the kernel's loader) against ``ops/resize.nearest_upsample``
followed by A on the large map ("unfused"); the two must agree within
``TOL_REL`` of max |unfused|, and A within ``TOL_REL`` of its plain
version.  A shape that the port's slab rule (``utils/quant.py:
slab_plan_ok``) refuses is printed as "no slab plan".

Each variant runs a chain of ``chain`` calls, each output fed back
(``x + 1e-3 |out|``, the large map folded back by ``[:, ::2, ::2]``), on
seeded inputs (numpy seed 0; weights x 0.02), timed by CUDA events after a
first chain; the median of 3 chains per conv is printed beside the share
of the bf16 peak (989 TFLOP/s) and the K split S of the call.  There is no
relay to subtract.  Needs a card: without one it exits non-zero.
``main()`` returns the launches of each kernel counter its calls make.
"""

from __future__ import annotations

import statistics
import sys
from collections import Counter

import numpy as np
import torch

# (b, h, w, c): ci == co so the conv chains; UNet maps then decoder maps
HALO_SHAPES = [
    (2, 64, 64, 640),      # SDXL level-1
    (2, 128, 128, 320),    # SDXL level-0
    (8, 128, 128, 512),    # decoder 128px level, serving batch
    (8, 256, 256, 256),    # decoder 256px level
    (8, 512, 512, 128),    # decoder 512px level
]

# (b, h, w, c): SMALL-map shapes feeding an upsample conv (decoder)
UP_SHAPES = [
    (8, 64, 64, 512),
    (8, 128, 128, 512),
    (8, 256, 256, 256),
]
REPEATS = 3


def seeded(shape, scale=1.0):
    """A bf16 tensor on the card from numpy's seed 0."""
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale).to(
        "cuda", torch.bfloat16)


def chain_ms(fn, x, chain: int, fold: bool = False):
    """(ms per call, first chain s): ``chain`` calls of ``fn``, each fed back
    as ``x + 1e-3 |out|`` (``out[:, ::2, ::2]`` when ``fold``), by CUDA
    events; the median of ``REPEATS`` chains after a first one."""
    from sdtpu_torch.tools import seconds

    def run():
        c = x
        for _ in range(chain):
            o = fn(c)
            c = c + (o[:, ::2, ::2] if fold else o).abs() * 1e-3

    first = seconds(run, x.device)
    return statistics.median(seconds(run, x.device) for _ in range(REPEATS)) / chain * 1e3, first


def main(argv=None) -> Counter:
    from sdtpu_torch.kernels.conv2d import (
        conv3x3_launches,
        conv3x3_slab,
        conv3x3_slab_plain,
        plan_conv3x3_split,
    )
    from sdtpu_torch.ops.resize import nearest_upsample
    from sdtpu_torch.tools import (
        PEAK_BF16_FLOPS,
        card_line,
        chain_arg,
        check_plain,
        require_cuda,
    )
    from sdtpu_torch.utils.quant import slab_plan_ok

    argv = sys.argv[1:] if argv is None else argv
    require_cuda("probe_slab_halo")
    chain = chain_arg(argv, 30)
    print(card_line(), flush=True)
    calls = Counter()
    runs = chain * (1 + REPEATS)

    print("== slab conv A (GroupNorm+SiLU prologue as a per-channel affine) ==", flush=True)
    for b, h, w, c in HALO_SHAPES:
        if not slab_plan_ok((b, h, w, c), (3, 3, c, c)):
            print(f"{b}x{h}x{w}x{c}: no slab plan", flush=True)
            continue
        x, k = seeded((b, h, w, c)), seeded((3, 3, c, c), 0.02)
        a = torch.ones((b, c), device="cuda")
        pb = torch.zeros((b, c), device="cuda")

        def fn(t, k=k, a=a, pb=pb):
            return conv3x3_slab(t, k, prologue_scale=a, prologue_bias=pb)

        keys = conv3x3_launches("conv3x3_slab", (b, h, w, c), c, prologue=True)
        check_plain(f"{b}x{h}x{w}x{c} A", fn(x),
                    conv3x3_slab_plain(x, k, prologue_scale=a, prologue_bias=pb))
        per, first = chain_ms(fn, x, chain)
        calls.update({key: n * (runs + 1) for key, n in keys.items()})
        flops = 2 * b * h * w * c * c * 9
        print(f"{b}x{h}x{w}x{c} S={plan_conv3x3_split(b, h, w, c, c):2d}: {per:7.3f} ms/conv "
              f"({flops / (per * 1e-3) / PEAK_BF16_FLOPS * 100:5.1f}% peak; first chain "
              f"{first:.2f}s)", flush=True)
        del x, k
        torch.cuda.empty_cache()

    print("== nearest-2x upsample conv: unfused (upsample + A) vs fused (B) ==", flush=True)
    for b, hs, ws, c in UP_SHAPES:
        if not slab_plan_ok((b, 2 * hs, 2 * ws, c), (3, 3, c, c)):
            print(f"{b}x{hs}x{ws}x{c}: no slab plan", flush=True)
            continue
        x, k = seeded((b, hs, ws, c)), seeded((3, 3, c, c), 0.02)
        bias = torch.zeros((c,), device="cuda")
        flops = 2 * b * (2 * hs) * (2 * ws) * c * c * 9
        modes = {
            "unfused": (lambda t, k=k, bias=bias: conv3x3_slab(nearest_upsample(t, 2), k, bias),
                        conv3x3_launches("conv3x3_slab", (b, 2 * hs, 2 * ws, c), c)),
            "fused": (lambda t, k=k, bias=bias: conv3x3_slab(t, k, bias, upsample=True),
                      conv3x3_launches("conv3x3_slab_upsample", (b, hs, ws, c), c,
                                       upsample=True)),
        }
        check_plain(f"{b}x{hs}x{ws}x{c} B vs upsample + A", modes["fused"][0](x),
                    modes["unfused"][0](x))
        for mode, (fn, keys) in modes.items():
            per, first = chain_ms(fn, x, chain, fold=True)
            calls.update({key: n * (runs + 1) for key, n in keys.items()})
            print(f"{b}x{hs}x{ws}x{c} -> {2 * hs}px {mode:>7}: {per:7.3f} ms/conv "
                  f"({flops / (per * 1e-3) / PEAK_BF16_FLOPS * 100:5.1f}% peak; first chain "
                  f"{first:.2f}s)", flush=True)
        del x, k
        torch.cuda.empty_cache()
    return calls


if __name__ == "__main__":
    main()
