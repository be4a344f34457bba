"""Probe: the packed out-projection (kernel G) against its PyTorch form, at
the SD family's self-attention shapes: the counterpart of the JAX package's
``tools/probe_out_proj.py``::

    python -m sdtpu_torch.tools.probe_out_proj [chain]    (default 500)

G computes ``residual + sum_h o_h W_h + bias`` from the head-major
attention output o (B, H, L, D) and w (H, D, C), accumulated in float32
and rounded once (``kernels/flash_attention.py:out_proj_packed``, its tile
and K split from ``plan_out_proj``); the PyTorch form is
``einsum("bhld,hdc->blc")`` + bias + residual, as the flash route runs it
with the flag off.  The JAX probe padded every head to d = 128, the TPU's
lane width; here each shape keeps its real head dim, C / H: 40, 80 and 160
at tiny-sd's levels, 64 at SDXL's and SD2.1's (G takes D as it is).  Each
variant runs ``chain`` calls after a warm-up call, timed by CUDA events
around the chain and by the profiler's device time beside them (G's calls
are shorter than their host-side enqueue, so the events time the host);
G's output is held to its plain version within ``TOL_REL`` of max |plain|.
Needs a card: without one it exits non-zero.  ``main()`` returns the
launches of each kernel counter its calls make.
"""

from __future__ import annotations

import sys
from collections import Counter

import numpy as np
import torch

# (label, b, heads, tokens, channels): the head dim is channels / heads
SHAPES = [
    ("tiny-sd L0 64x64x320", 2, 8, 4096, 320),
    ("tiny-sd L1 32x32x640", 2, 8, 1024, 640),
    ("tiny-sd L2 16x16x1280", 2, 8, 256, 1280),
    ("sdxl L1 64x64x640", 2, 10, 4096, 640),
    ("sdxl L2 32x32x1280", 2, 20, 1024, 1280),
    ("sd2.1 L0 96x96x320", 2, 5, 9216, 320),
]


def inputs(b, h, l, c, device="cuda"):
    """o (b, h, l, c / h) bf16, w (h, c / h, c) bf16 (x 0.02), bias (c,)
    float32, residual (b, l, c) bf16, from numpy's seed 0."""
    d = c // h
    rng = np.random.default_rng(0)
    o = torch.from_numpy(rng.standard_normal((b, h, l, d), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((h, d, c), dtype=np.float32) * 0.02)
    bias = torch.from_numpy(rng.standard_normal((c,), dtype=np.float32))
    res = torch.from_numpy(rng.standard_normal((b, l, c), dtype=np.float32))
    return (o.to(device, torch.bfloat16), w.to(device, torch.bfloat16), bias.to(device),
            res.to(device, torch.bfloat16))


def main(argv=None) -> Counter:
    from sdtpu_torch.kernels.flash_attention import (
        out_proj_launches,
        out_proj_packed,
        out_proj_packed_plain,
        plan_out_proj,
    )
    from sdtpu_torch.tools import (
        PEAK_BF16_FLOPS,
        card_line,
        chain_arg,
        check_plain,
        require_cuda,
        run_variants,
    )

    argv = sys.argv[1:] if argv is None else argv
    require_cuda("probe_out_proj")
    chain = chain_arg(argv, 500)
    print(card_line(), flush=True)
    calls = Counter()
    for label, b, h, l, c in SHAPES:
        o, w, bias, res = inputs(b, h, l, c)
        b16 = bias.to(torch.bfloat16)
        d = c // h
        bn, splits = plan_out_proj(b, h, l, d, c)
        variants = [
            ("einsum", None, lambda: torch.einsum("bhld,hdc->blc", o, w) + b16 + res),
            ("G", out_proj_launches((b, h, l, d), c), lambda: out_proj_packed(o, w, bias, res)),
        ]
        print(f"== {label}: o=({b}, {h}, {l}, {d}) c={c}, plan bn={bn} splits={splits}",
              flush=True)
        got = run_variants(label, variants, 2.0 * b * h * l * d * c, PEAK_BF16_FLOPS, chain,
                           calls)
        (ev_x, dev_x, _), (ev_g, dev_g, out) = got["einsum"], got["G"]
        check_plain(f"{label} G", out, out_proj_packed_plain(o, w, bias, res))
        dev = "" if dev_x is None or dev_g is None else f", device {dev_g / dev_x:.3f}"
        print(f"{label}: G / einsum time {ev_g / ev_x:.3f} by events{dev}", flush=True)
    return calls


if __name__ == "__main__":
    main()
