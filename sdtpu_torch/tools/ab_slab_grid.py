"""A/B of the slab conv's (kernel A's) split-K plan at the resnet conv
shapes the JAX package's trace ranked most expensive: the counterpart of
its ``tools/ab_slab_grid.py``::

    python -m sdtpu_torch.tools.ab_slab_grid [chain]    (default 50)

On the TPU the tool measured the kernel's grid order, which operand's
blocks stay resident in VMEM across grid steps.  On this card A streams
both operands through a ``cp.async`` ring and the schedule choice is
instead how many slices S its K loop (9 taps x Ci / 32) is split over
(``kernels/conv2d.py:plan_conv3x3_split``: the fewest slices that fill the
card's 132 SMs with one wave, each keeping at least 8 K steps), each slice
writing float32 partials that a fixed-order reduction kernel sums.  At each
of the JAX tool's ``SHAPES`` every S from 1 up to the plan's cap runs with
``plan_conv3x3_split`` swapped for it (restored after, whatever is raised),
the plan's own S marked; each S's output is held to the plain version
within ``TOL_REL`` of max |plain|.  A shape that the slab rule
(``utils/quant.py:slab_plan_ok``) refuses is printed as "no slab plan".

Each S runs a chain of ``chain`` calls (bias, no prologue, as the JAX
tool), each output folded back into the input (``x + 1e-6 mean(out,
channels)``), on seeded inputs, timed by CUDA events (the median of 5
chains after a first one), beside its share of the bf16 peak
(989 TFLOP/s), its blocks and the float32 partials it writes.  Needs a
card: without one it exits non-zero.  ``main()`` returns the launches of
each kernel counter its calls make.
"""

from __future__ import annotations

import statistics
import sys
from collections import Counter

import torch

# the resblock conv shapes the JAX package's trace ranked most expensive
SHAPES = [
    (2, 16, 16, 2560, 1280),   # tiny-sd/SD1.5 level-2 decoder concat
    (2, 16, 16, 1280, 1280),
    (2, 32, 32, 1920, 640),
    (2, 64, 64, 960, 320),
    (1, 512, 512, 128, 128),   # VAE decoder full-res
]
TIMED = 5


def split_cap(ci: int) -> int:
    """The largest S the split plan considers for Ci input channels: each
    slice keeps ``MIN_SLICE_K_STEPS`` K steps, at most ``MAX_SPLITS``."""
    from sdtpu_torch.kernels.conv2d import MAX_SPLITS, MIN_SLICE_K_STEPS, slab_k_steps

    return max(1, min(MAX_SPLITS, slab_k_steps(ci) // MIN_SLICE_K_STEPS))


def main(argv=None) -> Counter:
    import sdtpu_torch.kernels.conv2d as conv2d
    from sdtpu_torch.tools import (
        PEAK_BF16_FLOPS,
        card_line,
        chain_arg,
        check_plain,
        require_cuda,
        seconds,
        swapped,
    )
    from sdtpu_torch.tools.probe_slab_halo import seeded
    from sdtpu_torch.utils.quant import slab_plan_ok

    argv = sys.argv[1:] if argv is None else argv
    require_cuda("ab_slab_grid")
    chain = chain_arg(argv, 50)
    print(card_line(), flush=True)
    calls = Counter()
    for b, h, w, ci, co in SHAPES:
        if not slab_plan_ok((b, h, w, ci), (3, 3, ci, co)):
            print(f"{b}x{h}x{w} {ci}->{co}: no slab plan", flush=True)
            continue
        x, k = seeded((b, h, w, ci)), seeded((3, 3, ci, co), 0.02)
        bias = torch.zeros((co,), device="cuda")
        want = conv2d.conv3x3_slab_plain(x, k, bias)
        plan = conv2d.plan_conv3x3_split(b, h, w, ci, co)
        blocks = conv2d.slab_blocks(b, h, w, co)
        flops = 2 * b * h * w * 9 * ci * co
        print(f"== {b}x{h}x{w} {ci}->{co}: {blocks} blocks unsplit, K steps "
              f"{conv2d.slab_k_steps(ci)}, plan S={plan} ==", flush=True)

        def run():
            c = x
            for _ in range(chain):
                out = conv2d.conv3x3_slab(c, k, bias)
                c = c + (out.float().mean(dim=-1, keepdim=True) * 1e-6).to(c.dtype)

        for splits in range(1, split_cap(ci) + 1):
            with swapped(conv2d, "plan_conv3x3_split", lambda *_, s=splits: s):
                mark = " (plan)" if splits == plan else ""
                check_plain(f"{b}x{h}x{w} {ci}->{co} S={splits}", conv2d.conv3x3_slab(x, k, bias),
                            want)
                first = seconds(run, x.device)
                per = statistics.median(seconds(run, x.device) for _ in range(TIMED)) / chain
            n = 1 + chain * (1 + TIMED)
            calls.update({"conv3x3_slab": n, **({"conv3x3_slab_splitk": n} if splits > 1 else {})})
            ws_mb = splits * b * h * w * co * 4 / 1e6 if splits > 1 else 0.0
            print(f"  S={splits:2d}{mark:7s}: {per * 1e3:7.3f} ms/conv "
                  f"({flops / per / PEAK_BF16_FLOPS * 100:5.1f}% of peak; {blocks * splits} "
                  f"blocks, partials {ws_mb:.1f} MB; first chain {first:.2f}s)", flush=True)
        del x, k, want
        torch.cuda.empty_cache()
    return calls


if __name__ == "__main__":
    main()
