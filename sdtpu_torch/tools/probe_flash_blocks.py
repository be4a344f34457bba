"""Plan sweep of flash attention C at the head dim 64 shapes of SD2.1's and
SDXL's top attention levels: the counterpart of the JAX package's
``tools/probe_flash_blocks.py``::

    python -m sdtpu_torch.tools.probe_flash_blocks [chain]    (default 100)

The JAX probe swept the TPU kernel's ``block_q``/``block_k`` and chain
counts; those are VMEM tile sizes of the TPU and do not carry over.  On
this card C's schedule choice is its plan (``kernels/flash_attention.py:
plan_flash``): the query tile, and past d = 160 the split of the keys.
At each shape every plan C's launch takes (``flash_plans``; at d = 64
only the 64-row tile: the 128-row tile needs a padded depth of at most 48)
runs with ``plan_flash`` swapped for it (the plan's own marked), beside
SDPA (``F.scaled_dot_product_attention``).  Each variant runs ``chain``
calls after a warm-up, timed by CUDA events and the profiler's device
time; each plan's output is held to the plain version (``flash_attention_
plain`` over blocks of query rows) within ``TOL_REL`` of max |plain|; the
bound is the larger of the call's bytes over 3.35 TB/s, its operations
over 989 TFLOP/s and its exponentials over this card's exponential rate.
Needs a card: without one it exits non-zero.  ``main()`` returns the
launches of each kernel counter its calls make.
"""

from __future__ import annotations

import sys
from collections import Counter

import torch

SHAPES = [
    # (label, batch, heads, seq len, head dim)
    ("sd2.1 768 L0 (96x96, 5h, d64)", 2, 5, 9216, 64),
    ("sdxl 1024 top attn level (64x64, 10h, d64)", 2, 10, 4096, 64),
]


def plan_variants(q, k, v):
    """``[(name, launch keys, fn)]``: C under every plan its launch takes at
    this shape, ``plan_flash`` swapped for the call and restored."""
    import sdtpu_torch.kernels.flash_attention as fa
    from sdtpu_torch.tools import swapped

    b, h, lq, d = q.shape
    lk = k.shape[2]
    chosen = fa.plan_flash(b * h, lq, lk, d)
    out = []
    for plan in fa.flash_plans(b * h, lq, lk, d):
        def run(plan=plan):
            with swapped(fa, "plan_flash", lambda *_: plan):
                return fa.flash_attention_packed(q, k, v)

        keys = {"flash_attention": 1, **({"flash_attention_merge": 1} if plan[1] > 1 else {})}
        mark = " (plan)" if plan == chosen else ""
        out.append((f"C bq={plan[0]} S={plan[1]}{mark}", keys, run))
    return out


def main(argv=None) -> Counter:
    import torch.nn.functional as F

    from sdtpu_torch.kernels.flash_attention import flash_attention_plain
    from sdtpu_torch.tools import (
        PEAK_BF16_FLOPS,
        bound_ms,
        by_rows,
        card_line,
        chain_arg,
        check_plain,
        exp_rate,
        flash_cost,
        require_cuda,
        run_variants,
    )
    from sdtpu_torch.tools.probe_flash_vpu import qkv_inputs

    argv = sys.argv[1:] if argv is None else argv
    require_cuda("probe_flash_blocks")
    chain = chain_arg(argv, 100)
    print(card_line(), flush=True)
    rate = exp_rate()
    calls = Counter()
    for label, b, h, l, d in SHAPES:
        q, k, v = qkv_inputs(b, h, l, d)
        bound = bound_ms(flash_cost((b, h, l, d), l), PEAK_BF16_FLOPS, rate)[0]
        print(f"== {label}  chain={chain}; bound {bound:.4f} ms/call", flush=True)
        variants = plan_variants(q, k, v)
        variants.append(("SDPA", None, lambda: F.scaled_dot_product_attention(q, k, v)))
        res = run_variants(label, variants, 4.0 * b * h * l * l * d, PEAK_BF16_FLOPS, chain,
                           calls)
        want = by_rows(flash_attention_plain, q, k, v)
        for name, _, _ in variants[:-1]:
            check_plain(f"{label} {name}", res[name][2], want)
        del q, k, v, want, res
        torch.cuda.empty_cache()
    return calls


if __name__ == "__main__":
    main()
