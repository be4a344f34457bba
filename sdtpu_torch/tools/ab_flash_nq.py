"""Same-process A/B of flash attention C's plan on the full UNet step: the
counterpart of the JAX package's ``tools/ab_flash_nq.py``::

    python -m sdtpu_torch.tools.ab_flash_nq [preset] [image_size] [chain] [plan ...] [--device cuda]

On the TPU the kernel's free schedule choice was its count of softmax
chains ``nq``.  On this card C's choice is its plan
(``kernels/flash_attention.py:plan_flash``): the query tile of 64 or 128
rows at head dims up to 160 (128 only where the padded depth is at most
48), and past d = 160 the split of the keys over blocks.  Each variant
swaps ``plan_flash`` for a rule over the plans the kernel takes at each
call's shape (``flash_plans``), restoring it after its chain, whatever it
raises:

* ``plan``: ``plan_flash`` as it is;
* ``bq=64``: the 64-row tile at every head dim up to 160;
* ``bq=128``: the 128-row tile wherever the kernel takes it, else the plan's.

Past d = 160 (the VAE's attention, not in the UNet step) each keeps the
plan's.  Each variant (default ``plan bq=64 bq=128 plan``, as the JAX
tool's ``2 4 2``) runs a chain of ``chain`` (default 25) CFG-batched UNet
steps on zero weights of the preset's shapes (default ``sd21`` at 768, as
the JAX tool), flash attention and the slab convs, no hoists, each output
fed back: once, then timed 5 times; the median and best per step are
printed.  Times are CUDA events on a card, the host clock on the CPU
(``--device cpu``, the tests); without a card ``--device cuda`` exits
non-zero.  ``main()`` returns ``[(variant, median seconds)]`` in order;
each variant's chain runs ``1 + TIMED`` times.
"""

from __future__ import annotations

import argparse
import statistics

import torch

TIMED = 5
PLANS = ("plan", "bq=64", "bq=128")


def plan_rule(name: str, plan):
    """The ``plan_flash`` replacement of variant ``name`` (see above), over
    the original ``plan``."""
    from sdtpu_torch.kernels.flash_attention import FLASH_DEPTHS, flash_depth, flash_plans

    if name not in PLANS:
        raise ValueError(f"ab_flash_nq: unknown plan {name!r}; one of {PLANS}")
    if name == "plan":
        return plan
    bq = int(name.split("=")[1])

    def rule(bh, lq, lk, d):
        if flash_depth(d) > FLASH_DEPTHS[-1] or (bq, 1) not in flash_plans(bh, lq, lk, d):
            return plan(bh, lq, lk, d)
        return bq, 1

    return rule


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("preset", nargs="?", default="sd21")
    ap.add_argument("image_size", nargs="?", type=int, default=768)
    ap.add_argument("chain", nargs="?", type=int, default=25)
    ap.add_argument("plans", nargs="*", help=f"of {PLANS} (default: plan bq=64 bq=128 plan)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import sdtpu_torch.kernels.flash_attention as fa
    from sdtpu_torch.config import get_preset
    from sdtpu_torch.tools import card_line, device_arg, seconds, swapped
    from sdtpu_torch.tools.ab_unet import chain_inputs, make_chain

    names = args.plans or ["plan", "bq=64", "bq=128", "plan"]
    rules = [plan_rule(name, fa.plan_flash) for name in names]  # unknown names raise first
    device = device_arg("ab_flash_nq", args.device)
    if device.type == "cuda":
        print(card_line(), flush=True)
    config = get_preset(args.preset)
    fn = make_chain(config, *chain_inputs(config, args.image_size, device), attn="flash",
                    conv="gemm", hoist=False, chain=args.chain)
    results = []
    with torch.inference_mode():
        for name, rule in zip(names, rules):
            with swapped(fa, "plan_flash", rule):
                first = seconds(fn, device)
                times = [seconds(fn, device) for _ in range(TIMED)]
            med = statistics.median(times)
            results.append((name, med))
            print(f"{name}: {med * 1000:8.1f} ms / {args.chain} steps = "
                  f"{med / args.chain * 1000:6.2f} ms/step  (first {first:.1f}s, "
                  f"min {min(times) / args.chain * 1000:6.2f})", flush=True)
    return results


if __name__ == "__main__":
    main()
