"""Same-call A/B of flash attention (kernels C and F) between source trees,
at the main path's and the ring's call shapes, on one card.

    python sdtpu_torch/tools/ab_flash.py TREE [TREE ...] [--reps N] [--out F]

Each ``TREE`` is the root of a checkout (for example ``git archive`` of
another commit, unpacked); the trees run in the order given, each in a
process of its own that imports that tree's ``sdtpu_torch`` and times
``flash_attention_packed`` (C) at the bf16 image's four self-attention
shapes and ``flash_attention_stats_packed`` (F) at the ring's four shard
shapes, on the same seeded inputs, with CUDA events (``reps`` back-to-back
calls after a warm-up; for a call shorter than its host-side enqueue they
time the host) and by the profiler's device time (``tools.device_ms``).
Give a tree twice, in turns (old, new, new, old), to see the spread.
This process times the library beside them the same two ways:
``F.scaled_dot_product_attention`` for C (the memory-efficient SDPA at
D = 512, where flash refuses the head dim), and for F the flash SDPA
that returns the log-sum-exp (the efficient one at D = 512).  It prints,
per shape, calls per image, this tree's plan (query tile, key splits),
every run's ms (events; device), the library's, the bound and TFLOP/s by
device time, then each run's per-image sums for C and F.  Without a card
it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (kernel, q shape (B, H, Lq, D), Lk, calls per image) of tiny-sd at 512x512,
# 25 steps, CFG (UNet batch 2): C at each UNet level (3 transformer blocks x
# 25 steps) and the VAE mid-block (once); F at the ring's shards (n = 4:
# 16 calls per self-attention call)
SHAPES = (
    ("C", (2, 8, 4096, 40), 4096, 75),
    ("C", (2, 8, 1024, 80), 1024, 75),
    ("C", (2, 8, 256, 160), 256, 75),
    ("C", (1, 1, 4096, 512), 4096, 1),
    ("F", (2, 8, 1024, 40), 1024, 1200),
    ("F", (2, 8, 256, 80), 256, 1200),
    ("F", (2, 8, 64, 160), 64, 1200),
    ("F", (1, 1, 1024, 512), 1024, 16),
)
EXP_PER_CLOCK_SM = 16  # exp2 results per clock per SM, compute capability 9.0
SMS = 132


def qkv(torch, q_shape, lk, seed=0):
    """q, k, v on the card from a numpy seed (the same in every tree)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    b, h, _, d = q_shape

    def dev(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            "cuda", torch.bfloat16)

    return dev(q_shape), dev((b, h, lk, d)), dev((b, h, lk, d))


def worker(tree: str, reps: int) -> None:
    """Time this tree's C and F at every shape; one JSON line."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import sdtpu_torch
    from sdtpu_torch.kernels.flash_attention import (
        flash_attention_packed,
        flash_attention_stats_packed,
    )
    from sdtpu_torch.tools import device_ms, event_ms

    ms, dev = [], []
    for kind, q_shape, lk, _ in SHAPES:
        q, k, v = qkv(torch, q_shape, lk)
        fn = flash_attention_packed if kind == "C" else flash_attention_stats_packed
        ms.append(event_ms(lambda: fn(q, k, v), reps))
        d = device_ms(lambda: fn(q, k, v), reps)
        dev.append(float("nan") if d is None else d)  # nan: not measured
        del q, k, v
    print(json.dumps({"package": os.path.dirname(sdtpu_torch.__file__), "ms": ms,
                      "device_ms": dev}))


def run_trees(script: str, trees, reps: int) -> list:
    """Run ``script TREE --reps N --worker`` for each tree in the order
    given, each in a process of its own (so that each imports its own
    tree's ``sdtpu_torch``); each prints one JSON object as its last line.
    Returns ``[{"tree": TREE, **that object}, ...]``; raises SystemExit if a
    run fails."""
    runs = []
    for tree in trees:
        proc = subprocess.run([sys.executable, os.path.abspath(script), tree, "--reps", str(reps),
                               "--worker"], capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            raise SystemExit(f"{os.path.basename(script)}: the run of {tree} failed")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"run {len(runs)}: {tree} ({res['package']})", flush=True)
        runs.append({"tree": tree, **res})
    return runs


def library_call(torch, kind, q, k, v):
    """(name, function of no arguments) of the library's call at this shape."""
    import torch.nn.functional as F

    aten = torch.ops.aten
    if q.shape[-1] > 256:  # flash SDPA takes head dims up to 256
        return ("efficient SDPA",
                lambda: aten._scaled_dot_product_efficient_attention(q, k, v, None, kind == "F"))
    if kind == "C":
        return "SDPA", lambda: F.scaled_dot_product_attention(q, k, v)
    return "flash SDPA with lse", lambda: aten._scaled_dot_product_flash_attention(q, k, v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.trees[0], args.reps)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("ab_flash: torch.cuda.is_available() is False; this probe needs an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from sdtpu_torch.kernels.flash_attention import plan_flash
    from sdtpu_torch.tools import PEAK_BF16_FLOPS, card_line, device_ms, event_ms

    card = card_line()
    print(card, flush=True)
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    exp_rate = EXP_PER_CLOCK_SM * SMS * sm_mhz * 1e6
    runs = run_trees(__file__, args.trees, args.reps)
    zero = {"C": 0.0, "F": 0.0, "C_device": 0.0, "F_device": 0.0}
    rows, sums, lib_sum = [], [dict(zero) for _ in runs], dict(zero)
    for i, (kind, q_shape, lk, n) in enumerate(SHAPES):
        q, k, v = qkv(torch, q_shape, lk)
        lib_name, lib = library_call(torch, kind, q, k, v)
        t_l = event_ms(lib, args.reps)
        d_l = device_ms(lib, args.reps)
        d_l = float("nan") if d_l is None else d_l  # nan: not measured
        b, h, lq, d = q_shape
        flops = 4.0 * b * h * lq * lk * d
        nbytes = 2 * (b * h * lq * d * 2) + 2 * (b * h * lk * d * 2) + (
            2 * b * h * lq * 4 if kind == "F" else 0)
        bound = max(flops / PEAK_BF16_FLOPS, b * h * lq * lk / exp_rate,
                    nbytes / 3.35e12) * 1e3
        for r, run in enumerate(runs):
            sums[r][kind] += n * run["ms"][i]
            sums[r][kind + "_device"] += n * run["device_ms"][i]
        lib_sum[kind] += n * t_l
        lib_sum[kind + "_device"] += n * d_l
        plan = plan_flash(b * h, lq, lk, d)
        times = ", ".join(f"run {r} {run['ms'][i]:.4f}; {run['device_ms'][i]:.4f}"
                          for r, run in enumerate(runs))
        tflops = ", ".join(f"{flops / run['device_ms'][i] / 1e9:.1f}" for run in runs)
        print(f"{kind} q={q_shape} lk={lk} x{n}/image plan (bq, splits)={plan}: {times} ms "
              f"(events; device); {lib_name} {t_l:.4f}; {d_l:.4f} ms; bound {bound:.4f} ms; "
              f"TFLOP/s by device {tflops} ({lib_name} {flops / d_l / 1e9:.1f})", flush=True)
        rows.append({"kernel": kind, "q": list(q_shape), "lk": lk, "per_image": n,
                     "plan": list(plan), "ms": [run["ms"][i] for run in runs],
                     "device_ms": [run["device_ms"][i] for run in runs], "library": lib_name,
                     "library_ms": t_l, "library_device_ms": d_l, "bound_ms": bound,
                     "flops": flops})
        del q, k, v
    for label, t in [(f"run {r} ({run['tree']})", sums[r]) for r, run in enumerate(runs)] + [
            ("library", lib_sum)]:
        print(f"{label} per image: C {t['C']:.3f} ms, F {t['F']:.3f} ms by events; "
              f"C {t['C_device']:.3f} ms, F {t['F_device']:.3f} ms by device time", flush=True)
    print(card, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "sm_clock_max_mhz": sm_mhz, "runs": runs, "rows": rows,
                       "per_image": sums, "library_per_image": lib_sum}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
