"""Same-call A/B of flash attention (kernels C and F) and the packed
out-projection (kernel G) between source trees, at the main path's, the
ring's and the packed route's call shapes, on one card.

    python sdtpu_torch/tools/ab_flash.py TREE [TREE ...] [--reps N] [--out F]

Each ``TREE`` is the root of a checkout (for example ``git archive`` of
another commit, unpacked); the trees run in the order given, each in a
process of its own that imports that tree's ``sdtpu_torch`` and times
``flash_attention_packed`` (C) at the bf16 image's four self-attention
shapes, ``flash_attention_stats_packed`` (F) at the ring's four shard
shapes and ``out_proj_packed`` (G, with its split-K reduction where the
tree's plan splits) at the packed route's four shapes, on the same seeded
inputs, with CUDA events (``reps`` back-to-back
calls after a warm-up; for a call shorter than its host-side enqueue they
time the host) and by the profiler's device time (``tools.device_ms``).
Give a tree twice, in turns (old, new, new, old), to see the spread.
This process times the library beside them the same two ways:
``F.scaled_dot_product_attention`` for C (the memory-efficient SDPA at
D = 512, where flash refuses the head dim), and for F the flash SDPA
that returns the log-sum-exp (the efficient one at D = 512), and for G
the einsum form of the default route plus bias plus residual, in bf16.  It
prints, per shape, calls per image, this tree's plan (C and F: query tile,
key splits; G: column tile, K splits), every run's ms (events; device), the
library's, the bound and TFLOP/s by device time, then each run's per-image
sums for C, F and G.  With ``--plans`` it also times, in this process and
this tree, G at each packed shape under every output tile and split of
``OUT_PROJ_BNS`` x 1..``PLAN_SPLITS`` beside ``plan_out_proj``'s choice (the
evidence for the plan).  Without a card it exits non-zero.
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
# 16 calls per self-attention call); G (o shape, C, calls per packed image)
# after each self-attention of the packed route
SHAPES = (
    ("C", (2, 8, 4096, 40), 4096, 75),
    ("C", (2, 8, 1024, 80), 1024, 75),
    ("C", (2, 8, 256, 160), 256, 75),
    ("C", (1, 1, 4096, 512), 4096, 1),
    ("F", (2, 8, 1024, 40), 1024, 1200),
    ("F", (2, 8, 256, 80), 256, 1200),
    ("F", (2, 8, 64, 160), 64, 1200),
    ("F", (1, 1, 1024, 512), 1024, 16),
    ("G", (2, 8, 4096, 40), 320, 75),
    ("G", (2, 8, 1024, 80), 640, 75),
    ("G", (2, 8, 256, 160), 1280, 75),
    ("G", (1, 1, 4096, 512), 512, 1),
)
KINDS = ("C", "F", "G")
PLAN_SPLITS = 4        # --plans: the splits tried at each G shape
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


def out_proj_inputs(torch, o_shape, c, seed=0):
    """o, w, the f32 bias and the residual of one G call on the card from a
    numpy seed (the same in every tree)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    b, h, l, d = o_shape

    def dev(a, dtype=torch.bfloat16):
        return torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)

    return (dev(rng.standard_normal(o_shape)),
            dev(rng.standard_normal((h, d, c)) * (h * d) ** -0.5),
            dev(0.1 * rng.standard_normal(c), torch.float32),
            dev(rng.standard_normal((b, l, c))))


def call_args(torch, kind, shape, third):
    """The inputs of one call of ``kind`` at (shape, Lk or C)."""
    return out_proj_inputs(torch, shape, third) if kind == "G" else qkv(torch, shape, third)


def worker(tree: str, reps: int) -> None:
    """Time this tree's C, F and G at every shape; one JSON line."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import sdtpu_torch
    from sdtpu_torch.kernels.flash_attention import (
        flash_attention_packed,
        flash_attention_stats_packed,
        out_proj_packed,
    )
    from sdtpu_torch.tools import device_ms, event_ms

    fns = {"C": flash_attention_packed, "F": flash_attention_stats_packed, "G": out_proj_packed}
    ms, dev = [], []
    for kind, shape, third, _ in SHAPES:
        args = call_args(torch, kind, shape, third)
        ms.append(event_ms(lambda: fns[kind](*args), reps))
        d = device_ms(lambda: fns[kind](*args), reps)
        dev.append(float("nan") if d is None else d)  # nan: not measured
        del args
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


def library_call(torch, kind, *args):
    """(name, function of no arguments) of the library's call at this shape."""
    import torch.nn.functional as F

    if kind == "G":
        o, w, bias, res = args
        b16 = bias.to(torch.bfloat16)
        return ("einsum + bias + residual",
                lambda: torch.einsum("bhld,hdc->blc", o, w) + b16 + res)
    q, k, v = args
    aten = torch.ops.aten
    if q.shape[-1] > 256:  # flash SDPA takes head dims up to 256
        return ("efficient SDPA",
                lambda: aten._scaled_dot_product_efficient_attention(q, k, v, None, kind == "F"))
    if kind == "C":
        return "SDPA", lambda: F.scaled_dot_product_attention(q, k, v)
    return "flash SDPA with lse", lambda: aten._scaled_dot_product_flash_attention(q, k, v)


def plan_sweep(torch, reps: int) -> list:
    """G at each packed shape under every (bn, splits) the kernel takes up
    to PLAN_SPLITS splits, by device time (the split-K reduction included),
    with this tree's plan marked; one line each."""
    import sdtpu_torch.kernels.flash_attention as fa
    from sdtpu_torch.tools import device_ms

    plan, out = fa.plan_out_proj, []
    try:
        for kind, o_shape, c, _ in SHAPES:
            if kind != "G":
                continue
            args = out_proj_inputs(torch, o_shape, c)
            b, h, l, d = o_shape
            chosen = plan(b, h, l, d, c)
            for bn in fa.OUT_PROJ_BNS:
                for splits in range(1, min(PLAN_SPLITS, h * -(-d // fa.OUT_PROJ_BK)) + 1):
                    fa.plan_out_proj = lambda *_, p=(bn, splits): p
                    dev = device_ms(lambda: fa.out_proj_packed(*args), reps)
                    blocks = b * -(-l // fa.OUT_PROJ_BM) * -(-c // bn) * splits
                    mark = " (plan)" if (bn, splits) == chosen else ""
                    print(f"G o={o_shape} c={c} bn={bn} splits={splits} blocks={blocks}{mark}: "
                          f"{dev:.5f} ms by device", flush=True)
                    out.append({"o": list(o_shape), "c": c, "bn": bn, "splits": splits,
                                "blocks": blocks, "plan": bool(mark), "device_ms": dev})
            del args
    finally:
        fa.plan_out_proj = plan
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out")
    ap.add_argument("--plans", action="store_true", help="also sweep G's tiles and splits")
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
    from sdtpu_torch.kernels.flash_attention import plan_flash, plan_out_proj
    from sdtpu_torch.tools import PEAK_BF16_FLOPS, card_line, device_ms, event_ms

    card = card_line()
    print(card, flush=True)
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    exp_rate = EXP_PER_CLOCK_SM * SMS * sm_mhz * 1e6
    runs = run_trees(__file__, args.trees, args.reps)
    zero = {key: 0.0 for kind in KINDS for key in (kind, kind + "_device")}
    rows, sums, lib_sum = [], [dict(zero) for _ in runs], dict(zero)
    for i, (kind, shape, third, n) in enumerate(SHAPES):
        call = call_args(torch, kind, shape, third)
        lib_name, lib = library_call(torch, kind, *call)
        t_l = event_ms(lib, args.reps)
        d_l = device_ms(lib, args.reps)
        d_l = float("nan") if d_l is None else d_l  # nan: not measured
        b, h, lq, d = shape
        if kind == "G":  # o, w, the f32 bias, the residual read once; out written once
            c = third
            flops = 2.0 * b * lq * c * h * d
            nbytes = b * h * lq * d * 2 + h * d * c * 2 + c * 4 + 2 * b * lq * c * 2
            bound = max(flops / PEAK_BF16_FLOPS, nbytes / 3.35e12) * 1e3
            plan = plan_out_proj(b, h, lq, d, c)
        else:
            lk = third
            flops = 4.0 * b * h * lq * lk * d
            nbytes = 2 * (b * h * lq * d * 2) + 2 * (b * h * lk * d * 2) + (
                2 * b * h * lq * 4 if kind == "F" else 0)
            bound = max(flops / PEAK_BF16_FLOPS, b * h * lq * lk / exp_rate,
                        nbytes / 3.35e12) * 1e3
            plan = plan_flash(b * h, lq, lk, d)
        for r, run in enumerate(runs):
            sums[r][kind] += n * run["ms"][i]
            sums[r][kind + "_device"] += n * run["device_ms"][i]
        lib_sum[kind] += n * t_l
        lib_sum[kind + "_device"] += n * d_l
        times = ", ".join(f"run {r} {run['ms'][i]:.4f}; {run['device_ms'][i]:.4f}"
                          for r, run in enumerate(runs))
        tflops = ", ".join(f"{flops / run['device_ms'][i] / 1e9:.1f}" for run in runs)
        where = f"o={shape} c={third}" if kind == "G" else f"q={shape} lk={third}"
        plan_of = "(bn, splits)" if kind == "G" else "(bq, splits)"
        print(f"{kind} {where} x{n}/image plan {plan_of}={plan}: {times} ms "
              f"(events; device); {lib_name} {t_l:.4f}; {d_l:.4f} ms; bound {bound:.4f} ms; "
              f"TFLOP/s by device {tflops} ({lib_name} {flops / d_l / 1e9:.1f})", flush=True)
        rows.append({"kernel": kind, "shape": list(shape),
                     ("c" if kind == "G" else "lk"): third, "per_image": n,
                     "plan": list(plan), "ms": [run["ms"][i] for run in runs],
                     "device_ms": [run["device_ms"][i] for run in runs], "library": lib_name,
                     "library_ms": t_l, "library_device_ms": d_l, "bound_ms": bound,
                     "flops": flops})
        del call
    for label, t in [(f"run {r} ({run['tree']})", sums[r]) for r, run in enumerate(runs)] + [
            ("library", lib_sum)]:
        print(f"{label} per image: C {t['C']:.3f} ms, F {t['F']:.3f} ms, G {t['G']:.3f} ms by "
              f"events; C {t['C_device']:.3f} ms, F {t['F_device']:.3f} ms, G "
              f"{t['G_device']:.3f} ms by device time (F per ring image, G per packed image)",
              flush=True)
    plans = plan_sweep(torch, args.reps) if args.plans else None
    print(card, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "sm_clock_max_mhz": sm_mhz, "runs": runs, "rows": rows,
                       "per_image": sums, "library_per_image": lib_sum, "plans": plans}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
