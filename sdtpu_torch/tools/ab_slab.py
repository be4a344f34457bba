"""Same-call A/B of the slab convs (kernels A and B, and the int8 kernel
D) between source trees, at the main paths' call configurations, on one
card.

    python sdtpu_torch/tools/ab_slab.py CONFIGS.json TREE [TREE ...] [--reps N]
        [--kernels float|int8|all] [--out F]

``CONFIGS.json`` is the ``--out`` file of ``chip_smoke.py``, whose
``conv_configs`` lists every float slab call configuration of the bf16
image and ``int8_configs`` every int8 one of the int8 image, each with its
calls per image.  Each ``TREE`` is the root of a checkout
(for example ``git archive`` of another commit, unpacked); the trees run
in the order given, each in a process of its own that imports that tree's
``sdtpu_torch`` and times ``kernels.conv2d.conv3x3_slab`` on the same
seeded inputs, with CUDA events (``reps`` back-to-back calls after a
warm-up; for a call shorter than its host-side enqueue they time the host)
and by the profiler's device time (``tools.device_ms``).
Give a tree twice, in turns (old, new, new, old), to see the spread.
This process times cuDNN (``F.conv2d`` on the prologued, upsampled input)
the same two ways and prints, per configuration, calls per image, this
tree's split S, every run's ms (events; device), cuDNN's, the bound and
TFLOP/s by device time, then each run's per-image sums for A and B.  For D
(``--kernels int8`` or ``all``) each tree times ``conv3x3_slab`` with an
int8 kernel on seeded codes' scales, zero points and weights, and splits
the device time by kernel name into the pre-pass, the GEMM and the
reduction (a tree whose D is one kernel counts it all as the GEMM); this
process prints each run's ms, device ms and pieces beside the bound (int8
operations at 1979 TOP/s, or the bytes), then each run's per-image sums.
There is no library call for D.  Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def conv_inputs(torch, cfg, seed=0):
    """x, kernel, bias and the keyword arguments of one configuration, made
    on the card from a numpy seed (the same in every tree)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    b, hx, wx, ci = cfg["x"]
    co, up = cfg["co"], cfg["up"]
    h, w = (2 * hx, 2 * wx) if up else (hx, wx)

    def dev(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to("cuda", dtype)

    x = dev(rng.standard_normal((b, hx, wx, ci)), torch.bfloat16)
    k = dev(rng.standard_normal((3, 3, ci, co)) * (9 * ci) ** -0.5, torch.bfloat16)
    bias = dev(rng.standard_normal(co) * 0.1)
    kw = {"upsample": up, "emit_stats": cfg["stats"]}
    if cfg["pro"]:
        kw["prologue_scale"] = dev(0.5 + rng.random((b, ci)))
        kw["prologue_bias"] = dev(rng.standard_normal((b, ci)) * 0.5)
    if cfg["res"]:
        kw["residual"] = dev(rng.standard_normal((b, h, w, co)), torch.bfloat16)
    return x, k, bias, kw


def int8_inputs(torch, cfg, seed=0):
    """x, the int8 kernel, the bias and the keyword arguments of one int8
    configuration, made on the card from a numpy seed (the same in every
    tree): codes' scales and zero points in the ranges the model's take."""
    import numpy as np

    rng = np.random.default_rng(seed)
    b, h, w, ci = cfg["x"]
    co = cfg["co"]

    def dev(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a)).to("cuda", dtype)

    x = dev(rng.standard_normal((b, h, w, ci)), torch.bfloat16)
    k = dev(rng.integers(-127, 128, (3, 3, ci, co)), torch.int8)
    bias = dev(rng.standard_normal(co) * 0.1)
    kw = {"emit_stats": cfg["stats"], "prologue_scale": dev(0.5 + rng.random((b, ci))),
          "prologue_bias": dev(rng.standard_normal((b, ci)) * 0.5),
          "act_inv_scale": dev(rng.uniform(20.0, 60.0, ci)),
          "act_zp": dev(rng.integers(-110, -60, ci)),
          "w_scale": dev(rng.uniform(1e-4, 1e-3, co))}
    if cfg["res"]:
        kw["residual"] = dev(rng.standard_normal((b, h, w, co)), torch.bfloat16)
    return x, k, bias, kw


# kernel D's pieces by the names of their CUDA kernels in a profile
INT8_PIECES = (("prologue", "quantize_kernel"), ("gemm", "conv3x3_int8_kernel"),
               ("reduction", "int8_splitk_reduce_kernel"))


def int8_pieces(by_kernel: dict) -> dict:
    """D's device ms per call by piece from ms by kernel name (as
    ``tools.device_ms_by_kernel`` gives them); ``other`` is the wrapper's
    torch work (the moments' tile sum)."""
    out = dict.fromkeys([p for p, _ in INT8_PIECES] + ["other"], 0.0)
    for name, ms in by_kernel.items():
        out[next((p for p, tag in INT8_PIECES if tag in name), "other")] += ms
    return out


def worker(tree: str, configs_path: str, reps: int, kernels: str) -> None:
    """Time this tree's conv3x3_slab at every configuration; one JSON line."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import sdtpu_torch
    from sdtpu_torch.kernels.conv2d import conv3x3_slab
    from sdtpu_torch.tools import device_ms, event_ms

    with open(configs_path) as f:
        cfgs = json.load(f)
    res = {"package": os.path.dirname(sdtpu_torch.__file__), "ms": [], "device_ms": [],
           "int8_ms": [], "int8_device_ms": [], "int8_pieces": []}
    for cfg in cfgs["conv_configs"] if kernels in ("float", "all") else []:
        x, k, bias, kw = conv_inputs(torch, cfg)
        res["ms"].append(event_ms(lambda: conv3x3_slab(x, k, bias, **kw), reps))
        d = device_ms(lambda: conv3x3_slab(x, k, bias, **kw), reps)
        res["device_ms"].append(float("nan") if d is None else d)  # nan: not measured
        del x, k, bias, kw
    for cfg in cfgs["int8_configs"] if kernels in ("int8", "all") else []:
        x, k, bias, kw = int8_inputs(torch, cfg)
        res["int8_ms"].append(event_ms(lambda: conv3x3_slab(x, k, bias, **kw), reps))
        by = pieces_ms(torch, lambda: conv3x3_slab(x, k, bias, **kw), reps)
        res["int8_pieces"].append(by)
        res["int8_device_ms"].append(float("nan") if by is None else sum(by.values()))
        del x, k, bias, kw
    print(json.dumps(res))


def pieces_ms(torch, fn, reps):
    """D's device ms per call by piece (:func:`int8_pieces`) under
    torch.profiler, counted as ``tools.device_ms_by_kernel`` counts them
    (here, since the timed tree's package may predate it); None if no
    device time was recorded."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by = {e.key: e.self_device_time_total / e.count * max(1, round(e.count / reps)) / 1e3
              for e in prof.key_averages() if e.count and e.self_device_time_total > 0}
        if by:
            return int8_pieces(by)
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("configs")
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels", choices=("float", "int8", "all"), default="all")
    ap.add_argument("--out")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.trees[0], args.configs, args.reps, args.kernels)
        return 0

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("ab_slab: torch.cuda.is_available() is False; this probe needs an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from sdtpu_torch.kernels.conv2d import plan_conv3x3_int8_split, plan_conv3x3_split
    from sdtpu_torch.tools import PEAK_BF16_FLOPS, PEAK_INT8_OPS, card_line, device_ms, event_ms

    card = card_line()
    print(card, flush=True)
    with open(args.configs) as f:
        cfgs = json.load(f)
    configs = cfgs["conv_configs"] if args.kernels in ("float", "all") else []
    int8_configs = cfgs["int8_configs"] if args.kernels in ("int8", "all") else []
    runs = []
    for tree in args.trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), args.configs, tree,
                               "--reps", str(args.reps), "--kernels", args.kernels, "--worker"],
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            raise SystemExit(f"ab_slab: the run of {tree} failed")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"run {len(runs)}: {tree} ({res['package']})", flush=True)
        runs.append({"tree": tree, **res})
    zero = {"A": 0.0, "B": 0.0, "A_device": 0.0, "B_device": 0.0}
    rows, sums, cudnn_sum = [], [dict(zero) for _ in runs], dict(zero)
    for i, cfg in enumerate(configs):
        x, k, bias, kw = conv_inputs(torch, cfg)
        y = x
        if cfg["pro"]:
            y = x.float() * kw["prologue_scale"][:, None, None, :]
            y = y + kw["prologue_bias"][:, None, None, :]
            y = (y * torch.sigmoid(y)).to(torch.bfloat16)
        if cfg["up"]:
            y = y.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        y_nchw = y.permute(0, 3, 1, 2)
        w_oihw = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        b16 = bias.to(torch.bfloat16)
        t_l = event_ms(lambda: F.conv2d(y_nchw, w_oihw, b16, padding=1), args.reps)
        d_l = device_ms(lambda: F.conv2d(y_nchw, w_oihw, b16, padding=1), args.reps)
        d_l = float("nan") if d_l is None else d_l  # nan: not measured
        b, hx, wx, ci = cfg["x"]
        co = cfg["co"]
        h, w = (2 * hx, 2 * wx) if cfg["up"] else (hx, wx)
        flops = 2.0 * b * h * w * co * 9 * ci
        nbytes = (b * hx * wx * ci * 2 + 9 * ci * co * 2 + co * 4 + b * h * w * co * 2
                  + (2 * b * ci * 4 if cfg["pro"] else 0)
                  + (b * h * w * co * 2 if cfg["res"] else 0)
                  + (b * 2 * co * 4 if cfg["stats"] else 0))
        bound = max(flops / PEAK_BF16_FLOPS, nbytes / 3.35e12) * 1e3
        n, kind = cfg["per_image"], "B" if cfg["up"] else "A"
        splits = plan_conv3x3_split(b, h, w, ci, co)
        for r, run in enumerate(runs):
            sums[r][kind] += n * run["ms"][i]
            sums[r][kind + "_device"] += n * run["device_ms"][i]
        cudnn_sum[kind] += n * t_l
        cudnn_sum[kind + "_device"] += n * d_l
        desc = (f"{kind} x={tuple(cfg['x'])} co={co} pro={int(cfg['pro'])} res={int(cfg['res'])} "
                f"st={int(cfg['stats'])}")
        times = ", ".join(f"run {r} {run['ms'][i]:.4f}; {run['device_ms'][i]:.4f}"
                          for r, run in enumerate(runs))
        tflops = ", ".join(f"{flops / run['device_ms'][i] / 1e9:.1f}" for run in runs)
        print(f"{desc} x{n}/image S={splits}: {times} ms (events; device); cuDNN {t_l:.4f}; "
              f"{d_l:.4f} ms; bound {bound:.4f} ms; TFLOP/s by device {tflops} (cuDNN "
              f"{flops / d_l / 1e9:.1f})", flush=True)
        rows.append({"config": cfg, "split": splits, "ms": [run["ms"][i] for run in runs],
                     "device_ms": [run["device_ms"][i] for run in runs], "cudnn_ms": t_l,
                     "cudnn_device_ms": d_l, "bound_ms": bound, "flops": flops})
        del x, k, bias, kw, y, y_nchw, w_oihw
    for label, t in [(f"run {r} ({run['tree']})", sums[r]) for r, run in enumerate(runs)] + [
            ("cuDNN", cudnn_sum)] if configs else []:
        print(f"{label} per image: A {t['A']:.3f} ms, B {t['B']:.3f} ms by events; "
              f"A {t['A_device']:.3f} ms, B {t['B_device']:.3f} ms by device time", flush=True)
    int8_rows, int8_sums = [], [{"ms": 0.0, "device_ms": 0.0} for _ in runs]
    for i, cfg in enumerate(int8_configs):
        b, h, w, ci = cfg["x"]
        co, n = cfg["co"], cfg["per_image"]
        ops = 2.0 * b * h * w * co * 9 * ci
        nbytes = (b * h * w * ci * 2 + 9 * ci * co + 2 * co * 4 + 2 * b * ci * 4 + 2 * ci * 4
                  + b * h * w * co * 2 * (2 if cfg["res"] else 1)
                  + (b * 2 * co * 4 if cfg["stats"] else 0))
        bound = max(ops / PEAK_INT8_OPS, nbytes / 3.35e12) * 1e3
        splits = plan_conv3x3_int8_split(b, h, w, ci, co)
        for r, run in enumerate(runs):
            int8_sums[r]["ms"] += n * run["int8_ms"][i]
            int8_sums[r]["device_ms"] += n * run["int8_device_ms"][i]
            for piece, v in (run["int8_pieces"][i] or {}).items():
                int8_sums[r][piece] = int8_sums[r].get(piece, 0.0) + n * v
        desc = f"D x={tuple(cfg['x'])} co={co} res={int(cfg['res'])} st={int(cfg['stats'])}"
        times = ", ".join(
            f"run {r} {run['int8_ms'][i]:.4f}; {run['int8_device_ms'][i]:.4f} ("
            + ("not measured" if run["int8_pieces"][i] is None else
               " ".join(f"{k} {v:.4f}" for k, v in run["int8_pieces"][i].items())) + ")"
            for r, run in enumerate(runs))
        tops = ", ".join(f"{ops / run['int8_device_ms'][i] / 1e9:.1f}" for run in runs)
        print(f"{desc} x{n}/image S={splits}: {times} ms (events; device (pieces)); bound "
              f"{bound:.4f} ms; TOP/s by device {tops}", flush=True)
        int8_rows.append({"config": cfg, "split": splits,
                          "ms": [run["int8_ms"][i] for run in runs],
                          "device_ms": [run["int8_device_ms"][i] for run in runs],
                          "pieces": [run["int8_pieces"][i] for run in runs], "bound_ms": bound,
                          "ops": ops})
    if int8_configs:
        bound = sum(row["bound_ms"] * row["config"]["per_image"] for row in int8_rows)
        for r, run in enumerate(runs):
            t = int8_sums[r]
            print(f"run {r} ({run['tree']}) D per int8 image: {t['ms']:.3f} ms by events; "
                  f"{t['device_ms']:.3f} ms by device time ("
                  + ", ".join(f"{k} {t[k]:.3f}" for k in t if k not in ("ms", "device_ms"))
                  + f"); bound {bound:.3f} ms", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": runs, "rows": rows, "per_image": sums,
                       "cudnn_per_image": cudnn_sum, "int8_rows": int8_rows,
                       "int8_per_image": int8_sums}, f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
