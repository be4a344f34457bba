"""Same-call A/B of the probe kernels H (legacy flash body) and J (bf16 and
int8 GEMM) between source trees, on one card.

    python sdtpu_torch/tools/ab_probes.py TREE [TREE ...] [--reps N] [--out F]

Each ``TREE`` is the root of a checkout (for example ``git archive`` of
another commit, unpacked); the trees run in the order given, each in a
process of its own (``ab_flash.run_trees``) that imports that tree's
``sdtpu_torch`` and times, on the same seeded inputs: H
(``probe_flash_vpu.legacy_flash``) at ``chip_smoke.py`` phase 9's two
shapes and at ``probe_flash_vpu.SHAPES``, C (``flash_attention_packed``)
at ``probe_flash_vpu.SHAPES`` (the probe's legacy / shipped ratio), and J
(``probe_int8_dot.make``) bf16 -> f32 -> bf16 and int8 -> int32 at
``probe_int8_dot.SHAPES``; each with CUDA events (``reps`` back-to-back
calls after a warm-up; below about 0.15 ms a call they time the host's
enqueue) and by the profiler's device time (``tools.device_ms``).  Give a
tree twice, in turns (old, new, new, old), to see the spread.  This
process times the library beside them the same two ways: SDPA for H and C,
``torch.matmul`` for J bf16, ``torch._int_mm`` for J int8.  It prints, per
row, every run's ms (events; device), the library's, the bound and
T(FL)OP/s by device time, then per run: H summed over phase 9's shapes, H/C
by device time at the probe's shapes, J bf16 and J int8 summed; and the
host's cost per call of building J bf16's two TMA tensor maps in this tree
(``dot_bf16_tensor_maps``, host clock over ``100 * reps`` builds).  Without
a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

PHASE9_H = ((2, 8, 4096, 40), (2, 8, 1024, 80))  # chip_smoke.py phase 9's H shapes


def rows(probe_flash_vpu, probe_int8_dot):
    """(kernel, shape) of every timed row: H and C as (B, H, L, D) with Lk =
    Lq, J as (m, k, n)."""
    probe = [(b, h, l, d) for _, b, h, l, d in probe_flash_vpu.SHAPES]
    out = [("H", s) for s in PHASE9_H + tuple(s for s in probe if s not in PHASE9_H)]
    out += [("C", s) for s in probe]
    out += [(kind, s) for kind in ("J bf16", "J int8") for s in probe_int8_dot.SHAPES]
    return out


def calls(torch, kind, shape, mods, lib):
    """A function of no arguments running ``kind`` at ``shape`` (this tree's
    wrapper, or with ``lib`` the library's call) on seeded inputs."""
    vpu, dot, flash = mods
    if kind in ("H", "C"):
        q, k, v = vpu.qkv_inputs(*shape)
        if lib:
            return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)
        fn = vpu.legacy_flash if kind == "H" else flash.flash_attention_packed
        return lambda: fn(q, k, v)
    m, kk, n = shape
    x8, w8, x16, w16 = dot.dot_inputs(m, kk, n)
    if kind == "J bf16":
        if lib:
            return lambda: torch.matmul(x16, w16)
        f = dot.make(m, kk, n, torch.bfloat16, torch.float32, torch.bfloat16)
        return lambda: f(x16, w16)
    if lib:
        return lambda: torch._int_mm(x8, w8)
    f = dot.make(m, kk, n, torch.int8, torch.int32, torch.int32)
    return lambda: f(x8, w8)


def modules():
    from sdtpu_torch.kernels import flash_attention
    from sdtpu_torch.tools import probe_flash_vpu, probe_int8_dot

    return probe_flash_vpu, probe_int8_dot, flash_attention


def worker(tree: str, reps: int) -> None:
    """Time this tree's H, C and J at every row; one JSON line."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import sdtpu_torch
    from sdtpu_torch.tools import device_ms, event_ms

    mods = modules()
    ms, dev = [], []
    for kind, shape in rows(mods[0], mods[1]):
        fn = calls(torch, kind, shape, mods, lib=False)
        ms.append(event_ms(fn, reps))
        d = device_ms(fn, reps)
        dev.append(float("nan") if d is None else d)  # nan: not measured
        del fn
        torch.cuda.empty_cache()
    print(json.dumps({"package": os.path.dirname(sdtpu_torch.__file__), "ms": ms,
                      "device_ms": dev}))


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
        print("ab_probes: torch.cuda.is_available() is False; this probe needs an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from sdtpu_torch.tools import PEAK_BF16_FLOPS, PEAK_INT8_OPS, card_line, device_ms, event_ms
    from sdtpu_torch.tools.ab_flash import EXP_PER_CLOCK_SM, SMS, run_trees

    card = card_line()
    print(card, flush=True)
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    exp_rate = EXP_PER_CLOCK_SM * SMS * sm_mhz * 1e6
    runs = run_trees(__file__, args.trees, args.reps)
    mods = modules()
    table = []
    for i, (kind, shape) in enumerate(rows(mods[0], mods[1])):
        lib = calls(torch, kind, shape, mods, lib=True)
        t_l, d_l = event_ms(lib, args.reps), device_ms(lib, args.reps)
        d_l = float("nan") if d_l is None else d_l  # nan: not measured
        del lib
        torch.cuda.empty_cache()
        if kind in ("H", "C"):
            b, h, l, d = shape
            ops = 4.0 * b * h * l * l * d
            nbytes = 4 * b * h * l * d * 2
            bound = max(ops / PEAK_BF16_FLOPS, b * h * l * l / exp_rate, nbytes / 3.35e12)
            lib_name = "SDPA"
        else:
            m, k, n = shape
            ops = 2.0 * m * k * n
            int8 = kind == "J int8"
            nbytes = (m * k + k * n + 4 * m * n) if int8 else 2 * (m * k + k * n + m * n)
            bound = max(ops / (PEAK_INT8_OPS if int8 else PEAK_BF16_FLOPS), nbytes / 3.35e12)
            lib_name = "torch._int_mm" if int8 else "torch.matmul"
        bound *= 1e3
        times = ", ".join(f"run {r} {run['ms'][i]:.4f}; {run['device_ms'][i]:.4f}"
                          for r, run in enumerate(runs))
        rate = ", ".join(f"{ops / run['device_ms'][i] / 1e9:.1f}" for run in runs)
        print(f"{kind} {shape}: {times} ms (events; device); {lib_name} {t_l:.4f}; {d_l:.4f} "
              f"ms; bound {bound:.4f} ms; T(FL)OP/s by device {rate} ({lib_name} "
              f"{ops / d_l / 1e9:.1f})", flush=True)
        table.append({"kernel": kind, "shape": list(shape), "ms": [run["ms"][i] for run in runs],
                      "device_ms": [run["device_ms"][i] for run in runs], "library": lib_name,
                      "library_ms": t_l, "library_device_ms": d_l, "bound_ms": bound,
                      "ops": ops})
    probe = [tuple(r["shape"]) for r in table if r["kernel"] == "C"]
    summary = []
    for r, run in enumerate(runs + [None]):
        def dev(row, r=r):
            return row["library_device_ms"] if r == len(runs) else row["device_ms"][r]

        def evt(row, r=r):
            return row["library_ms"] if r == len(runs) else row["ms"][r]

        h9 = [row for row in table if row["kernel"] == "H" and tuple(row["shape"]) in PHASE9_H]
        s = {"run": "library" if run is None else f"run {r} ({run['tree']})",
             "H_phase9_device_ms": sum(dev(row) for row in h9),
             "H_phase9_ms": sum(evt(row) for row in h9)}
        if run is not None:
            by = {(row["kernel"], tuple(row["shape"])): row for row in table}
            s["H_over_C_device"] = [dev(by[("H", p)]) / dev(by[("C", p)]) for p in probe]
        for kind in ("J bf16", "J int8"):
            js = [row for row in table if row["kernel"] == kind]
            s[f"{kind} device_ms"] = sum(dev(row) for row in js)
            s[f"{kind} ms"] = sum(evt(row) for row in js)
        print(json.dumps(s), flush=True)
        summary.append(s)
    maps_us = {}
    for m, k, n in mods[1].SHAPES:
        x = torch.empty((m, k), device="cuda", dtype=torch.bfloat16)
        w = torch.empty((k, n), device="cuda", dtype=torch.bfloat16)
        build = mods[1]._lib().dot_bf16_tensor_maps
        t0 = time.perf_counter()
        for _ in range(100 * args.reps):
            err = build(x.data_ptr(), w.data_ptr(), m, k, n)
        maps_us[f"{(m, k, n)}"] = (time.perf_counter() - t0) / (100 * args.reps) * 1e6
        if err:
            raise SystemExit(f"ab_probes: dot_bf16_tensor_maps failed with cudaError_t {err}")
    print(f"J bf16 tensor maps, host us per call (this tree): {json.dumps(maps_us)}", flush=True)
    print(card, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "sm_clock_max_mhz": sm_mhz, "runs": runs, "rows": table,
                       "summary": summary, "tensor_maps_host_us": maps_us}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
