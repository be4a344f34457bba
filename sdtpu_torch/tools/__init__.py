"""Same-process A/B probes of the port's kernels on one NVIDIA card.

Counterparts of the JAX package's TPU probes, with the same arguments and
shapes::

    python -m sdtpu_torch.tools.ab_conv [chain] [BxHxWxC ...]      # kernels E and A
    python -m sdtpu_torch.tools.probe_flash_vpu [chain]            # kernel H against C
    python -m sdtpu_torch.tools.probe_flash_2stream [chain]        # kernel I's chain counts
    python -m sdtpu_torch.tools.probe_int8_dot [chain]             # kernel J, int8 against bf16
    python -m sdtpu_torch.tools.ab_flash TREE [TREE ...]            # C and F of source trees
    python -m sdtpu_torch.tools.profile_stages [preset] [size]     # CLIP, UNet step, VAE times
    python -m sdtpu_torch.tools.probe_int8_slab [chain]            # kernel D against A per shape
    python -m sdtpu_torch.tools.ab_unet [preset] [size] [chain]    # UNet-step routes, one process
    python -m sdtpu_torch.tools.ab_quant [--variants ...]          # quantization variants
    python -m sdtpu_torch.tools.device_precision                   # bf16 drift gates per stage
    python -m sdtpu_torch.tools.check_int8                         # int8 fidelity gates
    python -m sdtpu_torch.tools.ab_conv_stats [preset] [size] [chain]  # GN statistics chaining
    python -m sdtpu_torch.tools.ab_packed_proj [preset] [size] [chain] # kernel G on the step
    python -m sdtpu_torch.tools.ab_flash_nq [preset] [size] [chain] [plan ...]  # C's plans
    python -m sdtpu_torch.tools.probe_slab_halo [chain]            # A at large maps, B vs up + A
    python -m sdtpu_torch.tools.probe_out_proj [chain]             # kernel G against einsum
    python -m sdtpu_torch.tools.probe_flash_blocks [chain]         # C's plans at d = 64
    python -m sdtpu_torch.tools.probe_head_packing                 # C with heads packed (proxy)
    python -m sdtpu_torch.tools.probe_flash_int8 [chain]           # C in bf16 beside SDPA
    python -m sdtpu_torch.tools.ab_slab_grid [chain]               # A's split-K plan swept
    python -m sdtpu_torch.tools.generate_grid [--model-dir DIR]    # a seeds x prompts grid
    python -m sdtpu_torch.tools.capture_trace [--out DIR]          # a profiler trace of the bench
    python -m sdtpu_torch.tools.summarize_trace DIR                # its device/host self time

Each variant runs ``chain`` back-to-back calls on the same inputs, timed two
ways: CUDA events around the chain (which, for calls shorter than their
host-side enqueue, measure the host), and the kernels' own device time
under ``torch.profiler``.  Each tool prints per-call milliseconds, the share
of this card's dense peak (989 TFLOP/s bf16, 1979 TOP/s int8, H100 SXM data
sheet) and max |delta| against its first variant.  A failing variant fails
the run; without a card ``main()`` exits non-zero.  ``main()`` returns the
number of calls it made of each kernel wrapper, by launch key, so that a
caller can hold the launch counters to it.
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import sys
import time
from collections import Counter

import torch

PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
EXP_PER_CLOCK_SM = 16     # exp2 results per clock per SM, compute capability 9.0
SMS = 132                 # H100 SXM
TOL_REL = 2e-2            # a kernel against its plain version: max |delta| <= TOL_REL * max |plain|


def require_cuda(tool: str) -> None:
    """Exit non-zero unless a card is present: the probes have no CPU mode."""
    if not torch.cuda.is_available():
        print(f"{tool}: torch.cuda.is_available() is False; this probe needs an NVIDIA card",
              file=sys.stderr)
        raise SystemExit(2)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def exp_rate() -> float:
    """Exponentials per second of this card: ``EXP_PER_CLOCK_SM`` x ``SMS``
    at its ``clocks.max.sm`` as nvidia-smi prints it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return EXP_PER_CLOCK_SM * SMS * float(out.split()[0]) * 1e6


def check_plain(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want|; raises unless it is within ``TOL_REL`` x max
    |want| (a kernel against its plain version)."""
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    ok = bool(torch.isfinite(got).all()) and err <= TOL_REL * max(scale, 1e-6)
    print(f"{label}: max|kernel - plain| {err:.5f} (tol {TOL_REL} x {scale:.4f})"
          + (" ok" if ok else " FAIL"), flush=True)
    if not ok:
        raise AssertionError(f"{label}: the kernel disagrees with its plain version")
    return err


def flash_cost(q_shape, lk):
    """(bytes, tensor operations, exponentials) of one attention call over q
    (B, H, Lq, D) and Lk keys, bf16: q, k, v read once, the output written
    once; one exponential per score."""
    b, h, lq, d = q_shape
    return (2 * (b * h * lq * d * 2) + 2 * (b * h * lk * d * 2), 4.0 * b * h * lq * lk * d,
            float(b * h * lq * lk))


def bound_terms(cost, peak_ops=PEAK_BF16_FLOPS, exp_rate=None):
    """(byte ms, operation ms): bytes / PEAK_BYTES, and the larger of
    operations / ``peak_ops`` and, for a flash kernel's (bytes, ops, exps),
    exponentials / ``exp_rate`` (per second)."""
    t_ops = max(cost[1] / peak_ops, cost[2] / exp_rate if len(cost) > 2 else 0.0)
    return cost[0] / PEAK_BYTES * 1e3, t_ops * 1e3


def bound_ms(cost, peak_ops=PEAK_BF16_FLOPS, exp_rate=None):
    """(ms, "bytes" or "operations"): the larger of the two bound terms, the
    least time the card could take for a call of that cost."""
    t_by, t_ops = bound_terms(cost, peak_ops, exp_rate)
    return max(t_by, t_ops), "bytes" if t_by > t_ops else "operations"


def by_rows(fn, q, k, v, elems: int = 1 << 28):
    """``fn(q, k, v)`` over blocks of q's rows, each block's float32 scores
    at most ``elems``: the rows are independent, so this is the plain
    attention at shapes whose whole score matrix is tens of GB."""
    step = max(1, elems // (q.shape[0] * q.shape[1] * k.shape[2]))
    return torch.cat([fn(q[:, :, i:i + step], k, v) for i in range(0, q.shape[2], step)], dim=2)


@contextlib.contextmanager
def swapped(module, name: str, value):
    """``module.name`` is ``value`` inside the block and restored after it,
    whatever the block raises (a plan or a switch read at call time)."""
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def interleaved(variants, device, n: int, unit: str, repeats: int = 7) -> dict:
    """Each ``(name, fn)`` once (its first call printed), then ``repeats``
    rounds of every variant in turn (drift between the rounds shows as
    spread, not as a bias between the variants), timed by :func:`seconds`;
    prints the median and best per ``unit`` of ``n`` and returns ``{name:
    median seconds}``."""
    for name, fn in variants:
        print(f"{name}: first {seconds(fn, device):.1f}s", flush=True)
    times = {name: [] for name, _ in variants}
    for _ in range(repeats):
        for name, fn in variants:
            times[name].append(seconds(fn, device))
    meds = {}
    for name, ts in times.items():
        med = meds[name] = statistics.median(ts)
        print(f"{name}: {med * 1000:8.1f} ms / {n} {unit}s = {med / n * 1000:6.2f} ms/{unit}  "
              f"(min {min(ts) / n * 1000:6.2f})", flush=True)
    return meds


def device_arg(tool: str, name: str):
    """``torch.device(name)``; for ``cuda`` it exits non-zero unless a card
    is present (:func:`require_cuda`)."""
    device = torch.device(name)
    if device.type == "cuda":
        require_cuda(tool)
    return device


def shapes_tree(config) -> dict:
    """``init_pipeline_params``' tree for ``config`` as meta tensors, drawn
    at no cost: the shapes and dtypes of every leaf."""
    from sdtpu_torch.utils import hostrng
    from sdtpu_torch.utils.weights import init_pipeline_params

    with hostrng.shapes_only():
        return init_pipeline_params(0, config, device="meta")


def map_jax_order(fn, tree, path=()):
    """``fn(path, leaf)`` for every leaf of a dict/list tree, called in the
    order jax's tree functions visit the leaves (dict keys sorted, lists in
    order), so that draws from one numpy generator land on the leaves the
    JAX package's tools give them; the tree's structure is kept."""
    if isinstance(tree, dict):
        out = {k: map_jax_order(fn, tree[k], path + (k,)) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, list):
        return [map_jax_order(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def verdict(values: dict, gates, digits: int, results: dict) -> dict:
    """``results`` with each gated value of ``values`` (rounded to
    ``digits`` places), its gate, and the overall ``pass``, as the JAX
    fidelity tools write them; ``gates`` holds ``(name, gate, "lt"|"gt")``:
    the value must stay under or exceed its gate."""
    ok = True
    for name, gate, d in gates:
        val = values[name]
        ok &= val < gate if d == "lt" else val > gate
        results[name] = round(float(val), digits)
        results[name + "_gate"] = gate
    results["pass"] = bool(ok)
    return results


@contextlib.contextmanager
def no_tf32():
    """TF32 off in cuBLAS and cuDNN for a float32 reference; restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def seconds(fn, device) -> float:
    """Seconds of one ``fn()`` call: CUDA events around it on a card (its
    last kernel included), the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3


def chain_arg(argv, default: int) -> int:
    return int(argv[0]) if argv else default


def event_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``reps`` back-to-back calls, CUDA events
    around the run, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms_by_kernel(fn, reps: int = 10):
    """The kernels' own device time per call under torch.profiler (CUDA
    activity only) over ``reps`` calls, by kernel name: for each name its
    mean recorded duration times its launches per call (its record count
    over ``reps``, rounded, at least 1).  The mean, not the total over
    ``reps``, because the profiler does not record every launch on the
    card.  A second window is taken if the first records no device time;
    None if neither does."""
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
            return by
    return None


def device_ms(fn, reps: int = 10):
    """The sum over the kernels of :func:`device_ms_by_kernel`, or None."""
    by = device_ms_by_kernel(fn, reps)
    return None if by is None else sum(by.values())


def run_variants(label: str, variants, ops: float, peak: float, chain: int, calls: Counter):
    """Time each ``(name, launch keys, fn)`` and print one line per variant;
    the keys are None, one launch key, or a dict of the launch counters one
    call adds to (``kernels/conv2d.py:conv3x3_launches``), and ``calls``
    counts them over the calls made.  Returns ``{name: (event ms, device
    ms, output)}``."""
    results, base = {}, None
    for name, key, call in variants:
        def fn(call=call, key=key):
            if key is not None:
                calls.update({key: 1} if isinstance(key, str) else key)
            return call()

        ev = event_ms(fn, chain)
        dev = device_ms(fn)
        out = fn()
        torch.cuda.synchronize()
        if base is None:
            base_name, base, drift = name, out, 0.0
        else:
            drift = float((out.float() - base.float()).abs().max())
        dev_s = "not measured" if dev is None else f"{dev:.4f}"
        share = ops / (ev * 1e-3) / peak * 100
        dev_share = "" if dev is None else f", {ops / (dev * 1e-3) / peak * 100:5.1f}% device"
        print(f"{label} {name:>18}: {ev:8.4f} ms/call events, {dev_s} ms/call device "
              f"({share:5.1f}% of peak by events{dev_share}; max|delta| vs {base_name} "
              f"{drift:.5f})", flush=True)
        results[name] = (ev, dev, out)
    return results
