"""Same-process A/B probes of the port's kernels on one NVIDIA card.

Counterparts of the JAX package's TPU probes, with the same arguments and
shapes::

    python -m sdtpu_torch.tools.ab_conv [chain] [BxHxWxC ...]      # kernels E and A
    python -m sdtpu_torch.tools.probe_flash_vpu [chain]            # kernel H against C
    python -m sdtpu_torch.tools.probe_flash_2stream [chain]        # kernel I's chain counts
    python -m sdtpu_torch.tools.probe_int8_dot [chain]             # kernel J, int8 against bf16
    python -m sdtpu_torch.tools.ab_flash TREE [TREE ...]            # C and F of source trees
    python -m sdtpu_torch.tools.profile_stages [preset] [size]     # CLIP, UNet step, VAE times

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

import subprocess
import sys
from collections import Counter

import torch

PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12


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
