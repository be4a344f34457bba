"""Head-packed flash attention against one head per call: the counterpart
of the JAX package's ``tools/probe_head_packing.py``::

    python -m sdtpu_torch.tools.probe_head_packing [--out build/trace] [--chain 25]

The idea under test on the TPU: pack g heads of dim d into one 128-lane
head (g = 3 at d = 40, g = 2 at d = 64) with a block-diagonal score mask.
To keep the heads' scores apart the packed K and V must be block-diagonal,
so packing relocates the zeros instead of removing them; the JAX probe
measured a MAC-exact proxy that favours packing: the kernel at h / g heads
of depth g d over g L keys, without the mask.  The same proxy here: kernel
C at (b, h / g, L, g d) with g L keys (``packed``) beside C at (b, h, L, d)
(``padded``).  This card's kernel pads d only to its MMA depth (48 for 40,
64 for 64), not to 128, so here the proxy does g times the padded call's
MACs: what packing would cost on this kernel.

Each case (the JAX probe's ``CASES``) runs a chain of ``--chain`` calls,
each feeding ``q + 1e-3 tanh(o)`` into the next, once outside the trace
(the build), then under ``utils/profiling.trace`` into
``--out/hp_<label>_<variant>/trace.json``, which
``tools/summarize_trace.py`` reads (as the JAX probe handed its traces to
its summarizer; a trace that recorded no card activity is taken again, up
to ``TRACE_TRIES`` times): the line gives the chain's wall time per call,
the profiler's device time per call of one call (``tools.device_ms``) and
the trace's device self time per call of C's kernel ("not measured" where
a profiler recorded no card activity), then packed / padded by both.
Needs a card: without one it exits non-zero.  ``main()`` returns the
launches of each kernel counter its calls make.
"""

from __future__ import annotations

import argparse
import os
import time
from collections import Counter

import numpy as np
import torch

# (label, batch, heads, Lq, head dim, pack factor g)
CASES = [
    ("tinysd_d40", 2, 6, 4096, 40, 3),
    ("sd21_d64", 2, 4, 9216, 64, 2),
]
CHAIN = 25
TRACE_TRIES = 3  # traced runs of a chain until the trace holds C's kernel


def qkv(b, h, lq, lkv, d, device="cuda"):
    """q (b, h, lq, d) and k, v (b, h, lkv, d) bf16 from numpy's seed 0."""
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.standard_normal((b, h, n, d), dtype=np.float32))
            .to(device, torch.bfloat16) for n in (lq, lkv, lkv)]


def run_traced(tag, b, h, lq, lkv, d, chain, out_dir, calls: Counter) -> dict:
    """One variant's chain, traced; prints its line and returns its times."""
    from sdtpu_torch.kernels.flash_attention import flash_attention_packed, flash_launches
    from sdtpu_torch.tools import device_ms, summarize_trace
    from sdtpu_torch.utils import profiling

    q, k, v = qkv(b, h, lq, lkv, d)
    keys = flash_launches("flash_attention", (b, h, lq, d), lkv)

    def step(qc):
        calls.update(keys)
        o = flash_attention_packed(qc, k, v)
        return qc + (1e-3 * torch.tanh(o.float())).to(qc.dtype)

    def run():
        qc = q
        for _ in range(chain):
            qc = step(qc)
        return qc

    run()
    torch.cuda.synchronize()
    path = os.path.join(out_dir, f"hp_{tag}")
    for _ in range(TRACE_TRIES):  # a profiler session can record no card activity
        with profiling.trace(path):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev_ms, dev_n = summarize_trace.attribute(summarize_trace.load_trace(path))["device"]
        kernel = {n: ms for n, ms in dev_ms.items()
                  if summarize_trace.device_category(n) == "hand-written kernels"}
        if kernel:
            break
    traced = sum(kernel.values()) / chain if kernel else None
    dev = device_ms(lambda: step(q))
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms/call"  # noqa: E731
    print(f"{tag}: q=({b}, {h}, {lq}, {d}) lk={lkv}: wall {wall / chain * 1e3:.3f} ms/call, "
          f"device {fmt(dev)} (profiler), C's kernel {fmt(traced)} in the trace "
          f"({sum(dev_n[n] for n in kernel)} launches of {sum(dev_n.values())} device "
          f"activities; python -m "
          f"sdtpu_torch.tools.summarize_trace {path} --steps {chain})", flush=True)
    return {"wall_ms": wall / chain * 1e3, "device_ms": dev, "trace_ms": traced}


def main(argv=None) -> Counter:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("build", "trace"))
    ap.add_argument("--chain", type=int, default=CHAIN)
    args = ap.parse_args(argv)

    from sdtpu_torch.tools import card_line, require_cuda

    require_cuda("probe_head_packing")
    print(card_line(), flush=True)
    calls = Counter()
    with torch.inference_mode():
        for label, b, h, lq, d, g in CASES:
            if h % g:
                raise ValueError(f"{label}: {h} heads do not pack by {g}")
            pad = run_traced(f"{label}_padded", b, h, lq, lq, d, args.chain, args.out, calls)
            pack = run_traced(f"{label}_packed", b, h // g, lq, g * lq, g * d, args.chain,
                              args.out, calls)
            for key, what in (("trace_ms", "the traces' device time"),
                              ("device_ms", "the profiler's device time")):
                ratio = (None if pack[key] is None or pad[key] is None
                         else f"{pack[key] / pad[key]:.3f}")
                print(f"{label}: packed / padded {ratio or 'not measured'} by {what}",
                      flush=True)
    return calls


if __name__ == "__main__":
    main()
