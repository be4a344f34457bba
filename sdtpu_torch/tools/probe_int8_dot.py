"""Probe: does the card's int8 ``mma`` give twice the bf16 rate at the slab
conv's GEMM shapes?  (kernel J)

Counterpart of ``tools/probe_int8_dot.py``: ``make(m, k, n, in_dtype, acc_t,
out_dtype)`` returns ``f(x, w)``, one (m, k) @ (k, n) product with the
given accumulator: bf16 inputs accumulate in float32 and round once to
bf16, int8 inputs accumulate in int32 and return int32, exact.  Both
variants take the same integer-valued inputs (int8 values, exact in bf16),
so max |delta| of int8 against bf16 is bf16's rounding alone.

    python -m sdtpu_torch.tools.probe_int8_dot [chain]    (default 2000)
"""

from __future__ import annotations

import ctypes
import sys
from collections import Counter

import numpy as np
import torch

from sdtpu_torch.kernels import _build, launch_counts
from sdtpu_torch.tools import (
    PEAK_BF16_FLOPS,
    PEAK_INT8_OPS,
    card_line,
    chain_arg,
    require_cuda,
    run_variants,
)

SHAPES = [(1024, 2560, 512), (4096, 640, 640)]
# (in_dtype, acc_t, out_dtype) -> (launch key, K multiple, N multiple) of the card kernel
_FORMS = {
    (torch.bfloat16, torch.float32, torch.bfloat16): ("dot_bf16", 32, 8),
    (torch.int8, torch.int32, torch.int32): ("dot_int8", 64, 16),
}


def dot_plain(x: torch.Tensor, w: torch.Tensor, acc_t, out_dtype) -> torch.Tensor:
    """Kernel J's function: bf16 x bf16 accumulated in float32 and rounded
    once to ``out_dtype``; int8 x int8 in float64, returned as int32: each
    product is at most 2^14 in magnitude, so for K < 2^17 (where the int32
    result itself fits) every partial sum is an exact integer."""
    if acc_t == torch.int32:
        return (x.double() @ w.double()).to(out_dtype)
    return (x.float() @ w.float()).to(out_dtype)


def _lib():
    lib = _build.load("dot")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.dot_bf16_launch, lib.dot_int8_launch):
            fn.argtypes = [p] * 3 + [i] * 3 + [p]
            fn.restype = i
        lib._typed = True
    return lib


def make(m: int, k: int, n: int, in_dtype, acc_t, out_dtype):
    """``f(x, w)``: x (m, k) and w (k, n) of ``in_dtype`` -> (m, n) of
    ``out_dtype``, accumulated in ``acc_t``.  The forms taken are bf16 ->
    float32 -> bf16 and int8 -> int32 -> int32.  On the card x and w must be
    contiguous, k a multiple of 32 (bf16) or 64 (int8) and n of 8 or 16."""
    form = (in_dtype, acc_t, out_dtype)
    if form not in _FORMS:
        raise ValueError(f"make: (in, acc, out) = {form} is not one of {list(_FORMS)}")
    key, k_mult, n_mult = _FORMS[form]

    def f(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        for name, t, shape in (("x", x, (m, k)), ("w", w, (k, n))):
            if t.dtype != in_dtype or tuple(t.shape) != shape or t.device != x.device:
                raise ValueError(f"{key}: {name} must be {in_dtype} {shape} on {x.device}, "
                                 f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if x.device.type == "cpu":
            return dot_plain(x, w, acc_t, out_dtype)
        if x.device.type != "cuda":
            raise ValueError(f"{key}: unsupported device {x.device}")
        if k % k_mult or n % n_mult:
            raise ValueError(f"{key}: k={k} must be a multiple of {k_mult} and n={n} of "
                             f"{n_mult}")
        if not (x.is_contiguous() and w.is_contiguous()):
            raise ValueError(f"{key}: x and w must be contiguous")
        out = torch.empty((m, n), device=x.device, dtype=out_dtype)
        err = getattr(_lib(), key + "_launch")(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, key)
        launch_counts[key] += 1
        return out

    return f


def dot_inputs(m, k, n, seed=0):
    """Integer-valued x (m, k) and w (k, n) from one numpy seed, as int8 and
    as bf16 (exact) on the card."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8)).to("cuda")
    w = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8)).to("cuda")
    return x, w, x.to(torch.bfloat16), w.to(torch.bfloat16)


def main(argv=None) -> Counter:
    argv = sys.argv[1:] if argv is None else argv
    require_cuda("probe_int8_dot")
    chain = chain_arg(argv, 2000)
    print(card_line(), flush=True)
    calls = Counter()
    for m, k, n in SHAPES:
        x8, w8, x16, w16 = dot_inputs(m, k, n)
        f16 = make(m, k, n, torch.bfloat16, torch.float32, torch.bfloat16)
        f8 = make(m, k, n, torch.int8, torch.int32, torch.int32)
        label = f"({m},{k})@({k},{n})"
        ops = 2.0 * m * k * n
        r16 = run_variants(label, [("bf16->f32", "dot_bf16", lambda: f16(x16, w16))], ops,
                           PEAK_BF16_FLOPS, chain, calls)["bf16->f32"]
        r8 = run_variants(label, [("int8->i32", "dot_int8", lambda: f8(x8, w8))], ops,
                          PEAK_INT8_OPS, chain, calls)["int8->i32"]
        drift = float((r8[2].double() - r16[2].double()).abs().max())
        dev = "" if r8[1] is None or r16[1] is None else f", device {r16[1] / r8[1]:.3f}x"
        print(f"{label}: int8 speed-up over bf16 {r16[0] / r8[0]:.3f}x by events{dev}; "
              f"max|delta| int8 vs bf16 {drift:.1f} (bf16's rounding of |out| up to "
              f"{float(r8[2].abs().max()):.0f})", flush=True)
    return calls


if __name__ == "__main__":
    main()
