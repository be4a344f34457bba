"""Probe: does the card's int8 ``mma`` give twice the bf16 rate at the slab
conv's GEMM shapes?  (kernel J)

Counterpart of ``tools/probe_int8_dot.py``: ``make(m, k, n, in_dtype, acc_t,
out_dtype)`` returns ``f(x, w)``, one (m, k) @ (k, n) product with the
given accumulator: bf16 inputs accumulate in float32 and round once to
bf16, int8 inputs accumulate in int32 and return int32, exact.  Both
variants take the same integer-valued inputs (int8 values, exact in bf16),
so max |delta| of int8 against bf16 is bf16's rounding alone.

On the card the bf16 form takes its output tile and its split of the K
loop from ``plan_dot``; a split call adds the fixed-order reduction
(``dot_bf16_splitk``, counted on its own; ``dot_launches`` derives a call's
launches).

    python -m sdtpu_torch.tools.probe_int8_dot [chain]    (default 2000)
"""

from __future__ import annotations

import ctypes
import functools
import sys
from collections import Counter

import numpy as np
import torch

from sdtpu_torch.kernels import _build, launch_counts
from sdtpu_torch.kernels.flash_attention import SMS
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
# The tiles csrc/dot.cu's bf16 kernel is built with (``dot_bf16_tile``).
DOT_BM = 128            # output rows per block
DOT_BK = 64             # K values per step (the last one zero-filled past k)
DOT_STAGES = 4          # TMA ring depth
DOT_BNS = (128, 160)    # output columns per block, the plan's two choices
DOT_MIN_SPLIT = 2 * DOT_STAGES  # K steps a split keeps, at least
DOT_MAX_SPLITS = 16


def dot_plain(x: torch.Tensor, w: torch.Tensor, acc_t, out_dtype) -> torch.Tensor:
    """Kernel J's function: bf16 x bf16 accumulated in float32 and rounded
    once to ``out_dtype``; int8 x int8 in float64, returned as int32: each
    product is at most 2^14 in magnitude, so for K < 2^17 (where the int32
    result itself fits) every partial sum is an exact integer."""
    if acc_t == torch.int32:
        return (x.double() @ w.double()).to(out_dtype)
    return (x.float() @ w.float()).to(out_dtype)


@functools.lru_cache(maxsize=64)  # a call's host time sits at the enqueue floor
def plan_dot(m: int, k: int, n: int) -> tuple:
    """``(bn, splits)`` for one bf16 call of kernel J, (m, k) @ (k, n): the
    output tile is ``DOT_BM`` x bn and the K loop of ``ceil(k / DOT_BK)``
    steps is split over ``splits`` blocks.  Among bn in ``DOT_BNS`` and the
    splits that keep at least ``DOT_MIN_SPLIT`` steps each (at most
    ``DOT_MAX_SPLITS``), the one with the least ``waves * steps per block *
    bn`` (waves of one block per SM; a block's step costs in proportion to
    bn), then the fewest splits, then the wider tile.  Raises on a shape the
    kernel does not take."""
    if min(m, k, n) <= 0 or k % 32 or n % 8:
        raise ValueError(f"plan_dot: no plan for m={m} k={k} n={n} (k a multiple of 32, n of "
                         "8; sizes positive)")
    steps = -(-k // DOT_BK)
    cap = max(1, min(DOT_MAX_SPLITS, steps // DOT_MIN_SPLIT))
    best = None
    for bn in DOT_BNS:
        tiles = -(-m // DOT_BM) * -(-n // bn)
        for splits in range(1, cap + 1):
            cost = -(-tiles * splits // SMS) * -(-steps // splits) * bn
            key = (cost, splits, -bn)
            if best is None or key < best:
                best = key
    return -best[2], best[1]


def dot_launches(m: int, k: int, n: int, in_dtype) -> dict:
    """The launch counters one call of ``make(m, k, n, in_dtype, ...)``
    adds one to on the card: its own, and for bf16 the split-K reduction
    where ``plan_dot`` splits."""
    if in_dtype == torch.int8:
        return {"dot_int8": 1}
    keys = {"dot_bf16": 1}
    if plan_dot(m, k, n)[1] > 1:
        keys["dot_bf16_splitk"] = 1
    return keys


def splitk_reduce_plain(ws: torch.Tensor) -> torch.Tensor:
    """The split-K reduction's function: ``bf16(ws[0] + ws[1] + ... +
    ws[S-1])`` over ws (S, m, n) float32, added in that order in float32 and
    rounded once."""
    acc = ws[0].clone()
    for part in ws[1:]:
        acc += part
    return acc.to(torch.bfloat16)


def dot_splitk_plain(x: torch.Tensor, w: torch.Tensor, splits: int) -> torch.Tensor:
    """The bf16 card kernel's order of sums: split s takes the K steps
    ``[s * T // splits, (s + 1) * T // splits)`` of T = ceil(k / ``DOT_BK``),
    its float32 partial product is one slice of ws, and
    ``splitk_reduce_plain`` adds the slices in order and rounds once.  With
    one split this is ``dot_plain`` exactly."""
    k = x.shape[1]
    steps = -(-k // DOT_BK)
    bounds = [min(k, s * steps // splits * DOT_BK) for s in range(splits + 1)]
    ws = torch.stack([x[:, a:b].float() @ w[a:b].float() for a, b in zip(bounds, bounds[1:])])
    return splitk_reduce_plain(ws)


def _lib():
    lib = _build.load("dot")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dot_bf16_launch.argtypes = [p] * 4 + [i] * 5 + [p]
        lib.dot_bf16_launch.restype = i
        lib.dot_bf16_splitk_launch.argtypes = [p] * 2 + [i] * 3 + [p]
        lib.dot_bf16_splitk_launch.restype = i
        lib.dot_int8_launch.argtypes = [p] * 3 + [i] * 3 + [p]
        lib.dot_int8_launch.restype = i
        lib.dot_bf16_tile.argtypes = [i]
        lib.dot_bf16_tile.restype = i
        lib.dot_bf16_tensor_maps.argtypes = [p] * 2 + [i] * 3
        lib.dot_bf16_tensor_maps.restype = i
        tiles = tuple(lib.dot_bf16_tile(j) for j in range(5))
        want = (DOT_BM, DOT_BK, DOT_STAGES, *DOT_BNS)
        if tiles != want:
            raise RuntimeError(f"dot.cu runs tiles (BM, BK, STAGES, BN_A, BN_B) {tiles}, "
                               f"plan_dot assumes {want}")
        lib._typed = True
    return lib


def dot_splitk_reduce(ws: torch.Tensor) -> torch.Tensor:
    """The split-K reduction alone: ws (S, m, n) float32 -> (m, n) bf16 as
    ``splitk_reduce_plain``.  On the card: ws contiguous, m * n a multiple
    of 8."""
    if ws.device.type == "cpu":
        return splitk_reduce_plain(ws)
    if ws.device.type != "cuda":
        raise ValueError(f"dot_bf16_splitk: unsupported device {ws.device}")
    if ws.dtype != torch.float32 or ws.dim() != 3 or not ws.is_contiguous():
        raise ValueError("dot_bf16_splitk: ws must be contiguous float32 (S, m, n)")
    splits, m, n = ws.shape
    out = torch.empty((m, n), device=ws.device, dtype=torch.bfloat16)
    err = _lib().dot_bf16_splitk_launch(ws.data_ptr(), out.data_ptr(), m, n, splits,
                                        torch.cuda.current_stream(ws.device).cuda_stream)
    _build.check(err, "dot_bf16_splitk")
    launch_counts["dot_bf16_splitk"] += 1
    return out


def make(m: int, k: int, n: int, in_dtype, acc_t, out_dtype):
    """``f(x, w)``: x (m, k) and w (k, n) of ``in_dtype`` -> (m, n) of
    ``out_dtype``, accumulated in ``acc_t``.  The forms taken are bf16 ->
    float32 -> bf16 and int8 -> int32 -> int32.  On the card x and w must be
    contiguous, k a multiple of 32 (bf16) or 64 (int8) and n of 8 or 16;
    the bf16 form runs ``plan_dot``'s tile and splits."""
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
        lib, stream = _lib(), torch.cuda.current_stream(x.device).cuda_stream
        if in_dtype == torch.int8:
            out = torch.empty((m, n), device=x.device, dtype=out_dtype)
            err = lib.dot_int8_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, stream)
            _build.check(err, key)
            launch_counts[key] += 1
            return out
        bn, splits = plan_dot(m, k, n)
        out = ws = None
        if splits > 1:
            ws = torch.empty((splits, m, n), device=x.device, dtype=torch.float32)
        else:
            out = torch.empty((m, n), device=x.device, dtype=out_dtype)
        err = lib.dot_bf16_launch(x.data_ptr(), w.data_ptr(), None if out is None else
                                  out.data_ptr(), None if ws is None else ws.data_ptr(), m, k,
                                  n, bn, splits, stream)
        _build.check(err, key)
        launch_counts[key] += 1
        return out if ws is None else dot_splitk_reduce(ws)

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
        r16 = run_variants(label, [("bf16->f32", dot_launches(m, k, n, torch.bfloat16),
                                    lambda: f16(x16, w16))], ops,
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
