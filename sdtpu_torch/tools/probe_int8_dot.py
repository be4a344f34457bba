"""Probe: does the card's int8 ``mma`` give twice the bf16 rate at the slab
conv's GEMM shapes?  (kernel J)

Counterpart of ``tools/probe_int8_dot.py``: ``make(m, k, n, in_dtype, acc_t,
out_dtype)`` returns ``f(x, w)``, one (m, k) @ (k, n) product with the
given accumulator: bf16 inputs accumulate in float32 and round once to
bf16, int8 inputs accumulate in int32 and return int32, exact.  Both
variants take the same integer-valued inputs (int8 values, exact in bf16),
so max |delta| of int8 against bf16 is bf16's rounding alone.

On the card both forms take their output tile and their split of the K
loop from ``plan_dot``; a split call adds the reduction (``dot_bf16_splitk``
in a fixed order, ``dot_int8_splitk`` exact), counted on its own.  The
int8 form first transposes w to (n, k) (``dot_int8_transpose``, counted on
its own): the card's integer ``wgmma`` reads both operands K-major.
``dot_launches`` derives a call's launches.

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
# The int8 kernel: the same BM, ring and BNs, 128-value K steps; a split
# keeps at least the bf16 form's K depth (512 values)
DOT_I8_BK = 128
DOT_I8_MIN_SPLIT = DOT_MIN_SPLIT * DOT_BK // DOT_I8_BK


def dot_plain(x: torch.Tensor, w: torch.Tensor, acc_t, out_dtype) -> torch.Tensor:
    """Kernel J's function: bf16 x bf16 accumulated in float32 and rounded
    once to ``out_dtype``; int8 x int8 in float64, returned as int32: each
    product is at most 2^14 in magnitude, so for K < 2^17 (where the int32
    result itself fits) every partial sum is an exact integer."""
    if acc_t == torch.int32:
        return (x.double() @ w.double()).to(out_dtype)
    return (x.float() @ w.float()).to(out_dtype)


@functools.lru_cache(maxsize=64)  # a call's host time sits at the enqueue floor
def plan_dot(m: int, k: int, n: int, int8: bool = False) -> tuple:
    """``(bn, splits)`` for one call of kernel J, (m, k) @ (k, n): the
    output tile is ``DOT_BM`` x bn and the K loop of ``ceil(k / bk)`` steps
    (bk ``DOT_BK``, or ``DOT_I8_BK`` for ``int8``) is split over ``splits``
    blocks.  Among bn in ``DOT_BNS`` and the splits that keep at least
    ``DOT_MIN_SPLIT`` (int8: ``DOT_I8_MIN_SPLIT``) steps each (at most
    ``DOT_MAX_SPLITS``), the one with the least ``waves * steps per block *
    bn`` (waves of one block per SM; a block's step costs in proportion to
    bn), then the fewest splits, then the wider tile.  Raises on a shape the
    kernel does not take."""
    if min(m, k, n) <= 0 or k % 32 or n % 8:
        raise ValueError(f"plan_dot: no plan for m={m} k={k} n={n} (k a multiple of 32, n of "
                         "8; sizes positive)")
    bk, min_split = (DOT_I8_BK, DOT_I8_MIN_SPLIT) if int8 else (DOT_BK, DOT_MIN_SPLIT)
    steps = -(-k // bk)
    cap = max(1, min(DOT_MAX_SPLITS, steps // min_split))
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
    adds one to on the card: its own, the split-K reduction where
    ``plan_dot`` splits, and for int8 the transpose of w."""
    int8 = in_dtype == torch.int8
    key = "dot_int8" if int8 else "dot_bf16"
    keys = {key: 1}
    if int8:
        keys["dot_int8_transpose"] = 1
    if plan_dot(m, k, n, int8)[1] > 1:
        keys[key + "_splitk"] = 1
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


def dot_int8_split_plain(x: torch.Tensor, w: torch.Tensor, splits: int) -> torch.Tensor:
    """The int8 card kernel's split partials: (splits, m, n) int32, split s
    over the K steps ``[s * T // splits, (s + 1) * T // splits)`` of T =
    ceil(k / ``DOT_I8_BK``), each an exact integer sum."""
    k = x.shape[1]
    steps = -(-k // DOT_I8_BK)
    bounds = [min(k, s * steps // splits * DOT_I8_BK) for s in range(splits + 1)]
    return torch.stack([dot_plain(x[:, a:b], w[a:b], torch.int32, torch.int32)
                        for a, b in zip(bounds, bounds[1:])])


def dot_int8_reduce_plain(ws: torch.Tensor) -> torch.Tensor:
    """The int8 split-K reduction's function: the sum over ws (S, m, n)
    int32, exact (the int32 result fits)."""
    return ws.sum(dim=0, dtype=torch.int64).to(torch.int32)


def dot_transpose_plain(w: torch.Tensor) -> torch.Tensor:
    """The int8 form's transpose: w (k, n) -> (n, k), contiguous."""
    return w.t().contiguous()


def _lib():
    lib = _build.load("dot")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.dot_bf16_launch, lib.dot_int8_launch):
            fn.argtypes = [p] * 4 + [i] * 5 + [p]
            fn.restype = i
        for fn in (lib.dot_bf16_splitk_launch, lib.dot_int8_splitk_launch):
            fn.argtypes = [p] * 2 + [i] * 3 + [p]
            fn.restype = i
        lib.dot_int8_transpose_launch.argtypes = [p] * 2 + [i] * 2 + [p]
        lib.dot_int8_transpose_launch.restype = i
        lib.dot_bf16_tensor_maps.argtypes = [p] * 2 + [i] * 3
        lib.dot_bf16_tensor_maps.restype = i
        for form, bk in (("bf16", DOT_BK), ("int8", DOT_I8_BK)):
            tile = getattr(lib, f"dot_{form}_tile")
            tile.argtypes = [i]
            tile.restype = i
            tiles = tuple(tile(j) for j in range(5))
            want = (DOT_BM, bk, DOT_STAGES, *DOT_BNS)
            if tiles != want:
                raise RuntimeError(f"dot.cu runs {form} tiles (BM, BK, STAGES, BN_A, BN_B) "
                                   f"{tiles}, plan_dot assumes {want}")
        lib._typed = True
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dot_splitk_reduce(ws: torch.Tensor) -> torch.Tensor:
    """A split-K reduction alone: ws (S, m, n) float32 -> (m, n) bf16 as
    ``splitk_reduce_plain``, or int32 -> int32 as ``dot_int8_reduce_plain``.
    On the card: ws contiguous, m * n a multiple of 8."""
    int8 = ws.dtype == torch.int32
    key = "dot_int8_splitk" if int8 else "dot_bf16_splitk"
    if ws.device.type == "cpu":
        return dot_int8_reduce_plain(ws) if int8 else splitk_reduce_plain(ws)
    if ws.device.type != "cuda":
        raise ValueError(f"{key}: unsupported device {ws.device}")
    if ws.dtype not in (torch.float32, torch.int32) or ws.dim() != 3 or not ws.is_contiguous():
        raise ValueError(f"{key}: ws must be contiguous float32 or int32 (S, m, n)")
    splits, m, n = ws.shape
    out = torch.empty((m, n), device=ws.device, dtype=torch.int32 if int8 else torch.bfloat16)
    launch = _lib().dot_int8_splitk_launch if int8 else _lib().dot_bf16_splitk_launch
    err = launch(ws.data_ptr(), out.data_ptr(), m, n, splits, _stream(ws))
    _build.check(err, key)
    launch_counts[key] += 1
    return out


def dot_int8_transpose(w: torch.Tensor) -> torch.Tensor:
    """The int8 form's transpose alone: w (k, n) int8 -> (n, k) as
    ``dot_transpose_plain``.  On the card w contiguous, k and n multiples of
    16."""
    if w.device.type == "cpu":
        return dot_transpose_plain(w)
    if w.device.type != "cuda":
        raise ValueError(f"dot_int8_transpose: unsupported device {w.device}")
    if w.dtype != torch.int8 or w.dim() != 2 or not w.is_contiguous() or w.shape[0] % 16 \
            or w.shape[1] % 16:
        raise ValueError("dot_int8_transpose: w must be contiguous int8 (k, n), k and n "
                         "multiples of 16")
    k, n = w.shape
    wt = torch.empty((n, k), device=w.device, dtype=torch.int8)
    err = _lib().dot_int8_transpose_launch(w.data_ptr(), wt.data_ptr(), k, n, _stream(w))
    _build.check(err, "dot_int8_transpose")
    launch_counts["dot_int8_transpose"] += 1
    return wt


def dot_int8_kmajor(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """J int8 on an already transposed w: x (m, k) and wt (n, k) int8 ->
    (m, n) int32 = x @ wt.T, exact, with ``plan_dot``'s tile and splits (a
    split call adds ``dot_int8_splitk``).  On the card both contiguous, k a
    multiple of 64 and n of 16."""
    (m, k), n = x.shape, wt.shape[0]
    if wt.dtype != torch.int8 or x.dtype != torch.int8 or tuple(wt.shape) != (n, k) \
            or wt.device != x.device:
        raise ValueError(f"dot_int8: x (m, k) and wt (n, k) must be int8 on one device, got "
                         f"{x.dtype} {tuple(x.shape)} and {wt.dtype} {tuple(wt.shape)}")
    if x.device.type == "cpu":
        return dot_plain(x, wt.t(), torch.int32, torch.int32)
    if x.device.type != "cuda":
        raise ValueError(f"dot_int8: unsupported device {x.device}")
    if k % 64 or n % 16:
        raise ValueError(f"dot_int8: k={k} must be a multiple of 64 and n={n} of 16")
    if not (x.is_contiguous() and wt.is_contiguous()):
        raise ValueError("dot_int8: x and wt must be contiguous")
    bn, splits = plan_dot(m, k, n, True)
    out = ws = None
    if splits > 1:
        ws = torch.empty((splits, m, n), device=x.device, dtype=torch.int32)
    else:
        out = torch.empty((m, n), device=x.device, dtype=torch.int32)
    err = _lib().dot_int8_launch(x.data_ptr(), wt.data_ptr(), None if out is None else
                                 out.data_ptr(), None if ws is None else ws.data_ptr(), m, k, n,
                                 bn, splits, _stream(x))
    _build.check(err, "dot_int8")
    launch_counts["dot_int8"] += 1
    return out if ws is None else dot_splitk_reduce(ws)


def make(m: int, k: int, n: int, in_dtype, acc_t, out_dtype):
    """``f(x, w)``: x (m, k) and w (k, n) of ``in_dtype`` -> (m, n) of
    ``out_dtype``, accumulated in ``acc_t``.  The forms taken are bf16 ->
    float32 -> bf16 and int8 -> int32 -> int32.  On the card x and w must be
    contiguous, k a multiple of 32 (bf16) or 64 (int8) and n of 8 or 16;
    both forms run ``plan_dot``'s tile and splits, the int8 form after
    ``dot_int8_transpose``."""
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
        if in_dtype == torch.int8:
            return dot_int8_kmajor(x, dot_int8_transpose(w))
        bn, splits = plan_dot(m, k, n)
        out = ws = None
        if splits > 1:
            ws = torch.empty((splits, m, n), device=x.device, dtype=torch.float32)
        else:
            out = torch.empty((m, n), device=x.device, dtype=out_dtype)
        err = _lib().dot_bf16_launch(x.data_ptr(), w.data_ptr(), None if out is None else
                                     out.data_ptr(), None if ws is None else ws.data_ptr(), m,
                                     k, n, bn, splits, _stream(x))
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
        r8 = run_variants(label, [("int8->i32", dot_launches(m, k, n, torch.int8),
                                   lambda: f8(x8, w8))], ops,
                          PEAK_INT8_OPS, chain, calls)["int8->i32"]
        drift = float((r8[2].double() - r16[2].double()).abs().max())
        dev = "" if r8[1] is None or r16[1] is None else f", device {r16[1] / r8[1]:.3f}x"
        print(f"{label}: int8 speed-up over bf16 {r16[0] / r8[0]:.3f}x by events{dev}; "
              f"max|delta| int8 vs bf16 {drift:.1f} (bf16's rounding of |out| up to "
              f"{float(r8[2].abs().max()):.0f})", flush=True)
    return calls


if __name__ == "__main__":
    main()
