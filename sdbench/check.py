"""Whether the timed path produced the right images.

Once the window has closed, a sample of the finished requests, drawn from
the seed, is worked out again by the plain float32 reference
(``sdbench/reference``, TF32 off) from the same weights and inputs.  The
numbers compared are those the cell's own file
(``sdbench/workloads/<cell>.json``) gives limits for, each taken at the
sample's worst image: the mean absolute difference in uint8 levels between
a served image and the reference's (``mean_abs_levels``), and the share of
its values more than k levels off (``pct_over_<k>_levels``).  The limits
are set from the program's readings and the controls'
(``sdbench/control.py``; ``PERF.md`` gives them)."""

from __future__ import annotations

import contextlib
import re

import numpy as np


@contextlib.contextmanager
def strict_f32():
    """TF32 off for matmuls and convolutions, restored after."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def sample(records, seed: int, n: int) -> list:
    """At least ``n`` finished requests drawn from ``seed``, in request
    order: whole device batches where the driver sent batches (so that no
    row of a batch goes unchecked), else single requests."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 0xC4EC])
    batches = {}
    for r in records:
        batches.setdefault(r.batch if r.batch is not None else id(r), []).append(r)
    whole = [b for b in batches.values() if all(r.image is not None for r in b)]
    picked, rows = [], 0
    for i in rng.permutation(len(whole)):
        if rows >= n:
            break
        picked += whole[i]
        rows += len(whole[i])
    return sorted(picked, key=lambda r: r.req["index"])


def references(records, params, cfg: dict, *, per_row: bool, device,
               lowp: str = "f32") -> list:
    """Per record: the reference's uint8 image of its request (``lowp="fp8"``:
    the fp8 control's)."""
    from sdbench.reference.nn import Ops
    from sdbench.reference.pipeline import generate

    with strict_f32():
        return [generate(params, cfg, r.req, per_row=per_row, ops=Ops(lowp), device=device)
                for r in records]


OVER = re.compile(r"^pct_over_(\d+)_levels$")


def image_readings(image: np.ndarray, ref: np.ndarray, names) -> dict:
    """The named numbers of one image: ``mean_abs_levels``, the mean
    absolute difference in uint8 levels, and ``pct_over_<k>_levels``, the
    percentage of its values more than k levels off."""
    d = np.abs(image.astype(np.int16) - ref.astype(np.int16))
    out = {}
    for n in names:
        over = OVER.match(n)
        if n == "mean_abs_levels":
            out[n] = float(d.mean())
        elif over:
            out[n] = 100.0 * float((d > int(over.group(1))).mean())
        else:
            raise KeyError(f"no reading named {n!r}")
    return out


# what the control's readings cover, so that a limit can be set on any
READINGS = ("mean_abs_levels",) + tuple(f"pct_over_{k}_levels" for k in (2, 3, 4, 6, 8, 12, 16,
                                                                         24, 32))


def readings(images: list, refs: list, names) -> dict:
    """Each named number at the sample's worst image (None for an empty
    sample)."""
    per = [image_readings(a, b, names) for a, b in zip(images, refs)]
    return {n: max((p[n] for p in per), default=None) for n in names}


def judge(readings: dict, limits: dict) -> tuple:
    """``(correct, [(name, value, limit)])``: correct when every number is
    within its limit; a number with no limit set is not correct."""
    rows = [(k, readings[k], limits.get(k)) for k in readings]
    ok = all(lim is not None and v is not None and v <= lim for _, v, lim in rows)
    return ok, rows
