"""Probe: the legacy flash body (kernel H) against the shipped one (kernel C).

Counterpart of ``tools/probe_flash_vpu.py``.  The legacy body computes the
scores' scale after the product, compares every key column with Lk on every
tile (a masked column becomes the finite -0.7 * FLT_MAX) and uses the
natural exp; the shipped body folds log2(e) into the scale, uses exp2 and
masks only the tile that holds keys past Lk.  As the TPU probe timed the
legacy body against its shipped kernel on the same schedule, H here is C's
own kernel (``csrc/flash_attention.cu``: the cp.async K/V ring, ldmatrix
fragments, the query tile of ``plan_flash``) with the legacy body in place
of C's, so legacy / shipped prices the body alone.  Every tensor keeps its
real head dim; the scale is 1/sqrt(D).

    python -m sdtpu_torch.tools.probe_flash_vpu [chain]    (default 100)
"""

from __future__ import annotations

import sys
from collections import Counter

import numpy as np
import torch

from sdtpu_torch.kernels import _build, launch_counts
from sdtpu_torch.kernels.flash_attention import (
    _check_qkv,
    _flash_lib,
    _on_cpu,
    flash_attention_packed,
    flash_attention_stats_plain,
    plan_flash,
)
from sdtpu_torch.tools import PEAK_BF16_FLOPS, card_line, chain_arg, require_cuda, run_variants

# (label, b, h, l, d): latent self-attention shapes (CFG-doubled batch)
SHAPES = [
    ("tiny-sd b1 512px L0", 2, 8, 4096, 40),
    ("serving b8 512px L0", 16, 8, 4096, 40),
    ("sd2.1 b1 768px L0", 2, 8, 9216, 64),
    ("sdxl b1 1024px L0", 2, 10, 16384, 64),
]


def legacy_flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel H's function over (B, H, L, D): s = f32(q k^T) * (1/sqrt(D)),
    natural exp, P cast to v's dtype before P.V, ``1/l -> 1`` where l == 0.
    No key lies past Lk here, so the mask selects nothing."""
    return flash_attention_stats_plain(q, k, v)[0]


def legacy_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel H.  q (B, H, Lq, D), k/v (B, H, Lk, D) -> (B, H, Lq, D).

    On the card: bf16, contiguous, D a multiple of 8 and at most 160; the
    query tile is ``plan_flash``'s, as for kernel C."""
    if _on_cpu("flash_attention_legacy", q):
        return legacy_flash_plain(q, k, v)
    b, h, lq, lk, d = _check_qkv("flash_attention_legacy", q, k, v)
    if d > 160:
        raise ValueError(f"flash_attention_legacy: head dim {d} must be at most 160")
    bq, _ = plan_flash(b * h, lq, lk, d)  # one split: D <= 160
    out = torch.empty_like(q)
    err = _flash_lib().flash_attention_legacy_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, lq, lk, d, bq,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_legacy")
    launch_counts["flash_attention_legacy"] += 1
    return out


def qkv_inputs(b, h, l, d, seed=0):
    """q, k, v (b, h, l, d) bf16 on the card from one numpy seed."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, h, l, d), dtype=np.float32))
            .to("cuda", torch.bfloat16) for _ in range(3)]


def main(argv=None) -> Counter:
    argv = sys.argv[1:] if argv is None else argv
    require_cuda("probe_flash_vpu")
    chain = chain_arg(argv, 100)
    print(card_line(), flush=True)
    calls = Counter()
    for label, b, h, l, d in SHAPES:
        q, k, v = qkv_inputs(b, h, l, d)
        variants = [
            ("legacy", "flash_attention_legacy", lambda: legacy_flash(q, k, v)),
            ("shipped", "flash_attention", lambda: flash_attention_packed(q, k, v)),
        ]
        res = run_variants(label, variants, 4.0 * b * h * l * l * d, PEAK_BF16_FLOPS, chain, calls)
        (ev_l, dev_l, _), (ev_s, dev_s, _) = res["legacy"], res["shipped"]
        dev = "" if dev_l is None or dev_s is None else f", device {dev_l / dev_s:.3f}"
        print(f"{label}: legacy / shipped time {ev_l / ev_s:.3f} by events{dev}", flush=True)
    return calls


if __name__ == "__main__":
    main()
