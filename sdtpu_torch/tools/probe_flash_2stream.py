"""Probe: flash attention with nq independent online-softmax chains per block
(kernel I) against the shipped kernel C.

Counterpart of ``tools/probe_flash_2stream.py``.  Each chain has its own
running max, sum and accumulator over the same K/V tiles; natural exp, the
scale after the product, P cast to v's dtype, the key mask only on the
tile that holds keys past Lk.  The JAX probe's kernel reads its padded head
dim from a name it never defines (``a0_scr``, ``tools/probe_flash_2stream.py:74``),
so it raises NameError on every backend; the evident intent is the head dim
of the accumulator, and here every tensor keeps its real head dim (the
scale is 1/sqrt(D)).

On the card I runs on kernel C's own kernel (``csrc/flash_attention.cu``:
the cp.async K/V ring, ldmatrix fragments, C's key tile but where 128-key
tiles would spill) with H's body and
C's key mask (only the tile that holds keys past Lk).  A chain is 4 warps
and ``bq``, its rows, is 64 or 128 (one or two 16-row tiles a warp); a
block holds ``nq`` chains that stage each K/V tile once for all of them.
The JAX ``bq`` sized a VMEM tile.  The card variants and the JAX variants
they stand for:

    shipped  kernel C (exp2, plan_flash's tile)    shipped (bq 512, one chain)
    1q       nq 1, bq 64: C's 64-row schedule, natural exp  (the one-chain baseline)
    1q-128   nq 1, bq 128                          (rows per K/V tile without chains)
    2q-64    nq 2, bq 64                           2q-256
    2q-128   nq 2, bq 128                          2q-512
    3q-64    nq 3, bq 64                           3q-512
    4q-64    nq 4, bq 64                           4q-256

JAX's 4q-512 and 2q-1024 (over 256 rows per block on the card) have no card
variant.  A variant runs only where its nq * bq rows divide Lq, as the JAX
probe requires; the others are reported as not run.

    python -m sdtpu_torch.tools.probe_flash_2stream [chain]    (default 500)
"""

from __future__ import annotations

import sys
from collections import Counter

import torch

from sdtpu_torch.kernels import _build, launch_counts
from sdtpu_torch.kernels.flash_attention import (
    _check_qkv,
    _flash_lib,
    _on_cpu,
    flash_attention_packed,
)
from sdtpu_torch.tools import PEAK_BF16_FLOPS, card_line, chain_arg, require_cuda, run_variants
from sdtpu_torch.tools.probe_flash_vpu import SHAPES, legacy_flash_plain, qkv_inputs

# (nq, bq) pairs the card kernel takes: bq 64 or 128, nq * bq <= 256
CARD_VARIANTS = ((1, 64), (2, 64), (3, 64), (4, 64), (1, 128), (2, 128))
TOOL_VARIANTS = (("1q", 1, 64), ("1q-128", 1, 128), ("2q-64", 2, 64), ("2q-128", 2, 128),
                 ("3q-64", 3, 64), ("4q-64", 4, 64))


def _check_tile(lq: int, bq: int, nq: int) -> None:
    if lq % (nq * bq):
        raise ValueError(f"flash_2q: Lq={lq} must be a multiple of nq*bq={nq}*{bq}")


def flash_2q_plain(q, k, v, *, bq: int, nq: int = 2, block_k: int = 1024) -> torch.Tensor:
    """Kernel I's function over (B, H, L, D): softmax(q k^T / sqrt(D)) v with
    natural exp and P cast to v's dtype; each query row's softmax is its own,
    so the nq chains of bq rows change no value.  Raises where Lq is not a
    multiple of nq * bq.  ``block_k`` places the JAX key mask and changes no
    value."""
    _check_tile(q.shape[2], bq, nq)
    return legacy_flash_plain(q, k, v)


def flash_2q(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, bq: int, nq: int = 2,
             block_k: int = 1024) -> torch.Tensor:
    """Kernel I.  q (B, H, Lq, D), k/v (B, H, Lk, D) -> (B, H, Lq, D).  Raises
    where Lq is not a multiple of nq * bq.  On the card: bf16, contiguous, D a
    multiple of 8 and at most 160, (nq, bq) one of ``CARD_VARIANTS``;
    ``block_k`` is ignored (the card's key tile is kernel C's)."""
    if _on_cpu("flash_attention_nq", q):
        return flash_2q_plain(q, k, v, bq=bq, nq=nq, block_k=block_k)
    b, h, lq, lk, d = _check_qkv("flash_attention_nq", q, k, v)
    _check_tile(lq, bq, nq)
    if d > 160:
        raise ValueError(f"flash_attention_nq: head dim {d} must be at most 160")
    if (nq, bq) not in CARD_VARIANTS:
        raise ValueError(f"flash_attention_nq: (nq, bq) = ({nq}, {bq}) is not one of "
                         f"{CARD_VARIANTS}")
    out = torch.empty_like(q)
    err = _flash_lib().flash_attention_nq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, lq, lk, d, nq, bq,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_nq")
    launch_counts["flash_attention_nq"] += 1
    return out


def main(argv=None) -> Counter:
    argv = sys.argv[1:] if argv is None else argv
    require_cuda("probe_flash_2stream")
    chain = chain_arg(argv, 500)
    print(card_line(), flush=True)
    calls = Counter()
    for label, b, h, l, d in SHAPES:
        q, k, v = qkv_inputs(b, h, l, d)
        variants = [("shipped", "flash_attention", lambda: flash_attention_packed(q, k, v))]
        for name, nq, bq in TOOL_VARIANTS:
            if l % (nq * bq):
                print(f"{label} {name:>18}: not run, Lq={l} is not a multiple of {nq * bq}",
                      flush=True)
                continue
            variants.append((name, "flash_attention_nq",
                             lambda nq=nq, bq=bq: flash_2q(q, k, v, bq=bq, nq=nq)))
        run_variants(label, variants, 4.0 * b * h * l * l * d, PEAK_BF16_FLOPS, chain, calls)
    return calls


if __name__ == "__main__":
    main()
