"""Probe: flash attention C in bf16 beside SDPA at the SD family's latent
self-attention shapes: the counterpart of the JAX package's
``tools/probe_flash_int8.py``::

    python -m sdtpu_torch.tools.probe_flash_int8 [chain]    (default 60)

The JAX probe once timed dynamically quantized int8 modes of its flash
kernel against bf16.  Every int8 mode measured slower than bf16 on its
TPU, and ``sdtpu/kernels/flash_attention.py`` removed the modes; the probe
now times the shipped bf16 kernel and prints the recorded int8 rows of
that TPU, which describe another machine and are not printed here.  So
there is no int8 attention to port: this probe times C (bf16, the
``plan_flash`` tile, the real head dim) and SDPA at the JAX probe's three
shapes, ``chain`` calls after a warm-up, by CUDA events and the
profiler's device time, beside each call's share of the bf16 peak
(989 TFLOP/s) and its bound (bytes over 3.35 TB/s, operations over the
peak, exponentials over this card's rate: the larger).  C's output is held
to its plain version within ``TOL_REL`` of max |plain|.  Needs a card:
without one it exits non-zero.  ``main()`` returns the launches of each
kernel counter its calls make.
"""

from __future__ import annotations

import sys
from collections import Counter

import torch

# (label, b, h, l, d): latent self-attention shapes (CFG-doubled batch)
SHAPES = [
    ("tiny-sd b1 512px L0", 2, 8, 4096, 40),
    ("serving b8 512px L0", 16, 8, 4096, 40),
    ("sd2.1 b1 768px L0", 2, 8, 9216, 64),
]


def main(argv=None) -> Counter:
    import torch.nn.functional as F

    from sdtpu_torch.kernels.flash_attention import (
        flash_attention_packed,
        flash_attention_plain,
        flash_launches,
    )
    from sdtpu_torch.tools import (
        PEAK_BF16_FLOPS,
        bound_ms,
        by_rows,
        card_line,
        chain_arg,
        check_plain,
        exp_rate,
        flash_cost,
        require_cuda,
        run_variants,
    )
    from sdtpu_torch.tools.probe_flash_vpu import qkv_inputs

    argv = sys.argv[1:] if argv is None else argv
    require_cuda("probe_flash_int8")
    chain = chain_arg(argv, 60)
    print(card_line(), flush=True)
    rate = exp_rate()
    calls = Counter()
    for label, b, h, l, d in SHAPES:
        q, k, v = qkv_inputs(b, h, l, d)
        variants = [
            ("C bf16", flash_launches("flash_attention", (b, h, l, d), l),
             lambda: flash_attention_packed(q, k, v)),
            ("SDPA bf16", None, lambda: F.scaled_dot_product_attention(q, k, v)),
        ]
        bound = bound_ms(flash_cost((b, h, l, d), l), PEAK_BF16_FLOPS, rate)[0]
        print(f"== {label}: bound {bound:.4f} ms/call", flush=True)
        res = run_variants(label, variants, 4.0 * b * h * l * l * d, PEAK_BF16_FLOPS, chain,
                           calls)
        check_plain(f"{label} C", res["C bf16"][2], by_rows(flash_attention_plain, q, k, v))
        del q, k, v, res
        torch.cuda.empty_cache()
    return calls


if __name__ == "__main__":
    main()
