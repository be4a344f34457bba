"""Same-process A/B of conv implementations on the card: kernel E (the
whole-map conv of ``conv2d(impl="gemm")``), kernel A with and without its
GroupNorm+SiLU prologue, and cuDNN for each.

Counterpart of ``tools/ab_conv.py``, with its arguments and default shapes
(none of which ``plan_co_tile`` accepts, so E runs only on shapes given on
the command line, e.g. 2x64x64x320).  Variants, in two groups, each held
against its first (max |delta|):

    cudnn              F.conv2d + bias (the JAX tool's "xla")
    whole-map E        conv2d(x, k, b, padding=1, impl="gemm"), where plan_co_tile accepts
    slab               kernel A without prologue

    cudnn gn+silu+conv group_norm -> silu -> F.conv2d + bias
    slab gn-prologue   kernel A with the GroupNorm+SiLU prologue

Inputs are made from a numpy seed (the JAX tool used zeros); Co == Ci.

    python -m sdtpu_torch.tools.ab_conv [chain] [BxHxWxC ...]    (default 50)
"""

from __future__ import annotations

import sys
from collections import Counter

import numpy as np
import torch

from sdtpu_torch.kernels.conv2d import (
    conv3x3_launches,
    conv3x3_slab,
    gn_silu_conv3x3_slab,
    plan_co_tile,
)
from sdtpu_torch.ops import conv2d, group_norm, silu
from sdtpu_torch.tools import PEAK_BF16_FLOPS, card_line, chain_arg, require_cuda, run_variants
from sdtpu_torch.utils.quant import slab_plan_ok

DEFAULT_SHAPES = [
    (2, 96, 96, 320),     # SD2.1-768 level 0
    (2, 96, 96, 640),
    (2, 128, 128, 320),   # SDXL-1024 level 0
    (1, 128, 128, 512),   # VAE decoder
    (1, 256, 256, 256),
    (1, 512, 512, 128),
]


def conv_inputs(b, h, w, c, seed=0):
    """x (b, h, w, c) and kernel (3, 3, c, c) bf16, bias (c,) f32 and a
    GroupNorm's params, on the card from one numpy seed."""
    rng = np.random.default_rng(seed)

    def dev(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to("cuda", dtype)

    x = dev(rng.standard_normal((b, h, w, c)), torch.bfloat16)
    k = dev(rng.standard_normal((3, 3, c, c)) * (9 * c) ** -0.5, torch.bfloat16)
    bias = dev(rng.standard_normal(c) * 0.1)
    norm = {"scale": dev(1 + 0.1 * rng.standard_normal(c)), "bias": dev(0.1 * rng.standard_normal(c))}
    return x, k, bias, norm


def main(argv=None) -> Counter:
    argv = sys.argv[1:] if argv is None else argv
    require_cuda("ab_conv")
    chain = chain_arg(argv, 50)
    shapes = ([tuple(int(v) for v in s.split("x")) for s in argv[1:]] if len(argv) > 1
              else DEFAULT_SHAPES)
    print(card_line(), flush=True)
    calls = Counter()
    for b, h, w, c in shapes:
        x, k, bias, norm = conv_inputs(b, h, w, c)
        g = 32 if c % 32 == 0 else 16
        # cuDNN's own layouts, made once: a weight neither contiguous nor
        # channels_last is copied on every call
        x_nchw, b16 = x.permute(0, 3, 1, 2), bias.to(torch.bfloat16)
        k_oihw = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        conv = [("cudnn", None, lambda: torch.nn.functional.conv2d(
            x_nchw, k_oihw, b16, padding=1).permute(0, 2, 3, 1))]
        whole = plan_co_tile((b, h, w, c), (3, 3, c, c))
        if whole is not None:
            conv.append((f"whole-map E {whole}", conv3x3_launches("conv3x3_gemm", x.shape, c),
                         lambda: conv2d(x, k, bias, padding=1, impl="gemm")))
        slab = slab_plan_ok((b, h, w, c), (3, 3, c, c))
        if slab:
            conv.append(("slab", conv3x3_launches("conv3x3_slab", x.shape, c),
                         lambda: conv3x3_slab(x, k, bias)))
        gn_conv = [("cudnn gn+silu+conv", None, lambda: torch.nn.functional.conv2d(
            silu(group_norm(x, norm, num_groups=g)).permute(0, 3, 1, 2), k_oihw, b16,
            padding=1).permute(0, 2, 3, 1))]
        if slab:
            gn_conv.append(("slab gn-prologue",
                            conv3x3_launches("conv3x3_slab", x.shape, c, prologue=True),
                            lambda: gn_silu_conv3x3_slab(x, norm, k, bias, num_groups=g)))
        print(f"== {b}x{h}x{w}x{c} (chain {chain}) ==", flush=True)
        for variants in (conv, gn_conv):
            run_variants(f"{b}x{h}x{w}x{c}", variants, 2.0 * b * h * w * 9 * c * c,
                         PEAK_BF16_FLOPS, chain, calls)
    return calls


if __name__ == "__main__":
    main()
