"""Same-process A/B of the packed out-projection (kernel G) on the UNet
step, off and on: the counterpart of the JAX package's
``tools/ab_packed_proj.py``::

    python -m sdtpu_torch.tools.ab_packed_proj [preset] [image_size] [chain_len] [--device cuda]

Off, the flash route's self-attention out-projection is
``einsum("bhld,hdc->blc")`` of the head-major attention output, then bias,
then the residual (PyTorch ops); on
(``ops/attention.py:_PACKED_OUT_PROJ``, set at run time around each
variant's chain and restored), kernel G reads the head-major output and
adds bias and residual in its epilogue, rounded once.  Each variant is a
chain of ``chain_len`` (default 25) CFG-batched UNet steps on zero weights
of the preset's shapes (default tiny-sd at 512), flash attention and the
slab convs, the cross-attention K/V and the time projections hoisted, each
output fed back; both run once, then 7 interleaved rounds; the median and
best per step are printed, then the ratio.  Times are CUDA events on a
card, the host clock on the CPU (``--device cpu``, the tests); without a
card ``--device cuda`` exits non-zero.  ``main()`` returns ``{variant:
median seconds}``; each variant's chain runs ``1 + REPEATS`` times.
"""

from __future__ import annotations

import argparse

import torch

REPEATS = 7
NAMES = ("packed=off", "packed=ON ")


def with_packed(fn, on: bool):
    """``fn`` run with ``_PACKED_OUT_PROJ`` set to ``on``, restored after."""
    import importlib

    from sdtpu_torch.tools import swapped

    # the module: the package sdtpu_torch.ops re-exports a function of its name
    attn_mod = importlib.import_module("sdtpu_torch.ops.attention")

    def run():
        with swapped(attn_mod, "_PACKED_OUT_PROJ", on):
            return fn()

    return run


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("preset", nargs="?", default="tiny-sd")
    ap.add_argument("image_size", nargs="?", type=int, default=512)
    ap.add_argument("chain", nargs="?", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from sdtpu_torch.config import get_preset
    from sdtpu_torch.tools import card_line, device_arg, interleaved
    from sdtpu_torch.tools.ab_unet import chain_inputs, make_chain

    device = device_arg("ab_packed_proj", args.device)
    if device.type == "cuda":
        print(card_line(), flush=True)
    config = get_preset(args.preset)
    fn = make_chain(config, *chain_inputs(config, args.image_size, device), attn="flash",
                    conv="gemm", hoist=True, chain=args.chain)
    with torch.inference_mode():
        meds = interleaved([(NAMES[0], with_packed(fn, False)), (NAMES[1], with_packed(fn, True))],
                           device, args.chain, "step", REPEATS)
    off, on = meds[NAMES[0]], meds[NAMES[1]]
    print(f"packed out-proj: {off / on:5.3f}x vs einsum "
          f"({(off - on) / args.chain * 1000:+.3f} ms/step)", flush=True)
    return meds


if __name__ == "__main__":
    main()
