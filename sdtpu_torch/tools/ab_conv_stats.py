"""Same-process A/B of the GroupNorm statistics chaining inside the slab
resnets, on and off: the counterpart of the JAX package's
``tools/ab_conv_stats.py``::

    python -m sdtpu_torch.tools.ab_conv_stats [preset] [image_size] [chain_len] [--device cuda]
    python -m sdtpu_torch.tools.ab_conv_stats --vae [image_size] [reps_per_call] [--device cuda]

With the chaining on (``kernels/conv2d.py:CONV_STATS_CHAIN``, the
default), a resnet's first conv emits its output's per-channel moments and
the second conv's GroupNorm derives its statistics from them, as does the
transformer's (or the VAE mid-block attention's) GroupNorm after a resnet;
off, every such GroupNorm reduces its input map again.  The switch is read
at call time, so each variant sets it around its own chain and restores it.

The UNet chain (default tiny-sd, 512, 25): ``chain_len`` CFG-batched UNet
steps on zero weights of the preset's shapes, flash attention (kernel C)
and the slab convs (kernels A and B), with the cross-attention K/V and the
time projections hoisted once per chain, each step's output fed back as
the next input.  ``--vae``: ``reps_per_call`` (default 20) tiny-sd VAE
decodes at ``image_size`` (default 512), each coupled back into the
latents through ``tanh`` of the image's mean (a nonlinear coupling, as in
the JAX tool).  Both variants run once, then 7 interleaved rounds; the
median and best per step (per decode) are printed, then the ratio.  Times
are CUDA events on a card, the host clock on the CPU (``--device cpu``,
the tests); without a card ``--device cuda`` exits non-zero.  ``main()``
returns ``{variant: median seconds}``; each variant's chain runs ``1 +
REPEATS`` times.
"""

from __future__ import annotations

import argparse

import torch

REPEATS = 7
NAMES = ("stats=off", "stats=ON ")


def with_chaining(fn, on: bool):
    """``fn`` run with ``CONV_STATS_CHAIN`` set to ``on``, restored after."""
    import sdtpu_torch.kernels.conv2d as conv_kernels
    from sdtpu_torch.tools import swapped

    def run():
        with swapped(conv_kernels, "CONV_STATS_CHAIN", on):
            return fn()

    return run


def vae_chain(config, params, z0, reps: int):
    """A function of no arguments that runs ``reps`` VAE decodes from
    ``z0`` (slab convs, flash attention), each coupled back into the
    latents: ``z + 1e-6 * tanh(mean(image))``."""
    from sdtpu_torch.models.vae import vae_decode

    def run():
        z = z0
        for _ in range(reps):
            img = vae_decode(z, params, config.vae, conv_impl="gemm")
            red = torch.tanh(img.float().mean())
            z = z + (red * 1e-6).to(z.dtype)
        return z

    return run


def vae_case(size: int, reps: int, device):
    """The ``--vae`` chain: tiny-sd's decoder tree alone, zeros in the
    compute dtype, ``reps`` decodes of zero latents at ``size``."""
    from sdtpu_torch.config import get_preset
    from sdtpu_torch.models.vae import init_vae_decoder
    from sdtpu_torch.utils import hostrng
    from sdtpu_torch.utils.weights import zero_tree

    config = get_preset("tiny-sd")
    with hostrng.shapes_only():
        shapes = init_vae_decoder(0, config.vae, dtype=config.compute_dtype)
    lat = size // config.vae.downscale_factor
    z0 = torch.zeros((1, lat, lat, config.vae.latent_channels), dtype=config.compute_dtype,
                     device=device)
    return vae_chain(config, zero_tree(shapes, device), z0, reps)


def unet_case(preset: str, size: int, chain: int, device):
    """The UNet chain: ``ab_unet``'s flash + gemm chain with the hoists."""
    from sdtpu_torch.config import get_preset
    from sdtpu_torch.tools.ab_unet import chain_inputs, make_chain

    config = get_preset(preset)
    return make_chain(config, *chain_inputs(config, size, device), attn="flash", conv="gemm",
                      hoist=True, chain=chain)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vae", action="store_true", help="the VAE decode chain")
    ap.add_argument("args", nargs="*", help="preset size chain, or with --vae: size reps")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from sdtpu_torch.tools import card_line, device_arg, interleaved

    device = device_arg("ab_conv_stats", args.device)
    if device.type == "cuda":
        print(card_line(), flush=True)
    pos = args.args
    if args.vae:
        n = int(pos[1]) if len(pos) > 1 else 20
        fn, unit = vae_case(int(pos[0]) if pos else 512, n, device), "call"
    else:
        n = int(pos[2]) if len(pos) > 2 else 25
        fn = unet_case(pos[0] if pos else "tiny-sd", int(pos[1]) if len(pos) > 1 else 512, n,
                       device)
        unit = "step"
    with torch.inference_mode():
        meds = interleaved([(NAMES[0], with_chaining(fn, False)),
                            (NAMES[1], with_chaining(fn, True))], device, n, unit, REPEATS)
    off, on = meds[NAMES[0]], meds[NAMES[1]]
    print(f"conv-stats chain: {off / on:5.3f}x vs recompute "
          f"({(off - on) / n * 1000:+.3f} ms/{unit})", flush=True)
    return meds


if __name__ == "__main__":
    main()
