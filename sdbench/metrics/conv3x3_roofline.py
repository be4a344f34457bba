"""The least time of the 3x3 convolutions the traced whole requests
compute (every one the model defines: UNet and VAE resnets, up-sample
convs, conv_in/out, downsamples; ``work.conv_least_s``) over the device
time of every kernel that computes them, launched inside those requests.
Those kernels: the ``__global__`` functions of ``csrc/conv3x3_slab.cu``
(its GEMM, pre-pass and split-K reduction) and the library's convolutions."""

import re

from sdbench import spec

KERNELS = re.compile(r"::conv3x3_kernel\b|::prologue_kernel\b|::splitk_reduce_kernel<"
                     r"|fprop|convolve|cudnn")


def read(ctx):
    v, work = ctx.view, ctx.work
    if v is None or not v.whole:
        return None
    cfg, rows = ctx.cfg, ctx.mix.get("batch", 1)
    vae, unet = cfg["vae"], cfg["unet"]
    lat = cfg["image_size"] // 2 ** (len(vae["block_out_channels"]) - 1)
    convs = (work.unet_convs(unet, lat, spec.unet_rows(cfg, rows)) * len(v.steps)
             + work.vae_decode_convs(vae, lat, rows) * len(v.decodes)
             + work.vae_encode_convs(vae, cfg["image_size"], rows) * len(v.encodes))
    device = v.device_in(v.whole, KERNELS)
    if device <= 0 or not convs:
        return None
    return 100.0 * work.conv_least_s(convs, work.DTYPE_BYTES[cfg["dtype"]]) / device
