"""The least time of the self-attentions the traced whole requests compute
(the UNet transformer blocks' and the VAE mid block's;
``work.attention_least_s``) over the device time of every kernel that
computes them, launched inside those requests: the ``flash_*``
``__global__`` functions of ``csrc/flash_attention.cu`` and the library's
attention kernels."""

import re

from sdbench import spec

KERNELS = re.compile(r"::flash_(?:reg|wide|merge)_kernel\b|fmha|flash_fwd|attention_kernel"
                     r"|efficient_attention")


def read(ctx):
    v, work = ctx.view, ctx.work
    if v is None or not v.whole:
        return None
    cfg, rows = ctx.cfg, ctx.mix.get("batch", 1)
    vae, unet = cfg["vae"], cfg["unet"]
    lat = cfg["image_size"] // 2 ** (len(vae["block_out_channels"]) - 1)
    atts = (work.unet_attentions(unet, lat, spec.unet_rows(cfg, rows)) * len(v.steps)
            + work.vae_attentions(vae, lat, rows) * (len(v.decodes) + len(v.encodes)))
    device = v.device_in(v.whole, KERNELS)
    if device <= 0 or not atts:
        return None
    return 100.0 * work.attention_least_s(atts, work.DTYPE_BYTES[cfg["dtype"]]) / device
