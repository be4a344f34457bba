"""AutoencoderKL's encoder and decoder (diffusers) in plain float32:
resnets without a time branch (eps 1e-6), the single-head mid attention,
the encoder's asymmetric-pad stride-2 downsamples, the decoder's nearest-2x
upsamples, the 1x1 quant and post-quant convolutions."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sdbench.reference.nn import Ops, attention, group_norm, silu
from sdbench.reference.unet import resnet


def _mid(ops: Ops, x, p, g: int):
    x = resnet(ops, x, None, p["resnets"][0], g, 1e-6, has_time=False)
    b, h, w, c = x.shape
    a = p["attention"]
    t = group_norm(x, a["norm"], g, 1e-6).reshape(b, h * w, c)
    o = attention(ops, ops.linear(t, a["attn"]["q"]), ops.linear(t, a["attn"]["k"]),
                  ops.linear(t, a["attn"]["v"]), 1)
    x = x + ops.linear(o, a["attn"]["out"]).reshape(b, h, w, c)
    return resnet(ops, x, None, p["resnets"][1], g, 1e-6, has_time=False)


def decode(ops: Ops, lat, p, cfg: dict):
    """(B, h, w, latent) scaled latents -> (B, 8h, 8w, 3) image in about [-1, 1]."""
    g = cfg["norm_num_groups"]
    x = ops.conv(lat.float() / cfg["scaling_factor"], p["post_quant_conv"], padding=0)
    x = _mid(ops, ops.conv(x, p["conv_in"]), p["mid_block"], g)
    for blk in p["up_blocks"]:
        for r in blk["resnets"]:
            x = resnet(ops, x, None, r, g, 1e-6, has_time=False)
        if "upsample" in blk:
            x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
            x = ops.conv(x.permute(0, 2, 3, 1), blk["upsample"])
    return ops.conv(silu(group_norm(x, p["norm_out"], g, 1e-6)), p["conv_out"])


def encode(ops: Ops, image, noise, p, cfg: dict):
    """(B, H, W, 3) image in [-1, 1] and (B, H/8, W/8, latent) posterior
    noise -> scaled latents mean + noise * std."""
    g = cfg["norm_num_groups"]
    x = ops.conv(image.float(), p["conv_in"])
    for blk in p["down_blocks"]:
        for r in blk["resnets"]:
            x = resnet(ops, x, None, r, g, 1e-6, has_time=False)
        if "downsample" in blk:
            x = ops.conv(x, blk["downsample"], stride=2, padding=((0, 1), (0, 1)))
    x = _mid(ops, x, p["mid_block"], g)
    x = ops.conv(silu(group_norm(x, p["norm_out"], g, 1e-6)), p["conv_out"])
    moments = ops.conv(x, p["quant_conv"], padding=0)
    mean, logvar = moments.chunk(2, dim=-1)
    std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
    return (mean + noise.float() * std) * cfg["scaling_factor"]
