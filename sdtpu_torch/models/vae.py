"""VAE (AutoencoderKL): the encoder and the decoder.

Counterpart of ``sdtpu/models/vae.py``.  The encoder: conv_in -> down
blocks (resnets, then an asymmetric-pad ``((0, 1), (0, 1))`` stride-2
conv) -> mid (resnet, single-head attention, resnet) -> GN/SiLU/conv_out ->
1x1 quant conv, giving the posterior's mean and logvar; ``vae_encode``
samples (or takes the mode) and scales.  The decoder: /scaling -> 1x1
post-quant conv -> conv_in -> mid -> up blocks (resnets + fused nearest-2x
upsample conv) -> GN/SiLU/conv_out.  Resnets and upsamples that pass the
JAX package's routing rule take the slab-kernel path, and the GroupNorm
statistics chain from each producing kernel's moments, as in the JAX
package's TPU program (``vae.py:174-183, 245-264``): through a down block's
resnets, and through the decoder's up blocks; the others take the op path.
"""

from __future__ import annotations

import torch

import sdtpu_torch.kernels.conv2d as conv_kernels
from sdtpu_torch.config import VAEConfig
from sdtpu_torch.kernels.conv2d import gn_silu_conv3x3_slab
from sdtpu_torch.ops import (
    attention,
    conv1x1_tokens,
    conv2d,
    group_norm,
    init_attention,
    init_conv2d,
    init_norm,
    nearest_up_conv2d,
    silu,
)
from sdtpu_torch.utils import hostrng
from sdtpu_torch.utils.quant import float_conv_kernel, resnet_conv_args, resnet_takes_slab


def _shortcut(x: torch.Tensor, params: dict) -> torch.Tensor:
    if "conv_shortcut" not in params:
        return x
    return conv1x1_tokens(x, params["conv_shortcut"])


def vae_resnet(
    x: torch.Tensor, params: dict, *, num_groups: int = 32, stats=None,
    emit_stats: bool = False, conv_impl: str = "gemm",
):
    """Resnet without the time branch (eps 1e-6).  ``stats``: producer
    moments of ``x`` for norm1 (ignored if the channel count differs);
    ``emit_stats=True`` returns ``(out, moments)`` of the post-residual
    output (None off the slab path, and with ``kernels/conv2d.py:
    CONV_STATS_CHAIN`` off, which also leaves ``stats`` unused there).
    Routed as the UNet resnet; the op path is ``sdtpu/models/vae.py:
    125-135``, and with ``conv_impl="xla"`` every resnet takes it with
    ``F.conv2d``."""
    if stats is not None and stats.shape[-1] != x.shape[-1]:
        stats = None
    if conv_impl == "xla":
        (k1, b1, q1), (k2, b2, q2) = [(float_conv_kernel(params[c], x.dtype),
                                       params[c]["bias"], {}) for c in ("conv1", "conv2")]
    else:
        (k1, b1, q1), (k2, b2, q2) = resnet_conv_args(x.shape, params, num_groups, x.dtype)
    if conv_impl == "xla" or not resnet_takes_slab(x.shape, params, num_groups):
        h = silu(group_norm(x, params["norm1"], num_groups=num_groups, eps=1e-6, stats=stats))
        h = conv2d(h, k1, b1, padding=1, impl=conv_impl)
        h = silu(group_norm(h, params["norm2"], num_groups=num_groups, eps=1e-6))
        h = conv2d(h, k2, b2, padding=1, impl=conv_impl)
        out = _shortcut(x, params) + h
        return (out, None) if emit_stats else out
    chain = conv_kernels.CONV_STATS_CHAIN  # off: sdtpu/models/vae.py:102-122's choices
    h = gn_silu_conv3x3_slab(
        x, params["norm1"], k1, b1, num_groups=num_groups, eps=1e-6,
        stats=stats if chain else None, emit_stats=chain, **q1,
    )
    h, hstats = h if chain else (h, None)
    out = gn_silu_conv3x3_slab(
        h, params["norm2"], k2, b2, num_groups=num_groups, eps=1e-6,
        residual=_shortcut(x, params), stats=hstats, emit_stats=chain and emit_stats, **q2,
    )
    return (out, None) if emit_stats and not chain else out


def vae_attention(
    x: torch.Tensor, params: dict, *, num_groups: int = 32,
    implementation: str = "flash", stats=None,
) -> torch.Tensor:
    """GN -> single-head self-attention over the spatial tokens -> residual."""
    b, h, w, c = x.shape
    out = group_norm(x, params["norm"], num_groups=num_groups, eps=1e-6, stats=stats)
    out = attention(out.reshape(b, h * w, c), params["attn"], num_heads=1,
                    implementation=implementation, residual=x.reshape(b, h * w, c))
    return out.reshape(b, h, w, c)


def _mid(x: torch.Tensor, params: dict, *, num_groups: int,
         implementation: str = "flash", conv_impl: str = "gemm") -> torch.Tensor:
    x, st = vae_resnet(x, params["resnets"][0], num_groups=num_groups, emit_stats=True,
                       conv_impl=conv_impl)
    x = vae_attention(x, params["attention"], num_groups=num_groups,
                      implementation=implementation, stats=st)
    return vae_resnet(x, params["resnets"][1], num_groups=num_groups, conv_impl=conv_impl)


def vae_encoder(
    x: torch.Tensor, params: dict, config: VAEConfig, *,
    attention_impl: str = "flash", conv_impl: str = "gemm",
) -> torch.Tensor:
    """(B, H, W, 3) image in [-1, 1] -> (B, H/8, W/8, 2 * latent) moments
    (mean, then logvar)."""
    ng = config.norm_num_groups
    h = conv2d(x, params["conv_in"]["kernel"], params["conv_in"]["bias"], padding=1)
    for block in params["down_blocks"]:
        st = None  # the plain downsample conv breaks the chain
        for res in block["resnets"]:
            h, st = vae_resnet(h, res, num_groups=ng, stats=st, emit_stats=True,
                               conv_impl=conv_impl)
        if "downsample" in block:
            h = conv2d(h, block["downsample"]["kernel"], block["downsample"]["bias"],
                       stride=2, padding=((0, 1), (0, 1)))
    h = _mid(h, params["mid_block"], num_groups=ng, implementation=attention_impl,
             conv_impl=conv_impl)
    h = silu(group_norm(h, params["norm_out"], num_groups=ng, eps=1e-6))
    h = conv2d(h, params["conv_out"]["kernel"], params["conv_out"]["bias"], padding=1)
    return conv2d(h, params["quant_conv"]["kernel"], params["quant_conv"]["bias"])


def vae_encode(
    image: torch.Tensor, noise, params: dict, config: VAEConfig, *,
    attention_impl: str = "flash", conv_impl: str = "gemm", apply_scaling: bool = True,
) -> torch.Tensor:
    """Image -> latents: the moments, logvar clamped to [-30, 20] in
    float32, mean + noise * std, times ``scaling_factor``.  ``noise=None``
    takes the posterior's mode (the mean, no draw); ``apply_scaling=False``
    skips the scaling (InstructPix2Pix's image-conditioning latents)."""
    moments = vae_encoder(image, params, config, attention_impl=attention_impl,
                          conv_impl=conv_impl)
    mean, logvar = torch.chunk(moments, 2, dim=-1)
    if noise is None:
        latents = mean
    else:
        logvar = torch.clamp(logvar.float(), -30.0, 20.0)
        std = torch.exp(0.5 * logvar).to(mean.dtype)
        latents = mean + noise.to(mean.dtype) * std
    return latents * config.scaling_factor if apply_scaling else latents


def vae_decode(
    latents: torch.Tensor, params: dict, config: VAEConfig, *,
    attention_impl: str = "flash", conv_impl: str = "gemm",
) -> torch.Tensor:
    """(B, H/8, W/8, latent) -> (B, H, W, 3) image in [-1, 1].
    ``attention_impl``: "flash", "ring" or "xla"; ``conv_impl``: "gemm"
    (the slab kernels) or "xla" (``F.conv2d``)."""
    ng = config.norm_num_groups
    h = latents / config.scaling_factor
    h = conv2d(h, params["post_quant_conv"]["kernel"], params["post_quant_conv"]["bias"])
    h = conv2d(h, params["conv_in"]["kernel"], params["conv_in"]["bias"], padding=1)
    h = _mid(h, params["mid_block"], num_groups=ng, implementation=attention_impl,
             conv_impl=conv_impl)
    st = None
    for block in params["up_blocks"]:
        for res in block["resnets"]:
            h, st = vae_resnet(h, res, num_groups=ng, stats=st, emit_stats=True,
                               conv_impl=conv_impl)
        if "upsample" in block:
            h, st = nearest_up_conv2d(
                h, block["upsample"]["kernel"].to(h.dtype), block["upsample"]["bias"],
                emit_stats=True, impl=conv_impl)
    h = silu(group_norm(h, params["norm_out"], num_groups=ng, eps=1e-6, stats=st))
    return conv2d(h, params["conv_out"]["kernel"], params["conv_out"]["bias"], padding=1)


def _init_vae_resnet(key, in_ch, out_ch, *, dtype):
    k1, k2, k3 = hostrng.split(key, 3)
    params = {
        "norm1": init_norm(in_ch, dtype=dtype),
        "conv1": init_conv2d(k1, in_ch, out_ch, 3, dtype=dtype),
        "norm2": init_norm(out_ch, dtype=dtype),
        "conv2": init_conv2d(k2, out_ch, out_ch, 3, dtype=dtype),
    }
    if in_ch != out_ch:
        params["conv_shortcut"] = init_conv2d(k3, in_ch, out_ch, 1, dtype=dtype)
    return params


def _init_mid(key, ch, *, dtype):
    k1, k2, k3 = hostrng.split(key, 3)
    return {
        "resnets": [_init_vae_resnet(k1, ch, ch, dtype=dtype),
                    _init_vae_resnet(k2, ch, ch, dtype=dtype)],
        "attention": {
            "norm": init_norm(ch, dtype=dtype),
            "attn": init_attention(k3, ch, qkv_bias=True, dtype=dtype),
        },
    }


def init_vae_encoder(key, config: VAEConfig, *, dtype=torch.float32) -> dict:
    """Random encoder parameters with the JAX package's tree and bounds, on
    the CPU, drawn on the host from ``key`` (an int seed or a ``HostKey``)
    in the JAX package's key order: 64 children taken in turn."""
    keys = iter(hostrng.split(hostrng.ensure_key(key), 64))
    nk = lambda: next(keys)  # noqa: E731
    chs = config.block_out_channels
    params = {"conv_in": init_conv2d(nk(), config.in_channels, chs[0], 3, dtype=dtype)}
    down_blocks, in_ch = [], chs[0]
    for level, ch in enumerate(chs):
        block = {"resnets": [
            _init_vae_resnet(nk(), in_ch if i == 0 else ch, ch, dtype=dtype)
            for i in range(config.layers_per_block)
        ]}
        in_ch = ch
        if level < len(chs) - 1:
            block["downsample"] = init_conv2d(nk(), ch, ch, 3, dtype=dtype)
        down_blocks.append(block)
    params["down_blocks"] = down_blocks
    params["mid_block"] = _init_mid(nk(), chs[-1], dtype=dtype)
    params["norm_out"] = init_norm(chs[-1], dtype=dtype)
    z2 = 2 * config.latent_channels
    params["conv_out"] = init_conv2d(nk(), chs[-1], z2, 3, dtype=dtype)
    params["quant_conv"] = init_conv2d(nk(), z2, z2, 1, dtype=dtype)
    return params


def init_vae_decoder(key, config: VAEConfig, *, dtype=torch.float32) -> dict:
    """Random decoder parameters with the JAX package's tree and bounds, on
    the CPU, drawn on the host from ``key`` (an int seed or a ``HostKey``)
    in the JAX package's key order: 64 children taken in turn."""
    keys = iter(hostrng.split(hostrng.ensure_key(key), 64))
    nk = lambda: next(keys)  # noqa: E731
    chs = config.block_out_channels
    params = {
        "post_quant_conv": init_conv2d(nk(), config.latent_channels,
                                       config.latent_channels, 1, dtype=dtype),
        "conv_in": init_conv2d(nk(), config.latent_channels, chs[-1], 3, dtype=dtype),
        "mid_block": _init_mid(nk(), chs[-1], dtype=dtype),
    }
    up_blocks, in_ch = [], chs[-1]
    for rev, ch in enumerate(reversed(chs)):
        block = {"resnets": [
            _init_vae_resnet(nk(), in_ch if i == 0 else ch, ch, dtype=dtype)
            for i in range(config.layers_per_block + 1)
        ]}
        in_ch = ch
        if rev < len(chs) - 1:
            block["upsample"] = init_conv2d(nk(), ch, ch, 3, dtype=dtype)
        up_blocks.append(block)
    params["up_blocks"] = up_blocks
    params["norm_out"] = init_norm(chs[0], dtype=dtype)
    params["conv_out"] = init_conv2d(nk(), chs[0], config.out_channels, 3, dtype=dtype)
    return params
