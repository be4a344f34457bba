"""ControlNet: a trained copy of the UNet's encoder half that reads the
latents, the timestep, the text context and a control image, and emits one
residual per saved skip and one for the mid block, which the UNet adds
(``unet_forward(control=...)``).

Counterpart of ``sdtpu/models/controlnet.py``, with its tree (the diffusers
``ControlNetModel`` layout): ``conv_in``, ``time_embedding`` (SDXL's
``add_embedding`` too), ``down_blocks``, ``mid_block``; ``cond_embedding``,
the conv ladder that maps the (B, H, W, 3) control image in [0, 1] down 8x
to the latent grid; ``zero_convs`` / ``zero_conv_mid``, the 1x1 convs,
zero at init so that a fresh ControlNet is an exact no-op.

The encoder copy runs the UNet's blocks, so on a card its resnets take the
slab kernels and its self-attention kernel C, as the UNet's do; the zero
convs are token matmuls (``ops/conv.py:conv1x1_tokens``), the cond
embedding plain convolutions, computed once per request.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sdtpu_torch.config import UNetConfig
from sdtpu_torch.models.unet import (
    _heads_for_level,
    attention_block,
    compute_time_embedding,
    downsample,
    init_unet,
    resnet_block,
)
from sdtpu_torch.ops import conv1x1_tokens, conv2d, init_conv2d, silu
from sdtpu_torch.utils import hostrng

# diffusers' ControlNetConditioningEmbedding channel ladder
COND_EMBED_CHANNELS: Tuple[int, ...] = (16, 32, 96, 256)


def controlnet_cond_embed(cond_image: torch.Tensor, params: dict) -> torch.Tensor:
    """Control image (B, H, W, 3) in [0, 1] -> (B, H/8, W/8, ch0): a 3x3 conv
    in, the ladder's pairs (stride 1, then stride 2), each conv followed by
    SiLU, and the (zero at init) 3x3 conv out."""
    x = silu(conv2d(cond_image, params["conv_in"]["kernel"], params["conv_in"]["bias"],
                    padding=1))
    for i, blk in enumerate(params["blocks"]):
        x = silu(conv2d(x, blk["kernel"], blk["bias"], padding=1, stride=2 if i % 2 else 1))
    return conv2d(x, params["conv_out"]["kernel"], params["conv_out"]["bias"], padding=1)


def controlnet_forward(
    latents: torch.Tensor,
    timesteps: torch.Tensor,
    context: torch.Tensor,
    cond_embedding: torch.Tensor,
    params: dict,
    config: UNetConfig,
    *,
    conditioning_scale=1.0,
    added_cond: Optional[dict] = None,
    timestep_cond: Optional[torch.Tensor] = None,
    attention_impl: str = "flash",
    conv_impl: str = "gemm",
    cross_kv: Optional[dict] = None,
    time_cache: Optional[dict] = None,
) -> dict:
    """The encoder copy: ``{"down": [one per saved skip], "mid": tensor or
    None}`` for ``unet_forward(control=...)``.  ``cond_embedding`` is
    :func:`controlnet_cond_embed`'s output at the latents' batch;
    ``conditioning_scale`` (cast to the compute dtype) multiplies every
    residual.  ``cross_kv`` / ``time_cache``: this tree's
    ``precompute_cross_kv`` / one step of its
    ``precompute_time_projections``."""
    if time_cache is not None:
        temb = time_cache["temb"]
    else:
        temb = compute_time_embedding(
            timesteps, params, config, batch=latents.shape[0], dtype=latents.dtype,
            timestep_cond=timestep_cond, added_cond=added_cond)
    tp = time_cache
    ng = config.norm_num_groups
    context = context.to(latents.dtype)
    if tuple(cond_embedding.shape[1:3]) != tuple(latents.shape[1:3]):
        raise ValueError(
            f"cond_embedding grid {tuple(cond_embedding.shape[1:3])} != latent grid "
            f"{tuple(latents.shape[1:3])} — the cond-embedding ladder has "
            "len(cond_channels)-1 stride-2 convs; it must match the VAE "
            "downscale factor (SD: 8x -> 4-channel ladder)")
    x = conv2d(latents, params["conv_in"]["kernel"], params["conv_in"]["bias"], padding=1)
    x = x + cond_embedding.to(x.dtype)
    # a 0-dim CPU tensor: a scalar to the op on any device
    scale = torch.tensor(float(conditioning_scale), dtype=torch.float32).to(x.dtype)
    zero_convs = iter(params["zero_convs"])

    def residual(a):
        return conv1x1_tokens(a, next(zero_convs)) * scale

    down = [residual(x)]
    for level, block in enumerate(params["down_blocks"]):
        heads = _heads_for_level(config, config.block_out_channels[level])
        has_attn = config.attention_levels[level]
        for i, res in enumerate(block["resnets"]):
            x = resnet_block(x, temb, res, num_groups=ng,
                             t_pre=None if tp is None else tp["down"][level][i],
                             emit_stats=has_attn, conv_impl=conv_impl)
            if has_attn:
                x, rstats = x
                x = attention_block(
                    x, context, block["attentions"][i], num_heads=heads, num_groups=ng,
                    implementation=attention_impl,
                    cross_kv=None if cross_kv is None else cross_kv["down"][level][i],
                    stats=rstats)
            down.append(residual(x))
        if "downsample" in block:
            x = downsample(x, block["downsample"])
            down.append(residual(x))
    mid_res = None
    if config.mid_block:
        mid = params["mid_block"]
        heads = _heads_for_level(config, config.block_out_channels[-1])
        x, rstats = resnet_block(x, temb, mid["resnets"][0], num_groups=ng,
                                 t_pre=None if tp is None else tp["mid"][0],
                                 emit_stats=True, conv_impl=conv_impl)
        x = attention_block(
            x, context, mid["attentions"][0], num_heads=heads, num_groups=ng,
            implementation=attention_impl,
            cross_kv=None if cross_kv is None else cross_kv["mid"][0], stats=rstats)
        x = resnet_block(x, temb, mid["resnets"][1], num_groups=ng,
                         t_pre=None if tp is None else tp["mid"][1], conv_impl=conv_impl)
        mid_res = conv1x1_tokens(x, params["zero_conv_mid"]) * scale
    return {"down": down, "mid": mid_res}


def _zeros(shape, dtype) -> torch.Tensor:
    return hostrng.leaf(np.zeros(shape), dtype)


def _zero_conv1x1(ch: int, *, dtype) -> dict:
    return {"kernel": _zeros((1, 1, ch, ch), dtype), "bias": _zeros((ch,), dtype)}


def init_controlnet(
    key,
    config: UNetConfig,
    *,
    dtype=torch.float32,
    cond_channels: Tuple[int, ...] = COND_EMBED_CHANNELS,
    conditioning_channels: int = 3,
) -> dict:
    """Seeded random ControlNet with the JAX package's tree, leaves and key
    order: the key (an int seed or a ``HostKey``) splits into the UNet's
    and the cond embedding's; the encoder copy is the encoder half of a
    whole base UNet drawn from the first (so a seed gives the JAX
    package's leaves bitwise); the zero convs and the cond embedding's
    ``conv_out`` are zeros."""
    k_unet, k_cond = hostrng.split(hostrng.ensure_key(key))
    base = init_unet(k_unet, config, dtype=dtype)
    params = {"conv_in": base["conv_in"], "time_embedding": base["time_embedding"],
              "down_blocks": base["down_blocks"]}
    if "add_embedding" in base:
        params["add_embedding"] = base["add_embedding"]
    if config.mid_block:
        params["mid_block"] = base["mid_block"]
        params["zero_conv_mid"] = _zero_conv1x1(config.block_out_channels[-1], dtype=dtype)
    # one zero conv per saved skip: conv_in, every resnet (+ attention) unit
    # and every downsample, as unet_encode saves them
    zero_convs = [_zero_conv1x1(config.block_out_channels[0], dtype=dtype)]
    for level, ch in enumerate(config.block_out_channels):
        zero_convs.extend(_zero_conv1x1(ch, dtype=dtype) for _ in range(config.layers_per_block))
        if level < config.num_levels - 1:
            zero_convs.append(_zero_conv1x1(ch, dtype=dtype))
    params["zero_convs"] = zero_convs
    params["cond_embedding"] = init_cond_embedding(
        k_cond, config.block_out_channels[0], dtype=dtype, cond_channels=cond_channels,
        conditioning_channels=conditioning_channels)
    return params


def init_cond_embedding(
    key,
    out_channels: int,
    *,
    dtype=torch.float32,
    cond_channels: Tuple[int, ...] = COND_EMBED_CHANNELS,
    conditioning_channels: int = 3,
) -> dict:
    """The cond embedding of :func:`init_controlnet` from its key (the
    second half of the ControlNet's): its convs drawn as the JAX package
    draws them, ``conv_out`` zeros."""
    keys = iter(hostrng.split(hostrng.ensure_key(key), 2 * len(cond_channels)))
    blocks = []
    for i in range(len(cond_channels) - 1):
        blocks.append(init_conv2d(next(keys), cond_channels[i], cond_channels[i], 3,
                                  dtype=dtype))
        blocks.append(init_conv2d(next(keys), cond_channels[i], cond_channels[i + 1], 3,
                                  dtype=dtype))
    return {
        "conv_in": init_conv2d(next(keys), conditioning_channels, cond_channels[0], 3,
                               dtype=dtype),
        "blocks": blocks,
        "conv_out": {"kernel": _zeros((3, 3, cond_channels[-1], out_channels), dtype),
                     "bias": _zeros((out_channels,), dtype)},
    }
