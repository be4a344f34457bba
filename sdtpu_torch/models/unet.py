"""Conditional UNet denoiser.

Counterpart of ``sdtpu/models/unet.py`` for the layouts the txt2img slice
runs: time MLP, resnets, Transformer2D attention blocks, stride-2
downsamples, fused nearest-2x upsamples, an optional mid block, and the
encoder/decoder wiring with channel-concat skips popped LIFO.

A resnet that passes the JAX package's routing rule takes the slab-kernel
path of its TPU program (``unet.py:255-285``), with an int8 kernel where it
is quantized: conv1 is GN+SiLU+conv with its output moments, conv2 is
GN(+temb)+SiLU+conv with the shortcut as its residual and GN statistics
from conv1's moments; any other resnet takes GroupNorm -> SiLU -> conv2d.
A slab resnet followed by an attention block hands that block its output
moments for the block's GroupNorm.  The time MLP takes the LCM guidance
embedding (``timestep_cond`` through the bias-free ``cond_proj``, before
the MLP) and the SDXL add-embedding (``added_cond``: the pooled text
embedding and the size/crop/aesthetic time ids, through ``add_embedding``,
after it).

The denoise step's hooks: ControlNet residuals added to the saved skips
and the mid output (``control``), Perturbed-Attention Guidance's identity
self-attention on the last ``pag_tail`` rows at the PAG site, and FreeU's
backbone scale and skip low-pass at the two lowest-resolution up blocks
(``freeu``, :func:`apply_freeu`).  ``unet_encode`` / ``unet_decode`` split
the forward for the pipeline's encoder cache.
"""

from __future__ import annotations

from typing import Optional

import torch

import sdtpu_torch.kernels.conv2d as conv_kernels
from sdtpu_torch.config import UNetConfig
from sdtpu_torch.kernels.conv2d import gn_silu_conv3x3_slab
from sdtpu_torch.ops import (
    conv1x1_tokens,
    conv2d,
    group_norm,
    init_conv2d,
    init_linear,
    init_norm,
    init_transformer_block,
    linear,
    nearest_up_conv2d,
    precompute_transformer_cross_kv,
    silu,
    timestep_embedding,
    transformer_block,
)
from sdtpu_torch.utils import hostrng
from sdtpu_torch.utils.quant import float_conv_kernel, resnet_conv_args, resnet_takes_slab


def _time_mlp(temb: torch.Tensor, params: dict, config: UNetConfig, *, batch: int, dtype,
              timestep_cond: Optional[torch.Tensor], added_cond: Optional[dict]) -> torch.Tensor:
    """The sinusoidal embedding (..., batch, ch0) -> [+ LCM ``cond_proj``
    of ``timestep_cond``] -> Linear -> SiLU -> Linear -> [+ the SDXL
    add-embedding] -> the SiLU every resnet applies to it, hoisted."""
    te = params["time_embedding"]
    # cond_proj is per tree: a ControlNet paired with an LCM UNet has none
    if config.time_cond_proj_dim is not None and "cond_proj" in te:
        if timestep_cond is None:
            raise ValueError("LCM config requires timestep_cond")
        temb = temb + linear(timestep_cond.to(temb.dtype), te["cond_proj"])
    temb = linear(temb, te["linear_1"])
    temb = silu(temb)
    temb = linear(temb, te["linear_2"])
    if config.addition_embed_dim is not None:
        if added_cond is None:
            raise ValueError("SDXL config requires added_cond")
        time_ids = added_cond["time_ids"].reshape(-1)
        tid_emb = timestep_embedding(
            time_ids, config.addition_time_embed_dim,
            flip_sin_to_cos=config.flip_sin_to_cos, freq_shift=config.freq_shift,
            dtype=dtype,
        ).reshape(batch, -1)
        add_emb = torch.cat([added_cond["text_embeds"].to(dtype), tid_emb], dim=-1)
        aemb = linear(add_emb, params["add_embedding"]["linear_1"])
        aemb = silu(aemb)
        temb = temb + linear(aemb, params["add_embedding"]["linear_2"])
    return silu(temb)


def compute_time_embedding(
    timesteps: torch.Tensor, params: dict, config: UNetConfig, *, batch: int, dtype,
    timestep_cond: Optional[torch.Tensor] = None, added_cond: Optional[dict] = None,
) -> torch.Tensor:
    """One step's time MLP (:func:`_time_mlp`) for (batch,) or scalar
    ``timesteps``."""
    if timesteps.ndim == 0:
        timesteps = timesteps.expand(batch)
    temb = timestep_embedding(
        timesteps, config.block_out_channels[0],
        flip_sin_to_cos=config.flip_sin_to_cos, freq_shift=config.freq_shift,
        dtype=dtype,
    )
    return _time_mlp(temb, params, config, batch=batch, dtype=dtype,
                     timestep_cond=timestep_cond, added_cond=added_cond)


def precompute_time_projections(
    timesteps: torch.Tensor, params: dict, config: UNetConfig, *, batch: int,
    timestep_cond: Optional[torch.Tensor] = None, added_cond: Optional[dict] = None,
    dtype=torch.bfloat16,
) -> dict:
    """Every time-dependent projection for every step of a known timestep
    sequence (T,), in one batched sweep; the LCM guidance embedding
    (``timestep_cond`` (batch, time_cond_proj_dim)) and the SDXL
    add-embedding (``added_cond``: ``text_embeds`` (batch, P), ``time_ids``
    (batch, 5 or 6)) are the same at every step and fold in here:

      {"temb": (T, batch, time_embed_dim),
       "down": [[(T, batch, out_ch) per resnet] per level],
       "mid": [(T, batch, ch)] * 2, "up": [[...] per level]}

    Index step ``i`` with :func:`time_cache_step`."""
    n = timesteps.shape[0]
    temb = timestep_embedding(
        timesteps.float(), config.block_out_channels[0],
        flip_sin_to_cos=config.flip_sin_to_cos, freq_shift=config.freq_shift,
        dtype=dtype,
    )
    temb = temb[:, None, :].expand(n, batch, temb.shape[-1])
    temb = _time_mlp(temb, params, config, batch=batch, dtype=dtype,
                     timestep_cond=timestep_cond, added_cond=added_cond)

    def proj(r):
        return linear(temb, r["time_emb_proj"])

    cache = {"temb": temb, "down": [], "mid": [], "up": []}
    for block in params["down_blocks"]:
        cache["down"].append([proj(r) for r in block["resnets"]])
    if config.mid_block:
        cache["mid"] = [proj(r) for r in params["mid_block"]["resnets"]]
    # encoder-only trees (ControlNet) have no up blocks
    for block in params.get("up_blocks", []):
        cache["up"].append([proj(r) for r in block["resnets"]])
    return cache


def time_cache_step(cache, i: int):
    """Step ``i``'s slice of a :func:`precompute_time_projections` cache."""
    if isinstance(cache, dict):
        return {k: time_cache_step(v, i) for k, v in cache.items()}
    if isinstance(cache, list):
        return [time_cache_step(v, i) for v in cache]
    return cache[i]


def precompute_cross_kv(context: torch.Tensor, params: dict, config: UNetConfig) -> dict:
    """Cross-attention K/V for every transformer block, mirroring
    ``unet_forward``'s traversal; computed once per generation."""

    def block_kv(attn_params):
        return [precompute_transformer_cross_kv(context, b) for b in attn_params["blocks"]]

    cache = {"down": [], "mid": [], "up": []}
    for block in params["down_blocks"]:
        cache["down"].append([block_kv(a) for a in block.get("attentions", [])])
    if config.mid_block:
        cache["mid"] = [block_kv(a) for a in params["mid_block"]["attentions"]]
    for block in params.get("up_blocks", []):
        cache["up"].append([block_kv(a) for a in block.get("attentions", [])])
    return cache


def _shortcut(x: torch.Tensor, params: dict) -> torch.Tensor:
    """The resnet's 1x1 skip projection, as a token matmul."""
    if "conv_shortcut" not in params:
        return x
    return conv1x1_tokens(x, params["conv_shortcut"])


def resnet_block(
    x: torch.Tensor,
    temb: torch.Tensor,
    params: dict,
    *,
    num_groups: int = 32,
    t_pre: Optional[torch.Tensor] = None,
    emit_stats: bool = False,
    conv_impl: str = "gemm",
):
    """Resnet: GN -> SiLU -> conv1; + time projection; GN -> SiLU -> conv2;
    + shortcut.  ``temb`` is already SiLU'd; ``t_pre`` the precomputed
    (B, C_out) time projection.  ``emit_stats=True`` returns ``(out,
    moments)``, the per-channel output moments for the next GroupNorm
    (None off the slab path, and with ``kernels/conv2d.py:CONV_STATS_CHAIN``
    off, as in the JAX package).  With ``conv_impl="gemm"`` routed as the
    JAX package's kernel program (``utils/quant.py:
    resnet_takes_slab``): the slab kernels, int8 where quantized, or else
    the op path of ``sdtpu/models/unet.py:287-295`` with the float or
    dequantized kernels.  ``conv_impl="xla"`` is that op path everywhere,
    its convs ``F.conv2d``."""
    t = linear(temb, params["time_emb_proj"]) if t_pre is None else t_pre
    if conv_impl == "xla":
        (k1, b1, q1), (k2, b2, q2) = [(float_conv_kernel(params[c], x.dtype),
                                       params[c]["bias"], {}) for c in ("conv1", "conv2")]
    else:
        (k1, b1, q1), (k2, b2, q2) = resnet_conv_args(x.shape, params, num_groups, x.dtype)
    if conv_impl == "xla" or not resnet_takes_slab(x.shape, params, num_groups):
        h = silu(group_norm(x, params["norm1"], num_groups=num_groups))
        h = conv2d(h, k1, b1, padding=1, impl=conv_impl)
        h = h + t.to(h.dtype)[:, None, None, :]
        h = silu(group_norm(h, params["norm2"], num_groups=num_groups))
        h = conv2d(h, k2, b2, padding=1, impl=conv_impl)
        out = _shortcut(x, params) + h
        return (out, None) if emit_stats else out
    chain = conv_kernels.CONV_STATS_CHAIN  # off: sdtpu/models/unet.py:268-283's choices
    h = gn_silu_conv3x3_slab(
        x, params["norm1"], k1, b1, num_groups=num_groups, emit_stats=chain, **q1,
    )
    h, hstats = h if chain else (h, None)
    out = gn_silu_conv3x3_slab(
        h, params["norm2"], k2, b2, num_groups=num_groups, temb=t,
        residual=_shortcut(x, params), stats=hstats, emit_stats=chain and emit_stats, **q2,
    )
    return (out, None) if emit_stats and not chain else out


def attention_block(
    x: torch.Tensor,
    context: torch.Tensor,
    params: dict,
    *,
    num_heads: int,
    num_groups: int = 32,
    implementation: str = "flash",
    cross_kv: Optional[list] = None,
    pag_tail: int = 0,
    stats=None,
) -> torch.Tensor:
    """Transformer2D: GN(eps 1e-6, from the producer's ``stats`` when given)
    -> proj_in -> transformer blocks -> proj_out -> + residual.
    ``pag_tail``: the last rows take identity self-attention
    (:func:`sdtpu_torch.ops.attention.transformer_block`)."""
    b, h, w, c = x.shape
    out = group_norm(x, params["norm"], num_groups=num_groups, eps=1e-6, stats=stats)
    out = linear(out.reshape(b, h * w, c), params["proj_in"])
    for i, block in enumerate(params["blocks"]):
        out = transformer_block(
            out, block, num_heads=num_heads, context=context,
            implementation=implementation,
            cross_kv=None if cross_kv is None else cross_kv[i], pag_tail=pag_tail,
        )
    out = linear(out, params["proj_out"])
    return out.reshape(b, h, w, c) + x


def downsample(x: torch.Tensor, params: dict) -> torch.Tensor:
    """Stride-2 3x3 conv."""
    return conv2d(x, params["kernel"], params["bias"], stride=2, padding=1)


def upsample(x: torch.Tensor, params: dict, conv_impl: str = "gemm") -> torch.Tensor:
    """Nearest 2x + 3x3 conv, fused in the slab kernel's upsample mode where
    the slab shape rule accepts it (``conv_impl="gemm"``)."""
    return nearest_up_conv2d(x, params["kernel"].to(x.dtype), params["bias"], impl=conv_impl)


def fourier_filter(x: torch.Tensor, scale: float, threshold: int = 1) -> torch.Tensor:
    """FreeU's low-frequency rescale of an NHWC map: FFT over H and W in
    float32, fftshift, the ``2 * threshold`` square at the centre (the
    lowest frequencies) times ``scale``, inverse FFT, the real part in
    ``x``'s dtype."""
    h, w = x.shape[1], x.shape[2]
    xf = torch.fft.fftshift(torch.fft.fftn(x.float(), dim=(1, 2)), dim=(1, 2))
    mask = torch.ones((1, h, w, 1), dtype=torch.float32, device=x.device)
    cr, cc = h // 2, w // 2
    mask[:, cr - threshold:cr + threshold, cc - threshold:cc + threshold] = scale
    xf = torch.fft.ifftshift(xf * mask, dim=(1, 2))
    return torch.fft.ifftn(xf, dim=(1, 2)).real.to(x.dtype)


def apply_freeu(rev: int, x: torch.Tensor, skip: torch.Tensor, freeu):
    """FreeU at up block ``rev`` (0 = the lowest resolution): the backbone's
    first half of channels times b, the skip low-passed by s; blocks past
    the first two pass through."""
    if rev > 1:
        return x, skip
    b1, b2, s1, s2 = freeu
    b, s = (b1, s1) if rev == 0 else (b2, s2)
    half = x.shape[-1] // 2
    # b as a 0-dim CPU tensor of x's dtype: a scalar to the op on any device
    x = torch.cat([x[..., :half] * torch.tensor(b, dtype=x.dtype),
                   x[..., half:]], dim=-1)
    return x, fourier_filter(skip, s)


def _heads_for_level(config: UNetConfig, channels: int) -> int:
    """A fixed head count per level, or head_dim 64 when the config holds
    the 0 sentinel (SD 2.x / SDXL)."""
    if config.num_attention_heads > 0:
        return config.num_attention_heads
    return channels // 64


def unet_forward(
    latents: torch.Tensor,
    timesteps: torch.Tensor,
    context: torch.Tensor,
    params: dict,
    config: UNetConfig,
    *,
    added_cond: Optional[dict] = None,
    timestep_cond: Optional[torch.Tensor] = None,
    attention_impl: str = "flash",
    conv_impl: str = "gemm",
    cross_kv: Optional[dict] = None,
    time_cache: Optional[dict] = None,
    control: Optional[dict] = None,
    freeu=None,
    pag_tail: int = 0,
) -> torch.Tensor:
    """Predict noise.  latents: (B, H, W, C_in); timesteps: (B,) or scalar;
    context: (B, L, cross_attention_dim).  ``added_cond``: the SDXL
    micro-conditioning ``{"text_embeds": (B, P), "time_ids": (B, 5|6)}``;
    ``timestep_cond``: the LCM guidance embedding (B, time_cond_proj_dim).
    ``time_cache``: one step's slice of :func:`precompute_time_projections`
    (then ``timesteps``, ``added_cond`` and ``timestep_cond`` are unused:
    they are folded in).
    ``attention_impl``: "flash" (kernel C), "ring", "xla" (dense; SDPA on a
    card); ``conv_impl``: "gemm" (the slab kernels) or "xla" (``F.conv2d``).
    ``control``: ControlNet residuals ``{"down": [one per saved skip],
    "mid": tensor or None}`` (``models/controlnet.py``); ``freeu``: (b1, b2,
    s1, s2); ``pag_tail``: PAG's perturbed rows (:func:`unet_encode`)."""
    if time_cache is not None:
        temb = time_cache["temb"]
    else:
        temb = compute_time_embedding(
            timesteps, params, config, batch=latents.shape[0], dtype=latents.dtype,
            timestep_cond=timestep_cond, added_cond=added_cond)
    x, skips = unet_encode(
        latents, temb, context, params, config, attention_impl=attention_impl,
        conv_impl=conv_impl, cross_kv=cross_kv, time_proj=time_cache, control=control,
        pag_tail=pag_tail,
    )
    return unet_decode(
        x, skips, temb, context, params, config, attention_impl=attention_impl,
        conv_impl=conv_impl, cross_kv=cross_kv, time_proj=time_cache, freeu=freeu,
    )


def unet_encode(
    latents: torch.Tensor,
    temb: torch.Tensor,
    context: torch.Tensor,
    params: dict,
    config: UNetConfig,
    *,
    attention_impl: str = "flash",
    conv_impl: str = "gemm",
    cross_kv: Optional[dict] = None,
    time_proj: Optional[dict] = None,
    control: Optional[dict] = None,
    pag_tail: int = 0,
) -> tuple:
    """Encoder + mid block: returns ``(x, skips)``.  ``control``'s residuals
    are added to the saved skips (never to the running activation) and to
    the mid output.  ``pag_tail``: the last rows take identity
    self-attention at the PAG site: the mid block's attention, or, with no
    mid block, every attention block of the deepest attention level."""
    tp = time_proj
    ng = config.norm_num_groups
    context = context.to(latents.dtype)
    pag_level = -1
    if pag_tail and not config.mid_block:
        pag_level = max(lvl for lvl, has in enumerate(config.attention_levels) if has)
    ctrl_down = None if control is None else iter(control["down"])

    def save(a):
        return a if ctrl_down is None else a + next(ctrl_down).to(a.dtype)

    x = conv2d(latents, params["conv_in"]["kernel"], params["conv_in"]["bias"], padding=1)
    skips = [save(x)]
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
                    x, context, block["attentions"][i], num_heads=heads,
                    num_groups=ng, implementation=attention_impl,
                    cross_kv=None if cross_kv is None else cross_kv["down"][level][i],
                    pag_tail=pag_tail if level == pag_level else 0, stats=rstats,
                )
            skips.append(save(x))
        if "downsample" in block:
            x = downsample(x, block["downsample"])
            skips.append(save(x))
    if config.mid_block:
        mid = params["mid_block"]
        heads = _heads_for_level(config, config.block_out_channels[-1])
        x, rstats = resnet_block(x, temb, mid["resnets"][0], num_groups=ng,
                                 t_pre=None if tp is None else tp["mid"][0],
                                 emit_stats=True, conv_impl=conv_impl)
        x = attention_block(
            x, context, mid["attentions"][0], num_heads=heads, num_groups=ng,
            implementation=attention_impl,
            cross_kv=None if cross_kv is None else cross_kv["mid"][0],
            pag_tail=pag_tail, stats=rstats,
        )
        x = resnet_block(x, temb, mid["resnets"][1], num_groups=ng,
                         t_pre=None if tp is None else tp["mid"][1], conv_impl=conv_impl)
        if control is not None and control.get("mid") is not None:
            x = x + control["mid"].to(x.dtype)
    return x, tuple(skips)


def unet_decode(
    x: torch.Tensor,
    skips,
    temb: torch.Tensor,
    context: torch.Tensor,
    params: dict,
    config: UNetConfig,
    *,
    attention_impl: str = "flash",
    conv_impl: str = "gemm",
    cross_kv: Optional[dict] = None,
    time_proj: Optional[dict] = None,
    freeu=None,
) -> torch.Tensor:
    """Decoder + output head, consuming :func:`unet_encode`'s output (under
    the encoder cache an earlier step's, with this step's time
    projections).  ``freeu``: (b1, b2, s1, s2) at the skip concats of the
    first two up blocks (:func:`apply_freeu`)."""
    tp = time_proj
    ng = config.norm_num_groups
    context = context.to(x.dtype)
    skips = list(skips)
    for rev, block in enumerate(params["up_blocks"]):
        level = config.num_levels - 1 - rev
        heads = _heads_for_level(config, config.block_out_channels[level])
        has_attn = config.attention_levels[level]
        for i, res in enumerate(block["resnets"]):
            skip = skips.pop()
            if freeu is not None:
                x, skip = apply_freeu(rev, x, skip, freeu)
            x = torch.cat([x, skip], dim=-1)
            x = resnet_block(x, temb, res, num_groups=ng,
                             t_pre=None if tp is None else tp["up"][rev][i],
                             emit_stats=has_attn, conv_impl=conv_impl)
            if has_attn:
                x, rstats = x
                x = attention_block(
                    x, context, block["attentions"][i], num_heads=heads,
                    num_groups=ng, implementation=attention_impl,
                    cross_kv=None if cross_kv is None else cross_kv["up"][rev][i],
                    stats=rstats,
                )
        if "upsample" in block:
            x = upsample(x, block["upsample"], conv_impl)
    x = silu(group_norm(x, params["norm_out"], num_groups=ng))
    return conv2d(x, params["conv_out"]["kernel"], params["conv_out"]["bias"], padding=1)


def _init_resnet(key, in_ch, out_ch, time_dim, *, dtype):
    k1, k2, k3, k4 = hostrng.split(key, 4)
    params = {
        "norm1": init_norm(in_ch, dtype=dtype),
        "conv1": init_conv2d(k1, in_ch, out_ch, 3, dtype=dtype),
        "time_emb_proj": init_linear(k2, time_dim, out_ch, dtype=dtype),
        "norm2": init_norm(out_ch, dtype=dtype),
        "conv2": init_conv2d(k3, out_ch, out_ch, 3, dtype=dtype),
    }
    if in_ch != out_ch:
        params["conv_shortcut"] = init_conv2d(k4, in_ch, out_ch, 1, dtype=dtype)
    return params


def _init_attn_block(key, ch, depth, context_dim, *, dtype):
    keys = hostrng.split(key, depth + 2)
    return {
        "norm": init_norm(ch, dtype=dtype),
        "proj_in": init_linear(keys[0], ch, ch, dtype=dtype),
        "blocks": [init_transformer_block(keys[1 + i], ch, context_dim=context_dim, dtype=dtype)
                   for i in range(depth)],
        "proj_out": init_linear(keys[-1], ch, ch, dtype=dtype),
    }


def init_unet(key, config: UNetConfig, *, dtype=torch.float32) -> dict:
    """Random parameters with the JAX package's tree, shapes and bounds, on
    the CPU, drawn on the host from ``key`` (an int seed or a ``HostKey``)
    in the JAX package's key order: 256 children taken in turn (the LCM
    ``cond_proj`` and the SDXL ``add_embedding`` after the time MLP)."""
    keys = iter(hostrng.split(hostrng.ensure_key(key), 256))
    nk = lambda: next(keys)  # noqa: E731
    time_dim = config.time_embed_dim
    ch0 = config.block_out_channels[0]
    params = {
        "conv_in": init_conv2d(nk(), config.in_channels, ch0, 3, dtype=dtype),
        "time_embedding": {
            "linear_1": init_linear(nk(), ch0, time_dim, dtype=dtype),
            "linear_2": init_linear(nk(), time_dim, time_dim, dtype=dtype),
        },
    }
    if config.time_cond_proj_dim is not None:
        params["time_embedding"]["cond_proj"] = init_linear(
            nk(), config.time_cond_proj_dim, ch0, use_bias=False, dtype=dtype)
    if config.addition_embed_dim is not None:
        params["add_embedding"] = {
            "linear_1": init_linear(nk(), config.addition_embed_dim, time_dim, dtype=dtype),
            "linear_2": init_linear(nk(), time_dim, time_dim, dtype=dtype),
        }

    def attn(ch, level):
        return _init_attn_block(nk(), ch, config.transformer_layers_per_block[level],
                                config.cross_attention_dim, dtype=dtype)

    down_blocks, out_ch = [], ch0
    for level, ch in enumerate(config.block_out_channels):
        block = {"resnets": [], "attentions": []}
        for _ in range(config.layers_per_block):
            block["resnets"].append(_init_resnet(nk(), out_ch, ch, time_dim, dtype=dtype))
            out_ch = ch
            if config.attention_levels[level]:
                block["attentions"].append(attn(ch, level))
        if level < config.num_levels - 1:
            block["downsample"] = init_conv2d(nk(), ch, ch, 3, dtype=dtype)
        if not block["attentions"]:
            del block["attentions"]
        down_blocks.append(block)
    params["down_blocks"] = down_blocks

    if config.mid_block:
        ch = config.block_out_channels[-1]
        params["mid_block"] = {
            "resnets": [_init_resnet(nk(), ch, ch, time_dim, dtype=dtype),
                        _init_resnet(nk(), ch, ch, time_dim, dtype=dtype)],
            "attentions": [attn(ch, config.num_levels - 1)],
        }

    skip_chs = [ch0]
    for level, ch in enumerate(config.block_out_channels):
        skip_chs.extend([ch] * config.layers_per_block)
        if level < config.num_levels - 1:
            skip_chs.append(ch)
    up_blocks, prev_ch = [], config.block_out_channels[-1]
    for rev in range(config.num_levels):
        level = config.num_levels - 1 - rev
        ch = config.block_out_channels[level]
        block = {"resnets": [], "attentions": []}
        for _ in range(config.layers_per_block + 1):
            block["resnets"].append(
                _init_resnet(nk(), prev_ch + skip_chs.pop(), ch, time_dim, dtype=dtype))
            prev_ch = ch
            if config.attention_levels[level]:
                block["attentions"].append(attn(ch, level))
        if level > 0:
            block["upsample"] = init_conv2d(nk(), ch, ch, 3, dtype=dtype)
        if not block["attentions"]:
            del block["attentions"]
        up_blocks.append(block)
    params["up_blocks"] = up_blocks
    params["norm_out"] = init_norm(ch0, dtype=dtype)
    params["conv_out"] = init_conv2d(nk(), ch0, config.out_channels, 3, dtype=dtype)
    return params
