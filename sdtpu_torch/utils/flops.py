"""Analytic FLOP accounting for the SD pipeline: the basis of the
``mfu_pct`` field of ``python -m sdtpu_torch.bench``.

A copy of the JAX package's ``sdtpu/utils/flops.py`` against the port's
config.  The counters mirror the model structure (``sdtpu_torch/models``)
and count 2*M*N*K per matmul and 2*H*W*kh*kw*Ci*Co per conv: the
tensor-core work only (elementwise and norm work is bandwidth-, not
flop-, bound).
"""

from __future__ import annotations

from sdtpu_torch.config import CLIPConfig, PipelineConfig, UNetConfig, VAEConfig


def _conv(h, w, kh, kw, ci, co) -> float:
    return 2.0 * h * w * kh * kw * ci * co


def _mm(m, n, k) -> float:
    return 2.0 * m * n * k


def _attention_block_flops(l, c, depth, ctx_len, ctx_dim) -> float:
    """Transformer2D at l spatial tokens, c channels: proj_in/out + depth x
    (self-attn + cross-attn + GeGLU ff)."""
    f = 2 * _mm(l, c, c)  # proj_in + proj_out
    for _ in range(depth):
        # self: q,k,v,out projections + QK^T + PV
        f += 4 * _mm(l, c, c) + 2 * _mm(l, l, c)
        # cross: q/out on l, k/v on ctx_len, scores l x ctx_len
        f += 2 * _mm(l, c, c) + 2 * _mm(ctx_len, c, ctx_dim)
        f += 2 * _mm(l, ctx_len, c)
        # GeGLU: c -> 8c, gate to 4c -> c
        f += _mm(l, 8 * c, c) + _mm(l, c, 4 * c)
    return f


def _resnet_flops(h, w, ci, co, time_dim) -> float:
    f = _conv(h, w, 3, 3, ci, co) + _conv(h, w, 3, 3, co, co)
    f += _mm(1, co, time_dim)
    if ci != co:
        f += _conv(h, w, 1, 1, ci, co)
    return f


def unet_step_flops(config: UNetConfig, lat_size: int, batch: int,
                    ctx_len: int = 77) -> float:
    """One UNet forward at (batch, lat_size, lat_size, in_ch) — mirrors
    unet_forward's channel/spatial bookkeeping exactly."""
    chs = config.block_out_channels
    td = config.time_embed_dim
    ctx_dim = config.cross_attention_dim
    s = lat_size
    f = _conv(s, s, 3, 3, config.in_channels, chs[0])
    f += _mm(1, td, chs[0]) + _mm(1, td, td)  # time MLP

    # encoder
    skip_chs = [chs[0]]
    in_ch = chs[0]
    for lvl, ch in enumerate(chs):
        for _ in range(config.layers_per_block):
            f += _resnet_flops(s, s, in_ch, ch, td)
            in_ch = ch
            if config.attention_levels[lvl]:
                f += _attention_block_flops(
                    s * s, ch, config.transformer_layers_per_block[lvl],
                    ctx_len, ctx_dim,
                )
            skip_chs.append(ch)
        if lvl < len(chs) - 1:
            f += _conv(s // 2, s // 2, 3, 3, ch, ch)  # stride-2 downsample
            skip_chs.append(ch)
            s //= 2

    if config.mid_block:
        ch = chs[-1]
        f += 2 * _resnet_flops(s, s, ch, ch, td)
        f += _attention_block_flops(
            s * s, ch, config.transformer_layers_per_block[-1], ctx_len,
            ctx_dim,
        )

    # decoder
    prev = chs[-1]
    for rev in range(len(chs)):
        lvl = len(chs) - 1 - rev
        ch = chs[lvl]
        for _ in range(config.layers_per_block + 1):
            f += _resnet_flops(s, s, prev + skip_chs.pop(), ch, td)
            prev = ch
            if config.attention_levels[lvl]:
                f += _attention_block_flops(
                    s * s, ch, config.transformer_layers_per_block[lvl],
                    ctx_len, ctx_dim,
                )
        if lvl > 0:
            s *= 2
            f += _conv(s, s, 3, 3, ch, ch)  # upsample conv

    f += _conv(s, s, 3, 3, chs[0], config.out_channels)
    return f * batch


def clip_flops(config: CLIPConfig, batch: int) -> float:
    l, c = config.max_length, config.hidden_size
    per_layer = 4 * _mm(l, c, c) + 2 * _mm(l, l, c)
    per_layer += _mm(l, config.intermediate_size, c) * 2
    return batch * config.num_layers * per_layer


def vae_decode_flops(config: VAEConfig, lat_size: int, batch: int) -> float:
    chs = config.block_out_channels
    z = config.latent_channels
    s = lat_size
    f = _conv(s, s, 1, 1, z, z)  # post_quant
    f += _conv(s, s, 3, 3, z, chs[-1])
    # mid: 2 resnets + attention (l^2 at the latent grid)
    ch = chs[-1]
    f += 2 * (_conv(s, s, 3, 3, ch, ch) * 2)
    l = s * s
    f += 4 * _mm(l, ch, ch) + 2 * _mm(l, l, ch)
    prev = ch
    for rev, ch in enumerate(reversed(chs)):
        for i in range(config.layers_per_block + 1):
            ci = prev if i == 0 else ch
            f += _conv(s, s, 3, 3, ci, ch) + _conv(s, s, 3, 3, ch, ch)
            if ci != ch:
                f += _conv(s, s, 1, 1, ci, ch)
            prev = ch
        if rev < len(chs) - 1:
            s *= 2
            f += _conv(s, s, 3, 3, ch, ch)
    f += _conv(s, s, 3, 3, chs[0], config.out_channels)
    return f * batch


def vae_encode_flops(config: VAEConfig, image_size: int, batch: int) -> float:
    chs = config.block_out_channels
    s = image_size
    f = _conv(s, s, 3, 3, config.in_channels, chs[0])
    prev = chs[0]
    for lvl, ch in enumerate(chs):
        for i in range(config.layers_per_block):
            ci = prev if i == 0 else ch
            f += _conv(s, s, 3, 3, ci, ch) + _conv(s, s, 3, 3, ch, ch)
            if ci != ch:
                f += _conv(s, s, 1, 1, ci, ch)
            prev = ch
        if lvl < len(chs) - 1:
            s //= 2
            f += _conv(s, s, 3, 3, ch, ch)  # stride-2 downsample
    ch = chs[-1]
    f += 2 * (_conv(s, s, 3, 3, ch, ch) * 2)  # mid resnets
    l = s * s
    f += 4 * _mm(l, ch, ch) + 2 * _mm(l, l, ch)  # mid attention
    z = config.latent_channels
    f += _conv(s, s, 3, 3, ch, 2 * z) + _conv(s, s, 1, 1, 2 * z, 2 * z)
    return f * batch


def pipeline_flops(
    config: PipelineConfig, image_size: int, steps: int, batch: int,
    cfg: bool = True, img2img: bool = False, strength: float = 0.9,
) -> float:
    """Total matmul and conv flops of one generate(): CLIP (+CLIP2) once, CFG-batched
    UNet per step, VAE decode once (+VAE encode and strength-truncated step
    count for img2img — the schedule runs steps - int(steps*(1-strength))
    steps, samplers/ddpm.py:inference_timesteps)."""
    lat = image_size // config.vae.downscale_factor
    eff_batch = 2 * batch if cfg else batch
    # bigG-only presets (sdxl-refiner) have clip=None; text_config is the
    # tokenizer-facing encoder either way
    f = 0.0
    if config.clip is not None:
        f += clip_flops(config.clip, eff_batch)
    if config.clip_2 is not None:
        f += clip_flops(config.clip_2, eff_batch)
    if img2img:
        start = min(max(steps - int(steps * strength), 0), steps - 1)
        steps = steps - start
        f += vae_encode_flops(config.vae, image_size, batch)
    f += steps * unet_step_flops(config.unet, lat, eff_batch,
                                 config.text_config.max_length)
    f += vae_decode_flops(config.vae, lat, batch)
    return f
