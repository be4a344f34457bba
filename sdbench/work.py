"""The yardstick's arithmetic: the chip's peaks, a request's analytic
FLOPs, and the 3x3 convolutions and self-attentions a request computes,
each with its operations and bytes, all from a configuration file.

``request_flops`` is the port's ``utils/flops.py`` (``pipeline_flops``:
2*M*N*K per matmul, 2*H*W*kh*kw*Ci*Co per conv, the tensor-core work only;
it leaves out SDXL's add-embedding), copied over the configuration file so
that it stays fixed.  A conv's bytes count its input (the small map of a
fused upsample), its weights, its residual and its output once each, in
the configuration's dtype; an attention's its q, k, v and o once each.
"""

from __future__ import annotations

from sdbench import spec

# NVIDIA H100 SXM (data sheet, dense, at the 700 W limit)
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def _conv(h, w, kh, kw, ci, co):
    return 2.0 * h * w * kh * kw * ci * co


def _mm(m, n, k):
    return 2.0 * m * n * k


def _heads(u: dict, ch: int) -> int:
    return u["num_attention_heads"] or ch // 64


def _attn_block(l, c, depth, ctx_len, ctx_dim):
    f = 2 * _mm(l, c, c)
    for _ in range(depth):
        f += 4 * _mm(l, c, c) + 2 * _mm(l, l, c)
        f += 2 * _mm(l, c, c) + 2 * _mm(ctx_len, c, ctx_dim) + 2 * _mm(l, ctx_len, c)
        f += _mm(l, 8 * c, c) + _mm(l, c, 4 * c)
    return f


def _resnet(h, w, ci, co, td):
    f = _conv(h, w, 3, 3, ci, co) + _conv(h, w, 3, 3, co, co) + _mm(1, co, td)
    return f + (_conv(h, w, 1, 1, ci, co) if ci != co else 0.0)


def unet_step_flops(u: dict, lat: int, rows: int, ctx_len: int) -> float:
    chs = u["block_out_channels"]
    td = chs[0] * u["time_embed_dim_mult"]
    s = lat
    f = _conv(s, s, 3, 3, u["in_channels"], chs[0]) + _mm(1, td, chs[0]) + _mm(1, td, td)
    skips, cin = [chs[0]], chs[0]
    for lvl, ch in enumerate(chs):
        for _ in range(u["layers_per_block"]):
            f += _resnet(s, s, cin, ch, td)
            cin = ch
            if u["attention_levels"][lvl]:
                f += _attn_block(s * s, ch, u["transformer_layers_per_block"][lvl], ctx_len,
                                 u["cross_attention_dim"])
            skips.append(ch)
        if lvl < len(chs) - 1:
            f += _conv(s // 2, s // 2, 3, 3, ch, ch)
            skips.append(ch)
            s //= 2
    if u["mid_block"]:
        f += 2 * _resnet(s, s, chs[-1], chs[-1], td)
        f += _attn_block(s * s, chs[-1], u["transformer_layers_per_block"][-1], ctx_len,
                         u["cross_attention_dim"])
    prev = chs[-1]
    for rev in range(len(chs)):
        lvl = len(chs) - 1 - rev
        ch = chs[lvl]
        for _ in range(u["layers_per_block"] + 1):
            f += _resnet(s, s, prev + skips.pop(), ch, td)
            prev = ch
            if u["attention_levels"][lvl]:
                f += _attn_block(s * s, ch, u["transformer_layers_per_block"][lvl], ctx_len,
                                 u["cross_attention_dim"])
        if lvl > 0:
            s *= 2
            f += _conv(s, s, 3, 3, ch, ch)
    f += _conv(s, s, 3, 3, chs[0], u["out_channels"])
    return f * rows


def clip_flops(c: dict, rows: int) -> float:
    l, d = c["max_length"], c["hidden_size"]
    per = 4 * _mm(l, d, d) + 2 * _mm(l, l, d) + 2 * _mm(l, c["intermediate_size"], d)
    return rows * c["num_layers"] * per


def vae_decode_flops(v: dict, lat: int, rows: int) -> float:
    chs, s = v["block_out_channels"], lat
    f = _conv(s, s, 1, 1, v["latent_channels"], v["latent_channels"])
    f += _conv(s, s, 3, 3, v["latent_channels"], chs[-1])
    f += 2 * 2 * _conv(s, s, 3, 3, chs[-1], chs[-1])
    f += 4 * _mm(s * s, chs[-1], chs[-1]) + 2 * _mm(s * s, s * s, chs[-1])
    prev = chs[-1]
    for rev, ch in enumerate(reversed(chs)):
        for i in range(v["layers_per_block"] + 1):
            ci = prev if i == 0 else ch
            f += _conv(s, s, 3, 3, ci, ch) + _conv(s, s, 3, 3, ch, ch)
            f += _conv(s, s, 1, 1, ci, ch) if ci != ch else 0.0
            prev = ch
        if rev < len(chs) - 1:
            s *= 2
            f += _conv(s, s, 3, 3, ch, ch)
    return (f + _conv(s, s, 3, 3, chs[0], v["out_channels"])) * rows


def vae_encode_flops(v: dict, size: int, rows: int) -> float:
    chs, s = v["block_out_channels"], size
    f = _conv(s, s, 3, 3, v["in_channels"], chs[0])
    prev = chs[0]
    for lvl, ch in enumerate(chs):
        for i in range(v["layers_per_block"]):
            ci = prev if i == 0 else ch
            f += _conv(s, s, 3, 3, ci, ch) + _conv(s, s, 3, 3, ch, ch)
            f += _conv(s, s, 1, 1, ci, ch) if ci != ch else 0.0
            prev = ch
        if lvl < len(chs) - 1:
            s //= 2
            f += _conv(s, s, 3, 3, ch, ch)
    f += 2 * 2 * _conv(s, s, 3, 3, chs[-1], chs[-1])
    f += 4 * _mm(s * s, chs[-1], chs[-1]) + 2 * _mm(s * s, s * s, chs[-1])
    z = v["latent_channels"]
    f += _conv(s, s, 3, 3, chs[-1], 2 * z) + _conv(s, s, 1, 1, 2 * z, 2 * z)
    return f * rows


def schedule_steps(steps: int, strength: float = 1.0) -> int:
    """Steps an img2img request runs at ``strength`` ("leading" spacing)."""
    return steps - min(max(steps - int(steps * strength), 0), steps - 1)


def request_flops(cfg: dict, rows: int, strength: float = None) -> float:
    """One request of ``rows`` images: the text encoder(s) and every UNet
    step on ``spec.unet_rows`` rows (two an image under classifier-free
    guidance), the VAE decode, and for img2img (``strength``) the encode
    and the truncated schedule."""
    v, u = cfg["vae"], cfg["unet"]
    lat = cfg["image_size"] // 2 ** (len(v["block_out_channels"]) - 1)
    f = sum(clip_flops(cfg[k], spec.unet_rows(cfg, rows)) for k in ("clip", "clip_2")
            if cfg.get(k))
    steps = cfg["steps"]
    if strength is not None:
        steps = schedule_steps(steps, strength)
        f += vae_encode_flops(v, cfg["image_size"], rows)
    text = cfg.get("clip") or cfg["clip_2"]
    f += steps * unet_step_flops(u, lat, spec.unet_rows(cfg, rows), text["max_length"])
    return f + vae_decode_flops(v, lat, rows)


# -- the 3x3 convolutions and self-attentions, one entry per call ------------
# conv: (n, h_out, w_out, ci, co, input_pixels_per_row, residual)


def unet_convs(u: dict, lat: int, rows: int) -> list:
    chs = u["block_out_channels"]
    s = lat
    out = [(rows, s, s, u["in_channels"], chs[0], s * s, False)]

    def resnet(ci, co):
        out.append((rows, s, s, ci, co, s * s, False))
        out.append((rows, s, s, co, co, s * s, True))

    skips, cin = [chs[0]], chs[0]
    for lvl, ch in enumerate(chs):
        for _ in range(u["layers_per_block"]):
            resnet(cin, ch)
            cin = ch
            skips.append(ch)
        if lvl < len(chs) - 1:
            out.append((rows, s // 2, s // 2, ch, ch, s * s, False))
            skips.append(ch)
            s //= 2
    if u["mid_block"]:
        resnet(chs[-1], chs[-1])
        resnet(chs[-1], chs[-1])
    prev = chs[-1]
    for rev in range(len(chs)):
        lvl = len(chs) - 1 - rev
        ch = chs[lvl]
        for _ in range(u["layers_per_block"] + 1):
            resnet(prev + skips.pop(), ch)
            prev = ch
        if lvl > 0:
            out.append((rows, 2 * s, 2 * s, ch, ch, s * s, False))
            s *= 2
    out.append((rows, s, s, chs[0], u["out_channels"], s * s, False))
    return out


def vae_decode_convs(v: dict, lat: int, rows: int) -> list:
    chs, s = v["block_out_channels"], lat
    out = [(rows, s, s, v["latent_channels"], chs[-1], s * s, False)]
    for _ in range(2):
        out += [(rows, s, s, chs[-1], chs[-1], s * s, False),
                (rows, s, s, chs[-1], chs[-1], s * s, True)]
    prev = chs[-1]
    for rev, ch in enumerate(reversed(chs)):
        for i in range(v["layers_per_block"] + 1):
            ci = prev if i == 0 else ch
            out += [(rows, s, s, ci, ch, s * s, False), (rows, s, s, ch, ch, s * s, True)]
            prev = ch
        if rev < len(chs) - 1:
            out.append((rows, 2 * s, 2 * s, ch, ch, s * s, False))
            s *= 2
    out.append((rows, s, s, chs[0], v["out_channels"], s * s, False))
    return out


def vae_encode_convs(v: dict, size: int, rows: int) -> list:
    chs, s = v["block_out_channels"], size
    out = [(rows, s, s, v["in_channels"], chs[0], s * s, False)]
    prev = chs[0]
    for lvl, ch in enumerate(chs):
        for i in range(v["layers_per_block"]):
            ci = prev if i == 0 else ch
            out += [(rows, s, s, ci, ch, s * s, False), (rows, s, s, ch, ch, s * s, True)]
            prev = ch
        if lvl < len(chs) - 1:
            out.append((rows, s // 2, s // 2, ch, ch, s * s, False))
            s //= 2
    for _ in range(2):
        out += [(rows, s, s, chs[-1], chs[-1], s * s, False),
                (rows, s, s, chs[-1], chs[-1], s * s, True)]
    out.append((rows, s, s, chs[-1], 2 * v["latent_channels"], s * s, False))
    return out


def conv_least_s(convs: list, dtype_bytes: int) -> float:
    """The least time of the listed convs on the chip: each the larger of
    its operations over the bf16 peak and its bytes over the bandwidth."""
    total = 0.0
    for n, h, w, ci, co, in_px, residual in convs:
        ops = 2.0 * n * h * w * 9 * ci * co
        byt = dtype_bytes * (n * in_px * ci + 9 * ci * co + co + n * h * w * co
                             * (2 if residual else 1))
        total += max(ops / PEAK_FLOPS_BF16, byt / PEAK_BYTES_PER_S)
    return total


# attention: (n, heads, length, head_dim)


def unet_attentions(u: dict, lat: int, rows: int) -> list:
    chs, s, out = u["block_out_channels"], lat, []
    for lvl, ch in enumerate(chs):
        if u["attention_levels"][lvl]:
            per = u["transformer_layers_per_block"][lvl]
            n_blocks = u["layers_per_block"] + (u["layers_per_block"] + 1)
            out += [(rows, _heads(u, ch), s * s, ch // _heads(u, ch))] * (per * n_blocks)
        s //= 2 if lvl < len(chs) - 1 else 1
    if u["mid_block"]:
        ch = chs[-1]
        out += [(rows, _heads(u, ch), s * s, ch // _heads(u, ch))] * \
            u["transformer_layers_per_block"][-1]
    return out


def vae_attentions(v: dict, lat: int, rows: int) -> list:
    return [(rows, 1, lat * lat, v["block_out_channels"][-1])]


def attention_least_s(atts: list, dtype_bytes: int) -> float:
    total = 0.0
    for n, heads, length, d in atts:
        ops = 4.0 * n * heads * length * length * d
        byt = dtype_bytes * 4 * n * heads * length * d
        total += max(ops / PEAK_FLOPS_BF16, byt / PEAK_BYTES_PER_S)
    return total
