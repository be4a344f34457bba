"""Conditional UNet (diffusers ``UNet2DConditionModel``) in plain float32:
the time MLP (with SDXL's add-embedding of the pooled text and the size
time ids), resnets, Transformer2D blocks (self-attention, cross-attention,
GeGLU feed-forward), stride-2 downsamples, nearest-2x upsamples, the
optional mid block, skips concatenated last-in first-out."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sdbench.reference.nn import (Ops, attention, gelu_erf, group_norm, layer_norm, silu,
                                  timestep_embedding)


def heads_for(cfg: dict, channels: int) -> int:
    """A fixed head count, or head size 64 where the config gives 0."""
    return cfg["num_attention_heads"] or channels // 64


def time_embedding(ops: Ops, t: torch.Tensor, p: dict, cfg: dict, added: dict = None):
    """(rows,) timesteps -> SiLU(time MLP [+ add-embedding]) (rows, D)."""
    emb = timestep_embedding(t, cfg["block_out_channels"][0],
                             flip_sin_to_cos=cfg["flip_sin_to_cos"], freq_shift=cfg["freq_shift"])
    te = p["time_embedding"]
    emb = ops.linear(silu(ops.linear(emb, te["linear_1"])), te["linear_2"])
    if cfg.get("addition_embed_dim"):
        rows = added["time_ids"].shape[0]
        tid = timestep_embedding(added["time_ids"].reshape(-1), cfg["addition_time_embed_dim"],
                                 flip_sin_to_cos=cfg["flip_sin_to_cos"],
                                 freq_shift=cfg["freq_shift"]).reshape(rows, -1)
        a = torch.cat([added["text_embeds"].float(), tid], dim=-1)
        ae = p["add_embedding"]
        emb = emb + ops.linear(silu(ops.linear(a, ae["linear_1"])), ae["linear_2"])
    return silu(emb)


def resnet(ops: Ops, x, temb, p, groups: int, eps: float = 1e-5, has_time: bool = True):
    h = ops.conv(silu(group_norm(x, p["norm1"], groups, eps)), p["conv1"])
    if has_time:
        h = h + ops.linear(temb, p["time_emb_proj"])[:, None, None, :]
    h = ops.conv(silu(group_norm(h, p["norm2"], groups, eps)), p["conv2"])
    if "conv_shortcut" in p:
        x = ops.conv(x, p["conv_shortcut"], padding=0)
    return x + h


def transformer(ops: Ops, x, context, p, heads: int, groups: int):
    b, hh, ww, c = x.shape
    h = group_norm(x, p["norm"], groups, 1e-6).reshape(b, hh * ww, c)
    h = ops.linear(h, p["proj_in"])
    for blk in p["blocks"]:
        n = layer_norm(h, blk["norm1"])
        a = blk["attn1"]
        o = attention(ops, ops.linear(n, a["q"]), ops.linear(n, a["k"]), ops.linear(n, a["v"]),
                      heads)
        h = h + ops.linear(o, a["out"])
        n = layer_norm(h, blk["norm2"])
        a = blk["attn2"]
        o = attention(ops, ops.linear(n, a["q"]), ops.linear(context, a["k"]),
                      ops.linear(context, a["v"]), heads)
        h = h + ops.linear(o, a["out"])
        n = ops.linear(layer_norm(h, blk["norm3"]), blk["ff"]["proj"])
        value, gate = n.chunk(2, dim=-1)
        h = h + ops.linear(value * gelu_erf(gate), blk["ff"]["out"])
    return ops.linear(h, p["proj_out"]).reshape(b, hh, ww, c) + x


def forward(ops: Ops, lat, temb, context, p, cfg: dict):
    """(rows, h, w, C_in) latents, the time MLP's output, (rows, L, D)
    context -> the noise prediction (rows, h, w, C_out)."""
    g = cfg["norm_num_groups"]
    chs = cfg["block_out_channels"]
    levels = cfg["attention_levels"]
    context = context.float()
    x = ops.conv(lat.float(), p["conv_in"])
    skips = [x]
    for lvl, blk in enumerate(p["down_blocks"]):
        for i, r in enumerate(blk["resnets"]):
            x = resnet(ops, x, temb, r, g)
            if levels[lvl]:
                x = transformer(ops, x, context, blk["attentions"][i], heads_for(cfg, chs[lvl]), g)
            skips.append(x)
        if "downsample" in blk:
            x = ops.conv(x, blk["downsample"], stride=2)
            skips.append(x)
    if cfg["mid_block"]:
        m = p["mid_block"]
        x = resnet(ops, x, temb, m["resnets"][0], g)
        x = transformer(ops, x, context, m["attentions"][0], heads_for(cfg, chs[-1]), g)
        x = resnet(ops, x, temb, m["resnets"][1], g)
    for rev, blk in enumerate(p["up_blocks"]):
        lvl = len(chs) - 1 - rev
        for i, r in enumerate(blk["resnets"]):
            x = resnet(ops, torch.cat([x, skips.pop()], dim=-1), temb, r, g)
            if levels[lvl]:
                x = transformer(ops, x, context, blk["attentions"][i], heads_for(cfg, chs[lvl]), g)
        if "upsample" in blk:
            x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
            x = ops.conv(x.permute(0, 2, 3, 1), blk["upsample"])
    x = silu(group_norm(x, p["norm_out"], g, 1e-5))
    return ops.conv(x, p["conv_out"])
