"""CLIP text encoder (Radford et al. 2021; HF ``CLIPTextModel``) in plain
float32: token and position embeddings, pre-LN layers with causal
self-attention and a QuickGELU or erf-GELU MLP, final LayerNorm.  The
layer parameters are stacked along a leading axis."""

from __future__ import annotations

import torch

from sdbench.reference.nn import Ops, attention, gelu_erf, layer_norm


def _layer(stacked, i: int):
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def encode(ops: Ops, ids: torch.Tensor, p: dict, cfg: dict):
    """(B, L) ids -> (hidden (B, L, D), pooled (B, D or projection)).
    ``hidden`` is the final-LN output, or the penultimate layer's state
    when ``use_final_layer_norm_output`` is false (SDXL); ``pooled`` the
    final-LN state at each row's EOS (its largest id), projected where the
    encoder has a text projection."""
    eps = cfg["layer_norm_eps"]
    x = p["token_embedding"]["weight"].float()[ids.long()]
    x = x + p["position_embedding"].float()[None, :ids.shape[1]]
    n = cfg["num_layers"]
    keep = n if cfg["use_final_layer_norm_output"] else n - 1
    hidden = None
    for i in range(n):
        lp = _layer(p["layers"], i)
        h = layer_norm(x, lp["norm1"], eps)
        a = lp["attn"]
        att = attention(ops, ops.linear(h, a["q"]), ops.linear(h, a["k"]),
                        ops.linear(h, a["v"]), cfg["num_heads"], causal=True)
        x = x + ops.linear(att, a["out"])
        h = ops.linear(layer_norm(x, lp["norm2"], eps), lp["mlp"]["fc1"])
        h = h * torch.sigmoid(1.702 * h) if cfg["hidden_act"] == "quick_gelu" else gelu_erf(h)
        x = x + ops.linear(h, lp["mlp"]["fc2"])
        if i == keep - 1:
            hidden = x
    normed = layer_norm(x, p["final_norm"], eps)
    pooled = normed[torch.arange(ids.shape[0], device=ids.device), ids.argmax(dim=-1)]
    if cfg.get("projection_dim"):
        pooled = ops.matmul(pooled, p["text_projection"]["kernel"])
    return (normed if cfg["use_final_layer_norm_output"] else hidden), pooled
