"""CLIP text encoder.

Counterpart of ``sdtpu/models/clip.py``: token + learned position
embeddings, pre-LN transformer layers with causal self-attention and a
QuickGELU (or erf GELU) MLP, final LayerNorm.  The layers are stacked along
a leading axis as in the JAX package's parameter tree; the JAX scan over
them is a Python loop here.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sdtpu_torch.config import CLIPConfig
from sdtpu_torch.ops import (
    attention,
    embedding_lookup,
    gelu_erf,
    init_attention,
    init_embedding,
    init_linear,
    init_norm,
    layer_norm,
    linear,
    quick_gelu,
)
from sdtpu_torch.ops.embedding import scaled_normal
from sdtpu_torch.parallel.mesh import like
from sdtpu_torch.utils import hostrng


def _layer(stacked, i: int):
    """Layer ``i`` of a stacked parameter tree (a tp-sharded projection's
    dict keeps its split: ``parallel/mesh.py:like``)."""
    if isinstance(stacked, dict):
        return like(stacked, {k: _layer(v, i) for k, v in stacked.items()})
    return stacked[i]


def encoder_layer(
    x: torch.Tensor, params: dict, *, num_heads: int, act: str, eps: float
) -> torch.Tensor:
    """LN -> causal self-attention -> residual; LN -> MLP -> residual."""
    h = layer_norm(x, params["norm1"], eps=eps)
    x = x + attention(h, params["attn"], num_heads=num_heads, causal=True)
    h = layer_norm(x, params["norm2"], eps=eps)
    h = linear(h, params["mlp"]["fc1"])
    h = quick_gelu(h) if act == "quick_gelu" else gelu_erf(h)
    return x + linear(h, params["mlp"]["fc2"])


def clip_encode(
    token_ids: torch.Tensor, params: dict, config: CLIPConfig, *, clip_skip: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L) ids -> ``(hidden (B, L, D), pooled (B, D or projection))``.

    ``hidden`` is the final-LayerNorm output (SD 1.x) or the penultimate
    state (``use_final_layer_norm_output=False``); ``pooled`` is the
    final-LN state at each row's EOS (argmax id) position.  ``clip_skip``
    taps the hidden state that many layers earlier (diffusers semantics)."""
    seq_len = token_ids.shape[1]
    x = embedding_lookup(token_ids, params["token_embedding"])
    x = x + params["position_embedding"][None, :seq_len, :].to(x.dtype)
    eff_skip = clip_skip + (0 if config.use_final_layer_norm_output else 1)
    if not 0 <= eff_skip < config.num_layers:
        raise ValueError(f"clip_skip {clip_skip} out of range")
    n_head = config.num_layers - eff_skip
    h = x
    for i in range(config.num_layers):
        x = encoder_layer(x, _layer(params["layers"], i), num_heads=config.num_heads,
                          act=config.hidden_act, eps=config.layer_norm_eps)
        if i == n_head - 1:
            h = x
    normed = layer_norm(x, params["final_norm"], eps=config.layer_norm_eps)

    eos_pos = torch.argmax(token_ids, dim=-1)
    pooled = normed[torch.arange(normed.shape[0], device=normed.device), eos_pos]
    if config.projection_dim is not None:
        pooled = linear(pooled, params["text_projection"])
    if config.use_final_layer_norm_output:
        hidden = normed if eff_skip == 0 else layer_norm(
            h, params["final_norm"], eps=config.layer_norm_eps)
    else:
        hidden = h
    return hidden, pooled


def clip_encode_windows(
    token_ids: torch.Tensor, params: dict, config: CLIPConfig, *, clip_skip: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`clip_encode` over (B, n*W) ids as B*n independent W-token
    windows in one batched call, hidden states re-concatenated to
    (B, n*W, D); the pooled output is the first window's."""
    b, length = token_ids.shape
    if length <= config.max_length:
        return clip_encode(token_ids, params, config, clip_skip=clip_skip)
    if length % config.max_length:
        raise ValueError(
            f"token_ids length {length} must be a multiple of the CLIP window "
            f"({config.max_length})"
        )
    n = length // config.max_length
    flat = token_ids.reshape(b * n, config.max_length)
    hidden, pooled = clip_encode(flat, params, config, clip_skip=clip_skip)
    return hidden.reshape(b, length, hidden.shape[-1]), pooled.reshape(b, n, -1)[:, 0]


def init_clip(key, config: CLIPConfig, *, dtype=torch.float32) -> dict:
    """Random parameters (layers stacked along a leading axis) on the CPU,
    drawn on the host from ``key`` (an int seed or a ``HostKey``) in the JAX
    package's key order.  The token and position embeddings are float32
    whatever ``dtype`` is, as in the JAX package's host-side init."""
    d = config.hidden_size
    keys = hostrng.split(hostrng.ensure_key(key), config.num_layers + 3)

    def init_layer(k):
        k1, k2, k3 = hostrng.split(k, 3)
        return {
            "norm1": init_norm(d, dtype=dtype),
            "attn": init_attention(k1, d, qkv_bias=True, dtype=dtype),
            "norm2": init_norm(d, dtype=dtype),
            "mlp": {
                "fc1": init_linear(k2, d, config.intermediate_size, dtype=dtype),
                "fc2": init_linear(k3, config.intermediate_size, d, dtype=dtype),
            },
        }

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    params = {
        "token_embedding": init_embedding(keys[-3], config.vocab_size, d, dtype=dtype),
        "position_embedding": scaled_normal(keys[-2], (config.max_length, d), dtype, 0.01),
        "layers": stack([init_layer(k) for k in keys[:config.num_layers]]),
        "final_norm": init_norm(d, dtype=dtype),
    }
    if config.projection_dim is not None:
        params["text_projection"] = init_linear(
            keys[-1], d, config.projection_dim, use_bias=False, dtype=dtype)
    return params
