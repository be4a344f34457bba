"""Token embedding and sinusoidal timestep embedding (diffusers
``Timesteps`` semantics: freqs = exp(-ln(max_period) * i / (half - shift)),
cos||sin when ``flip_sin_to_cos``)."""

from __future__ import annotations

import math

import torch

from sdtpu_torch.utils import hostrng


def embedding_lookup(token_ids: torch.Tensor, params: dict) -> torch.Tensor:
    """(B, L) int ids -> (B, L, D) rows of the table."""
    return params["weight"][token_ids.long()]


def init_embedding(key, num_embeddings: int, features: int, *, dtype=torch.float32) -> dict:
    """N(0, 1) drawn in ``dtype``, times 0.02 in float32: the table is
    float32 whatever ``dtype`` is, as the JAX package's numpy product
    leaves it."""
    return {"weight": scaled_normal(key, (num_embeddings, features), dtype, 0.02)}


def scaled_normal(key, shape, dtype, scale: float) -> torch.Tensor:
    """``hostrng.normal(key, shape, dtype) * scale`` as the JAX package's
    numpy computes it: the draw rounded to ``dtype``, the product in
    float32."""
    return hostrng.leaf(hostrng.normal(key, shape), dtype).float() * torch.tensor(
        scale, dtype=torch.float32)


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    *,
    flip_sin_to_cos: bool = True,
    freq_shift: float = 0.0,
    max_period: float = 10000.0,
    dtype=torch.float32,
) -> torch.Tensor:
    """(B,) timesteps -> (B, dim) sinusoidal embedding."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half - freq_shift)
    freqs = torch.exp(exponent)
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    return emb.to(dtype)
