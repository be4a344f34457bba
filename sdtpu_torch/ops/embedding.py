"""Token embedding and sinusoidal timestep embedding (diffusers
``Timesteps`` semantics: freqs = exp(-ln(max_period) * i / (half - shift)),
cos||sin when ``flip_sin_to_cos``)."""

from __future__ import annotations

import math

import torch


def embedding_lookup(token_ids: torch.Tensor, params: dict) -> torch.Tensor:
    """(B, L) int ids -> (B, L, D) rows of the table."""
    return params["weight"][token_ids.long()]


def init_embedding(
    gen: torch.Generator, num_embeddings: int, features: int
) -> dict:
    """N(0, 0.02^2) table.  Float32 whatever the parameter dtype, as the JAX
    package's host-side init leaves it."""
    w = torch.randn(
        (num_embeddings, features), generator=gen, device=gen.device,
        dtype=torch.float32,
    )
    return {"weight": w * 0.02}


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
