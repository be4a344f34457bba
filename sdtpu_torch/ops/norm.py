"""GroupNorm and LayerNorm with float32 statistics.

Counterpart of ``sdtpu/ops/norm.py``.  ``group_norm`` takes optional
producer ``stats`` (per-channel [mean, mean-of-squares], the slab conv's
``emit_stats`` output) and then derives the group variance as
E[x^2] - mean^2 clamped at 0; without stats it is the two-pass
mean((x - mean)^2).  ``layer_norm`` is the last-axis reduction form, one
kernel on the card (``kernels/rowwise.py``).
"""

from __future__ import annotations

import torch

from sdtpu_torch.kernels.rowwise import layer_norm_rows


def group_norm(
    x: torch.Tensor,
    params: dict,
    *,
    num_groups: int = 32,
    eps: float = 1e-5,
    stats=None,
) -> torch.Tensor:
    """x: (N, H, W, C) or (N, L, C); normalizes over (spatial, C/G)."""
    n, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    cpg = c // num_groups
    xf = x.float().reshape(n, -1, num_groups, cpg)
    if stats is not None:
        m1 = stats[:, 0].float().reshape(n, 1, num_groups, cpg)
        m2 = stats[:, 1].float().reshape(n, 1, num_groups, cpg)
        mean = m1.mean(dim=3, keepdim=True)
        var = torch.clamp(m2.mean(dim=3, keepdim=True) - mean.square(), min=0.0)
    else:
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    xf = xf.reshape(x.shape)
    out = xf * params["scale"].float() + params["bias"].float()
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, params: dict, *, eps: float = 1e-5) -> torch.Tensor:
    """Last-axis LayerNorm with per-feature affine, statistics in float32
    (``kernels/rowwise.py:layer_norm_rows``: one pass on the card)."""
    return layer_norm_rows(x, params["scale"], params["bias"], eps)


def init_norm(num_channels: int, *, dtype=torch.float32) -> dict:
    """Unit scale, zero bias (GroupNorm and LayerNorm alike), on the CPU."""
    return {
        "scale": torch.ones((num_channels,), dtype=dtype),
        "bias": torch.zeros((num_channels,), dtype=dtype),
    }
