"""Activations: SiLU, GELU (tanh and erf forms), QuickGELU and GeGLU.

Counterpart of ``sdtpu/ops/activations.py``: the GELU forms compute in
float32 and cast back, as the JAX package does.
"""

from __future__ import annotations

import torch

from sdtpu_torch.kernels.rowwise import geglu_rows

_GELU_C = 0.7978845608028654  # sqrt(2/pi)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU, written out as the canonical formula."""
    xf = x.float()
    out = 0.5 * xf * (1.0 + torch.tanh(_GELU_C * (xf + 0.044715 * xf * xf * xf)))
    return out.to(x.dtype)


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU in float32: the form diffusers' GEGLU gate and HF
    CLIP's "gelu" use."""
    xf = x.float()
    return (xf * 0.5 * (1.0 + torch.erf(xf / 2.0**0.5))).to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x), CLIP's activation."""
    return x * torch.sigmoid(1.702 * x)


def geglu(x: torch.Tensor) -> torch.Tensor:
    """Split the 8x projection into (value, gate); value * GELU_erf(gate)
    (``kernels/rowwise.py:geglu_rows``: one pass on the card)."""
    return geglu_rows(x)
