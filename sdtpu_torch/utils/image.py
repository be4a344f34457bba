"""Image conversion between [-1, 1] floats and uint8."""

from __future__ import annotations

import numpy as np
import torch


def to_uint8(images):
    """(-1, 1) float images -> clamped, rounded (half to even) uint8.  A
    tensor stays a tensor on its device; anything else becomes numpy."""
    if isinstance(images, torch.Tensor):
        arr = (images.float() + 1.0) * 127.5
        return torch.clamp(torch.round(arr), 0, 255).to(torch.uint8)
    arr = (np.asarray(images, dtype=np.float32) + 1.0) * 127.5
    return np.clip(np.round(arr), 0, 255).astype(np.uint8)


def from_uint8(images) -> np.ndarray:
    """uint8 [0, 255] -> float32 (-1, 1)."""
    return np.asarray(images, dtype=np.float32) / 127.5 - 1.0
