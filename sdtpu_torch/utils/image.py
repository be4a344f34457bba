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


def psnr(a, b, *, data_range: float = 2.0) -> float:
    """Peak signal-to-noise ratio in dB (range 2.0 for [-1, 1] images), in
    float64 on the host."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))
