"""Nearest-neighbour 2x spatial upsampling of an NHWC map."""

from __future__ import annotations

import torch


def nearest_upsample(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """(N, H, W, C) -> (N, H*scale, W*scale, C) by repetition."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, scale, w, scale, c)
    return x.reshape(n, h * scale, w * scale, c)
