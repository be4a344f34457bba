"""Nearest-neighbour resizing of NHWC maps: the 2x upsampling of the
up-blocks and ``resize_image``, the pre-resize of an img2img request's init
image (``sdtpu/ops/resize.py``)."""

from __future__ import annotations

import torch


def nearest_upsample(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """(N, H, W, C) -> (N, H*scale, W*scale, C) by repetition."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, scale, w, scale, c)
    return x.reshape(n, h * scale, w * scale, c)


def resize_image(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Nearest-neighbour resize of an (H, W, C) or (N, H, W, C) image: output
    row r reads input row min(r * h // height, h - 1), and columns alike."""
    batched = image.ndim == 4
    if not batched:
        image = image[None]
    _, h, w, _ = image.shape
    rows = torch.clamp(torch.arange(height, device=image.device) * h // height, 0, h - 1)
    cols = torch.clamp(torch.arange(width, device=image.device) * w // width, 0, w - 1)
    out = image[:, rows][:, :, cols]
    return out if batched else out[0]
