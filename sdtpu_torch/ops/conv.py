"""2-D convolutions on NHWC activations with HWIO kernels.

Counterpart of ``sdtpu/ops/conv.py``.  ``conv2d`` is the plain convolution
the JAX package leaves to XLA (conv_in/conv_out, the stride-2 downsamples,
the VAE's 1x1 convs); ``nearest_up_conv2d`` is the up-block's
nearest-2x + 3x3 conv, which goes through the slab kernel's fused upsample
mode (``kernels/conv2d.py``).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

from sdtpu_torch.kernels.conv2d import conv3x3_slab
from sdtpu_torch.ops.linear import uniform

Padding = Union[int, Tuple[Tuple[int, int], Tuple[int, int]]]


def conv2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias=None,
    *,
    stride: Union[int, Tuple[int, int]] = 1,
    padding: Padding = 0,
) -> torch.Tensor:
    """NHWC conv; ``padding`` is a symmetric int or explicit
    ``((top, bottom), (left, right))`` (the VAE encoder's asymmetric
    ``((0, 1), (0, 1))`` stride-2 pad)."""
    if isinstance(stride, int):
        stride = (stride, stride)
    if isinstance(padding, int):
        padding = ((padding, padding), (padding, padding))
    (top, bottom), (left, right) = padding
    xc = x.permute(0, 3, 1, 2)
    if (top, left) == (bottom, right):
        pad = (top, left)
    else:
        xc = F.pad(xc, (left, right, top, bottom))
        pad = (0, 0)
    out = F.conv2d(xc, kernel.to(x.dtype).permute(3, 2, 0, 1), stride=stride, padding=pad)
    out = out.permute(0, 2, 3, 1).contiguous()
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def nearest_up_conv2d(
    x: torch.Tensor, kernel: torch.Tensor, bias=None, *, emit_stats: bool = False
):
    """Nearest-2x upsample + 3x3 same-pad conv, fused: only the small map is
    read.  ``emit_stats=True`` returns ``(out, moments)`` for the consumer
    GroupNorm."""
    return conv3x3_slab(x, kernel, bias, upsample=True, emit_stats=emit_stats)


def conv1x1_tokens(x: torch.Tensor, params: dict) -> torch.Tensor:
    """A 1x1 conv as a token matmul: (B, H, W, Ci) -> (B, H, W, Co)."""
    b, h, w, ci = x.shape
    kernel = params["kernel"][0, 0]
    out = x.reshape(b, h * w, ci) @ kernel.to(x.dtype)
    out = out + params["bias"].to(out.dtype)
    return out.reshape(b, h, w, kernel.shape[-1])


def init_conv2d(
    gen: torch.Generator,
    in_channels: int,
    out_channels: int,
    kernel_size: int = 3,
    *,
    dtype=torch.float32,
) -> dict:
    """Fan-in uniform init U(-1/sqrt(k), 1/sqrt(k)), k = in * kh * kw."""
    bound = (in_channels * kernel_size * kernel_size) ** -0.5
    return {
        "kernel": uniform(gen, (kernel_size, kernel_size, in_channels, out_channels),
                          dtype, bound),
        "bias": uniform(gen, (out_channels,), dtype, bound),
    }
