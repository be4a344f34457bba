"""2-D convolutions on NHWC activations with HWIO kernels.

Counterpart of ``sdtpu/ops/conv.py``.  ``conv2d`` is the plain convolution
the JAX package leaves to XLA (conv_in/conv_out, the stride-2 downsamples,
the VAE's 1x1 convs), and with ``impl="gemm"`` the JAX package's kernel
route for 3x3 same-pad convs (kernel E, else the slab kernel without
prologue); ``nearest_up_conv2d`` is the up-block's nearest-2x + 3x3 conv,
which goes through the slab kernel's fused upsample mode
(``kernels/conv2d.py``) where the slab shape rule accepts it.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

from sdtpu_torch.kernels.conv2d import conv3x3_gemm, conv3x3_slab, plan_co_tile
from sdtpu_torch.ops.linear import uniform
from sdtpu_torch.ops.resize import nearest_upsample
from sdtpu_torch.utils import hostrng
from sdtpu_torch.utils.quant import slab_plan_ok

Padding = Union[int, Tuple[Tuple[int, int], Tuple[int, int]]]


def conv2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias=None,
    *,
    stride: Union[int, Tuple[int, int]] = 1,
    padding: Padding = 0,
    impl: str = "xla",
) -> torch.Tensor:
    """NHWC conv; ``padding`` is a symmetric int or explicit
    ``((top, bottom), (left, right))`` (the VAE encoder's asymmetric
    ``((0, 1), (0, 1))`` stride-2 pad).

    ``impl="gemm"`` routes a 3x3 stride-1 pad-1 conv as
    ``sdtpu/ops/conv.py:44-63`` does: to kernel E where the JAX package's
    ``plan_co_tile`` accepts the shape, else to the slab kernel without
    prologue where the slab shape rule accepts it, else to ``F.conv2d``.
    ``impl="xla"`` (the default) always takes ``F.conv2d``."""
    if impl not in ("xla", "gemm"):
        raise ValueError(f"conv2d: unknown impl {impl!r} (expected 'xla' or 'gemm')")
    if isinstance(stride, int):
        stride = (stride, stride)
    if isinstance(padding, int):
        padding = ((padding, padding), (padding, padding))
    if (impl == "gemm" and stride == (1, 1) and tuple(kernel.shape[:2]) == (3, 3)
            and padding == ((1, 1), (1, 1))):
        co_tile = plan_co_tile(x.shape, kernel.shape)
        if co_tile is not None:
            return conv3x3_gemm(x, kernel.to(x.dtype), bias, co_tile=co_tile)
        if slab_plan_ok(x.shape, kernel.shape):
            return conv3x3_slab(x, kernel.to(x.dtype), bias)
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
    x: torch.Tensor, kernel: torch.Tensor, bias=None, *, emit_stats: bool = False,
    impl: str = "gemm",
):
    """Nearest-2x upsample + 3x3 same-pad conv, fused with ``impl="gemm"``
    where the slab shape rule accepts the upsampled map: only the small map
    is read.  ``emit_stats=True`` returns ``(out, moments)`` for the
    consumer GroupNorm.  Elsewhere upsample, then :func:`conv2d` with
    ``impl``, with ``(out, None)`` under ``emit_stats``, as
    ``sdtpu/ops/conv.py:98-120``.
    The JAX package also wants an even row tile there, a limit of the TPU
    kernel's VMEM slabs that this kernel does not have."""
    b, h, w, ci = x.shape
    if impl == "gemm" and slab_plan_ok((b, 2 * h, 2 * w, ci), kernel.shape):
        return conv3x3_slab(x, kernel, bias, upsample=True, emit_stats=emit_stats)
    out = conv2d(nearest_upsample(x, 2), kernel, bias, padding=1, impl=impl)
    return (out, None) if emit_stats else out


def conv1x1_tokens(x: torch.Tensor, params: dict) -> torch.Tensor:
    """A 1x1 conv as a token matmul: (B, H, W, Ci) -> (B, H, W, Co)."""
    b, h, w, ci = x.shape
    kernel = params["kernel"][0, 0]
    out = x.reshape(b, h * w, ci) @ kernel.to(x.dtype)
    out = out + params["bias"].to(out.dtype)
    return out.reshape(b, h, w, kernel.shape[-1])


def init_conv2d(
    key,
    in_channels: int,
    out_channels: int,
    kernel_size: int = 3,
    *,
    dtype=torch.float32,
) -> dict:
    """Fan-in uniform init U(-1/sqrt(k), 1/sqrt(k)), k = in * kh * kw, from
    the key's two children as in the JAX package."""
    bound = (in_channels * kernel_size * kernel_size) ** -0.5
    k_key, b_key = hostrng.split(key)
    return {
        "kernel": uniform(k_key, (kernel_size, kernel_size, in_channels, out_channels),
                          dtype, bound),
        "bias": uniform(b_key, (out_channels,), dtype, bound),
    }
