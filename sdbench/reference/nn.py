"""Plain float32 building blocks of the reference, over the parameter trees
the benchmark makes (NHWC activations, HWIO conv kernels, (in, out) linear
kernels, norms as ``{"scale", "bias"}``).

Every product goes through an :class:`Ops` object.  ``Ops()`` computes in
float32 (the caller turns TF32 off); ``Ops(lowp="fp8")`` is the control:
each operand of every matmul and convolution is first rounded to
float8 e4m3 with a per-tensor scale (amax / 448), the precision one step
below the configurations' bfloat16.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-12) / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Ops:
    """Matmuls and convolutions in float32, or with fp8-rounded operands."""

    def __init__(self, lowp: str = "f32"):
        if lowp not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {lowp!r}")
        self.lowp = lowp

    def q(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return _fp8(x) if self.lowp == "fp8" else x

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.q(a), self.q(b))

    def linear(self, x: torch.Tensor, p: dict) -> torch.Tensor:
        out = self.matmul(x, p["kernel"])
        if "bias" in p:
            out = out + p["bias"].float()
        return out

    def conv(self, x: torch.Tensor, p: dict, *, stride: int = 1, padding=1) -> torch.Tensor:
        """NHWC conv with an HWIO kernel; ``padding`` an int or
        ((top, bottom), (left, right))."""
        k = p["kernel"]
        xc = self.q(x).permute(0, 3, 1, 2)
        if isinstance(padding, int):
            pad = padding
        else:
            (top, bottom), (left, right) = padding
            xc = F.pad(xc, (left, right, top, bottom))
            pad = 0
        out = F.conv2d(xc, self.q(k).permute(3, 2, 0, 1), stride=stride, padding=pad)
        out = out.permute(0, 2, 3, 1)
        if "bias" in p:
            out = out + p["bias"].float()
        return out


def group_norm(x: torch.Tensor, p: dict, groups: int, eps: float) -> torch.Tensor:
    n, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(n, -1, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    xf = ((xf - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    return xf * p["scale"].float() + p["bias"].float()


def layer_norm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p["scale"].float() + p["bias"].float()


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def timestep_embedding(t: torch.Tensor, dim: int, *, flip_sin_to_cos: bool,
                       freq_shift: float, max_period: float = 10000.0) -> torch.Tensor:
    """diffusers' sinusoidal embedding of (N,) timesteps -> (N, dim)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=t.device) / (half - freq_shift)
    args = t.float()[:, None] * torch.exp(exponent)[None]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


def attention(ops: Ops, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, *,
              causal: bool = False, block: int = 4096) -> torch.Tensor:
    """Softmax attention of (B, Lq, D) against (B, Lk, D) with ``heads``
    heads, in blocks of query rows so that the scores fit."""
    b, lq, d = q.shape
    lk = k.shape[1]
    hd = d // heads
    qh = q.reshape(b, lq, heads, hd).transpose(1, 2)
    kh = k.reshape(b, lk, heads, hd).transpose(1, 2)
    vh = v.reshape(b, lk, heads, hd).transpose(1, 2)
    out = torch.empty_like(qh, dtype=torch.float32)
    scale = hd ** -0.5
    for s in range(0, lq, block):
        scores = ops.matmul(qh[:, :, s:s + block], kh.transpose(-1, -2)) * scale
        if causal:
            rows = torch.arange(s, min(s + block, lq), device=q.device)[:, None]
            cols = torch.arange(lk, device=q.device)[None]
            scores = scores.masked_fill(cols > rows, float("-inf"))
        out[:, :, s:s + block] = ops.matmul(torch.softmax(scores, dim=-1), vh)
    return out.transpose(1, 2).reshape(b, lq, d)
