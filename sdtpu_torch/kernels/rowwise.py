"""The transformer block's float32 row chains as one pass each: LayerNorm and
the feed-forward's bias + GeGLU gate.

* ``layer_norm_rows(x, scale, bias, eps)``: last-axis LayerNorm, the mean
  and the centred two-pass variance in float32, the float32 affine, one
  cast to x's dtype (``ops/norm.py:layer_norm``, CLIP's LayerNorms).
* ``geglu_rows(h, bias)``: ``h`` the feed-forward projection's product
  before its bias, ``(value, gate)`` the two halves of its last axis;
  ``value * GELU_erf(gate)`` after the bias (``transformer_block``).

Neither replaces a TPU kernel: XLA fuses both chains in the JAX program.
Eager PyTorch runs them as 14 and 9 kernels over float32 intermediates;
``csrc/rowwise.cu`` reads the activations once and writes them once, with
the eager code's roundings (the plain versions below are that code).  On
the CPU each wrapper runs its plain version; on the card it launches its
kernel (counted in ``launch_counts``) or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from sdtpu_torch.kernels import _build, launch_counts
from sdtpu_torch.kernels.flash_attention import _on_cpu

MAX_C = 2048  # the widest LayerNorm row (csrc/rowwise.cu: MAX_C)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernels' dtype codes


def layer_norm_rows_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          eps: float) -> torch.Tensor:
    """Last-axis LayerNorm with per-feature affine, statistics in float32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    out = xf * scale.float() + bias.float()
    return out.to(x.dtype)


def geglu_rows_plain(h: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``h + bias`` in h's dtype, split into (value, gate) halves of the last
    axis; value * GELU_erf(gate), the GELU in float32 and cast back."""
    if bias is not None:
        h = h + bias.to(h.dtype)
    value, gate = torch.chunk(h, 2, dim=-1)
    gf = gate.float()
    return value * (gf * 0.5 * (1.0 + torch.erf(gf / 2.0**0.5))).to(h.dtype)


def _lib():
    lib = _build.load("rowwise")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.layer_norm_rows_launch.argtypes = [p] * 4 + [i, i, ctypes.c_float, i, i, p]
        lib.layer_norm_rows_launch.restype = i
        lib.geglu_rows_launch.argtypes = [p] * 3 + [i] * 4 + [p]
        lib.geglu_rows_launch.restype = i
        lib.rowwise_max_c.argtypes = []
        lib.rowwise_max_c.restype = i
        if lib.rowwise_max_c() != MAX_C:
            raise RuntimeError(f"rowwise.cu takes rows up to {lib.rowwise_max_c()} wide, "
                               f"kernels/rowwise.py assumes {MAX_C}")
        lib._typed = True
    return lib


def _check(what: str, name: str, t: torch.Tensor, device) -> None:
    if (t.device != device or t.dtype not in _DTYPES or not t.is_contiguous()
            or t.data_ptr() % 16):
        raise ValueError(f"{what}: {name} must be contiguous float32 or bf16, 16-byte aligned, "
                         f"on {device}; got {t.dtype} on {t.device}"
                         f"{'' if t.is_contiguous() else ', not contiguous'}")


def layer_norm_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over x's last axis (C), scale and bias (C,) -> x's shape
    and dtype.

    On the card: x contiguous float32 or bf16, C a multiple of 8 and at most
    MAX_C; scale and bias float32 or bf16."""
    if _on_cpu("layer_norm_rows", x):
        return layer_norm_rows_plain(x, scale, bias, eps)
    c = x.shape[-1]
    _check("layer_norm_rows", "x", x, x.device)
    for name, t in (("scale", scale), ("bias", bias)):
        _check("layer_norm_rows", name, t, x.device)
        if tuple(t.shape) != (c,) or t.dtype != scale.dtype:
            raise ValueError(f"layer_norm_rows: {name} must be ({c},) of scale's dtype, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if c % 8 or c > MAX_C:
        raise ValueError(f"layer_norm_rows: width {c} must be a multiple of 8, at most {MAX_C}")
    out = torch.empty_like(x)
    rows = x.numel() // c
    if rows == 0:
        return out
    err = _lib().layer_norm_rows_launch(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), rows, c, eps,
        _DTYPES[x.dtype], _DTYPES[scale.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "layer_norm_rows")
    launch_counts["layer_norm_rows"] += 1
    return out


def geglu_rows(h: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h (..., 2F) and bias (2F,) or None -> (..., F) in h's dtype:
    ``value * GELU_erf(gate)`` of ``h + bias``'s two halves.

    On the card: h contiguous float32 or bf16, F a multiple of 8, fewer
    than 2^31 output values; the bias float32 or bf16 (rounded to h's dtype
    before the add, as the eager add rounds it)."""
    if _on_cpu("geglu_rows", h):
        return geglu_rows_plain(h, bias)
    two_f = h.shape[-1]
    _check("geglu_rows", "h", h, h.device)
    if bias is not None:
        _check("geglu_rows", "bias", bias, h.device)
        if tuple(bias.shape) != (two_f,):
            raise ValueError(f"geglu_rows: bias must be ({two_f},), got {tuple(bias.shape)}")
    if two_f % 16 or h.numel() // 2 >= 2**31:
        raise ValueError(f"geglu_rows: width {two_f} must be twice a multiple of 8, the "
                         f"output under 2^31 values, got {h.numel() // 2}")
    f = two_f // 2
    out = torch.empty((*h.shape[:-1], f), dtype=h.dtype, device=h.device)
    rows = h.numel() // two_f
    if rows == 0:
        return out
    err = _lib().geglu_rows_launch(
        h.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(), rows, f,
        _DTYPES[h.dtype], 0 if bias is None else _DTYPES[bias.dtype],
        torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(err, "geglu_rows")
    launch_counts["geglu_rows"] += 1
    return out
