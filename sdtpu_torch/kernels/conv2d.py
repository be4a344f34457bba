"""3x3 same-pad convolution with a fused GroupNorm(+temb)+SiLU prologue,
bias + residual epilogue, optional output moments, and an optional fused
nearest-2x upsample of the input.

Counterpart of ``sdtpu/kernels/conv2d.py:conv3x3_gemm_slab`` and
``gn_silu_conv3x3_slab``.  On the card ``conv3x3_slab`` launches the CUDA
kernel of ``csrc/conv3x3_slab.cu``; on the CPU it runs
``conv3x3_slab_plain``, the same function in float32 with the same bf16
rounding points:

* the prologue output is rounded to the activation dtype, and the conv's
  zero padding comes AFTER the prologue (a pad pixel is 0, not SiLU(b));
* accumulation is float32, then bias, then residual, then the cast;
* the moments are the per-channel mean and mean-of-squares of the CAST
  output over (H, W).

Layouts are the JAX package's: NHWC activations, HWIO kernels.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sdtpu_torch.kernels import _build, launch_counts


def conv3x3_slab_plain(
    x: torch.Tensor,
    kernel: torch.Tensor,
    conv_bias=None,
    *,
    prologue_scale=None,
    prologue_bias=None,
    residual=None,
    upsample: bool = False,
    emit_stats: bool = False,
):
    """The plain PyTorch version of the kernel (see the module docstring)."""
    if prologue_scale is not None:
        y = x.float() * prologue_scale.float()[:, None, None, :]
        y = y + prologue_bias.float()[:, None, None, :]
        y = (y * torch.sigmoid(y)).to(x.dtype)
    else:
        y = x
    if upsample:
        y = y.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    acc = F.conv2d(
        y.float().permute(0, 3, 1, 2), kernel.float().permute(3, 2, 0, 1),
        padding=1,
    ).permute(0, 2, 3, 1)
    if conv_bias is not None:
        acc = acc + conv_bias.float()
    if residual is not None:
        acc = acc + residual.float()
    out = acc.to(x.dtype)
    if not emit_stats:
        return out
    of = out.float()
    return out, torch.stack([of.mean(dim=(1, 2)), of.square().mean(dim=(1, 2))], dim=1)


def _lib():
    lib = _build.load("conv3x3_slab")
    if not getattr(lib, "_typed", False):
        p = ctypes.c_void_p
        lib.conv3x3_slab_launch.argtypes = [p] * 8 + [ctypes.c_int] * 6 + [p]
        lib.conv3x3_slab_launch.restype = ctypes.c_int
        lib.conv3x3_slab_m_tiles.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.conv3x3_slab_m_tiles.restype = ctypes.c_int
        lib._typed = True
    return lib


def _expect(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"conv3x3_slab: {name} must be {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"conv3x3_slab: {name} must be contiguous")


def conv3x3_slab(
    x: torch.Tensor,
    kernel: torch.Tensor,
    conv_bias=None,
    *,
    prologue_scale=None,
    prologue_bias=None,
    residual=None,
    upsample: bool = False,
    emit_stats: bool = False,
):
    """NHWC stride-1 same-pad 3x3 conv (+bias) (+residual) with an optional
    per-(batch, channel) affine + SiLU prologue on the input.

    x: (B, H, W, Ci), or the small (B, H/2, W/2, Ci) map when ``upsample``;
    kernel: (3, 3, Ci, Co); prologue_scale/bias: (B, Ci); residual:
    (B, H, W, Co).  ``emit_stats=True`` returns ``(out, moments)`` with
    moments (B, 2, Co) f32 = per-channel [mean, mean-of-squares] of the
    output.  On the card every tensor must be contiguous, x, kernel and
    residual bf16, Ci and Co multiples of 8."""
    kw = dict(prologue_scale=prologue_scale, prologue_bias=prologue_bias,
              residual=residual, upsample=upsample, emit_stats=emit_stats)
    if x.device.type == "cpu":
        return conv3x3_slab_plain(x, kernel, conv_bias, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_slab: unsupported device {x.device}")
    dev = x.device
    b, hx, wx, ci = x.shape
    h, w = (2 * hx, 2 * wx) if upsample else (hx, wx)
    co = kernel.shape[-1]
    if ci % 8 or co % 8:
        raise ValueError(f"conv3x3_slab: Ci={ci} and Co={co} must be multiples of 8")
    _expect(x, "x", (b, hx, wx, ci), torch.bfloat16, dev)
    _expect(kernel, "kernel", (3, 3, ci, co), torch.bfloat16, dev)
    bias = (torch.zeros(co, device=dev, dtype=torch.float32) if conv_bias is None
            else conv_bias.float().contiguous())
    _expect(bias, "conv_bias", (co,), torch.float32, dev)
    if (prologue_scale is None) != (prologue_bias is None):
        raise ValueError("conv3x3_slab: give both prologue_scale and prologue_bias")
    pa = pc = None
    if prologue_scale is not None:
        pa = prologue_scale.float().contiguous()
        pc = prologue_bias.float().contiguous()
        _expect(pa, "prologue_scale", (b, ci), torch.float32, dev)
        _expect(pc, "prologue_bias", (b, ci), torch.float32, dev)
    if residual is not None:
        _expect(residual, "residual", (b, h, w, co), torch.bfloat16, dev)
    lib = _lib()
    out = torch.empty((b, h, w, co), device=dev, dtype=torch.bfloat16)
    part = None
    if emit_stats:
        part = torch.empty((b, lib.conv3x3_slab_m_tiles(h, w), 2, co),
                           device=dev, dtype=torch.float32)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = lib.conv3x3_slab_launch(
        ptr(x), ptr(kernel), ptr(bias), ptr(pa), ptr(pc), ptr(residual),
        ptr(out), ptr(part), b, h, w, ci, co, int(upsample),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "conv3x3_slab")
    launch_counts["conv3x3_slab_upsample" if upsample else "conv3x3_slab"] += 1
    if not emit_stats:
        return out
    return out, part.sum(dim=1) / float(h * w)


def gn_silu_conv3x3_slab(
    x: torch.Tensor,
    norm_params: dict,
    kernel: torch.Tensor,
    conv_bias=None,
    *,
    num_groups: int = 32,
    eps: float = 1e-5,
    temb=None,
    residual=None,
    stats=None,
    emit_stats: bool = False,
):
    """(x [+ temb]) -> GroupNorm -> SiLU -> 3x3 conv (+bias) (+residual).

    The group statistics and the folded per-(batch, channel) affine
    GN(x + t) = x * (inv * gamma) + ((t - mu) * inv * gamma + beta) are
    computed here in plain torch exactly as the JAX package computes them
    (``stats`` given: from the producer's moments with the temb fold
    E[(x+t)^2] = E[x^2] + 2tE[x] + t^2 and the variance clamped at 0;
    otherwise E[x^2] - mean^2 from the map, unclamped); the kernel applies
    the affine + SiLU on its input load."""
    b, h, w, ci = x.shape
    cpg = ci // num_groups
    t = None if temb is None else temb.float()
    if stats is not None:
        m1 = stats[:, 0].float()
        m2 = stats[:, 1].float()
        if t is not None:
            m2 = m2 + 2.0 * t * m1 + t.square()
            m1 = m1 + t
        mean = m1.reshape(b, num_groups, cpg).mean(dim=2)
        ex2 = m2.reshape(b, num_groups, cpg).mean(dim=2)
        var = torch.clamp(ex2 - mean.square(), min=0.0)
    else:
        xf = x.float()
        if t is not None:
            xf = xf + t[:, None, None, :]
        xg = xf.reshape(b, h * w, num_groups, cpg)
        mean = xg.mean(dim=(1, 3))
        var = xg.square().mean(dim=(1, 3)) - mean.square()
    inv = torch.rsqrt(var + eps)
    invc = inv.repeat_interleave(cpg, dim=1)
    muc = mean.repeat_interleave(cpg, dim=1)
    a = invc * norm_params["scale"].float()[None]
    off = -muc if t is None else t - muc
    bb = off * a + norm_params["bias"].float()[None]
    return conv3x3_slab(
        x, kernel, conv_bias, prologue_scale=a, prologue_bias=bb,
        residual=residual, emit_stats=emit_stats,
    )
