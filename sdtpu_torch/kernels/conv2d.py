"""3x3 same-pad convolution with a fused GroupNorm(+temb)+SiLU prologue,
bias + residual epilogue, optional output moments, and an optional fused
nearest-2x upsample of the input; with an int8 kernel, its W8A8 form; and
the plain whole-map 3x3 conv of the ``conv2d(impl="gemm")`` route (kernel
E, ``conv3x3_gemm``, at the end of this module).

Counterpart of ``sdtpu/kernels/conv2d.py:conv3x3_gemm_slab`` and
``gn_silu_conv3x3_slab``.  On the card ``conv3x3_slab`` launches the CUDA
kernel of ``csrc/conv3x3_slab.cu`` (float) or ``csrc/conv3x3_slab_int8.cu``
(int8 kernel); on the CPU it runs ``conv3x3_slab_plain``, the same function
with the same rounding points.  Float kernel:

* the prologue output is rounded to the activation dtype, and the conv's
  zero padding comes AFTER the prologue (a pad pixel is 0, not SiLU(b));
* accumulation is float32, then bias, then residual, then the cast;
* the moments are the per-channel mean and mean-of-squares of the CAST
  output over (H, W).

int8 kernel (``act_inv_scale``, ``act_zp`` and ``w_scale`` given; the
prologue is required and the upsample mode is not taken):

* the float32 prologue output, NOT rounded to the activation dtype, is
  quantized per input channel, ``q = clamp(round(y * act_inv_scale) + zp,
  -128, 127)``, rounding half to even;
* a pad pixel holds the zero point (the real value 0), not integer 0;
* the contraction is an exact integer sum; the plain version takes it in
  float64, where every partial sum of these magnitudes is exact;
* float32(acc) * w_scale[co], then bias (the caller's bias minus the
  zero-point correction), then residual, then the cast; moments as above.

Layouts are the JAX package's: NHWC activations, HWIO kernels.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sdtpu_torch.kernels import _build, launch_counts


def _check_int8_args(kernel, prologue_scale, upsample, act_inv_scale, w_scale) -> bool:
    """Whether this is the W8A8 form; raises on what it does not take."""
    if kernel.dtype != torch.int8:
        return False
    if prologue_scale is None:
        raise ValueError("conv3x3_slab: the int8 conv requires the affine prologue")
    if upsample:
        raise ValueError("conv3x3_slab: the int8 conv has no upsample mode")
    if act_inv_scale is None or w_scale is None:
        raise ValueError("conv3x3_slab: an int8 kernel needs act_inv_scale and w_scale")
    return True


def _moments(out: torch.Tensor) -> torch.Tensor:
    of = out.float()
    return torch.stack([of.mean(dim=(1, 2)), of.square().mean(dim=(1, 2))], dim=1)


def _conv3x3_int8_plain(x, kernel, conv_bias, a, c, s, z, w_scale, residual, emit_stats):
    ci = x.shape[-1]
    z = torch.zeros(ci, device=x.device) if z is None else z.float()
    y = x.float() * a.float()[:, None, None, :]
    y = y + c.float()[:, None, None, :]
    y = y * torch.sigmoid(y)
    q = torch.clamp(torch.round(y * s.float()) + z, -128.0, 127.0)
    zc = z.double()[None, :, None, None]
    # the pad holds the zero point: pad q - z with 0, then add z back
    qp = F.pad((q.double().permute(0, 3, 1, 2) - zc), (1, 1, 1, 1)) + zc
    acc = F.conv2d(qp, kernel.double().permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    out = acc.float() * w_scale.float()
    if conv_bias is not None:
        out = out + conv_bias.float()
    if residual is not None:
        out = out + residual.float()
    out = out.to(x.dtype)
    return (out, _moments(out)) if emit_stats else out


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
    act_inv_scale=None,
    act_zp=None,
    w_scale=None,
):
    """The plain PyTorch version of the kernel (see the module docstring)."""
    if _check_int8_args(kernel, prologue_scale, upsample, act_inv_scale, w_scale):
        return _conv3x3_int8_plain(x, kernel, conv_bias, prologue_scale, prologue_bias,
                                   act_inv_scale, act_zp, w_scale, residual, emit_stats)
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
    return (out, _moments(out)) if emit_stats else out


# pointer and int arguments of each source's launch function, before the stream
_LAUNCH_ARGS = {"conv3x3_slab": (8, 6), "conv3x3_slab_int8": (11, 5)}


def _lib(name: str):
    """The library of ``csrc/<name>.cu`` with its two functions typed."""
    lib = _build.load(name)
    if not getattr(lib, "_typed", False):
        p = ctypes.c_void_p
        n_ptrs, n_ints = _LAUNCH_ARGS[name]
        launch, m_tiles = getattr(lib, name + "_launch"), getattr(lib, name + "_m_tiles")
        launch.argtypes = [p] * n_ptrs + [ctypes.c_int] * n_ints + [p]
        launch.restype = ctypes.c_int
        m_tiles.argtypes = [ctypes.c_int, ctypes.c_int]
        m_tiles.restype = ctypes.c_int
        if name == "conv3x3_slab":  # kernel E's entry in the same library
            lib.conv3x3_gemm_launch.argtypes = [p] * 3 + [ctypes.c_int] * 5 + [p]
            lib.conv3x3_gemm_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _expect(t: torch.Tensor, name: str, shape, dtype, device, what="conv3x3_slab") -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{what}: {name} must be {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")


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
    act_inv_scale=None,
    act_zp=None,
    w_scale=None,
):
    """NHWC stride-1 same-pad 3x3 conv (+bias) (+residual) with an optional
    per-(batch, channel) affine + SiLU prologue on the input.

    x: (B, H, W, Ci), or the small (B, H/2, W/2, Ci) map when ``upsample``;
    kernel: (3, 3, Ci, Co); prologue_scale/bias: (B, Ci); residual:
    (B, H, W, Co).  ``emit_stats=True`` returns ``(out, moments)`` with
    moments (B, 2, Co) f32 = per-channel [mean, mean-of-squares] of the
    output.  An int8 kernel takes the W8A8 form with ``act_inv_scale`` and
    ``act_zp`` (Ci,) and ``w_scale`` (Co,).  On the card every tensor must
    be contiguous, x and residual bf16, the kernel bf16 or int8, Ci and Co
    multiples of 8, and Ci a multiple of 32 for an int8 kernel."""
    if x.device.type == "cpu":
        return conv3x3_slab_plain(
            x, kernel, conv_bias, prologue_scale=prologue_scale, prologue_bias=prologue_bias,
            residual=residual, upsample=upsample, emit_stats=emit_stats,
            act_inv_scale=act_inv_scale, act_zp=act_zp, w_scale=w_scale)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_slab: unsupported device {x.device}")
    quant = _check_int8_args(kernel, prologue_scale, upsample, act_inv_scale, w_scale)
    dev = x.device
    b, hx, wx, ci = x.shape
    h, w = (2 * hx, 2 * wx) if upsample else (hx, wx)
    co = kernel.shape[-1]
    if ci % 8 or co % 8:
        raise ValueError(f"conv3x3_slab: Ci={ci} and Co={co} must be multiples of 8")
    if quant and ci % 32:
        raise ValueError(f"conv3x3_slab: the int8 conv needs Ci={ci} a multiple of 32")
    _expect(x, "x", (b, hx, wx, ci), torch.bfloat16, dev)
    _expect(kernel, "kernel", (3, 3, ci, co), torch.int8 if quant else torch.bfloat16, dev)

    def f32(t, name, shape):
        t = t.float().contiguous()
        _expect(t, name, shape, torch.float32, dev)
        return t

    bias = f32(torch.zeros(co, device=dev) if conv_bias is None else conv_bias,
               "conv_bias", (co,))
    if (prologue_scale is None) != (prologue_bias is None):
        raise ValueError("conv3x3_slab: give both prologue_scale and prologue_bias")
    pa = pc = None
    if prologue_scale is not None:
        pa = f32(prologue_scale, "prologue_scale", (b, ci))
        pc = f32(prologue_bias, "prologue_bias", (b, ci))
    if residual is not None:
        _expect(residual, "residual", (b, h, w, co), torch.bfloat16, dev)
    name = "conv3x3_slab_int8" if quant else "conv3x3_slab"
    lib = _lib(name)
    out = torch.empty((b, h, w, co), device=dev, dtype=torch.bfloat16)
    part = None
    if emit_stats:
        part = torch.empty((b, getattr(lib, name + "_m_tiles")(h, w), 2, co),
                           device=dev, dtype=torch.float32)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    if quant:
        qs = f32(act_inv_scale, "act_inv_scale", (ci,))
        qz = f32(torch.zeros(ci, device=dev) if act_zp is None else act_zp, "act_zp", (ci,))
        ws = f32(w_scale, "w_scale", (co,))
        err = lib.conv3x3_slab_int8_launch(
            ptr(x), ptr(kernel), ptr(bias), ptr(pa), ptr(pc), ptr(qs), ptr(qz), ptr(ws),
            ptr(residual), ptr(out), ptr(part), b, h, w, ci, co, stream)
    else:
        err = lib.conv3x3_slab_launch(
            ptr(x), ptr(kernel), ptr(bias), ptr(pa), ptr(pc), ptr(residual),
            ptr(out), ptr(part), b, h, w, ci, co, int(upsample), stream)
    _build.check(err, name)
    launch_counts[name + ("_upsample" if upsample else "")] += 1
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
    act_inv_scale=None,
    act_zp=None,
    w_scale=None,
):
    """(x [+ temb]) -> GroupNorm -> SiLU -> 3x3 conv (+bias) (+residual);
    with an int8 ``kernel`` and ``act_inv_scale``/``act_zp``/``w_scale``
    its W8A8 form (``utils/quant.py``).

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
        residual=residual, emit_stats=emit_stats, act_inv_scale=act_inv_scale,
        act_zp=act_zp, w_scale=w_scale,
    )


# -- kernel E: the whole-map conv of the conv2d(impl="gemm") route ----------
#
# The JAX package's routing rule for it, copied: ``plan_co_tile`` decides
# whether ``sdtpu/ops/conv.py:conv2d(impl="gemm")`` sends a 3x3 conv to the
# whole-map kernel (``sdtpu/kernels/conv2d.py:32-99``).  Its VMEM budget
# and estimate are the TPU kernel's, kept so that the port routes the same
# shapes to the same function; they are not a memory budget of the card.

_VMEM_BUDGET = 72 * 1024 * 1024


def _vmem_estimate(h, w, ci, co_tile, itemsize=2) -> int:
    """The JAX package's per-grid-cell VMEM estimate of the whole-map
    kernel (a routing rule, see above)."""
    in_b = (h + 2) * (w + 2) * ci * itemsize * 2
    k_b = 9 * ci * co_tile * itemsize * 2
    out_b = h * w * co_tile * itemsize * 2
    acc_b = h * w * co_tile * 4 * 2
    core_b = h * w * ci * itemsize
    return in_b + k_b + out_b + acc_b + core_b


def _co_tile_candidates(co: int):
    """Tile widths in the JAX package's order: exact, then 128-multiple
    divisors of co, then padding 128-multiples, largest first."""
    exact = [co]
    divisors = [t for t in (640, 512, 384, 256, 128)
                if t < co and t % 128 == 0 and co % t == 0]
    padded = [t for t in (512, 384, 256, 128)
              if t < co and t % 128 == 0 and co % t != 0]
    return exact + divisors + padded


def plan_co_tile(x_shape, kernel_shape):
    """The JAX package's routing rule for the whole-map kernel: its co_tile,
    or None for another route.  A 3x3 kernel, H and W multiples of 8, Ci
    and Co >= 64, H*W <= 4096, and a co_tile whose VMEM estimate fits the
    TPU budget."""
    _, h, w, ci = x_shape
    kh, kw, _, co = kernel_shape
    if (kh, kw) != (3, 3) or h % 8 != 0 or w % 8 != 0:
        return None
    if ci < 64 or co < 64:
        return None
    if h * w > 64 * 64:
        return None
    for co_tile in _co_tile_candidates(co):
        if _vmem_estimate(h, w, ci, co_tile) <= _VMEM_BUDGET:
            return co_tile
    return None


def fits_fused(x_shape, kernel_shape) -> bool:
    return plan_co_tile(x_shape, kernel_shape) is not None


def conv3x3_gemm_plain(x: torch.Tensor, kernel: torch.Tensor, bias=None, *,
                       co_tile: int = 256) -> torch.Tensor:
    """Kernel E's function: the nine taps accumulated in float32, rounded
    once to x's dtype, then ``bias.to(x.dtype)`` added in x's dtype (two
    roundings, where kernel A adds its bias in float32).  ``co_tile`` only
    pads in the JAX package and changes no value."""
    acc = F.conv2d(x.float().permute(0, 3, 1, 2), kernel.float().permute(3, 2, 0, 1),
                   padding=1).permute(0, 2, 3, 1)
    out = acc.to(x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def conv3x3_gemm(x: torch.Tensor, kernel: torch.Tensor, bias=None, *,
                 co_tile: int = 256) -> torch.Tensor:
    """Kernel E.  NHWC stride-1 same-pad 3x3 conv: x (B, H, W, Ci), kernel
    (3, 3, Ci, Co) -> (B, H, W, Co) in x's dtype, with the bias added after
    the cast (see :func:`conv3x3_gemm_plain`).  ``co_tile`` is kept for
    parity with the JAX signature; the card ignores it.  On the card x and
    the kernel must be contiguous bf16 and Ci and Co multiples of 8."""
    if x.device.type == "cpu":
        return conv3x3_gemm_plain(x, kernel, bias, co_tile=co_tile)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_gemm: unsupported device {x.device}")
    b, h, w, ci = x.shape
    co = kernel.shape[-1]
    if ci % 8 or co % 8:
        raise ValueError(f"conv3x3_gemm: Ci={ci} and Co={co} must be multiples of 8")
    _expect(x, "x", (b, h, w, ci), torch.bfloat16, x.device, "conv3x3_gemm")
    _expect(kernel, "kernel", (3, 3, ci, co), torch.bfloat16, x.device, "conv3x3_gemm")
    out = torch.empty((b, h, w, co), device=x.device, dtype=torch.bfloat16)
    err = _lib("conv3x3_slab").conv3x3_gemm_launch(
        x.data_ptr(), kernel.data_ptr(), out.data_ptr(), b, h, w, ci, co,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "conv3x3_gemm")
    launch_counts["conv3x3_gemm"] += 1
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
