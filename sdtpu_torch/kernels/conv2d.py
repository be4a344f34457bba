"""3x3 same-pad convolution with a fused GroupNorm(+temb)+SiLU prologue,
bias + residual epilogue, optional output moments, and an optional fused
nearest-2x upsample of the input; with an int8 kernel, its W8A8 form; and
the plain whole-map 3x3 conv of the ``conv2d(impl="gemm")`` route (kernel
E, ``conv3x3_gemm``, at the end of this module).

Counterpart of ``sdtpu/kernels/conv2d.py:conv3x3_gemm_slab`` and
``gn_silu_conv3x3_slab``.  On the card ``conv3x3_slab`` launches the CUDA
kernels of ``csrc/conv3x3_slab.cu`` (float) or ``csrc/conv3x3_slab_int8.cu``
(int8 kernel); on the CPU it runs ``conv3x3_slab_plain``, the same function
with the same rounding points.  The float conv is up to three kernels, each
with its own wrapper, plain version and launch count: the prologue as an
elementwise pre-pass (``conv3x3_prologue``), the GEMM, and, where
``plan_conv3x3_split`` splits the K loop, the fixed-order reduction of the
slices' float32 partial sums (``conv3x3_splitk_reduce``).  Float kernel:

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


def conv3x3_prologue_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
    """The pre-pass's function: ``silu(x * scale[b, ci] + bias[b, ci])`` in
    float32, rounded to x's dtype (the kernel's rounding point)."""
    y = x.float() * scale.float()[:, None, None, :]
    y = y + bias.float()[:, None, None, :]
    return (y * torch.sigmoid(y)).to(x.dtype)


def conv3x3_split_plain(x: torch.Tensor, kernel: torch.Tensor, splits: int, *,
                        upsample: bool = False) -> torch.Tensor:
    """The split GEMM's function: (S, B, H, W, Co) float32 partial sums, slice
    s over K steps [s*KT//S, (s+1)*KT//S) of the flattened K loop (KT =
    ``slab_k_steps(Ci)``; step k is tap k // ceil(Ci/BK), channels
    BK * (k % ceil(Ci/BK)) onwards) of x (prologue applied) padded by one
    zero pixel."""
    y = x.float()
    if upsample:
        y = y.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    b, h, w, ci = y.shape
    co = kernel.shape[-1]
    yp = F.pad(y, (0, 0, 1, 1, 1, 1))
    nch, kt = -(-ci // SLAB_BK), slab_k_steps(ci)
    out = torch.zeros((splits, b, h, w, co), dtype=torch.float32, device=x.device)
    for s in range(splits):
        for k in range(s * kt // splits, (s + 1) * kt // splits):
            tap, ch = divmod(k, nch)
            ty, tx = divmod(tap, 3)
            c0, c1 = ch * SLAB_BK, min(ci, ch * SLAB_BK + SLAB_BK)
            out[s] += yp[:, ty:ty + h, tx:tx + w, c0:c1] @ kernel[ty, tx, c0:c1].float()
    return out


def splitk_reduce_plain(ws: torch.Tensor, bias=None, residual=None, *,
                        emit_stats: bool = False, dtype=torch.bfloat16):
    """The reduction's function: the slices of ``ws`` (S, B, H, W, Co)
    summed in float32 in order, then bias, then residual, one rounding to
    ``dtype``; with the moments of the rounded output."""
    acc = ws[0]
    for s in range(1, ws.shape[0]):
        acc = acc + ws[s]
    if bias is not None:
        acc = acc + bias.float()
    if residual is not None:
        acc = acc + residual.float()
    out = acc.to(dtype)
    return (out, _moments(out)) if emit_stats else out


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
    y = x if prologue_scale is None else conv3x3_prologue_plain(x, prologue_scale,
                                                                 prologue_bias)
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


# the GEMM's tiles (``csrc/conv3x3_slab.cu``; ``_lib`` checks the library
# reports the same) and the split-K plan's limits
SLAB_BM, SLAB_BN, SLAB_BK, SLAB_STAGES = 128, 128, 32, 4
SMS = 132                              # H100 SXM
MIN_SLICE_K_STEPS = 2 * SLAB_STAGES    # K steps a slice keeps: its ring fills twice
MAX_SPLITS = 16

# C entry points: (pointer arguments, int arguments) before the stream
_SIGNATURES = {
    "conv3x3_slab": {"conv3x3_slab_launch": (7, 7), "conv3x3_prologue_launch": (4, 4),
                     "conv3x3_splitk_reduce_launch": (5, 5)},
    "conv3x3_slab_int8": {"conv3x3_slab_int8_launch": (11, 5)},
}


def _lib(name: str):
    """The library of ``csrc/<name>.cu`` with its functions typed."""
    lib = _build.load(name)
    if not getattr(lib, "_typed", False):
        p = ctypes.c_void_p
        for fn, (n_ptrs, n_ints) in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = [p] * n_ptrs + [ctypes.c_int] * n_ints + [p]
            f.restype = ctypes.c_int
        m_tiles = getattr(lib, name + "_m_tiles")
        m_tiles.argtypes = [ctypes.c_int, ctypes.c_int]
        m_tiles.restype = ctypes.c_int
        if name == "conv3x3_slab":
            lib.conv3x3_slab_tile.argtypes = [ctypes.c_int]
            lib.conv3x3_slab_tile.restype = ctypes.c_int
            tiles = tuple(lib.conv3x3_slab_tile(i) for i in range(4))
            if tiles != (SLAB_BM, SLAB_BN, SLAB_BK, SLAB_STAGES):
                raise RuntimeError(f"conv3x3_slab.cu runs tiles (BM, BN, BK, stages) {tiles}, "
                                   f"the split plan assumes {(SLAB_BM, SLAB_BN, SLAB_BK, SLAB_STAGES)}")
        lib._typed = True
    return lib


def slab_k_steps(ci: int) -> int:
    """The GEMM's K steps: 9 taps x ceil(Ci / BK) channel chunks."""
    return 9 * -(-ci // SLAB_BK)


def slab_blocks(b: int, h: int, w: int, co: int) -> int:
    """Blocks of one unsplit GEMM launch over an H x W output map."""
    return -(-(h * w) // SLAB_BM) * -(-co // SLAB_BN) * b


def plan_conv3x3_split(b: int, h: int, w: int, ci: int, co: int) -> int:
    """S, the slices of the K loop for a conv with an H x W OUTPUT map: the
    smallest S whose grid of S x ``slab_blocks`` blocks is at least one
    block per SM (one full wave), capped so that each slice keeps at least
    ``MIN_SLICE_K_STEPS`` K steps (and at ``MAX_SPLITS``); 1 where the grid
    is full already."""
    blocks = slab_blocks(b, h, w, co)
    cap = max(1, min(MAX_SPLITS, slab_k_steps(ci) // MIN_SLICE_K_STEPS))
    splits = 1
    while blocks * splits < SMS and splits < cap:
        splits += 1
    return splits


def conv3x3_launches(key: str, x_shape, co: int, *, prologue: bool = False,
                     upsample: bool = False) -> dict:
    """The launch counters one call of a float conv wrapper adds one to on
    the card: its own (``key``: ``conv3x3_slab``, ``conv3x3_slab_upsample``
    or ``conv3x3_gemm``), the pre-pass with a prologue, and the split-K
    reduction where ``plan_conv3x3_split`` gives S > 1."""
    b, hx, wx, ci = x_shape
    h, w = (2 * hx, 2 * wx) if upsample else (hx, wx)
    keys = {key: 1}
    if prologue:
        keys["conv3x3_slab_prologue"] = 1
    if plan_conv3x3_split(b, h, w, ci, co) > 1:
        keys["conv3x3_slab_splitk"] = 1
    return keys


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
    if not quant:
        stream = _stream(x)
        if pa is not None:
            x = _prologue_launch(x, pa, pc, stream)
        return _slab_gemm(x, kernel, bias, residual, upsample=upsample, emit_stats=emit_stats,
                          key="conv3x3_slab_upsample" if upsample else "conv3x3_slab",
                          stream=stream)
    lib = _lib("conv3x3_slab_int8")
    out = torch.empty((b, h, w, co), device=dev, dtype=torch.bfloat16)
    part = None
    if emit_stats:
        part = torch.empty((b, lib.conv3x3_slab_int8_m_tiles(h, w), 2, co),
                           device=dev, dtype=torch.float32)
    qs = f32(act_inv_scale, "act_inv_scale", (ci,))
    qz = f32(torch.zeros(ci, device=dev) if act_zp is None else act_zp, "act_zp", (ci,))
    ws = f32(w_scale, "w_scale", (co,))
    err = lib.conv3x3_slab_int8_launch(
        _ptr(x), _ptr(kernel), _ptr(bias), _ptr(pa), _ptr(pc), _ptr(qs), _ptr(qz), _ptr(ws),
        _ptr(residual), _ptr(out), _ptr(part), b, h, w, ci, co, _stream(x))
    _build.check(err, "conv3x3_slab_int8")
    launch_counts["conv3x3_slab_int8"] += 1
    return (out, _tile_moments(part, h, w)) if emit_stats else out


def _ptr(t):
    return None if t is None else t.data_ptr()


def _tile_moments(part: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, 2, Co) moments from a kernel's (B, M tiles, 2, Co) tile sums."""
    return part.sum(dim=1) / float(h * w)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _slab_gemm(x, kernel, bias, residual, *, upsample, emit_stats, key, stream):
    """The GEMM on the card (x already through the prologue), with the
    split-K reduction where the plan splits, on ``stream``; the caller has
    checked every tensor.  Returns out, or (out, moments)."""
    b, hx, wx, ci = x.shape
    h, w = (2 * hx, 2 * wx) if upsample else (hx, wx)
    co = kernel.shape[-1]
    lib = _lib("conv3x3_slab")
    splits = plan_conv3x3_split(b, h, w, ci, co)
    if splits > 1:
        ws = torch.empty((splits, b, h, w, co), device=x.device, dtype=torch.float32)
        err = lib.conv3x3_slab_launch(_ptr(x), _ptr(kernel), None, None, None, None, _ptr(ws),
                                      b, h, w, ci, co, int(upsample), splits, stream)
        _build.check(err, key)
        launch_counts[key] += 1
        return _splitk_launch(ws, bias, residual, emit_stats, stream)
    out = torch.empty((b, h, w, co), device=x.device, dtype=torch.bfloat16)
    part = None
    if emit_stats:
        part = torch.empty((b, lib.conv3x3_slab_m_tiles(h, w), 2, co), device=x.device,
                           dtype=torch.float32)
    err = lib.conv3x3_slab_launch(_ptr(x), _ptr(kernel), _ptr(bias), _ptr(residual), _ptr(out),
                                  _ptr(part), None, b, h, w, ci, co, int(upsample), 1, stream)
    _build.check(err, key)
    launch_counts[key] += 1
    return (out, _tile_moments(part, h, w)) if emit_stats else out


def conv3x3_prologue(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The pre-pass: ``bf16(silu(x * scale[b, ci] + bias[b, ci]))`` over an
    NHWC map, once per element.  x (B, H, W, Ci); scale and bias (B, Ci).
    On the card x must be contiguous bf16 with Ci a multiple of 8, scale
    and bias float32."""
    if x.device.type == "cpu":
        return conv3x3_prologue_plain(x, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_prologue: unsupported device {x.device}")
    b, h, w, ci = x.shape
    if ci % 8:
        raise ValueError(f"conv3x3_prologue: Ci={ci} must be a multiple of 8")
    _expect(x, "x", (b, h, w, ci), torch.bfloat16, x.device, "conv3x3_prologue")
    for t, name in ((scale, "scale"), (bias, "bias")):
        _expect(t, name, (b, ci), torch.float32, x.device, "conv3x3_prologue")
    return _prologue_launch(x, scale, bias, _stream(x))


def _prologue_launch(x, scale, bias, stream):
    """The pre-pass on the card; the caller has checked every tensor."""
    b, h, w, ci = x.shape
    y = torch.empty_like(x)
    err = _lib("conv3x3_slab").conv3x3_prologue_launch(
        _ptr(x), _ptr(scale), _ptr(bias), _ptr(y), b, h, w, ci, stream)
    _build.check(err, "conv3x3_prologue")
    launch_counts["conv3x3_slab_prologue"] += 1
    return y


def conv3x3_splitk_reduce(ws: torch.Tensor, bias=None, residual=None, *,
                          emit_stats: bool = False):
    """The split-K reduction: ``bf16(sum_s ws[s] + bias + residual)`` with
    the slices summed in order and one rounding (see
    :func:`splitk_reduce_plain`); ``emit_stats=True`` adds the (B, 2, Co)
    moments of the output.  ws (S, B, H, W, Co) float32, bias (Co,)
    float32, residual (B, H, W, Co) bf16; on the card Co a multiple of 8
    and every tensor contiguous."""
    if ws.device.type == "cpu":
        return splitk_reduce_plain(ws, bias, residual, emit_stats=emit_stats)
    if ws.device.type != "cuda":
        raise ValueError(f"conv3x3_splitk_reduce: unsupported device {ws.device}")
    splits, b, h, w, co = ws.shape
    if co % 8:
        raise ValueError(f"conv3x3_splitk_reduce: Co={co} must be a multiple of 8")
    what, dev = "conv3x3_splitk_reduce", ws.device
    _expect(ws, "ws", (splits, b, h, w, co), torch.float32, dev, what)
    if bias is not None:
        _expect(bias, "bias", (co,), torch.float32, dev, what)
    if residual is not None:
        _expect(residual, "residual", (b, h, w, co), torch.bfloat16, dev, what)
    return _splitk_launch(ws, bias, residual, emit_stats, _stream(ws))


def _splitk_launch(ws, bias, residual, emit_stats, stream):
    """The split-K reduction on the card; the caller has checked every
    tensor.  Returns out, or (out, moments)."""
    splits, b, h, w, co = ws.shape
    dev = ws.device
    lib = _lib("conv3x3_slab")
    out = torch.empty((b, h, w, co), device=dev, dtype=torch.bfloat16)
    part = None
    if emit_stats:
        part = torch.empty((b, lib.conv3x3_slab_m_tiles(h, w), 2, co), device=dev,
                           dtype=torch.float32)
    err = lib.conv3x3_splitk_reduce_launch(_ptr(ws), _ptr(bias), _ptr(residual), _ptr(out),
                                           _ptr(part), b, h, w, co, splits, stream)
    _build.check(err, "conv3x3_splitk_reduce")
    launch_counts["conv3x3_slab_splitk"] += 1
    return (out, _tile_moments(part, h, w)) if emit_stats else out


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
    out = _slab_gemm(x, kernel, None, None, upsample=False, emit_stats=False,
                     key="conv3x3_gemm", stream=_stream(x))
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
