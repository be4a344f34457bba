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
slices' float32 partial sums (``conv3x3_splitk_reduce``).  The int8 conv
has the same three (``conv3x3_int8_prologue`` writing a zero-point-padded
code map, the GEMM on a K-major copy of the weights kept beside each int8
weight tensor, ``conv3x3_int8_splitk_reduce`` over int32 partials, split
by ``plan_conv3x3_int8_split``).  Float kernel:

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
import os

import torch
import torch.nn.functional as F

from sdtpu_torch.kernels import _build, launch_counts

# conv1 -> GN2 statistics chaining inside the slab resnets (the UNet's
# ``resnet_block`` and the VAE's ``vae_resnet`` read it at call time): on,
# conv1 emits its output's moments and norm2 derives its statistics from
# them; off (``SDTPU_CONV_STATS=0``, or set at run time, as the A/B tool
# ``tools/ab_conv_stats.py`` does), as in ``sdtpu/kernels/conv2d.py:27-30``,
# no conv emits moments and every GroupNorm of the chain computes its own
# statistics from the map, E[x^2] - mean^2 unclamped (the cancellation at a
# large mean that the port reproduces, ROADMAP Queue C).
CONV_STATS_CHAIN = os.environ.get("SDTPU_CONV_STATS", "1") not in ("0", "false")


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


def _zero_points(act_zp, ci, device) -> torch.Tensor:
    return torch.zeros(ci, device=device) if act_zp is None else act_zp.float()


def _int8_codes(x, a, c, s, z) -> torch.Tensor:
    """The quantized prologue as float codes: ``clamp(round(silu(x * a + c)
    * s) + z, -128, 127)`` from the float32 SiLU, half to even."""
    y = x.float() * a.float()[:, None, None, :]
    y = y + c.float()[:, None, None, :]
    y = y * torch.sigmoid(y)
    return torch.clamp(torch.round(y * s.float()) + z, -128.0, 127.0)


def _conv3x3_int8_plain(x, kernel, conv_bias, a, c, s, z, w_scale, residual, emit_stats):
    z = _zero_points(z, x.shape[-1], x.device)
    q = _int8_codes(x, a, c, s, z)
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


def conv3x3_int8_codes_plain(x, scale, bias, act_inv_scale, act_zp=None) -> torch.Tensor:
    """The int8 pre-pass's function: (B, H+2, W+2, Ci) int8 codes, the
    quantized prologue of x (B, H, W, Ci) inside and the zero point on the
    one-pixel ring (the pad is the real value 0)."""
    b, h, w, ci = x.shape
    z = _zero_points(act_zp, ci, x.device)
    codes = z.expand(b, h + 2, w + 2, ci).clone()
    codes[:, 1:-1, 1:-1] = _int8_codes(x, scale, bias, act_inv_scale, z)
    return codes.to(torch.int8)


def conv3x3_kmajor_plain(kernel: torch.Tensor) -> torch.Tensor:
    """The int8 GEMM's weight layout: HWIO (3, 3, Ci, Co) -> (3, 3, Co, Ci),
    each output channel's input channels contiguous (K-major)."""
    return kernel.permute(0, 1, 3, 2).contiguous()


def conv3x3_int8_split_plain(codes: torch.Tensor, kernel_kmajor: torch.Tensor,
                             splits: int) -> torch.Tensor:
    """The int8 GEMM's function on the padded codes and the K-major weights:
    (S, B, H, W, Co) int32 partial sums, slice s over K steps [s*KT//S,
    (s+1)*KT//S) of the flattened K loop (KT = ``int8_k_steps(Ci)``; step k
    is tap k // ceil(Ci/BK), channels BK * (k % ceil(Ci/BK)) onwards), each
    an exact integer sum (taken in float64)."""
    b, hp, wp, ci = codes.shape
    h, w, co = hp - 2, wp - 2, kernel_kmajor.shape[2]
    q = codes.double()
    nch, kt = -(-ci // INT8_BK), int8_k_steps(ci)
    out = torch.zeros((splits, b, h, w, co), dtype=torch.float64, device=codes.device)
    for s in range(splits):
        for k in range(s * kt // splits, (s + 1) * kt // splits):
            tap, ch = divmod(k, nch)
            ty, tx = divmod(tap, 3)
            c0, c1 = ch * INT8_BK, min(ci, ch * INT8_BK + INT8_BK)
            out[s] += q[:, ty:ty + h, tx:tx + w, c0:c1] @ kernel_kmajor[ty, tx, :, c0:c1].double().T
    return out.to(torch.int32)


def conv3x3_int8_reduce_plain(ws: torch.Tensor, w_scale, bias=None, residual=None, *,
                              emit_stats: bool = False, dtype=torch.bfloat16):
    """The int8 reduction's function: the int32 slices of ``ws`` (S, B, H,
    W, Co) summed exactly, then ``float32(acc) * w_scale``, bias, residual
    and one rounding to ``dtype`` (the unsplit epilogue's steps); with the
    moments of the rounded output."""
    out = ws.sum(dim=0, dtype=torch.int64).double().float() * w_scale.float()
    if bias is not None:
        out = out + bias.float()
    if residual is not None:
        out = out + residual.float()
    out = out.to(dtype)
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


# the GEMMs' tiles (``csrc/conv3x3_slab.cu``, ``csrc/conv3x3_slab_int8.cu``;
# ``_lib`` checks each library reports the same) and the split-K plan's limits
SLAB_BM, SLAB_BN, SLAB_BK, SLAB_STAGES = 128, 128, 32, 4
INT8_BM, INT8_BN, INT8_BK, INT8_STAGES = 128, 128, 64, 4
SMS = 132                              # H100 SXM
MIN_SLICE_K_STEPS = 2 * SLAB_STAGES    # K steps a slice keeps: its ring fills twice (both GEMMs)
MAX_SPLITS = 16

# C entry points: (pointer arguments, int arguments) before the stream
_SIGNATURES = {
    "conv3x3_slab": {"conv3x3_slab_launch": (7, 7), "conv3x3_prologue_launch": (4, 4),
                     "conv3x3_splitk_reduce_launch": (5, 5)},
    "conv3x3_slab_int8": {"conv3x3_slab_int8_launch": (8, 6),
                          "conv3x3_int8_prologue_launch": (6, 4),
                          "conv3x3_int8_splitk_reduce_launch": (6, 5)},
}
_TILES = {"conv3x3_slab": (SLAB_BM, SLAB_BN, SLAB_BK, SLAB_STAGES),
          "conv3x3_slab_int8": (INT8_BM, INT8_BN, INT8_BK, INT8_STAGES)}


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
        tile = getattr(lib, name + "_tile")
        tile.argtypes = [ctypes.c_int]
        tile.restype = ctypes.c_int
        tiles = tuple(tile(i) for i in range(4))
        if tiles != _TILES[name]:
            raise RuntimeError(f"{name}.cu runs tiles (BM, BN, BK, stages) {tiles}, "
                               f"the split plan assumes {_TILES[name]}")
        lib._typed = True
    return lib


def slab_k_steps(ci: int) -> int:
    """The GEMM's K steps: 9 taps x ceil(Ci / BK) channel chunks."""
    return 9 * -(-ci // SLAB_BK)


def int8_k_steps(ci: int) -> int:
    """The int8 GEMM's K steps: 9 taps x ceil(Ci / INT8_BK) channel chunks."""
    return 9 * -(-ci // INT8_BK)


def slab_blocks(b: int, h: int, w: int, co: int) -> int:
    """Blocks of one unsplit GEMM launch over an H x W output map (the
    float and the int8 GEMM have the same BM x BN tile)."""
    return -(-(h * w) // SLAB_BM) * -(-co // SLAB_BN) * b


def _plan_split(blocks: int, k_steps: int) -> int:
    """The smallest S whose grid of S x ``blocks`` blocks is at least one
    block per SM (one full wave), capped so that each slice keeps at least
    ``MIN_SLICE_K_STEPS`` K steps (and at ``MAX_SPLITS``); 1 where the grid
    is full already."""
    cap = max(1, min(MAX_SPLITS, k_steps // MIN_SLICE_K_STEPS))
    splits = 1
    while blocks * splits < SMS and splits < cap:
        splits += 1
    return splits


def plan_conv3x3_split(b: int, h: int, w: int, ci: int, co: int) -> int:
    """S, the slices of the float GEMM's K loop for a conv with an H x W
    OUTPUT map (see :func:`_plan_split`)."""
    return _plan_split(slab_blocks(b, h, w, co), slab_k_steps(ci))


def plan_conv3x3_int8_split(b: int, h: int, w: int, ci: int, co: int) -> int:
    """S, the slices of the int8 GEMM's K loop (64-channel steps) for a conv
    with an H x W output map (see :func:`_plan_split`)."""
    return _plan_split(slab_blocks(b, h, w, co), int8_k_steps(ci))


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


def conv3x3_int8_launches(x_shape, co: int) -> dict:
    """The launch counters one call of the int8 conv adds one to on the
    card: the GEMM (``conv3x3_slab_int8``), its pre-pass, and the split-K
    reduction where ``plan_conv3x3_int8_split`` gives S > 1."""
    b, h, w, ci = x_shape
    keys = {"conv3x3_slab_int8": 1, "conv3x3_slab_int8_prologue": 1}
    if plan_conv3x3_int8_split(b, h, w, ci, co) > 1:
        keys["conv3x3_slab_int8_splitk"] = 1
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
    qs = f32(act_inv_scale, "act_inv_scale", (ci,))
    qz = f32(torch.zeros(ci, device=dev) if act_zp is None else act_zp, "act_zp", (ci,))
    ws = f32(w_scale, "w_scale", (co,))
    stream = _stream(x)
    codes = _int8_prologue_launch(x, pa, pc, qs, qz, stream)
    return _int8_gemm(codes, kernel, bias, ws, residual, emit_stats, stream)


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


# -- the int8 conv's pieces on the card --------------------------------------


def _kmajor(kernel: torch.Tensor) -> torch.Tensor:
    """The K-major copy (``conv3x3_kmajor_plain``) of an int8 weight that
    the int8 GEMM reads: made on the weight's device once and kept on the
    weight tensor itself (outside the parameter tree), remade if the tensor
    was written in place since (an inference tensor keeps no version
    counter: its copy is never remade)."""
    try:
        version = kernel._version
    except RuntimeError:  # an inference tensor keeps no version counter
        version = None
    cached = getattr(kernel, "_sdtpu_kmajor", None)
    if cached is None or cached[0] != version:
        cached = (version, conv3x3_kmajor_plain(kernel))
        kernel._sdtpu_kmajor = cached
    return cached[1]


def _int8_prologue_launch(x, pa, pc, qs, qz, stream):
    """The int8 pre-pass on the card; the caller has checked every tensor."""
    b, h, w, ci = x.shape
    codes = torch.empty((b, h + 2, w + 2, ci), device=x.device, dtype=torch.int8)
    err = _lib("conv3x3_slab_int8").conv3x3_int8_prologue_launch(
        _ptr(x), _ptr(pa), _ptr(pc), _ptr(qs), _ptr(qz), _ptr(codes), b, h, w, ci, stream)
    _build.check(err, "conv3x3_int8_prologue")
    launch_counts["conv3x3_slab_int8_prologue"] += 1
    return codes


def _int8_gemm_launch(codes, kernel, splits, stream, *, bias=None, wsc=None, residual=None,
                      out=None, part=None, ws=None):
    b, hp, wp, ci = codes.shape
    co = kernel.shape[-1]
    err = _lib("conv3x3_slab_int8").conv3x3_slab_int8_launch(
        _ptr(codes), _ptr(_kmajor(kernel)), _ptr(bias), _ptr(wsc), _ptr(residual), _ptr(out),
        _ptr(part), _ptr(ws), b, hp - 2, wp - 2, ci, co, splits, stream)
    _build.check(err, "conv3x3_slab_int8")
    launch_counts["conv3x3_slab_int8"] += 1


def _int8_gemm(codes, kernel, bias, wsc, residual, emit_stats, stream):
    """The int8 GEMM on the card (on the padded codes), with the split-K
    reduction where the plan splits; the caller has checked every tensor.
    Returns out, or (out, moments)."""
    b, hp, wp, ci = codes.shape
    h, w, co = hp - 2, wp - 2, kernel.shape[-1]
    splits = plan_conv3x3_int8_split(b, h, w, ci, co)
    if splits > 1:
        ws = torch.empty((splits, b, h, w, co), device=codes.device, dtype=torch.int32)
        _int8_gemm_launch(codes, kernel, splits, stream, ws=ws)
        return _int8_splitk_launch(ws, wsc, bias, residual, emit_stats, stream)
    out = torch.empty((b, h, w, co), device=codes.device, dtype=torch.bfloat16)
    part = None
    if emit_stats:
        part = torch.empty((b, _lib("conv3x3_slab_int8").conv3x3_slab_int8_m_tiles(h, w), 2, co),
                           device=codes.device, dtype=torch.float32)
    _int8_gemm_launch(codes, kernel, 1, stream, bias=bias, wsc=wsc, residual=residual, out=out,
                      part=part)
    return (out, _tile_moments(part, h, w)) if emit_stats else out


def _int8_splitk_launch(ws, wsc, bias, residual, emit_stats, stream):
    """The int8 split-K reduction on the card; the caller has checked every
    tensor.  Returns out, or (out, moments)."""
    splits, b, h, w, co = ws.shape
    lib = _lib("conv3x3_slab_int8")
    out = torch.empty((b, h, w, co), device=ws.device, dtype=torch.bfloat16)
    part = None
    if emit_stats:
        part = torch.empty((b, lib.conv3x3_slab_int8_m_tiles(h, w), 2, co), device=ws.device,
                           dtype=torch.float32)
    err = lib.conv3x3_int8_splitk_reduce_launch(_ptr(ws), _ptr(bias), _ptr(wsc), _ptr(residual),
                                                _ptr(out), _ptr(part), b, h, w, co, splits,
                                                stream)
    _build.check(err, "conv3x3_int8_splitk_reduce")
    launch_counts["conv3x3_slab_int8_splitk"] += 1
    return (out, _tile_moments(part, h, w)) if emit_stats else out


def conv3x3_int8_prologue(x, scale, bias, act_inv_scale, act_zp=None) -> torch.Tensor:
    """The int8 pre-pass: the padded (B, H+2, W+2, Ci) int8 codes of
    :func:`conv3x3_int8_codes_plain`.  On the card x must be contiguous
    bf16 with Ci a multiple of 16; scale and bias (B, Ci), act_inv_scale and
    act_zp (Ci,) float32."""
    if x.device.type == "cpu":
        return conv3x3_int8_codes_plain(x, scale, bias, act_inv_scale, act_zp)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_int8_prologue: unsupported device {x.device}")
    b, h, w, ci = x.shape
    what = "conv3x3_int8_prologue"
    if ci % 16:
        raise ValueError(f"{what}: Ci={ci} must be a multiple of 16")
    _expect(x, "x", (b, h, w, ci), torch.bfloat16, x.device, what)
    for t, name, shape in ((scale, "scale", (b, ci)), (bias, "bias", (b, ci)),
                           (act_inv_scale, "act_inv_scale", (ci,))):
        _expect(t, name, shape, torch.float32, x.device, what)
    qz = torch.zeros(ci, device=x.device) if act_zp is None else act_zp
    _expect(qz, "act_zp", (ci,), torch.float32, x.device, what)
    return _int8_prologue_launch(x, scale, bias, act_inv_scale, qz, _stream(x))


def conv3x3_int8_split(codes: torch.Tensor, kernel: torch.Tensor, splits: int) -> torch.Tensor:
    """The int8 GEMM alone in its split form: (S, B, H, W, Co) int32
    partial sums of :func:`conv3x3_int8_split_plain` from the padded codes
    and the HWIO int8 kernel (its K-major copy made once).  On the card S
    is 2 up to the K steps, codes and kernel contiguous int8, Ci a multiple
    of 16 and Co of 8."""
    if codes.device.type == "cpu":
        return conv3x3_int8_split_plain(codes, conv3x3_kmajor_plain(kernel), splits)
    if codes.device.type != "cuda":
        raise ValueError(f"conv3x3_int8_split: unsupported device {codes.device}")
    b, hp, wp, ci = codes.shape
    co = kernel.shape[-1]
    what = "conv3x3_int8_split"
    if ci % 16 or co % 8 or not 2 <= splits <= int8_k_steps(ci):
        raise ValueError(f"{what}: Ci={ci} (a multiple of 16), Co={co} (of 8), "
                         f"splits={splits} (2 .. {int8_k_steps(ci)})")
    _expect(codes, "codes", (b, hp, wp, ci), torch.int8, codes.device, what)
    _expect(kernel, "kernel", (3, 3, ci, co), torch.int8, codes.device, what)
    ws = torch.empty((splits, b, hp - 2, wp - 2, co), device=codes.device, dtype=torch.int32)
    _int8_gemm_launch(codes, kernel, splits, _stream(codes), ws=ws)
    return ws


def conv3x3_int8_splitk_reduce(ws: torch.Tensor, w_scale, bias, residual=None, *,
                               emit_stats: bool = False):
    """The int8 split-K reduction: ``bf16(float(sum_s ws[s]) * w_scale +
    bias + residual)`` (see :func:`conv3x3_int8_reduce_plain`);
    ``emit_stats=True`` adds the (B, 2, Co) moments.  ws (S, B, H, W, Co)
    int32, w_scale and bias (Co,) float32, residual (B, H, W, Co) bf16; on
    the card Co a multiple of 8 and every tensor contiguous."""
    if ws.device.type == "cpu":
        return conv3x3_int8_reduce_plain(ws, w_scale, bias, residual, emit_stats=emit_stats)
    if ws.device.type != "cuda":
        raise ValueError(f"conv3x3_int8_splitk_reduce: unsupported device {ws.device}")
    splits, b, h, w, co = ws.shape
    what, dev = "conv3x3_int8_splitk_reduce", ws.device
    if co % 8:
        raise ValueError(f"{what}: Co={co} must be a multiple of 8")
    _expect(ws, "ws", (splits, b, h, w, co), torch.int32, dev, what)
    _expect(w_scale, "w_scale", (co,), torch.float32, dev, what)
    _expect(bias, "bias", (co,), torch.float32, dev, what)
    if residual is not None:
        _expect(residual, "residual", (b, h, w, co), torch.bfloat16, dev, what)
    return _int8_splitk_launch(ws, w_scale, bias, residual, emit_stats, _stream(ws))


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
