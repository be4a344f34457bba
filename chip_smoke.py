#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sdtpu_torch``) once on one NVIDIA card.

    python3 chip_smoke.py [--out details.json]

Phases, each printing its own lines; any failure ends the run non-zero:

1. device  -- needs CUDA; prints ``nvidia-smi`` name and power limit.
2. build   -- compiles every ``sdtpu_torch/csrc/*.cu`` with nvcc for sm_90a
              into ``build/`` (one nvcc per source, all started together).
3. kernels -- each hand-written kernel against its plain PyTorch version on
              the card at the main paths' shapes (tolerance stated per
              line; the slab conv also at its split-K shapes, and its
              pre-pass and split-K reduction alone; flash attention C and F,
              out, m and l, also at ragged shapes at D = 40, 80, 160, 512:
              Lq and Lk no multiple of their tiles, Lq under one tile; the
              key-split merge alone), then every kernel call
              configuration of the main paths timed with CUDA events, each
              slab conv configuration with its split S, each attention one
              with its plan (query tile, key splits) and, beside the events,
              the profiler's device time of the kernels and the library
              (per call and per image): the kernel, its plain version, and one
              library call for the same function as a yardstick (for the
              int8 slab conv, which no one call computes, two float
              counterparts instead: kernel A and cuDNN bf16).  Kernels F
              and G are checked and timed at every call shape of the ring
              and the packed routes, recorded from a one-step image of each,
              and their device time is also read from torch.profiler (at
              these shapes a call's kernel can be shorter than its
              host-side enqueue, which then sets the CUDA-event time).
4. e2e     -- ``StableDiffusionPipeline.from_random("tiny-sd")`` and one
              512x512, 25-step DDPM + CFG image (after a warm-up image);
              checks the image and the kernels' launch counts (the slab
              conv's pre-pass and split-K reductions derived from the
              recorded calls and the split plan), prints
              seconds per image and peak memory; then one full-width UNet
              forward and one VAE decode through the kernels and through
              the plain versions, beside the plain path's own bf16-versus-
              float32 difference.
5. ring    -- ``attention_impl="ring"`` under ``ring_context(LocalRing(4))``:
              all four shards of the sequence-parallel ring on the one card,
              every latent self-attention through kernel F (16 launches per
              attention call); a warm-up and one timed image with exact launch
              counts (derived from the tree), then the ring UNet forward and
              VAE decode through the kernels against the plain ring route,
              beside that route's bf16-vs-f32 difference, and (for
              information) against the flash route.
6. nccl    -- ``health_check`` on a one-rank NCCL group, and the ring over
              ``ProcessGroupRing`` on it against ``LocalRing(1)``.
7. packed  -- the flash route with ``_PACKED_OUT_PROJ`` on: every
              self-attention's out-projection and residual add through
              kernel G; an image with exact launch counts and the same
              kernels-vs-plain control; then seconds per image of the
              flash, packed and ring routes in turns (flash, packed, ring,
              ring, packed, flash).
8. int8    -- the same pipeline after ``quantize_int8(transformer=True,
              vae=True)``: the quantization's host seconds; the int8 slab
              kernel checked and timed (phase 3's work) at every int8 call
              shape; a warm-up and one timed image with exact launch counts
              (every resnet conv on the int8 slab kernel); then the int8
              UNet forward and VAE decode through the kernels against the
              plain int8 route, beside the plain int8 route's own
              bf16-vs-float32 difference (the tolerance's yardstick), its
              int8-vs-bf16 difference, and the bf16 route's bf16-vs-f32.
9. probes  -- the kernels of the measurement entry points: E (the whole-map
              conv of ``conv2d(impl="gemm")``) at the tiny-sd resnet shapes
              that ``plan_co_tile`` accepts (two of them split-K) and at a
              ragged split-K shape, H and I (every chain count) at
              two latent self-attention shapes, J (int8 bitwise, bf16) at
              the probe's two GEMM shapes and J's bf16 split-K reduction
              alone (bitwise) where ``plan_dot`` splits, each against its
              plain version, then timed beside its bound, its plain version
              and one library call where there is one (CUDA events and
              profiler device time); then
              every kernel variant the tools run, at the tools' own shapes
              and inputs, against its plain version (``ab_conv``'s E and A
              with and without prologue; C, H and every chain variant of I
              at tiny-sd b1 and b8, SD2.1 768 and SDXL 1024, the plain
              attention over blocks of query rows); then each tool's ``main()`` (``sdtpu_torch/tools/``) at a short
              chain, with the launch counters held to the calls it made.

A flash kernel's bound counts one exponential per score at 16 per clock
per SM (``nvidia-smi`` clocks.max.sm) beside its bytes and tensor
operations.

Every float32 reference on the card runs with TF32 off (cuBLAS and cuDNN).
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import subprocess
import sys
import time
from collections import Counter

# event_ms: CUDA events around back-to-back calls; device_ms: the kernels'
# own time under torch.profiler, so that a call whose kernel is shorter than
# its host-side enqueue is not timed by the host
from sdtpu_torch.tools import device_ms, event_ms

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12   # H100 SXM dense int8
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
TOL_REL = 2e-2            # max |kernel - plain| <= TOL_REL * max |plain|
STEPS = 25                # the main path's DDPM steps (bench.py's default workload)
# the bf16 image's launches of each wrapper; the slab conv's pre-pass and
# split-K reduction (conv3x3_slab_prologue, conv3x3_slab_splitk) are added
# per path from its recorded calls (conv_sub_counts)
# and flash attention's key-split merge (flash_attention_merge) likewise from
# its recorded calls (flash_sub_counts)
E2E_COUNTS = {"conv3x3_slab": 478, "conv3x3_slab_upsample": 53, "conv3x3_slab_int8": 0,
              "flash_attention": 226, "flash_attention_stats": 0, "flash_attention_merge": 0,
              "out_proj_packed": 0,
              "conv3x3_gemm": 0, "flash_attention_legacy": 0, "flash_attention_nq": 0,
              "dot_bf16": 0, "dot_bf16_splitk": 0, "dot_int8": 0}
EXP_PER_CLOCK_SM = 16     # exp2 results per clock per SM, compute capability 9.0
SMS = 132                 # H100 SXM
RING = 4                  # shards of the sequence-parallel ring on the one card
SOURCES = {  # kernel: (its source, the pallas_call of the TPU kernel it replaces)
    "conv3x3_slab": ("sdtpu_torch/csrc/conv3x3_slab.cu", "sdtpu/kernels/conv2d.py:456"),
    "conv3x3_slab_upsample": ("sdtpu_torch/csrc/conv3x3_slab.cu",
                              "sdtpu/kernels/conv2d.py:456"),
    "conv3x3_slab_prologue": ("sdtpu_torch/csrc/conv3x3_slab.cu",
                              "sdtpu/kernels/conv2d.py:456"),
    "conv3x3_slab_splitk": ("sdtpu_torch/csrc/conv3x3_slab.cu",
                            "sdtpu/kernels/conv2d.py:456"),
    "flash_attention": ("sdtpu_torch/csrc/flash_attention.cu",
                        "sdtpu/kernels/flash_attention.py:267"),
    "conv3x3_slab_int8": ("sdtpu_torch/csrc/conv3x3_slab_int8.cu",
                          "sdtpu/kernels/conv2d.py:456"),
    "flash_attention_stats": ("sdtpu_torch/csrc/flash_attention.cu",
                              "sdtpu/kernels/flash_attention.py:379"),
    "flash_attention_merge": ("sdtpu_torch/csrc/flash_attention.cu",
                              "sdtpu/kernels/flash_attention.py:267"),
    "out_proj_packed": ("sdtpu_torch/csrc/out_proj_packed.cu",
                        "sdtpu/kernels/flash_attention.py:464"),
    "conv3x3_gemm": ("sdtpu_torch/csrc/conv3x3_slab.cu", "sdtpu/kernels/conv2d.py:606"),
    "flash_attention_legacy": ("sdtpu_torch/csrc/flash_attention.cu",
                               "tools/probe_flash_vpu.py:105"),
    "flash_attention_nq": ("sdtpu_torch/csrc/flash_nq.cu", "tools/probe_flash_2stream.py:124"),
    "dot_bf16": ("sdtpu_torch/csrc/dot.cu", "tools/probe_int8_dot.py:39"),
    "dot_bf16_splitk": ("sdtpu_torch/csrc/dot.cu", "tools/probe_int8_dot.py:39"),
    "dot_int8": ("sdtpu_torch/csrc/dot.cu", "tools/probe_int8_dot.py:39"),
}
MAIN_KERNELS = ("conv3x3_slab", "conv3x3_slab_upsample", "conv3x3_slab_prologue",
                "conv3x3_slab_splitk", "flash_attention",
                "flash_attention_merge")  # launched by the bf16 image
PROBE_KERNELS = ("conv3x3_gemm", "flash_attention_legacy", "flash_attention_nq", "dot_bf16",
                 "dot_bf16_splitk", "dot_int8")


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- routing --

_SITES = {  # each kernel wrapper's call sites on the main paths
    "conv3x3_slab": (("sdtpu_torch.kernels.conv2d", "conv3x3_slab"),
                     ("sdtpu_torch.ops.conv", "conv3x3_slab")),
    "flash_attention_packed": (("sdtpu_torch.ops.attention", "flash_attention_packed"),),
    "flash_attention_stats_packed": (("sdtpu_torch.parallel.ring_attention",
                                      "flash_attention_stats_packed"),),
    "out_proj_packed": (("sdtpu_torch.ops.attention", "out_proj_packed"),),
}


@contextlib.contextmanager
def routed(**fns):
    """Point every call site of the named kernel wrappers at other
    functions (a recording shim, or the plain versions) for the duration."""
    saved = []
    for key, fn in fns.items():
        for mod, name in _SITES[key]:
            m = sys.modules[mod]
            saved.append((m, name, getattr(m, name)))
            setattr(m, name, fn)
    try:
        yield
    finally:
        for m, name, f in reversed(saved):
            setattr(m, name, f)


def plain_routes():
    from sdtpu_torch.kernels.conv2d import conv3x3_slab_plain
    from sdtpu_torch.kernels.flash_attention import (
        flash_attention_plain,
        flash_attention_stats_plain,
        out_proj_packed_plain,
    )

    return {"conv3x3_slab": conv3x3_slab_plain, "flash_attention_packed": flash_attention_plain,
            "flash_attention_stats_packed": flash_attention_stats_plain,
            "out_proj_packed": out_proj_packed_plain}


# ---------------------------------------------------------- kernel cases --

def conv_inputs(torch, gen, x_shape, co, *, pro, res, up):
    b, hx, wx, ci = x_shape
    h, w = (2 * hx, 2 * wx) if up else (hx, wx)
    dev = "cuda"
    x = torch.randn(x_shape, generator=gen, device=dev).to(torch.bfloat16)
    k = (torch.randn((3, 3, ci, co), generator=gen, device=dev)
         * (9 * ci) ** -0.5).to(torch.bfloat16)
    bias = torch.randn((co,), generator=gen, device=dev) * 0.1
    kw = {"upsample": up}
    if pro:
        kw["prologue_scale"] = 0.5 + torch.rand((b, ci), generator=gen, device=dev)
        kw["prologue_bias"] = torch.randn((b, ci), generator=gen, device=dev) * 0.5
    if res:
        kw["residual"] = torch.randn((b, h, w, co), generator=gen, device=dev).to(torch.bfloat16)
    return x, k, bias, kw


def conv_cost(x_shape, co, *, pro, res, up, stats):
    """(bytes, flops): each input read once, each output written once."""
    b, hx, wx, ci = x_shape
    h, w = (2 * hx, 2 * wx) if up else (hx, wx)
    by = b * hx * wx * ci * 2 + 9 * ci * co * 2 + co * 4 + b * h * w * co * 2
    by += 2 * b * ci * 4 if pro else 0
    by += b * h * w * co * 2 if res else 0
    by += b * 2 * co * 4 if stats else 0
    return by, 2.0 * b * h * w * co * 9 * ci


def flash_cost(q_shape, lk):
    """(bytes, tensor operations, exponentials): one exponential per score."""
    b, h, lq, d = q_shape
    return (2 * (b * h * lq * d * 2) + 2 * (b * h * lk * d * 2), 4.0 * b * h * lq * lk * d,
            float(b * h * lq * lk))


def flash_stats_cost(q_shape, lk):
    """Kernel C's bytes and operations plus the m and l rows it writes."""
    b, h, lq, _ = q_shape
    by, ops, exps = flash_cost(q_shape, lk)
    return by + 2 * b * h * lq * 4, ops, exps


def out_proj_cost(o_shape, c):
    """o, w, the f32 bias, the residual read once; the output written once."""
    b, h, l, d = o_shape
    return b * h * l * d * 2 + h * d * c * 2 + c * 4 + 2 * b * l * c * 2, 2.0 * b * l * c * h * d


def int8_conv_cost(x_shape, co, *, res, stats):
    """(bytes, int8 ops) of one int8 slab call: x bf16, the int8 kernel,
    bias, w_scale, the (B, Ci) prologue, the (Ci,) codes' scale and zero
    point, the bf16 output, residual and moments."""
    b, h, w, ci = x_shape
    by = b * h * w * ci * 2 + 9 * ci * co + 2 * co * 4 + 2 * b * ci * 4 + 2 * ci * 4
    by += b * h * w * co * 2 * (2 if res else 1)
    by += b * 2 * co * 4 if stats else 0
    return by, 2.0 * b * h * w * co * 9 * ci


def bound_terms(cost, peak_ops=PEAK_BF16_FLOPS, exp_rate=None):
    """(byte ms, operation ms): bytes / PEAK_BYTES, and the larger of
    operations / ``peak_ops`` and, for a flash kernel's (bytes, ops, exps),
    exponentials / ``exp_rate`` (per second)."""
    t_ops = max(cost[1] / peak_ops, cost[2] / exp_rate if len(cost) > 2 else 0.0)
    return cost[0] / PEAK_BYTES * 1e3, t_ops * 1e3


def bound_ms(cost, peak_ops=PEAK_BF16_FLOPS, exp_rate=None):
    """(ms, "bytes" or "operations"): the larger of the two bound terms."""
    t_by, t_ops = bound_terms(cost, peak_ops, exp_rate)
    return max(t_by, t_ops), "bytes" if t_by > t_ops else "operations"


def max_err(a, b):
    return float((a.float() - b.float()).abs().max()), float(b.float().abs().max())


def check_conv(torch, gen, case):
    from sdtpu_torch.kernels.conv2d import conv3x3_slab, conv3x3_slab_plain

    x_shape, co, pro, res, up, stats = case
    x, k, bias, kw = conv_inputs(torch, gen, x_shape, co, pro=pro, res=res, up=up)
    got = conv3x3_slab(x, k, bias, emit_stats=stats, **kw)
    want = conv3x3_slab_plain(x, k, bias, emit_stats=stats, **kw)
    torch.cuda.synchronize()
    if stats:
        (got, gst), (want, wst) = got, want
        serr, sref = max_err(gst, wst)
    err, ref = max_err(got, want)
    ok = err <= TOL_REL * ref and (not stats or serr <= TOL_REL * sref)
    name = "conv3x3_slab_upsample" if up else "conv3x3_slab"
    moments = f" moments max_abs_err={serr:.4g} (max={sref:.4g})" if stats else ""
    log(f"check {name} x={tuple(x_shape)} co={co} prologue={pro} residual={res} "
        f"stats={stats}: max_abs_err={err:.4g} (max|plain|={ref:.4g}, rel {err / ref:.3g}, "
        f"tol {TOL_REL:g}){moments}" + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return name, err


def flash_qkv(torch, gen, q_shape, lk):
    q = torch.randn(q_shape, generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(q_shape[:2] + (lk, q_shape[3]), generator=gen,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    return q, k, v


def check_flash(torch, gen, q_shape, lk=None, stats=False):
    """Kernel C (or F with ``stats``: out, m and l) against its plain
    version, each within TOL_REL of its max |plain|."""
    from sdtpu_torch.kernels.flash_attention import (
        flash_attention_packed,
        flash_attention_plain,
        flash_attention_stats_packed,
        flash_attention_stats_plain,
        plan_flash,
    )

    lk = q_shape[2] if lk is None else lk
    q, k, v = flash_qkv(torch, gen, q_shape, lk)
    if stats:
        got, want = flash_attention_stats_packed(q, k, v), flash_attention_stats_plain(q, k, v)
    else:
        got, want = (flash_attention_packed(q, k, v),), (flash_attention_plain(q, k, v),)
    torch.cuda.synchronize()
    errs = [max_err(g, w) for g, w in zip(got, want)]
    ok = all(e <= TOL_REL * r for e, r in errs)
    name = "flash_attention_stats" if stats else "flash_attention"
    b, h, lq, d = q_shape
    log(f"check {name} q={tuple(q_shape)} lk={lk} plan (bq, splits)="
        f"{plan_flash(b * h, lq, lk, d)}: "
        + ", ".join(f"{n} max_abs_err={e:.4g} (max|plain|={r:.4g})"
                    for n, (e, r) in zip(("out", "m", "l"), errs))
        + f", tol {TOL_REL:g} rel" + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return name, errs[0][0]


def merge_ws(torch, gen, splits, bh, lq):
    """A random workspace of the wide plan's merge (l > 0)."""
    from sdtpu_torch.kernels.flash_attention import FLASH_WIDE_DP

    n = splits * bh * lq
    return torch.cat([torch.randn(n * FLASH_WIDE_DP, generator=gen, device="cuda"),
                      4.0 * torch.randn(n, generator=gen, device="cuda"),
                      1.0 + 49.0 * torch.rand(n, generator=gen, device="cuda")])


def check_merge(torch, gen, splits, bh, lq, d):
    """The merge kernel alone against its plain version (out, m, l, each
    within TOL_REL of its max |plain|)."""
    from sdtpu_torch.kernels.flash_attention import flash_attention_merge, flash_merge_plain

    ws = merge_ws(torch, gen, splits, bh, lq)
    got = flash_attention_merge(ws, bh, lq, d, splits, stats=True)
    want = flash_merge_plain(ws, bh, lq, d, splits)
    torch.cuda.synchronize()
    errs = [max_err(g, w) for g, w in zip(got, want)]
    ok = all(e <= TOL_REL * r for e, r in errs)
    log(f"check flash_attention_merge splits={splits} rows={bh}x{lq} d={d}: "
        + ", ".join(f"{n} max_abs_err={e:.4g} (max|plain|={r:.4g})"
                    for n, (e, r) in zip(("out", "m", "l"), errs))
        + f", tol {TOL_REL:g} rel" + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError("flash_attention_merge disagrees with its plain version")
    return errs[0][0]


def time_conv(torch, gen, cfg):
    """Kernel, plain and cuDNN ms by CUDA events, then the kernel's (every
    kernel of the wrapper call) and cuDNN's device ms by the profiler."""
    from sdtpu_torch.kernels.conv2d import conv3x3_slab, conv3x3_slab_plain

    x_shape, co, pro, res, up, stats = cfg
    x, k, bias, kw = conv_inputs(torch, gen, x_shape, co, pro=pro, res=res, up=up)
    big = x.numel() * co > 2**31
    reps = 5 if big else 20
    run = functools.partial(conv3x3_slab, x, k, bias, emit_stats=stats, **kw)
    lib = cudnn_call(torch, x, k, bias, kw)
    t_k = event_ms(run, reps)
    t_p = event_ms(lambda: conv3x3_slab_plain(x, k, bias, emit_stats=stats, **kw),
                   2 if big else 5)
    return t_k, t_p, event_ms(lib, reps), device_ms(run, 10), device_ms(lib, 10)


def cudnn_call(torch, x, k, bias, kw):
    """Yardstick: one cuDNN bf16 conv on the prologued (and upsampled)
    input, as a function of no arguments."""
    import torch.nn.functional as F

    y = x
    if kw.get("prologue_scale") is not None:
        y = x.float() * kw["prologue_scale"][:, None, None, :] + kw["prologue_bias"][:, None, None, :]
        y = (y * torch.sigmoid(y)).to(torch.bfloat16)
    if kw.get("upsample"):
        y = y.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    y_nchw = y.permute(0, 3, 1, 2)  # channels_last memory
    w_oihw = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    b16 = bias.to(torch.bfloat16)
    return lambda: F.conv2d(y_nchw, w_oihw, b16, padding=1)


def int8_case(torch, gen, x_shape, co, res, stats):
    """One int8 slab call configuration: check kernel D against its plain
    version, then time D, the plain version, and the two float
    counterparts at the same shape (kernel A, cuDNN bf16), which compute a
    different function.  The codes' scale and zero point come from a
    GroupNorm affine equal to batch 0's prologue, so they cover the
    activations as the model's own do."""
    from sdtpu_torch.kernels.conv2d import conv3x3_slab, conv3x3_slab_plain
    from sdtpu_torch.utils.quant import act_qparams_from_norm, quantize_conv_w8a8

    x, k, bias, kw = conv_inputs(torch, gen, x_shape, co, pro=True, res=res, up=False)
    s, z = act_qparams_from_norm({"scale": kw["prologue_scale"][0],
                                  "bias": kw["prologue_bias"][0]})
    q, ws, zp = quantize_conv_w8a8(k, s, z)

    def dev(a):
        return torch.from_numpy(a).to("cuda")

    q, qbias = dev(q), bias - dev(zp)
    qkw = dict(kw, act_inv_scale=1.0 / dev(s), act_zp=dev(z), w_scale=dev(ws))
    got = conv3x3_slab(x, q, qbias, emit_stats=stats, **qkw)
    want = conv3x3_slab_plain(x, q, qbias, emit_stats=stats, **qkw)
    torch.cuda.synchronize()
    serr = sref = 0.0
    if stats:
        (got, gst), (want, wst) = got, want
        serr, sref = max_err(gst, wst)
    err, ref = max_err(got, want)
    share = float((got.float() != want.float()).float().mean())
    ok = err <= TOL_REL * ref and serr <= TOL_REL * max(sref, 1e-30)
    log(f"check conv3x3_slab_int8 x={tuple(x_shape)} co={co} residual={res} stats={stats}: "
        f"max_abs_err={err:.4g} (max|plain|={ref:.4g}, tol {TOL_REL:g} rel), "
        f"share of outputs differing {share:.3g}"
        + (f", moments max_abs_err={serr:.4g} (max={sref:.4g})" if stats else "")
        + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError("conv3x3_slab_int8 disagrees with its plain version")
    big = x.numel() * co > 2**31
    reps = 5 if big else 20
    t_k = event_ms(lambda: conv3x3_slab(x, q, qbias, emit_stats=stats, **qkw), reps)
    t_p = event_ms(lambda: conv3x3_slab_plain(x, q, qbias, emit_stats=stats, **qkw), 2)
    t_a = event_ms(lambda: conv3x3_slab(x, k, bias, emit_stats=stats, **kw), reps)
    t_l = event_ms(cudnn_call(torch, x, k, bias, kw), reps)
    return err, share, t_k, t_p, t_a, t_l


def time_flash(torch, gen, q_shape, lk):
    """Kernel C (with its merge where the plan splits), its plain version
    and the library by CUDA events, then the kernels' and the library's
    device ms by the profiler.  Library: SDPA, the memory-efficient one
    where flash refuses the head dim (D > 256)."""
    from sdtpu_torch.kernels.flash_attention import flash_attention_packed, flash_attention_plain

    q, k, v = flash_qkv(torch, gen, q_shape, lk)
    aten = torch.ops.aten
    if q_shape[3] > 256:
        lib = lambda: aten._scaled_dot_product_efficient_attention(q, k, v, None, False)  # noqa: E731
    else:
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)  # noqa: E731
    t_k = event_ms(lambda: flash_attention_packed(q, k, v), 10)
    t_p = event_ms(lambda: flash_attention_plain(q, k, v), 3)
    t_l = event_ms(lib, 10)
    return t_k, t_p, t_l, device_ms(lambda: flash_attention_packed(q, k, v), 10), device_ms(lib, 10)


def flash_stats_case(torch, gen, q_shape, lk):
    """Kernel F at one call shape: out, m and l against the plain version
    (each within TOL_REL of its max |plain|), then the times.  Library: the
    flash SDPA that returns the log-sum-exp (m + log l, not m and l), or the
    memory-efficient one where flash refuses the head dim."""
    from sdtpu_torch.kernels.flash_attention import (
        flash_attention_stats_packed,
        flash_attention_stats_plain,
    )

    q = torch.randn(q_shape, generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(q_shape[:2] + (lk, q_shape[3]), generator=gen,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    got = flash_attention_stats_packed(q, k, v)
    want = flash_attention_stats_plain(q, k, v)
    torch.cuda.synchronize()
    errs = [max_err(g, w) for g, w in zip(got, want)]
    ok = all(e <= TOL_REL * r for e, r in errs)
    log(f"check flash_attention_stats q={tuple(q_shape)} lk={lk}: "
        + ", ".join(f"{n} max_abs_err={e:.4g} (max|plain|={r:.4g})"
                    for n, (e, r) in zip(("out", "m", "l"), errs))
        + f", tol {TOL_REL:g} rel" + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError("flash_attention_stats disagrees with its plain version")
    t_k = event_ms(lambda: flash_attention_stats_packed(q, k, v), 10)
    t_p = event_ms(lambda: flash_attention_stats_plain(q, k, v), 3)
    aten = torch.ops.aten
    libs = (("_scaled_dot_product_flash_attention", lambda: aten._scaled_dot_product_flash_attention(q, k, v)),
            ("_scaled_dot_product_efficient_attention",
             lambda: aten._scaled_dot_product_efficient_attention(q, k, v, None, True)))
    t_l = lib_call = None
    for name, fn in libs:
        try:
            t_l = event_ms(fn, 10)
        except RuntimeError as exc:
            log(f"library {name} refuses q={tuple(q_shape)}: {str(exc).splitlines()[0]}")
            continue
        log(f"library for flash_attention_stats q={tuple(q_shape)} lk={lk}: aten.{name} "
            f"(returns the log-sum-exp m + log l, not m and l): {t_l:.4f} ms")
        lib_call = f"aten.{name}"
        break
    dev = {"kernel": device_ms(lambda: flash_attention_stats_packed(q, k, v), 10),
           "library": None if t_l is None else device_ms(fn, 10),
           "library_call": lib_call}
    return errs[0][0], t_k, t_p, t_l, dev


def out_proj_case(torch, gen, o_shape, c):
    """Kernel G at one call shape against its plain version, then the
    times.  Library: the default route's einsum + bias + residual in bf16
    (three roundings where G rounds once)."""
    from sdtpu_torch.kernels.flash_attention import out_proj_packed, out_proj_packed_plain

    b, h, l, d = o_shape
    o = torch.randn(o_shape, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((h, d, c), generator=gen, device="cuda") * (h * d) ** -0.5).to(torch.bfloat16)
    bias = torch.randn((c,), generator=gen, device="cuda") * 0.1
    res = torch.randn((b, l, c), generator=gen, device="cuda").to(torch.bfloat16)
    got = out_proj_packed(o, w, bias, res)
    want = out_proj_packed_plain(o, w, bias, res)
    torch.cuda.synchronize()
    err, ref = max_err(got, want)
    ok = err <= TOL_REL * ref
    log(f"check out_proj_packed o={tuple(o_shape)} c={c}: max_abs_err={err:.4g} "
        f"(max|plain|={ref:.4g}, rel {err / ref:.3g}, tol {TOL_REL:g})" + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError("out_proj_packed disagrees with its plain version")
    b16 = bias.to(torch.bfloat16)
    t_k = event_ms(lambda: out_proj_packed(o, w, bias, res), 20)
    t_p = event_ms(lambda: out_proj_packed_plain(o, w, bias, res), 5)
    t_l = event_ms(lambda: torch.einsum("bhld,hdc->blc", o, w) + b16 + res, 20)
    dev = {"kernel": device_ms(lambda: out_proj_packed(o, w, bias, res), 20),
           "library": device_ms(lambda: torch.einsum("bhld,hdc->blc", o, w) + b16 + res,
                                20),
           "library_call": "einsum + bias + residual"}
    return err, t_k, t_p, t_l, dev


def record_main_path_calls(torch, pipe, ids):
    """A main path's kernel call configurations with their counts per
    image: one 1-step image recorded through shims, UNet calls (batch 2
    under CFG) scaled to STEPS steps.  Returns ``{wrapper: {config: n}}``;
    a conv configuration is (x shape, Co, prologue, residual, upsample,
    moments, int8 kernel), an attention one (q shape, Lk), an
    out-projection one (o shape, C).  The ring context in force, if any,
    applies."""
    # sys.modules: the package sdtpu_torch.ops re-exports a function named
    # ``attention`` that shadows its submodule of that name
    real = {key: getattr(sys.modules[sites[0][0]], sites[0][1]) for key, sites in _SITES.items()}
    calls = {key: Counter() for key in _SITES}

    def conv_shim(x, kernel, conv_bias=None, **kw):
        calls["conv3x3_slab"][(tuple(x.shape), kernel.shape[-1],
                               kw.get("prologue_scale") is not None,
                               kw.get("residual") is not None, bool(kw.get("upsample")),
                               bool(kw.get("emit_stats")), kernel.dtype == torch.int8)] += 1
        return real["conv3x3_slab"](x, kernel, conv_bias, **kw)

    def attn_shim(key):
        def shim(q, k, v):
            calls[key][(tuple(q.shape), k.shape[2])] += 1
            return real[key](q, k, v)
        return shim

    def out_proj_shim(o, w, bias, residual):
        calls["out_proj_packed"][(tuple(o.shape), w.shape[-1])] += 1
        return real["out_proj_packed"](o, w, bias, residual)

    with routed(conv3x3_slab=conv_shim,
                flash_attention_packed=attn_shim("flash_attention_packed"),
                flash_attention_stats_packed=attn_shim("flash_attention_stats_packed"),
                out_proj_packed=out_proj_shim):
        pipe.generate(token_ids=ids, num_inference_steps=1, seed=1, image_size=512)

    def per_image(shape):
        return STEPS if shape[0] == 2 else 1  # UNet runs at batch 2, the VAE at 1

    return {key: {c: n * per_image(c[0]) for c, n in cs.items()} for key, cs in calls.items()}


def conv_sub_counts(conv_calls):
    """The slab conv's pre-pass and split-K reduction launches per image of
    a path, from its recorded float slab calls and the split plan."""
    from sdtpu_torch.kernels.conv2d import conv3x3_launches

    subs = {"conv3x3_slab_prologue": 0, "conv3x3_slab_splitk": 0}
    for (x_shape, co, pro, _res, up, _stats, quant), n in conv_calls.items():
        if quant:
            continue
        for key, v in conv3x3_launches("conv3x3_slab", x_shape, co, prologue=pro,
                                       upsample=up).items():
            if key in subs:
                subs[key] += n * v
    return subs


def flash_sub_counts(calls):
    """Flash attention's key-split merge launches per image of a path, from
    its recorded C and F calls and the tile plan."""
    from sdtpu_torch.kernels.flash_attention import flash_launches

    n_merge = 0
    for key, wrapper in (("flash_attention", "flash_attention_packed"),
                         ("flash_attention_stats", "flash_attention_stats_packed")):
        for (q_shape, lk), n in calls[wrapper].items():
            n_merge += n * flash_launches(key, q_shape, lk).get("flash_attention_merge", 0)
    return {"flash_attention_merge": n_merge}


def check_prologue(torch, gen, x_shape):
    """The pre-pass alone against its plain version (tolerance TOL_REL)."""
    from sdtpu_torch.kernels.conv2d import conv3x3_prologue, conv3x3_prologue_plain

    x, _, _, kw = conv_inputs(torch, gen, x_shape, 8, pro=True, res=False, up=False)
    a, c = kw["prologue_scale"], kw["prologue_bias"]
    got, want = conv3x3_prologue(x, a, c), conv3x3_prologue_plain(x, a, c)
    torch.cuda.synchronize()
    err, ref = max_err(got, want)
    ok = err <= TOL_REL * ref
    log(f"check conv3x3_slab_prologue x={tuple(x_shape)}: max_abs_err={err:.4g} "
        f"(max|plain|={ref:.4g}, tol {TOL_REL:g} rel)" + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError("conv3x3_prologue disagrees with its plain version")
    return err


def splitk_inputs(torch, gen, ws_shape, *, res):
    splits, b, h, w, co = ws_shape
    ws = torch.randn(ws_shape, generator=gen, device="cuda")
    bias = torch.randn((co,), generator=gen, device="cuda") * 0.1
    r = (torch.randn((b, h, w, co), generator=gen, device="cuda").to(torch.bfloat16)
         if res else None)
    return ws, bias, r


def check_splitk(torch, gen, ws_shape, res):
    """The split-K reduction alone against its plain version: the same
    float32 additions in the same order, so the output bitwise; moments
    within TOL_REL."""
    from sdtpu_torch.kernels.conv2d import conv3x3_splitk_reduce, splitk_reduce_plain

    ws, bias, r = splitk_inputs(torch, gen, ws_shape, res=res)
    got, gst = conv3x3_splitk_reduce(ws, bias, r, emit_stats=True)
    want, wst = splitk_reduce_plain(ws, bias, r, emit_stats=True)
    torch.cuda.synchronize()
    err, ref = max_err(got, want)
    serr, sref = max_err(gst, wst)
    ok = bool(torch.equal(got, want)) and serr <= TOL_REL * sref
    log(f"check conv3x3_slab_splitk ws={tuple(ws_shape)} residual={res}: max_abs_err={err:.4g} "
        f"(bitwise), moments max_abs_err={serr:.4g} (max={sref:.4g}, tol {TOL_REL:g} rel)"
        + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError("conv3x3_splitk_reduce disagrees with its plain version")
    return err


def rel_l2(torch, a, b):
    return float(torch.linalg.vector_norm((a.float() - b.float()).flatten())
                 / torch.linalg.vector_norm(b.float().flatten()))


def to_dtype(tree, dtype):
    if isinstance(tree, dict):
        return {k: to_dtype(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_dtype(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


# ------------------------------------------------------------------- main --

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every measurement to this JSON file")
    args = ap.parse_args()

    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("float32 references: torch.backends.cuda.matmul.allow_tf32=False, "
        "torch.backends.cudnn.allow_tf32=False")
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    exp_rate = EXP_PER_CLOCK_SM * SMS * sm_mhz * 1e6
    log(f"exponential units: {EXP_PER_CLOCK_SM}/clock/SM x {SMS} SMs x {sm_mhz:.0f} MHz "
        f"(clocks.max.sm) = {exp_rate:.4g} exp/s")

    import numpy as np

    from sdtpu_torch import StableDiffusionPipeline
    from sdtpu_torch.kernels import _build, launch_counts, reset_launch_counts
    from sdtpu_torch.kernels.conv2d import (
        conv3x3_prologue,
        conv3x3_prologue_plain,
        conv3x3_splitk_reduce,
        plan_conv3x3_split,
        splitk_reduce_plain,
    )
    from sdtpu_torch.kernels.flash_attention import (
        flash_attention_merge,
        flash_merge_plain,
        plan_flash,
    )
    from sdtpu_torch.parallel import LocalRing, ring_context

    details = {"device": smi, "sm_clock_max_mhz": sm_mhz, "exp_per_s": exp_rate}
    plain = plain_routes()

    # phase 2: build
    t0 = time.perf_counter()
    report = _build.build(ptxas_verbose=True)
    build_s = time.perf_counter() - t0
    for name, (secs, out) in report.items():
        lines = [ln.strip() for ln in out.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"build {name}.cu: {secs:.1f} s")
        for ln in lines:
            log(f"  ptxas {name}: {ln}")
    log(f"build: {build_s:.1f} s for {len(report)} sources (nvcc sm_90a)")
    details["build_s"] = build_s

    # phase 3: kernels
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    for case in [
        ((2, 64, 64, 320), 320, True, True, False, True),
        ((2, 16, 16, 2560), 1280, True, False, False, True),
        ((1, 512, 512, 256), 128, True, False, False, True),
        ((2, 16, 16, 1280), 1280, False, False, True, False),
        ((1, 256, 256, 256), 256, False, False, True, True),
        # split-K shapes (S = 4, 2, 2): residual and moments through the reduction
        ((2, 16, 16, 2560), 1280, True, True, False, True),
        ((2, 32, 32, 640), 640, True, True, False, True),
        ((1, 64, 64, 512), 512, True, True, False, True),
    ]:
        name, err = check_conv(torch, gen, case)
        errs[name] = max(errs.get(name, 0.0), err)
    errs["conv3x3_slab_prologue"] = max(check_prologue(torch, gen, s) for s in (
        (2, 64, 64, 320), (2, 16, 16, 2560), (1, 512, 512, 256)))
    errs["conv3x3_slab_splitk"] = max(check_splitk(torch, gen, s, r) for s, r in (
        ((4, 2, 16, 16, 1280), True), ((2, 2, 32, 32, 640), False), ((2, 1, 64, 64, 512), True)))
    for q_shape in [(2, 8, 4096, 40), (2, 8, 1024, 80), (2, 8, 256, 160), (1, 1, 4096, 512)]:
        name, err = check_flash(torch, gen, q_shape)
        errs[name] = max(errs.get(name, 0.0), err)
    # ragged shapes, C and F: Lq and Lk no multiple of their tiles (4000 rows
    # take 128-row tiles at D = 40), and Lq under one tile
    for d in (40, 80, 160, 512):
        for lq, lk in ((4000, 3999), (1000, 1001), (10, 77)):
            for stats in (False, True):
                name, err = check_flash(torch, gen, (2, 8, lq, d), lk, stats)
                errs[name] = max(errs.get(name, 0.0), err)
    errs["flash_attention_merge"] = max(check_merge(torch, gen, *c) for c in (
        (4, 1, 4096, 512), (16, 1, 1024, 512), (2, 3, 100, 168)))

    ids = np.random.default_rng(40).integers(1, 49408, (2, 77))
    pipe = StableDiffusionPipeline.from_random("tiny-sd", seed=0, device="cuda")
    pcfg = pipe.config
    pipe_ring = StableDiffusionPipeline(pcfg.replace(attention_impl="ring"), pipe.params,
                                        device="cuda")
    attn_mod = sys.modules["sdtpu_torch.ops.attention"]
    calls = record_main_path_calls(torch, pipe, ids)
    with ring_context(LocalRing(RING)):
        ring_calls = record_main_path_calls(torch, pipe_ring, ids)
    attn_mod._PACKED_OUT_PROJ = True
    try:
        packed_calls = record_main_path_calls(torch, pipe, ids)
    finally:
        attn_mod._PACKED_OUT_PROJ = False
    totals = {n: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                  "bound_ms_without_exp": 0.0, "byte_ms": 0.0, "op_ms": 0.0,
                  "per_image_calls": 0} for n in SOURCES}
    rows = []
    # the profiler's device time per image beside the CUDA-event sums: a
    # small conv's back-to-back calls can be bound by their host-side
    # enqueue (three kernels and their checks), which events then time
    device = {}

    def add_device(name, n, d_k, d_l=None):
        tot = device.setdefault(name, {"kernel_ms": 0.0, "library_ms": 0.0})
        for key, d in (("kernel_ms", d_k), ("library_ms", d_l)):
            tot[key] = None if d is None or tot[key] is None else tot[key] + n * d

    def fmt_ms(v):
        return "not measured" if v is None else f"{v:.4f} ms"

    details["conv_configs"] = []
    for cfg, n in sorted(calls["conv3x3_slab"].items()):
        x_shape, co, pro, res, up, stats, _ = cfg
        b, hx, wx, ci = x_shape
        h, w = (2 * hx, 2 * wx) if up else (hx, wx)
        splits = plan_conv3x3_split(b, h, w, ci, co)
        details["conv_configs"].append({"x": list(x_shape), "co": co, "pro": pro, "res": res,
                                        "up": up, "stats": stats, "per_image": n,
                                        "split": splits})
        t_k, t_p, t_l, d_k, d_l = time_conv(torch, gen, cfg[:6])
        cost = conv_cost(x_shape, co, pro=pro, res=res, up=up, stats=stats)
        desc = f"x={x_shape} co={co} pro={int(pro)} res={int(res)} st={int(stats)} S={splits}"
        name = "conv3x3_slab_upsample" if up else "conv3x3_slab"
        rows.append((name, desc, n, t_k, t_p, t_l, cost, PEAK_BF16_FLOPS))
        add_device(name, n, d_k, d_l)
        details["conv_configs"][-1].update(device_ms=d_k, cudnn_device_ms=d_l)
        log(f"device time {name} {desc}: kernels {fmt_ms(d_k)}, cuDNN {fmt_ms(d_l)} "
            f"(torch.profiler, per call)")
        # the call's sub-kernels alone: the pre-pass, the split-K reduction
        if pro:
            x, _, _, kw = conv_inputs(torch, gen, x_shape, 8, pro=True, res=False, up=False)
            a, c = kw["prologue_scale"], kw["prologue_bias"]
            run = functools.partial(conv3x3_prologue, x, a, c)
            rows.append(("conv3x3_slab_prologue", f"x={x_shape}", n, event_ms(run, 20),
                         event_ms(lambda: conv3x3_prologue_plain(x, a, c), 5), None,
                         (2 * x.numel() * 2 + 2 * b * ci * 4, 0.0), PEAK_BF16_FLOPS))
            d_sub = device_ms(run, 10)
            add_device("conv3x3_slab_prologue", n, d_sub)
            details["conv_configs"][-1]["prologue_device_ms"] = d_sub
            share = "" if None in (d_sub, d_k) else f", {100 * d_sub / d_k:.1f}% of the call's"
            log(f"device time conv3x3_slab_prologue x={x_shape}: {fmt_ms(d_sub)}{share}")
            del x
        if splits > 1:
            ws_shape = (splits, b, h, w, co)
            ws, bias, r = splitk_inputs(torch, gen, ws_shape, res=res)
            run = functools.partial(conv3x3_splitk_reduce, ws, bias, r, emit_stats=stats)
            d_sub = device_ms(run, 10)
            add_device("conv3x3_slab_splitk", n, d_sub)
            details["conv_configs"][-1]["splitk_device_ms"] = d_sub
            share = "" if None in (d_sub, d_k) else f", {100 * d_sub / d_k:.1f}% of the call's"
            log(f"device time conv3x3_slab_splitk ws={ws_shape}: {fmt_ms(d_sub)}{share}")
            rows.append(("conv3x3_slab_splitk", f"ws={ws_shape} res={int(res)} st={int(stats)}",
                         n, event_ms(run, 20),
                         event_ms(lambda: splitk_reduce_plain(ws, bias, r, emit_stats=stats), 5),
                         None, (ws.numel() * 4 + co * 4 + b * h * w * co * 2 * (2 if res else 1)
                                + (b * 2 * co * 4 if stats else 0), 0.0), PEAK_BF16_FLOPS))
            del ws
    for (q_shape, lk), n in sorted(calls["flash_attention_packed"].items()):
        t_k, t_p, t_l, d_k, d_l = time_flash(torch, gen, q_shape, lk)
        b, h, lq, d = q_shape
        bq, splits = plan_flash(b * h, lq, lk, d)
        desc = f"q={q_shape} lk={lk} bq={bq} splits={splits}"
        rows.append(("flash_attention", desc, n, t_k, t_p, t_l, flash_cost(q_shape, lk),
                     PEAK_BF16_FLOPS))
        add_device("flash_attention", n, d_k, d_l)
        details.setdefault("flash_configs", []).append(
            {"q": list(q_shape), "lk": lk, "per_image": n, "bq": bq, "splits": splits,
             "ms": t_k, "plain_ms": t_p, "library_ms": t_l, "device_ms": d_k,
             "library_device_ms": d_l})
        log(f"device time flash_attention {desc}: kernels {fmt_ms(d_k)}, library "
            f"{fmt_ms(d_l)} (torch.profiler, per call)")
        if splits > 1:  # the merge alone, on a workspace of this call's shape
            ws = merge_ws(torch, gen, splits, b * h, lq)
            run = functools.partial(flash_attention_merge, ws, b * h, lq, d, splits)
            d_sub = device_ms(run, 10)
            add_device("flash_attention_merge", n, d_sub)
            share = "" if None in (d_sub, d_k) else f", {100 * d_sub / d_k:.1f}% of the call's"
            log(f"device time flash_attention_merge splits={splits} rows={b * h}x{lq}: "
                f"{fmt_ms(d_sub)}{share}")
            rows.append(("flash_attention_merge", f"splits={splits} rows={b * h}x{lq} d={d}", n,
                         event_ms(run, 20),
                         event_ms(lambda: flash_merge_plain(ws, b * h, lq, d, splits), 5), None,
                         (ws.numel() * 4 + b * h * lq * d * 2, 0.0), PEAK_BF16_FLOPS))
            del ws
    log("device time flash_attention per image (torch.profiler): kernels "
        f"{fmt_ms(device['flash_attention']['kernel_ms'])}, library "
        f"{fmt_ms(device['flash_attention']['library_ms'])}")
    # F and G: besides the CUDA-event time of back-to-back calls, the
    # profiler's device time, since at these shapes a call's kernel can be
    # shorter than its host-side enqueue
    cases = [("flash_attention_stats", f"q={q} lk={lk}", n, flash_stats_cost(q, lk),
              functools.partial(flash_stats_case, torch, gen, q, lk))
             for (q, lk), n in sorted(ring_calls["flash_attention_stats_packed"].items())]
    cases += [("out_proj_packed", f"o={o} c={c}", n, out_proj_cost(o, c),
               functools.partial(out_proj_case, torch, gen, o, c))
              for (o, c), n in sorted(packed_calls["out_proj_packed"].items())]
    for name, desc, n, cost, case in cases:
        err, t_k, t_p, t_l, dev = case()
        errs[name] = max(errs.get(name, 0.0), err)
        rows.append((name, desc, n, t_k, t_p, t_l, cost, PEAK_BF16_FLOPS))
        fmt = {k: "not measured" if dev[k] is None else f"{dev[k]:.4f} ms"
               for k in ("kernel", "library")}
        log(f"device time {name} {desc}: kernel {fmt['kernel']}, library "
            f"({dev['library_call']}) {fmt['library']} (torch.profiler, per call)")
        details.setdefault("device_ms_per_call", []).append(
            {"kernel": name, "config": desc, "per_image": n, "kernel_ms": dev["kernel"],
             "library_ms": dev["library"], "library_call": dev["library_call"]})
        tot = device.setdefault(name, {"kernel_ms": 0.0, "library_ms": 0.0})
        for k in ("kernel", "library"):
            tot[f"{k}_ms"] = None if dev[k] is None or tot[f"{k}_ms"] is None \
                else tot[f"{k}_ms"] + n * dev[k]
    details["device_ms_per_image"] = device
    log(f"device time per image (torch.profiler): {device}")

    # phase 4: end to end, bf16
    counts, e2e = run_image(torch, np, pipe, ids, "e2e", launch_counts, reset_launch_counts)
    e2e_expected = dict(E2E_COUNTS, **conv_sub_counts(calls["conv3x3_slab"]),
                        **flash_sub_counts(calls))
    log(f"e2e expected launches: {e2e_expected}")
    if counts != e2e_expected:
        raise AssertionError(f"launch counts {counts} != expected {e2e_expected}")
    idle = [name for name in MAIN_KERNELS if counts[name] == 0]
    if idle:
        raise AssertionError(f"the bf16 image launched no {idle}")
    details["e2e"] = e2e

    # control: one UNet forward and one VAE decode, kernels vs plain, beside
    # the plain path's bf16-vs-float32 difference
    from sdtpu_torch.models.unet import unet_forward
    from sdtpu_torch.models.vae import vae_decode

    lat = torch.randn((2, 64, 64, 4), generator=gen, device="cuda")
    ctx = torch.randn((2, 77, 768), generator=gen, device="cuda")
    ts = torch.full((2,), 501.0, device="cuda")
    dec_in = torch.randn((1, 64, 64, 4), generator=gen, device="cuda")

    def unet(params, dt, impl="flash"):
        return unet_forward(lat.to(dt), ts, ctx.to(dt), params, pcfg.unet,
                            attention_impl=impl).float()

    def vae(params, dt, impl="flash"):
        return vae_decode(dec_in.to(dt), params, pcfg.vae, attention_impl=impl).float()

    def route_outputs(params, impl="flash"):
        """(kernels bf16, plain bf16, plain f32) of the UNet forward and of
        the VAE decode through one attention route."""
        params32 = {k: to_dtype(params[k], torch.float32) for k in ("unet", "vae_decoder")}
        with torch.inference_mode():
            k_out = (unet(params["unet"], torch.bfloat16, impl),
                     vae(params["vae_decoder"], torch.bfloat16, impl))
            with routed(**plain):
                p_out = (unet(params["unet"], torch.bfloat16, impl),
                         vae(params["vae_decoder"], torch.bfloat16, impl))
                f_out = (unet(params32["unet"], torch.float32, impl),
                         vae(params32["vae_decoder"], torch.float32, impl))
        return k_out, p_out, f_out

    def judge(label, outs):
        """kernels vs plain <= max(2 x the plain route's bf16-vs-f32, 1e-2)."""
        result = {}
        for i, what in enumerate(("unet_forward", "vae_decode")):
            k_out, p_out, f_out = (o[i] for o in outs)
            finite = bool(torch.isfinite(k_out).all())
            d_kp = rel_l2(torch, k_out, p_out)
            d_pf = rel_l2(torch, p_out, f_out)
            d_kf = rel_l2(torch, k_out, f_out)
            ok = finite and d_kp <= max(2.0 * d_pf, 1e-2)
            log(f"{label} {what}: rel L2 kernels-vs-plain (bf16) {d_kp:.4g}; plain "
                f"bf16-vs-f32 {d_pf:.4g}; kernels-vs-plain-f32 {d_kf:.4g}; finite {finite}; "
                f"tol max(2x bf16-vs-f32, 1e-2)" + (" ok" if ok else " FAIL"))
            result[what] = {"kernels_vs_plain": d_kp, "plain_bf16_vs_f32": d_pf,
                            "kernels_vs_f32": d_kf}
            if not ok:
                raise AssertionError(f"{label} {what}: kernels disagree with the plain route")
        return result

    flash_outs = route_outputs(pipe.params)
    (k_unet, k_vae), (p_unet, p_vae), _ = flash_outs
    control = judge("control", flash_outs)
    details["control"] = control

    # derived from the tree: the self-attention calls per image (every UNet
    # transformer block per step, the VAE mid-block's attention once)
    uparams = pipe.params["unet"]
    n_blocks = sum(len(a["blocks"]) for blk in uparams["down_blocks"] + uparams["up_blocks"]
                   for a in blk.get("attentions", []))
    n_blocks += sum(len(a["blocks"]) for a in uparams.get("mid_block", {}).get("attentions", []))
    n_self = STEPS * n_blocks + 1
    log(f"{n_blocks} UNet transformer blocks x {STEPS} steps + 1 VAE attention = {n_self} "
        f"self-attention calls per image")
    if n_self != E2E_COUNTS["flash_attention"]:
        raise AssertionError(f"{n_self} self-attention calls, but kernel C runs "
                             f"{E2E_COUNTS['flash_attention']} times per image")

    # phase 5: the sequence-parallel ring on the one card, kernel F
    ring_expected = dict(E2E_COUNTS, flash_attention=0, flash_attention_stats=RING * RING * n_self,
                         **conv_sub_counts(ring_calls["conv3x3_slab"]),
                         **flash_sub_counts(ring_calls))
    with ring_context(LocalRing(RING)):
        ring_counts, ring_e2e = run_image(torch, np, pipe_ring, ids, "ring", launch_counts,
                                          reset_launch_counts)
        log(f"ring expected launches ({RING}x{RING} F launches per self-attention call): "
            f"{ring_expected}")
        if ring_counts != ring_expected:
            raise AssertionError(f"ring launch counts {ring_counts} != expected {ring_expected}")
        ring_outs = route_outputs(pipe.params, "ring")
    details["ring"] = ring_e2e
    details["ring_control"] = judge("ring control", ring_outs)
    for i, what in enumerate(("unet_forward", "vae_decode")):
        d = rel_l2(torch, ring_outs[0][i], flash_outs[0][i])
        log(f"ring vs flash route (kernels, bf16) {what}: rel L2 {d:.4g} (for information)")
        details["ring_control"][what]["ring_vs_flash"] = d

    # phase 6: one-rank NCCL group: health_check and the ring over it
    details["nccl"] = nccl_phase(torch)

    # phase 7: the packed out-projection, kernel G
    packed_expected = dict(E2E_COUNTS, out_proj_packed=n_self,
                           **conv_sub_counts(packed_calls["conv3x3_slab"]),
                           **flash_sub_counts(packed_calls))
    attn_mod._PACKED_OUT_PROJ = True
    try:
        packed_counts, packed_e2e = run_image(torch, np, pipe, ids, "packed", launch_counts,
                                              reset_launch_counts)
        log(f"packed expected launches: {packed_expected}")
        if packed_counts != packed_expected:
            raise AssertionError(
                f"packed launch counts {packed_counts} != expected {packed_expected}")
        details["packed"] = packed_e2e
        details["packed_control"] = judge("packed control", route_outputs(pipe.params))
    finally:
        attn_mod._PACKED_OUT_PROJ = False
    # the three routes' seconds per image in turns inside this call (host-
    # side variance between calls is large)
    turns = []
    for route in ("flash", "packed", "ring", "ring", "packed", "flash"):
        attn_mod._PACKED_OUT_PROJ = route == "packed"
        try:
            with ring_context(LocalRing(RING) if route == "ring" else None):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                (pipe_ring if route == "ring" else pipe).generate(
                    token_ids=ids, num_inference_steps=STEPS, seed=40, image_size=512)
                turns.append((route, time.perf_counter() - t0))
        finally:
            attn_mod._PACKED_OUT_PROJ = False
    log("s/image in turns: " + ", ".join(f"{r} {t:.4f}" for r, t in turns))
    details["route_turns_s"] = turns
    pipe.params = pipe_ring.params = None  # the int8 image's peak memory holds only its own tree

    # phase 8: int8 (W8A8); kernel D checked and timed at every int8 call
    # shape (phase 3's work for this path), then the int8 image
    pipe_q = StableDiffusionPipeline.from_random("tiny-sd", seed=0, device="cuda")
    t0 = time.perf_counter()
    pipe_q.quantize_int8(transformer=True, vae=True)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    log(f"int8: quantize_int8(transformer=True, vae=True) took {quant_s:.3f} s on the host")
    details["quantize_s"] = quant_s
    q_all_calls = record_main_path_calls(torch, pipe_q, ids)
    q_calls = q_all_calls["conv3x3_slab"]
    # kernel D at every int8 call shape of the int8 path
    counterparts = {"kernel_A_ms": 0.0, "cudnn_bf16_ms": 0.0}
    d_configs = []
    for (x_shape, co, pro, res, up, stats, quant), n in sorted(q_calls.items()):
        if not quant:
            continue
        err, share, t_k, t_p, t_a, t_l = int8_case(torch, gen, x_shape, co, res, stats)
        errs["conv3x3_slab_int8"] = max(errs.get("conv3x3_slab_int8", 0.0), err)
        counterparts["kernel_A_ms"] += n * t_a
        counterparts["cudnn_bf16_ms"] += n * t_l
        desc = f"x={x_shape} co={co} res={int(res)} st={int(stats)}"
        cost = int8_conv_cost(x_shape, co, res=res, stats=stats)
        rows.append(("conv3x3_slab_int8", desc, n, t_k, t_p, None, cost, PEAK_INT8_OPS))
        d_configs.append({"config": desc, "per_image": n, "ms": t_k, "plain_ms": t_p,
                          "float_counterpart_kernel_A_ms": t_a,
                          "float_counterpart_cudnn_bf16_ms": t_l,
                          "max_abs_err": err, "share_differing": share,
                          "tops": cost[1] / t_k / 1e9})
        log(f"float counterparts of conv3x3_slab_int8 {desc} (not the same function): "
            f"kernel A {t_a:.4f} ms, cuDNN bf16 {t_l:.4f} ms; "
            f"D {cost[1] / t_k / 1e9:.1f} TOP/s, A {cost[1] / t_a / 1e9:.1f} TFLOP/s, "
            f"cuDNN {cost[1] / t_l / 1e9:.1f} TFLOP/s")
    details["int8_configs"] = d_configs
    details["configs"] = []
    for name, desc, n, t_k, t_p, t_l, cost, peak in rows:
        b_ms, b_by = bound_ms(cost, peak, exp_rate)
        b_old = bound_ms(cost[:2], peak)[0]
        t_by, t_ops = bound_terms(cost, peak, exp_rate)
        tot = totals[name]
        tot["per_image_calls"] += n
        tot["ms"] += n * t_k
        tot["plain_ms"] += n * t_p
        tot["library_ms"] = None if t_l is None else tot["library_ms"] + n * t_l
        tot["bound_ms"] += n * b_ms
        tot["bound_ms_without_exp"] += n * b_old
        tot["byte_ms"] += n * t_by
        tot["op_ms"] += n * t_ops
        lib = "library none" if t_l is None else f"library {t_l:.4f} ms"
        old = f", without the exp term {b_old:.4f} ms" if len(cost) > 2 else ""
        log(f"time {name} {desc} x{n}/image ({n * t_k:.3f} ms/image): kernel {t_k:.4f} ms, "
            f"plain {t_p:.4f} ms, "
            f"{lib}, bound {b_ms:.4f} ms ({b_by}{old}), {cost[1] / t_k / 1e9:.1f} T(FL)OP/s")
        details["configs"].append({"kernel": name, "config": desc, "per_image": n,
                                   "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                                   "bound_ms": b_ms, "bound_by": b_by,
                                   "bound_ms_without_exp": b_old,
                                   "bytes": cost[0], "ops": cost[1]})
    log("per-image bounds with the exp term (without): " + ", ".join(
        f"{n} {totals[n]['bound_ms']:.3f} ({totals[n]['bound_ms_without_exp']:.3f}) ms"
        for n in ("flash_attention", "flash_attention_stats")))
    log(f"float counterparts of conv3x3_slab_int8 per image (not the same function): "
        f"kernel A {counterparts['kernel_A_ms']:.3f} ms, cuDNN bf16 "
        f"{counterparts['cudnn_bf16_ms']:.3f} ms; D {totals['conv3x3_slab_int8']['ms']:.3f} ms")
    details["int8_float_counterparts_per_image"] = counterparts

    uparams = pipe_q.params["unet"]
    n_unet = sum(len(b["resnets"]) for b in uparams["down_blocks"] + uparams["up_blocks"])
    n_unet += len(uparams["mid_block"]["resnets"]) if "mid_block" in uparams else 0
    vparams = pipe_q.params["vae_decoder"]
    n_vae = len(vparams["mid_block"]["resnets"]) + sum(len(b["resnets"])
                                                       for b in vparams["up_blocks"])
    d_expected = 2 * n_unet * STEPS + 2 * n_vae
    log(f"int8: {n_unet} UNet resnets x 2 convs x {STEPS} steps + {n_vae} VAE resnets x 2 "
        f"convs = {d_expected} int8 slab convs per image")
    q_expected = dict(E2E_COUNTS, conv3x3_slab=0, conv3x3_slab_int8=d_expected,
                      **conv_sub_counts(q_calls), **flash_sub_counts(q_all_calls))
    if d_expected != 478:
        raise AssertionError(f"tiny-sd should have 478 resnet convs per image, got {d_expected}")
    q_counts, q_e2e = run_image(torch, np, pipe_q, ids, "int8", launch_counts,
                                reset_launch_counts)
    log(f"int8 expected launches: {q_expected}")
    if q_counts != q_expected:
        raise AssertionError(f"int8 launch counts {q_counts} != expected {q_expected}")
    details["int8"] = q_e2e

    q32 = {k: to_dtype(pipe_q.params[k], torch.float32) for k in ("unet", "vae_decoder")}
    with torch.inference_mode():
        kq_unet = unet(pipe_q.params["unet"], torch.bfloat16)
        kq_vae = vae(pipe_q.params["vae_decoder"], torch.bfloat16)
        with routed(**plain):
            pq_unet = unet(pipe_q.params["unet"], torch.bfloat16)
            pq_vae = vae(pipe_q.params["vae_decoder"], torch.bfloat16)
            fq_unet = unet(q32["unet"], torch.float32)
            fq_vae = vae(q32["vae_decoder"], torch.float32)
        # one kernel on the card, the rest plain: how far a single kernel's
        # bf16-level differences move the int8 route
        with routed(conv3x3_slab=plain["conv3x3_slab"]):
            cq_unet = unet(pipe_q.params["unet"], torch.bfloat16)
            cq_vae = vae(pipe_q.params["vae_decoder"], torch.bfloat16)
    del q32
    q_control = {}
    for what, k_out, p_out, f_out, c_out, p_bf16 in (
            ("unet_forward", kq_unet, pq_unet, fq_unet, cq_unet, p_unet),
            ("vae_decode", kq_vae, pq_vae, fq_vae, cq_vae, p_vae)):
        finite = bool(torch.isfinite(k_out).all())
        d_kp = rel_l2(torch, k_out, p_out)
        d_qf = rel_l2(torch, p_out, f_out)
        d_cp = rel_l2(torch, c_out, p_out)
        d_qb = rel_l2(torch, p_out, p_bf16)
        d_pf = control[what]["plain_bf16_vs_f32"]
        # an int8 code flips wherever a bf16-level difference crosses a
        # rounding boundary, so the int8 route is judged against its own
        # bf16-vs-f32 difference, as the bf16 route is against its own
        ok = finite and d_kp <= max(2.0 * d_qf, 1e-2)
        log(f"int8 control {what}: rel L2 kernels-vs-plain (int8) {d_kp:.4g}; plain int8 "
            f"bf16-vs-f32 {d_qf:.4g}; only flash_attention on the card vs plain {d_cp:.4g}; "
            f"plain int8-vs-bf16 {d_qb:.4g}; plain bf16-vs-f32 (bf16 route) {d_pf:.4g}; "
            f"finite {finite}; tol max(2x int8 bf16-vs-f32, 1e-2)" + (" ok" if ok else " FAIL"))
        q_control[what] = {"kernels_vs_plain": d_kp, "plain_int8_bf16_vs_f32": d_qf,
                           "flash_only_vs_plain": d_cp, "plain_int8_vs_bf16": d_qb,
                           "plain_bf16_vs_f32": d_pf}
        if not ok:
            raise AssertionError(f"int8 {what}: kernels disagree with the plain int8 route")
    mse = float((kq_vae - k_vae).square().mean())
    vae_psnr = 10.0 * math.log10(4.0 / mse) if mse > 0 else float("inf")
    log(f"int8 VAE decode vs bf16 decode (kernels, same latents): PSNR {vae_psnr:.2f} dB "
        f"(range 2, for information)")
    q_control["vae_decode_psnr_db"] = vae_psnr
    details["int8_control"] = q_control

    # phase 9: the measurement entry points' kernels E, H, I, J
    probes = probes_phase(torch, gen, exp_rate, launch_counts, reset_launch_counts)
    details["probes"] = probes

    kernels = []
    for name, (src, replaces) in SOURCES.items():
        if name in PROBE_KERNELS:
            kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                            **probes["kernels"][name]})
            continue
        tot = totals[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": {"conv3x3_slab_int8": q_counts, "flash_attention_stats": ring_counts,
                         "out_proj_packed": packed_counts}.get(name, counts)[name],
            "max_abs_err": errs[name],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if tot["byte_ms"] > tot["op_ms"] else "operations",
            "library_ms": tot["library_ms"],
        })
    details["kernels"] = kernels
    if args.out:
        with open(args.out, "w") as f:
            json.dump(details, f, indent=1)
    log("kernel times are per image: the sum over the main path's calls "
        "(count per image x CUDA-event time per call); launches of conv3x3_slab_int8 are "
        "the int8 image's, of flash_attention_stats the ring image's, of out_proj_packed "
        "the packed image's, the others the bf16 image's; for the probe kernels "
        f"{', '.join(PROBE_KERNELS)} the times are sums over phase 9's check calls (one per "
        "shape and variant) and the launches those of their tool's run")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------- probes --

E_SHAPES = ((2, 64, 64, 320), (2, 32, 32, 640), (2, 16, 16, 1280))  # tiny-sd resnets, Ci = Co
HI_SHAPES = ((2, 8, 4096, 40), (2, 8, 1024, 80))                  # tiny-sd self-attention
TOOL_CHAIN = 3                                                      # calls per timed chain


def judge_probe(torch, name, desc, got, want, *, exact=False):
    """Fail unless ``got`` equals ``want`` (bitwise when ``exact``, else
    within TOL_REL of max |want|); returns the max abs error."""
    torch.cuda.synchronize()
    if exact:
        err = float((got.double() - want.double()).abs().max())
        ref = float(want.double().abs().max())
        ok = bool(torch.equal(got, want))
        tol = "bitwise"
    else:
        err, ref = max_err(got, want)
        ok = err <= TOL_REL * ref
        tol = f"tol {TOL_REL:g} rel"
    log(f"check {name} {desc}: max_abs_err={err:.4g} (max|plain|={ref:.4g}, {tol})"
        + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError(f"{name} {desc} disagrees with its plain version")
    return err


def by_rows(torch, fn, q, k, v, elems=1 << 28):
    """``fn(q, k, v)`` over blocks of q's rows, each block's f32 scores at
    most ``elems``: query rows are independent, so this is the plain
    attention over the whole of q at shapes whose score matrix is tens of GB."""
    step = max(1, elems // (q.shape[0] * q.shape[1] * k.shape[2]))
    return torch.cat([fn(q[:, :, i:i + step], k, v) for i in range(0, q.shape[2], step)], dim=2)


def tool_checks(torch, errs):
    """Every kernel variant that the tools run, on the tools' own inputs and
    shapes, against its plain version (``errs[name]`` collects the errors):
    ab_conv's E and A with and without prologue, and at every shape of the
    flash probes C, H and I at each card variant."""
    from sdtpu_torch.kernels.conv2d import (
        conv3x3_gemm_plain,
        conv3x3_slab,
        conv3x3_slab_plain,
        gn_silu_conv3x3_slab,
        plan_co_tile,
    )
    from sdtpu_torch.kernels.flash_attention import flash_attention_packed, flash_attention_plain
    from sdtpu_torch.ops import conv2d
    from sdtpu_torch.tools import ab_conv, probe_flash_vpu
    from sdtpu_torch.tools.probe_flash_2stream import CARD_VARIANTS, flash_2q
    from sdtpu_torch.tools.probe_flash_vpu import legacy_flash, legacy_flash_plain, qkv_inputs
    from sdtpu_torch.utils.quant import slab_plan_ok

    for b, h, w, c in E_SHAPES + tuple(ab_conv.DEFAULT_SHAPES):
        x, k, bias, norm = ab_conv.conv_inputs(b, h, w, c)
        desc, g = f"ab_conv x={(b, h, w, c)} co={c}", 32 if c % 32 == 0 else 16
        if plan_co_tile((b, h, w, c), (3, 3, c, c)) is not None:
            errs["conv3x3_gemm"].append(judge_probe(
                torch, "conv3x3_gemm", desc, conv2d(x, k, bias, padding=1, impl="gemm"),
                conv3x3_gemm_plain(x, k, bias)))
        if slab_plan_ok((b, h, w, c), (3, 3, c, c)):
            judge_probe(torch, "conv3x3_slab", desc, conv3x3_slab(x, k, bias),
                        conv3x3_slab_plain(x, k, bias))
            got = gn_silu_conv3x3_slab(x, norm, k, bias, num_groups=g)
            with routed(conv3x3_slab=conv3x3_slab_plain):
                want = gn_silu_conv3x3_slab(x, norm, k, bias, num_groups=g)
            judge_probe(torch, "conv3x3_slab", desc + " gn-prologue", got, want)
        del x, k
    for label, b, h, l, d in probe_flash_vpu.SHAPES:
        q, k, v = qkv_inputs(b, h, l, d)
        desc = f"{label} q=k=v={(b, h, l, d)}"
        judge_probe(torch, "flash_attention", desc, flash_attention_packed(q, k, v),
                    by_rows(torch, flash_attention_plain, q, k, v))
        # flash_2q_plain is legacy_flash_plain behind its Lq check, so one
        # reference serves H and every variant of I (on its first lq rows)
        want = by_rows(torch, legacy_flash_plain, q, k, v)
        errs["flash_attention_legacy"].append(judge_probe(
            torch, "flash_attention_legacy", desc, legacy_flash(q, k, v), want))
        for nq, bq in CARD_VARIANTS:
            lq = l // (nq * bq) * (nq * bq)  # the largest Lq the variant takes
            qi = q if lq == l else q[:, :, :lq].contiguous()
            errs["flash_attention_nq"].append(judge_probe(
                torch, "flash_attention_nq", f"nq={nq} bq={bq} {desc} lq={lq}",
                flash_2q(qi, k, v, bq=bq, nq=nq), want[:, :, :lq]))
        del q, k, v, want
        torch.cuda.empty_cache()


def probe_case(torch, name, desc, run, plain, library, cost, peak, exp_rate, *, exact=False):
    """One probe kernel at one shape: ``run()`` against ``plain()`` (bitwise
    when ``exact``, else within TOL_REL of max |plain|), then the kernel,
    plain and library times by CUDA events and the kernel's and library's
    device times by the profiler, beside the bound.  ``library`` None: no
    one PyTorch call computes the function (its times are None)."""
    err = judge_probe(torch, name, desc, run(), plain(), exact=exact)
    t_k, t_p = event_ms(run, 10), event_ms(plain, 3)
    t_l = None if library is None else event_ms(library, 10)
    d_k, d_l = device_ms(run, 10), None if library is None else device_ms(library, 10)
    b_ms, b_by = bound_ms(cost, peak, exp_rate)
    t_by, t_ops = bound_terms(cost, peak, exp_rate)
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"  # noqa: E731
    old = f", without the exp term {bound_ms(cost[:2], peak)[0]:.4f} ms" if len(cost) > 2 else ""
    lib = "none" if library is None else f"{t_l:.4f} ms (device {fmt(d_l)})"
    log(f"time {name} {desc}: kernel {t_k:.4f} ms (device {fmt(d_k)}), plain {t_p:.4f} ms, "
        f"library {lib}, bound {b_ms:.4f} ms ({b_by}{old}), "
        f"{cost[1] / t_k / 1e9:.1f} T(FL)OP/s")
    return {"config": desc, "max_abs_err": err, "ms": t_k, "device_ms": d_k, "plain_ms": t_p,
            "library_ms": t_l, "library_device_ms": d_l, "bound_ms": b_ms, "bound_by": b_by,
            "byte_ms": t_by, "op_ms": t_ops}


def probes_phase(torch, gen, exp_rate, launch_counts, reset_launch_counts):
    """Phase 9: E, H, I and J against their plain versions and timed, then
    each tool's main() with the launch counters held to its calls.  Returns
    the per-kernel sums for the kernels line and every case."""
    import torch.nn.functional as F

    from sdtpu_torch.kernels.conv2d import conv3x3_gemm, conv3x3_gemm_plain, plan_co_tile
    from sdtpu_torch.tools import ab_conv, probe_flash_2stream, probe_flash_vpu, probe_int8_dot
    from sdtpu_torch.tools.probe_flash_2stream import CARD_VARIANTS, flash_2q, flash_2q_plain
    from sdtpu_torch.tools.probe_flash_vpu import legacy_flash, legacy_flash_plain
    from sdtpu_torch.tools.probe_int8_dot import (
        dot_inputs,
        dot_plain,
        dot_splitk_reduce,
        make,
        plan_dot,
        splitk_reduce_plain,
    )

    t0 = time.perf_counter()
    cases = {n: [] for n in PROBE_KERNELS}
    for b, h, w, c in E_SHAPES:
        if plan_co_tile((b, h, w, c), (3, 3, c, c)) is None:
            raise AssertionError(f"plan_co_tile refuses {(b, h, w, c)}")
        x, k, bias, _ = conv_inputs(torch, gen, (b, h, w, c), c, pro=False, res=False, up=False)
        x_nchw, b16 = x.permute(0, 3, 1, 2), bias.to(torch.bfloat16)
        k_oihw = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        cases["conv3x3_gemm"].append(probe_case(
            torch, "conv3x3_gemm", f"x={(b, h, w, c)} co={c}",
            lambda: conv3x3_gemm(x, k, bias), lambda: conv3x3_gemm_plain(x, k, bias),
            lambda: F.conv2d(x_nchw, k_oihw, b16, padding=1),
            conv_cost((b, h, w, c), c, pro=False, res=False, up=False, stats=False),
            PEAK_BF16_FLOPS, exp_rate))
    sdpa = F.scaled_dot_product_attention
    for b, h, l, d in HI_SHAPES:
        q, k, v = (torch.randn((b, h, l, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        cases["flash_attention_legacy"].append(probe_case(
            torch, "flash_attention_legacy", f"q=k=v={(b, h, l, d)}",
            lambda: legacy_flash(q, k, v), lambda: legacy_flash_plain(q, k, v),
            lambda: sdpa(q, k, v), flash_cost((b, h, l, d), l), PEAK_BF16_FLOPS, exp_rate))
        for nq, bq in CARD_VARIANTS:
            lq = l // (nq * bq) * (nq * bq)  # the largest Lq the variant takes
            qi = q[:, :, :lq].contiguous()
            cases["flash_attention_nq"].append(probe_case(
                torch, "flash_attention_nq", f"nq={nq} bq={bq} q={(b, h, lq, d)} lk={l}",
                lambda: flash_2q(qi, k, v, bq=bq, nq=nq),
                lambda: flash_2q_plain(qi, k, v, bq=bq, nq=nq),
                lambda: sdpa(qi, k, v), flash_cost((b, h, lq, d), l), PEAK_BF16_FLOPS,
                exp_rate))
    for m, kk, n in probe_int8_dot.SHAPES:
        x8, w8, x16, w16 = dot_inputs(m, kk, n)
        f16 = make(m, kk, n, torch.bfloat16, torch.float32, torch.bfloat16)
        f8 = make(m, kk, n, torch.int8, torch.int32, torch.int32)
        desc = f"({m},{kk})@({kk},{n})"
        cases["dot_bf16"].append(probe_case(
            torch, "dot_bf16", desc, lambda: f16(x16, w16),
            lambda: dot_plain(x16, w16, torch.float32, torch.bfloat16),
            lambda: torch.matmul(x16, w16), (2 * (m * kk + kk * n + m * n), 2.0 * m * kk * n),
            PEAK_BF16_FLOPS, exp_rate))
        cases["dot_int8"].append(probe_case(
            torch, "dot_int8", desc, lambda: f8(x8, w8),
            lambda: dot_plain(x8, w8, torch.int32, torch.int32),
            lambda: torch._int_mm(x8, w8), (m * kk + kk * n + 4 * m * n, 2.0 * m * kk * n),
            PEAK_INT8_OPS, exp_rate, exact=True))
        splits = plan_dot(m, kk, n)[1]
        if splits > 1:  # the bf16 call's split-K reduction alone, bitwise
            ws = torch.randn((splits, m, n), generator=gen, device="cuda")
            cases["dot_bf16_splitk"].append(probe_case(
                torch, "dot_bf16_splitk", f"ws={(splits, m, n)}", lambda: dot_splitk_reduce(ws),
                lambda: splitk_reduce_plain(ws), None, (ws.numel() * 4 + m * n * 2, 0.0),
                PEAK_BF16_FLOPS, exp_rate, exact=True))
    tool_errs = {n: [] for n in PROBE_KERNELS}
    tool_checks(torch, tool_errs)
    # E at a ragged split-K shape (S = 2; ragged M, Ci and N tiles)
    x, k, bias, _ = conv_inputs(torch, gen, (1, 12, 20, 40), 72, pro=False, res=False, up=False)
    tool_errs["conv3x3_gemm"].append(judge_probe(
        torch, "conv3x3_gemm", "x=(1, 12, 20, 40) co=72 S=2", conv3x3_gemm(x, k, bias),
        conv3x3_gemm_plain(x, k, bias)))
    checks_s = time.perf_counter() - t0

    runs = ((ab_conv, [str(TOOL_CHAIN)] + ["x".join(map(str, s)) for s in
                                           E_SHAPES + tuple(ab_conv.DEFAULT_SHAPES)]),
            (probe_flash_vpu, [str(TOOL_CHAIN)]), (probe_flash_2stream, [str(TOOL_CHAIN)]),
            (probe_int8_dot, [str(10 * TOOL_CHAIN)]))
    tool_launches, tool_runs = {}, []
    for mod, argv in runs:
        tool = mod.__name__.rsplit(".", 1)[1]
        log(f"tool: python -m sdtpu_torch.tools.{tool} {' '.join(argv)}")
        reset_launch_counts()
        t1 = time.perf_counter()
        calls = mod.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        counts = {key: n for key, n in launch_counts.items() if n}
        log(f"tool {tool}: {secs:.1f} s; launches {counts}, calls of each wrapper {dict(calls)}"
            + (" ok" if counts == dict(calls) else " FAIL"))
        if counts != dict(calls):
            raise AssertionError(f"{tool}: launches {counts} != its calls {dict(calls)}")
        tool_launches.update({k: n for k, n in counts.items() if k in PROBE_KERNELS})
        tool_runs.append({"tool": tool, "argv": argv, "s": secs, "launches": counts})
    if set(tool_launches) != set(PROBE_KERNELS):
        raise AssertionError(f"the tools launched {sorted(tool_launches)}, not every probe "
                             f"kernel {PROBE_KERNELS}")

    kernels = {}
    for name, rows in cases.items():
        dev = [r["device_ms"] for r in rows]
        lib = [r["library_ms"] for r in rows]
        kernels[name] = {
            "launches": tool_launches[name],
            "max_abs_err": max([r["max_abs_err"] for r in rows] + tool_errs[name]),
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": ("bytes" if sum(r["byte_ms"] for r in rows) > sum(r["op_ms"] for r in rows)
                         else "operations"),
            "library_ms": None if None in lib else sum(lib),
        }
        log(f"probe kernel {name}: {len(rows)} check calls, sums: kernel {kernels[name]['ms']:.4f} "
            f"ms, device " + ("not measured" if None in dev else f"{sum(dev):.4f} ms")
            + f", plain {kernels[name]['plain_ms']:.4f} ms, library "
            + ("none" if None in lib else f"{sum(lib):.4f} ms")
            + f", bound {kernels[name]['bound_ms']:.4f} ms")
    log(f"probes: checks and times {checks_s:.1f} s, tools "
        f"{sum(r['s'] for r in tool_runs):.1f} s")
    return {"kernels": kernels, "cases": cases, "tools": tool_runs}


def nccl_phase(torch):
    """A one-rank NCCL group on the card: ``health_check`` over it, and the
    ring over ``ProcessGroupRing`` (its all_gather on NCCL) against
    ``LocalRing(1)``, bitwise.  Several ranks would need several cards."""
    import socket

    import torch.distributed as dist

    from sdtpu_torch.parallel import LocalRing, ProcessGroupRing, health_check, ring_attention

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0, device_id=torch.device("cuda", 0))
    try:
        report = health_check()
        gen = torch.Generator(device="cuda").manual_seed(1)
        q, k, v = (torch.randn((2, 256, 8, 40), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        same = bool(torch.equal(ring_attention(q, k, v, ProcessGroupRing()),
                                ring_attention(q, k, v, LocalRing(1))))
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    log(f"nccl: health_check on a 1-rank NCCL group: {report}; ring over ProcessGroupRing "
        f"== LocalRing(1) bitwise: {same}" + (" ok" if report["ok"] and same else " FAIL"))
    if not (report["ok"] and same):
        raise AssertionError("the one-rank NCCL group is not healthy")
    return {"health_check": report, "process_group_ring_equals_local": same}


def run_image(torch, np, pipe, ids, label, launch_counts, reset_launch_counts):
    """A warm-up image, then one timed 512x512 STEPS-step image with the
    launch counts zeroed just before it and read just after."""
    reset_launch_counts()
    t0 = time.perf_counter()
    warm = pipe.generate(token_ids=ids, num_inference_steps=STEPS, seed=40, image_size=512,
                         output="float")
    warm_s = time.perf_counter() - t0
    if warm.shape != (1, 512, 512, 3) or not np.isfinite(warm).all():
        raise AssertionError(f"{label} warm-up image: shape {warm.shape}, finite "
                             f"{bool(np.isfinite(warm).all())}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    img = pipe.generate(token_ids=ids, num_inference_steps=STEPS, seed=40, image_size=512)
    sec = time.perf_counter() - t0
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated()
    log(f"{label}: image {img.shape} {img.dtype}, pixel std {float(img.std()):.3f}, "
        f"warm-up {warm_s:.3f} s, {sec:.4f} s/image, peak memory {peak / 2**30:.3f} GiB")
    log(f"{label} launches: {counts}")
    if img.shape != (1, 512, 512, 3) or img.dtype != np.uint8 or float(img.std()) == 0.0:
        raise AssertionError(f"{label} image is not a non-constant (1, 512, 512, 3) uint8 image")
    return counts, {"s_per_image": sec, "warmup_s": warm_s, "peak_bytes": peak,
                    "launches": counts}


if __name__ == "__main__":
    sys.exit(main())
