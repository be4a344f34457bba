#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sdtpu_torch``) once on one NVIDIA card.

    python3 chip_smoke.py [--out details.json]

Phases, each printing its own lines; any failure ends the run non-zero:

1. device  -- needs CUDA; prints ``nvidia-smi`` name and power limit.
2. build   -- compiles every ``sdtpu_torch/csrc/*.cu`` with nvcc for sm_90a
              into ``build/`` (one nvcc per source, all started together).
3. kernels -- each hand-written kernel against its plain PyTorch version on
              the card at the main paths' shapes (tolerance stated per
              line), then every kernel call configuration of the main paths
              timed with CUDA events: the kernel, its plain version, and one
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
              checks the image and the kernels' launch counts, prints
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

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12   # H100 SXM dense int8
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
TOL_REL = 2e-2            # max |kernel - plain| <= TOL_REL * max |plain|
STEPS = 25                # the main path's DDPM steps (bench.py's default workload)
E2E_COUNTS = {"conv3x3_slab": 478, "conv3x3_slab_upsample": 53, "conv3x3_slab_int8": 0,
              "flash_attention": 226, "flash_attention_stats": 0, "out_proj_packed": 0}
RING = 4                  # shards of the sequence-parallel ring on the one card
SOURCES = {  # kernel: (its source, the pallas_call of the TPU kernel it replaces)
    "conv3x3_slab": ("sdtpu_torch/csrc/conv3x3_slab.cu", "sdtpu/kernels/conv2d.py:456"),
    "conv3x3_slab_upsample": ("sdtpu_torch/csrc/conv3x3_slab.cu",
                              "sdtpu/kernels/conv2d.py:456"),
    "flash_attention": ("sdtpu_torch/csrc/flash_attention.cu",
                        "sdtpu/kernels/flash_attention.py:267"),
    "conv3x3_slab_int8": ("sdtpu_torch/csrc/conv3x3_slab_int8.cu",
                          "sdtpu/kernels/conv2d.py:456"),
    "flash_attention_stats": ("sdtpu_torch/csrc/flash_attention.cu",
                              "sdtpu/kernels/flash_attention.py:379"),
    "out_proj_packed": ("sdtpu_torch/csrc/out_proj_packed.cu",
                        "sdtpu/kernels/flash_attention.py:464"),
}


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
    b, h, lq, d = q_shape
    return 2 * (b * h * lq * d * 2) + 2 * (b * h * lk * d * 2), 4.0 * b * h * lq * lk * d


def flash_stats_cost(q_shape, lk):
    """Kernel C's bytes and operations plus the m and l rows it writes."""
    b, h, lq, _ = q_shape
    by, ops = flash_cost(q_shape, lk)
    return by + 2 * b * h * lq * 4, ops


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


def bound_ms(cost, peak_ops=PEAK_BF16_FLOPS):
    by, ops = cost
    return max(by / PEAK_BYTES, ops / peak_ops) * 1e3, (
        "bytes" if by / PEAK_BYTES > ops / peak_ops else "operations")


def cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps):
    """Device time per call: the kernels' own time summed over ``reps``
    calls under torch.profiler (CUDA activity only), so that a call whose
    kernel is shorter than its host-side enqueue is not timed by the host.
    None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages())
    return us / 1e3 / reps if us > 0 else None


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


def check_flash(torch, gen, q_shape):
    from sdtpu_torch.kernels.flash_attention import flash_attention_packed, flash_attention_plain

    q, k, v = (torch.randn(q_shape, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    got = flash_attention_packed(q, k, v)
    want = flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    err, ref = max_err(got, want)
    ok = err <= TOL_REL * ref
    log(f"check flash_attention q=k=v={tuple(q_shape)}: max_abs_err={err:.4g} "
        f"(max|plain|={ref:.4g}, rel {err / ref:.3g}, tol {TOL_REL:g})" + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError("flash_attention disagrees with its plain version")
    return "flash_attention", err


def time_conv(torch, gen, cfg):
    import torch.nn.functional as F

    from sdtpu_torch.kernels.conv2d import conv3x3_slab, conv3x3_slab_plain

    x_shape, co, pro, res, up, stats = cfg
    x, k, bias, kw = conv_inputs(torch, gen, x_shape, co, pro=pro, res=res, up=up)
    big = x.numel() * co > 2**31
    t_k = cuda_ms(torch, lambda: conv3x3_slab(x, k, bias, emit_stats=stats, **kw), 5 if big else 20)
    t_p = cuda_ms(torch, lambda: conv3x3_slab_plain(x, k, bias, emit_stats=stats, **kw),
                  2 if big else 5)
    return t_k, t_p, cudnn_ms(torch, x, k, bias, kw, 5 if big else 20)


def cudnn_ms(torch, x, k, bias, kw, reps):
    """Yardstick: one cuDNN bf16 conv on the prologued (and upsampled) input."""
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
    return cuda_ms(torch, lambda: F.conv2d(y_nchw, w_oihw, b16, padding=1), reps)


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
    t_k = cuda_ms(torch, lambda: conv3x3_slab(x, q, qbias, emit_stats=stats, **qkw), reps)
    t_p = cuda_ms(torch, lambda: conv3x3_slab_plain(x, q, qbias, emit_stats=stats, **qkw), 2)
    t_a = cuda_ms(torch, lambda: conv3x3_slab(x, k, bias, emit_stats=stats, **kw), reps)
    t_l = cudnn_ms(torch, x, k, bias, kw, reps)
    return err, share, t_k, t_p, t_a, t_l


def time_flash(torch, gen, q_shape, lk):
    import torch.nn.functional as F

    from sdtpu_torch.kernels.flash_attention import flash_attention_packed, flash_attention_plain

    q = torch.randn(q_shape, generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(q_shape[:2] + (lk, q_shape[3]), generator=gen,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    t_k = cuda_ms(torch, lambda: flash_attention_packed(q, k, v), 10)
    t_p = cuda_ms(torch, lambda: flash_attention_plain(q, k, v), 3)
    t_l = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v), 10)
    return t_k, t_p, t_l


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
    t_k = cuda_ms(torch, lambda: flash_attention_stats_packed(q, k, v), 10)
    t_p = cuda_ms(torch, lambda: flash_attention_stats_plain(q, k, v), 3)
    aten = torch.ops.aten
    libs = (("_scaled_dot_product_flash_attention", lambda: aten._scaled_dot_product_flash_attention(q, k, v)),
            ("_scaled_dot_product_efficient_attention",
             lambda: aten._scaled_dot_product_efficient_attention(q, k, v, None, True)))
    t_l = lib_call = None
    for name, fn in libs:
        try:
            t_l = cuda_ms(torch, fn, 10)
        except RuntimeError as exc:
            log(f"library {name} refuses q={tuple(q_shape)}: {str(exc).splitlines()[0]}")
            continue
        log(f"library for flash_attention_stats q={tuple(q_shape)} lk={lk}: aten.{name} "
            f"(returns the log-sum-exp m + log l, not m and l): {t_l:.4f} ms")
        lib_call = f"aten.{name}"
        break
    dev = {"kernel": device_ms(torch, lambda: flash_attention_stats_packed(q, k, v), 10),
           "library": None if t_l is None else device_ms(torch, fn, 10),
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
    t_k = cuda_ms(torch, lambda: out_proj_packed(o, w, bias, res), 20)
    t_p = cuda_ms(torch, lambda: out_proj_packed_plain(o, w, bias, res), 5)
    t_l = cuda_ms(torch, lambda: torch.einsum("bhld,hdc->blc", o, w) + b16 + res, 20)
    dev = {"kernel": device_ms(torch, lambda: out_proj_packed(o, w, bias, res), 20),
           "library": device_ms(torch, lambda: torch.einsum("bhld,hdc->blc", o, w) + b16 + res,
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

    import numpy as np

    from sdtpu_torch import StableDiffusionPipeline
    from sdtpu_torch.kernels import _build, launch_counts, reset_launch_counts
    from sdtpu_torch.parallel import LocalRing, ring_context

    details = {"device": smi}
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
    ]:
        name, err = check_conv(torch, gen, case)
        errs[name] = max(errs.get(name, 0.0), err)
    for q_shape in [(2, 8, 4096, 40), (2, 8, 1024, 80), (2, 8, 256, 160), (1, 1, 4096, 512)]:
        name, err = check_flash(torch, gen, q_shape)
        errs[name] = max(errs.get(name, 0.0), err)

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
                  "byte_ms": 0.0, "op_ms": 0.0, "per_image_calls": 0} for n in SOURCES}
    rows = []
    for cfg, n in sorted(calls["conv3x3_slab"].items()):
        x_shape, co, pro, res, up, stats, _ = cfg
        t_k, t_p, t_l = time_conv(torch, gen, cfg[:6])
        cost = conv_cost(x_shape, co, pro=pro, res=res, up=up, stats=stats)
        rows.append(("conv3x3_slab_upsample" if up else "conv3x3_slab",
                     f"x={x_shape} co={co} pro={int(pro)} res={int(res)} st={int(stats)}",
                     n, t_k, t_p, t_l, cost, PEAK_BF16_FLOPS))
    for (q_shape, lk), n in sorted(calls["flash_attention_packed"].items()):
        t_k, t_p, t_l = time_flash(torch, gen, q_shape, lk)
        rows.append(("flash_attention", f"q={q_shape} lk={lk}", n, t_k, t_p, t_l,
                     flash_cost(q_shape, lk), PEAK_BF16_FLOPS))
    # F and G: besides the CUDA-event time of back-to-back calls, the
    # profiler's device time, since at these shapes a call's kernel can be
    # shorter than its host-side enqueue
    device = {}
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
    log(f"e2e expected launches: {E2E_COUNTS}")
    if counts != E2E_COUNTS:
        raise AssertionError(f"launch counts {counts} != expected {E2E_COUNTS}")
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
    ring_expected = dict(E2E_COUNTS, flash_attention=0, flash_attention_stats=RING * RING * n_self)
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
    packed_expected = dict(E2E_COUNTS, out_proj_packed=n_self)
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
    q_calls = record_main_path_calls(torch, pipe_q, ids)["conv3x3_slab"]
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
        b_ms, b_by = bound_ms(cost, peak)
        tot = totals[name]
        tot["per_image_calls"] += n
        tot["ms"] += n * t_k
        tot["plain_ms"] += n * t_p
        tot["library_ms"] = None if t_l is None else tot["library_ms"] + n * t_l
        tot["bound_ms"] += n * b_ms
        tot["byte_ms"] += n * cost[0] / PEAK_BYTES * 1e3
        tot["op_ms"] += n * cost[1] / peak * 1e3
        lib = "library none" if t_l is None else f"library {t_l:.4f} ms"
        log(f"time {name} {desc} x{n}/image ({n * t_k:.3f} ms/image): kernel {t_k:.4f} ms, "
            f"plain {t_p:.4f} ms, "
            f"{lib}, bound {b_ms:.4f} ms ({b_by}), {cost[1] / t_k / 1e9:.1f} T(FL)OP/s")
        details["configs"].append({"kernel": name, "config": desc, "per_image": n,
                                   "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                                   "bound_ms": b_ms, "bound_by": b_by,
                                   "bytes": cost[0], "ops": cost[1]})
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
    q_expected = dict(E2E_COUNTS, conv3x3_slab=0, conv3x3_slab_int8=d_expected)
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

    kernels = []
    for name, (src, replaces) in SOURCES.items():
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
        "the packed image's, the others the bf16 image's")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


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
