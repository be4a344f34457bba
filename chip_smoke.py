#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sdtpu_torch``) once on one NVIDIA card.

    python3 chip_smoke.py [--out details.json]

Phases, each printing its own lines; any failure ends the run non-zero:

1. device  -- needs CUDA; prints ``nvidia-smi`` name and power limit.
2. build   -- compiles every ``sdtpu_torch/csrc/*.cu`` with nvcc for sm_90a
              into ``build/`` (one nvcc per source, all started together).
3. kernels -- each hand-written kernel against its plain PyTorch version on
              the card at the main path's shapes (bf16 tolerance stated per
              line), then every kernel call configuration of the main path
              timed with CUDA events: the kernel, its plain version, and one
              library call for the same function as a yardstick.  Prints one
              JSON ``{"kernels": [...]}`` line with per-image totals.
4. e2e     -- ``StableDiffusionPipeline.from_random("tiny-sd")`` and one
              512x512, 25-step DDPM + CFG image (after a warm-up image);
              checks the image and the kernels' launch counts, prints
              seconds per image and peak memory; then one full-width UNet
              forward and one VAE decode through the kernels and through
              the plain versions, beside the plain path's own bf16-versus-
              float32 difference.

Every float32 reference on the card runs with TF32 off (cuBLAS and cuDNN).
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from collections import Counter

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
TOL_REL = 2e-2            # bf16: max |kernel - plain| <= TOL_REL * max |plain|
STEPS = 25                # the main path's DDPM steps (bench.py's default workload)
E2E_COUNTS = {"conv3x3_slab": 478, "conv3x3_slab_upsample": 53, "flash_attention": 226}
SOURCES = {  # kernel: (its source, the pallas_call of the TPU kernel it replaces)
    "conv3x3_slab": ("sdtpu_torch/csrc/conv3x3_slab.cu", "sdtpu/kernels/conv2d.py:456"),
    "conv3x3_slab_upsample": ("sdtpu_torch/csrc/conv3x3_slab.cu",
                              "sdtpu/kernels/conv2d.py:456"),
    "flash_attention": ("sdtpu_torch/csrc/flash_attention.cu",
                        "sdtpu/kernels/flash_attention.py:267"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- routing --

_SITES = (
    ("sdtpu_torch.kernels.conv2d", "conv3x3_slab"),
    ("sdtpu_torch.ops.conv", "conv3x3_slab"),
    ("sdtpu_torch.ops.attention", "flash_attention_packed"),
)


@contextlib.contextmanager
def routed(conv_fn, flash_fn):
    """Point every call site of the two kernel wrappers at other functions
    (a recording shim, or the plain versions) for the duration."""
    mods = [sys.modules[m] for m, _ in _SITES]
    saved = [getattr(m, n) for m, (_, n) in zip(mods, _SITES)]
    for m, (_, n) in zip(mods, _SITES):
        setattr(m, n, flash_fn if n == "flash_attention_packed" else conv_fn)
    try:
        yield
    finally:
        for m, (_, n), f in zip(mods, _SITES, saved):
            setattr(m, n, f)


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


def bound_ms(cost):
    by, fl = cost
    return max(by / PEAK_BYTES, fl / PEAK_BF16_FLOPS) * 1e3, (
        "bytes" if by / PEAK_BYTES > fl / PEAK_BF16_FLOPS else "operations")


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
    # yardstick: one cuDNN bf16 conv on the prologued (and upsampled) input
    y = x
    if pro:
        y = x.float() * kw["prologue_scale"][:, None, None, :] + kw["prologue_bias"][:, None, None, :]
        y = (y * torch.sigmoid(y)).to(torch.bfloat16)
    if up:
        y = y.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    y_nchw = y.permute(0, 3, 1, 2)  # channels_last memory
    w_oihw = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    b16 = bias.to(torch.bfloat16)
    t_l = cuda_ms(torch, lambda: F.conv2d(y_nchw, w_oihw, b16, padding=1), 5 if big else 20)
    return t_k, t_p, t_l


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


def record_main_path_calls(torch, pipe, ids):
    """The main path's kernel call configurations with their counts per
    image: one 1-step image recorded through shims, UNet calls (batch 2
    under CFG) scaled to STEPS steps."""
    # sys.modules: the package sdtpu_torch.ops re-exports a function named
    # ``attention`` that shadows its submodule of that name
    real_conv = sys.modules["sdtpu_torch.kernels.conv2d"].conv3x3_slab
    real_flash = sys.modules["sdtpu_torch.ops.attention"].flash_attention_packed
    convs, flashes = Counter(), Counter()

    def conv_shim(x, kernel, conv_bias=None, **kw):
        convs[(tuple(x.shape), kernel.shape[-1], kw.get("prologue_scale") is not None,
               kw.get("residual") is not None, bool(kw.get("upsample")),
               bool(kw.get("emit_stats")))] += 1
        return real_conv(x, kernel, conv_bias, **kw)

    def flash_shim(q, k, v):
        flashes[(tuple(q.shape), k.shape[2])] += 1
        return real_flash(q, k, v)

    with routed(conv_shim, flash_shim):
        pipe.generate(token_ids=ids, num_inference_steps=1, seed=1, image_size=512)

    def per_image(shape):
        return STEPS if shape[0] == 2 else 1  # UNet runs at batch 2, the VAE at 1

    return ({c: n * per_image(c[0]) for c, n in convs.items()},
            {c: n * per_image(c[0]) for c, n in flashes.items()})


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
    from sdtpu_torch.kernels.conv2d import conv3x3_slab_plain
    from sdtpu_torch.kernels.flash_attention import flash_attention_plain

    details = {"device": smi}

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
    conv_calls, flash_calls = record_main_path_calls(torch, pipe, ids)
    totals = {n: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                  "byte_ms": 0.0, "op_ms": 0.0, "per_image_calls": 0} for n in SOURCES}
    rows = []
    for cfg, n in sorted(conv_calls.items()):
        x_shape, co, pro, res, up, stats = cfg
        t_k, t_p, t_l = time_conv(torch, gen, cfg)
        cost = conv_cost(x_shape, co, pro=pro, res=res, up=up, stats=stats)
        rows.append(("conv3x3_slab_upsample" if up else "conv3x3_slab",
                     f"x={x_shape} co={co} pro={int(pro)} res={int(res)} st={int(stats)}",
                     n, t_k, t_p, t_l, cost))
    for (q_shape, lk), n in sorted(flash_calls.items()):
        t_k, t_p, t_l = time_flash(torch, gen, q_shape, lk)
        rows.append(("flash_attention", f"q={q_shape} lk={lk}", n, t_k, t_p, t_l,
                     flash_cost(q_shape, lk)))
    details["configs"] = []
    for name, desc, n, t_k, t_p, t_l, cost in rows:
        b_ms, b_by = bound_ms(cost)
        tot = totals[name]
        tot["per_image_calls"] += n
        tot["ms"] += n * t_k
        tot["plain_ms"] += n * t_p
        tot["library_ms"] += n * t_l
        tot["bound_ms"] += n * b_ms
        tot["byte_ms"] += n * cost[0] / PEAK_BYTES * 1e3
        tot["op_ms"] += n * cost[1] / PEAK_BF16_FLOPS * 1e3
        log(f"time {name} {desc} x{n}/image: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
            f"library {t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{cost[1] / t_k / 1e9:.1f} TFLOP/s")
        details["configs"].append({"kernel": name, "config": desc, "per_image": n,
                                   "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                                   "bound_ms": b_ms, "bound_by": b_by,
                                   "bytes": cost[0], "flops": cost[1]})

    # phase 4: end to end
    reset_launch_counts()
    t0 = time.perf_counter()
    warm = pipe.generate(token_ids=ids, num_inference_steps=STEPS, seed=40, image_size=512,
                         output="float")
    warm_s = time.perf_counter() - t0
    if warm.shape != (1, 512, 512, 3) or not np.isfinite(warm).all():
        raise AssertionError(f"warm-up image: shape {warm.shape}, finite "
                             f"{bool(np.isfinite(warm).all())}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    img = pipe.generate(token_ids=ids, num_inference_steps=STEPS, seed=40, image_size=512)
    sec = time.perf_counter() - t0
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated()
    log(f"e2e: image {img.shape} {img.dtype}, pixel std {float(img.std()):.3f}, "
        f"warm-up {warm_s:.3f} s, {sec:.4f} s/image, peak memory {peak / 2**30:.3f} GiB")
    log(f"e2e launches: {counts} (expected {E2E_COUNTS})")
    if img.shape != (1, 512, 512, 3) or img.dtype != np.uint8 or float(img.std()) == 0.0:
        raise AssertionError("e2e image is not a non-constant (1, 512, 512, 3) uint8 image")
    if counts != E2E_COUNTS:
        raise AssertionError(f"launch counts {counts} != expected {E2E_COUNTS}")
    details["e2e"] = {"s_per_image": sec, "warmup_s": warm_s, "peak_bytes": peak,
                      "launches": counts}

    # control: one UNet forward and one VAE decode, kernels vs plain, beside
    # the plain path's bf16-vs-float32 difference
    from sdtpu_torch.models.unet import unet_forward
    from sdtpu_torch.models.vae import vae_decode

    cfg = pipe.config
    lat = torch.randn((2, 64, 64, 4), generator=gen, device="cuda")
    ctx = torch.randn((2, 77, 768), generator=gen, device="cuda")
    ts = torch.full((2,), 501.0, device="cuda")
    dec_in = torch.randn((1, 64, 64, 4), generator=gen, device="cuda")
    unet32, vae32 = (to_dtype(pipe.params[k], torch.float32) for k in ("unet", "vae_decoder"))
    with torch.inference_mode():
        def unet(params, dt):
            return unet_forward(lat.to(dt), ts, ctx.to(dt), params, cfg.unet).float()

        def vae(params, dt):
            return vae_decode(dec_in.to(dt), params, cfg.vae).float()

        k_unet = unet(pipe.params["unet"], torch.bfloat16)
        k_vae = vae(pipe.params["vae_decoder"], torch.bfloat16)
        with routed(conv3x3_slab_plain, flash_attention_plain):
            p_unet = unet(pipe.params["unet"], torch.bfloat16)
            p_vae = vae(pipe.params["vae_decoder"], torch.bfloat16)
            f_unet = unet(unet32, torch.float32)
            f_vae = vae(vae32, torch.float32)
    control = {}
    for what, k_out, p_out, f_out in (("unet_forward", k_unet, p_unet, f_unet),
                                      ("vae_decode", k_vae, p_vae, f_vae)):
        finite = bool(torch.isfinite(k_out).all())
        d_kp = rel_l2(torch, k_out, p_out)
        d_pf = rel_l2(torch, p_out, f_out)
        d_kf = rel_l2(torch, k_out, f_out)
        ok = finite and d_kp <= max(2.0 * d_pf, 1e-2)
        log(f"control {what}: rel L2 kernels-vs-plain (bf16) {d_kp:.4g}; plain bf16-vs-f32 "
            f"{d_pf:.4g}; kernels-vs-plain-f32 {d_kf:.4g}; finite {finite}; "
            f"tol max(2x bf16-vs-f32, 1e-2)" + (" ok" if ok else " FAIL"))
        control[what] = {"kernels_vs_plain": d_kp, "plain_bf16_vs_f32": d_pf,
                         "kernels_vs_f32": d_kf}
        if not ok:
            raise AssertionError(f"{what}: kernels disagree with the plain path")
    details["control"] = control

    kernels = []
    for name, (src, replaces) in SOURCES.items():
        tot = totals[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[name], "max_abs_err": errs[name],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if tot["byte_ms"] > tot["op_ms"] else "operations",
            "library_ms": tot["library_ms"],
        })
    details["kernels"] = kernels
    if args.out:
        with open(args.out, "w") as f:
            json.dump(details, f, indent=1)
    log("kernel times are per image: the sum over the main path's calls "
        "(count per image x CUDA-event time per call)")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
