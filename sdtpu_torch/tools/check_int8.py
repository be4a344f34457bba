"""Fidelity gates of the int8 (W8A8) path on the card, the counterpart of
the JAX package's ``tools/check_int8.py``::

    python -m sdtpu_torch.tools.check_int8 [--preset tiny-sd] [--steps 25]
        [--image-size 512] [--sigmas S] [--device cuda]

Gates, the JAX tool's, at a preset's full width with host-seeded weights
(``numpy.random.default_rng(1234)``: a 1-D ``scale`` leaf ones, a 1-D
``bias`` leaf zeros, every other leaf 0.04 x normals, in jax's leaf order):

1. kernel parity: the int8 slab conv (kernel D) against the float slab conv
   (kernel A) at (2, 16, 16, 1280 -> 1280), G = 32, with the activation
   code from the norm's affine: rel < 0.04;
2. one CFG-batched UNet forward (64^2 latents, t = 500) of the int8 tree
   against the bf16 tree, both through the kernels: rel < 0.045;
2b. one VAE decode of the int8 decoder against the bf16 one: PSNR > 30 dB
   (a single pass, so an absolute gate holds on random weights);
3. the pipeline, relative: the int8-vs-bf16 PSNR of one ``--steps`` image
   (seed 40, CFG) minus the bf16-vs-float32 control PSNR > -5 dB.  With
   random weights the denoise loop is chaotic, so the int8 route is held
   to the bf16 route's own distance from float32, not to an absolute bar.

The float32 control differs from the JAX tool's by necessity: there it runs
the TPU kernels in float32, while the port's kernels take bf16 only, so the
control here is the library route (``attention_impl="xla"``,
``conv_impl="xla"``: SDPA and cuDNN) in float32 with TF32 off; the JSON
line names it (``control_path``).  Each tree is freed before the next is
built.  Prints one JSON line with the JAX tool's keys; exits 0 only if
every gate passes, non-zero for ``cuda`` without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from sdtpu_torch.tools import no_tf32, verdict
from sdtpu_torch.tools.device_precision import rel

# (name, gate, "lt" or "gt")
GATES = (("kernel_rel_vs_float", 0.04, "lt"), ("unet_forward_rel_int8_vs_bf16", 0.045, "lt"),
         ("vae_decode_psnr_db_int8_vs_bf16", 30.0, "gt"),
         ("psnr_margin_db_vs_chaos_control", -5.0, "gt"))
CONTROL_PATH = "float32 attention=xla conv=xla (SDPA, cuDNN; TF32 off)"
KERNEL_SHAPE = (2, 16, 16, 1280, 1280)  # gate 1's (b, h, w, ci, co)


def kernel_case(shape=KERNEL_SHAPE, *, device="cuda"):
    """Gate 1's inputs from ``numpy.random.default_rng(5)`` (x bf16, the
    norm, the kernel x 0.05, the bias) and the int8 form of the kernel from
    the norm's activation code: ``(x, norm, kernel, bias, q, w_scale,
    zp_corr, act_scale, act_zp)`` on ``device``."""
    from sdtpu_torch.utils.quant import act_qparams_from_norm, quantize_conv_w8a8

    b, h, w, ci, co = shape
    rng = np.random.default_rng(5)

    def dev(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dtype)

    x = dev(rng.standard_normal((b, h, w, ci)), torch.bfloat16)
    norm = {"scale": dev(rng.standard_normal(ci)), "bias": dev(rng.standard_normal(ci))}
    k = (rng.standard_normal((3, 3, ci, co)) * 0.05).astype(np.float32)
    cb = dev(rng.standard_normal(co))
    s_act, z_act = act_qparams_from_norm(norm)
    q, w_scale, zp_corr = quantize_conv_w8a8(k, s_act, z_act)
    return (x, norm, dev(k), cb, torch.from_numpy(q).to(device), dev(w_scale), dev(zp_corr),
            dev(s_act), dev(z_act))


def kernel_gate(shape=KERNEL_SHAPE, *, device="cuda"):
    """Gate 1: rel of the int8 slab conv against the float one, G = 32;
    returns (rel, int8 output, float output)."""
    from sdtpu_torch.kernels.conv2d import gn_silu_conv3x3_slab

    x, norm, k, cb, q, w_scale, zp_corr, s_act, z_act = kernel_case(shape, device=device)
    with torch.inference_mode():
        want = gn_silu_conv3x3_slab(x, norm, k.to(torch.bfloat16), cb, num_groups=32)
        got = gn_silu_conv3x3_slab(x, norm, q, cb - zp_corr, num_groups=32,
                                   act_inv_scale=1.0 / s_act, act_zp=z_act, w_scale=w_scale)
    return rel(want, got), got, want


def gate_tree(config, host, device) -> dict:
    """The JAX tool's weights for ``config``: from the numpy generator
    ``host`` in jax's leaf order, a 1-D ``scale`` leaf ones, a 1-D ``bias``
    leaf zeros, every other leaf 0.04 x standard normals (float64 draws
    rounded to float32), each cast to the parameter dtype (the JAX tool's
    abstract tree holds every leaf in it, the CLIP embeddings too)."""
    from sdtpu_torch.tools import map_jax_order, shapes_tree

    def make(path, s):
        if s.ndim == 1 and path[-1] == "scale":
            arr = np.ones(tuple(s.shape), np.float32)
        elif s.ndim == 1 and path[-1] == "bias":
            arr = np.zeros(tuple(s.shape), np.float32)
        else:
            arr = (host.standard_normal(tuple(s.shape)) * 0.04).astype(np.float32)
        return torch.from_numpy(arr).to(device).to(config.param_dtype)

    return map_jax_order(make, shapes_tree(config))


def quantized(params: dict, sigmas=None) -> dict:
    """``quantize_pipeline_int8`` as the JAX tool calls it (the UNet's
    convs; CLIP and the VAE stay float); ``sigmas`` None keeps the
    library default."""
    from sdtpu_torch.utils.quant import quantize_pipeline_int8

    return quantize_pipeline_int8(params, **({} if sigmas is None else {"sigmas": sigmas}))


def unet_gate(config, params: dict, qparams: dict, host, *, latent: int = 64,
              added_cond=None) -> float:
    """Gate 2: one CFG-batched UNet forward (batch 2, ``latent``^2, t = 500,
    inputs drawn from ``host`` in the compute dtype) of the int8 tree
    against the bf16 tree, both through the kernel route."""
    from sdtpu_torch.models.unet import unet_forward

    device = params["unet"]["conv_in"]["kernel"].device
    cd = config.compute_dtype
    lat = torch.from_numpy(host.standard_normal((2, latent, latent, config.unet.in_channels))
                           ).to(device, cd)
    ctx = torch.from_numpy(host.standard_normal(
        (2, config.clip.max_length, config.unet.cross_attention_dim))).to(device, cd)
    ts = torch.full((2,), 500.0, device=device)
    kw = dict(attention_impl="flash", conv_impl="gemm", added_cond=added_cond)
    with torch.inference_mode():
        u16 = unet_forward(lat, ts, ctx, params["unet"], config.unet, **kw).float()
        uq = unet_forward(lat, ts, ctx, qparams["unet"], config.unet, **kw).float()
    return rel(u16, uq)


def vae_gate(config, params: dict, host, *, image_size: int, conv_impl: str = "gemm") -> float:
    """Gate 2b: the PSNR of one decode (``image_size // 8``-square latents
    drawn from ``host``) through the int8 decoder
    (``quantize_vae_decoder_int8`` at its defaults) against the bf16 one,
    the attention on the library route as in the JAX tool."""
    from sdtpu_torch.models.vae import vae_decode
    from sdtpu_torch.utils.image import psnr
    from sdtpu_torch.utils.quant import quantize_vae_decoder_int8

    dec = params["vae_decoder"]
    device = dec["conv_in"]["kernel"].device
    f = image_size // 8
    z = torch.from_numpy(host.standard_normal((1, f, f, config.vae.latent_channels))).to(
        device, config.compute_dtype)
    with torch.inference_mode():
        d16 = vae_decode(z, dec, config.vae, attention_impl="xla", conv_impl=conv_impl).float()
        qdec = quantize_vae_decoder_int8(dec)
        dq = vae_decode(z, qdec, config.vae, attention_impl="xla", conv_impl=conv_impl).float()
    del qdec
    return psnr(d16.cpu().numpy(), dq.cpu().numpy())


def control_config(config):
    """The float32 control's config: float32 leaves and compute on the
    library route."""
    return config.replace(compute_dtype=torch.float32, param_dtype=torch.float32,
                          attention_impl="xla", conv_impl="xla")


def pipeline_gate(config, trees: dict, host, *, steps: int, image_size: int, device) -> dict:
    """Gate 3: one ``steps``-step image (seed 40, ids drawn from ``host``,
    CFG, float output) through ``trees["bf16"]``, then ``trees["int8"]``,
    which is taken out of ``trees`` and freed before the float32 control
    (the bf16 tree cast, on the library route, TF32 off) is built.  Returns
    the two PSNRs and the three images' seconds."""
    from sdtpu_torch import StableDiffusionPipeline
    from sdtpu_torch.tools.device_precision import cast_tree
    from sdtpu_torch.utils.image import psnr

    ids = host.integers(1, config.clip.vocab_size, (2, config.clip.max_length))
    kw = dict(token_ids=ids, num_inference_steps=steps, seed=40, image_size=image_size,
              output="float")
    secs = {}

    def image(label, cfg, params):
        t0 = time.perf_counter()
        with torch.inference_mode():
            img = np.asarray(StableDiffusionPipeline(cfg, params, device=device).generate(
                "x", **kw), np.float32)
        secs[label] = time.perf_counter() - t0
        print(f"{label} generate in {secs[label]:.1f}s", file=sys.stderr)
        return img

    want = image("bf16", config, trees["bf16"])
    got = image("int8", config, trees.pop("int8"))
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with no_tf32():
        ref = image("f32 control", control_config(config), cast_tree(trees["bf16"], torch.float32))
    return {"pipeline_psnr_db_int8_vs_bf16": psnr(want, got),
            "control_psnr_db_bf16_vs_f32": psnr(ref, want), "seconds": secs}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="tiny-sd")
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--sigmas", type=float, default=None,
                    help="activation-range headroom (default: the library default in "
                         "sdtpu_torch/utils/quant.py)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(args, device) -> dict:
    """The four gates on ``device``; prints the JSON line and returns it as
    a dict (``pass`` says whether every gate held)."""
    from sdtpu_torch.config import get_preset

    values = {"kernel_rel_vs_float": kernel_gate(KERNEL_SHAPE, device=device)[0]}
    print(f"int8 slab kernel vs float slab: rel {values['kernel_rel_vs_float']:.4f}",
          file=sys.stderr)

    config = get_preset(args.preset)
    host = np.random.default_rng(1234)
    t0 = time.perf_counter()
    params = gate_tree(config, host, device)
    print(f"params in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    trees = {"bf16": params, "int8": quantized(params, args.sigmas)}
    values["unet_forward_rel_int8_vs_bf16"] = unet_gate(config, params, trees["int8"], host)
    print(f"single-forward UNet int8 vs bf16: rel "
          f"{values['unet_forward_rel_int8_vs_bf16']:.4f}", file=sys.stderr)
    values["vae_decode_psnr_db_int8_vs_bf16"] = vae_gate(
        config, params, host, image_size=args.image_size,
        conv_impl="gemm" if device.type == "cuda" else "xla")
    print(f"VAE decode int8 vs bf16: {values['vae_decode_psnr_db_int8_vs_bf16']:.1f} dB",
          file=sys.stderr)
    p = pipeline_gate(config, trees, host, steps=args.steps, image_size=args.image_size,
                      device=device)
    values["psnr_margin_db_vs_chaos_control"] = (p["pipeline_psnr_db_int8_vs_bf16"]
                                                 - p["control_psnr_db_bf16_vs_f32"])
    print(f"pipeline PSNR int8-vs-bf16 {p['pipeline_psnr_db_int8_vs_bf16']:.1f} dB; chaos "
          f"control bf16-vs-f32 {p['control_psnr_db_bf16_vs_f32']:.1f} dB", file=sys.stderr)
    results = verdict(values, GATES, 4, {
        "backend": device.type,
        "pipeline_psnr_db_int8_vs_bf16": round(p["pipeline_psnr_db_int8_vs_bf16"], 2),
        "control_psnr_db_bf16_vs_f32": round(p["control_psnr_db_bf16_vs_f32"], 2),
        "control_path": CONTROL_PATH})
    results["steps"] = args.steps
    print(json.dumps(results))
    return results


def main(argv=None) -> dict:
    from sdtpu_torch.tools import device_arg

    args = parse_args(argv)
    results = run(args, device_arg("check_int8", args.device))
    if not results["pass"]:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
