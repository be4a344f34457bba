"""Hold a diffusers checkpoint's networks in the port against an independent
PyTorch mirror of the diffusers architecture.

Counterpart of ``tools/validate_checkpoint.py``.  One checkpoint directory
loads twice: into the port's trees (``utils/weights.py``, in ``--dtype``)
and into ``tests/torch_ref.py``'s ``RefUNet`` and ``RefAutoencoderKL``
(float32; the file imports torch only and is loaded by its path).  Both run
full-network forwards on shared seeded inputs on ``--device``: the UNet at
``--batch`` x ``--latent``^2 latents, the VAE decode of ``--latent``^2
latents and the VAE encode of an ``--image``^2 image.  An SDXL or refiner
UNet also takes a synthesized pooled text embedding and its time ids (six,
or five with an aesthetic score).  It prints each
network's max absolute and relative (L2) error and the decoded image's
PSNR::

    python -m sdtpu_torch.tools.validate_checkpoint MODEL_DIR [--preset tiny-sd]
        [--latent 32] [--batch 1] [--image 256] [--device cuda] [--dtype float32]

The mirror's float32 reference runs with TF32 off.  In float32 a network
passes at a relative error under 1e-3 (the decode: PSNR over 40 dB); a
bf16 run is judged against a bf16-versus-float32 control (``chip_smoke.py``
runs the port's plain route for it).  It exits non-zero when asked for
``cuda`` on a machine without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import numpy as np
import torch

from sdtpu_torch.tools import no_tf32

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TORCH_REF = os.path.join(REPO, "tests", "torch_ref.py")
NETWORKS = ("unet", "vae_decode", "vae_encode")


def torch_ref():
    """``tests/torch_ref.py`` (the diffusers mirror), loaded by its path."""
    spec = importlib.util.spec_from_file_location("torch_ref", TORCH_REF)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve_config(model_dir: str, preset=None):
    """An explicit preset; else the checkpoint's own JSON configs; else the
    preset named by the directory (tiny-sd if none is)."""
    from sdtpu_torch.config import PRESETS, config_from_checkpoint, get_preset

    if preset is not None:
        return get_preset(preset)
    try:
        return config_from_checkpoint(model_dir)
    except (ValueError, FileNotFoundError):
        base = os.path.basename(model_dir.rstrip("/"))
        return get_preset(base if base in PRESETS else "tiny-sd")


def load_port(model_dir: str, config, *, dtype, device) -> dict:
    """The port's UNet and VAE trees, in ``dtype`` on ``device``."""
    from sdtpu_torch.utils.weights import (
        load_subfolder,
        unet_params_from_state_dict,
        vae_decoder_params_from_state_dict,
        vae_encoder_params_from_state_dict,
    )

    params = {"unet": load_subfolder(model_dir, "unet",
                                     lambda sd: unet_params_from_state_dict(sd, config.unet),
                                     dtype, device)}
    params.update(load_subfolder(model_dir, "vae", lambda sd: {
        "vae_encoder": vae_encoder_params_from_state_dict(sd, config.vae),
        "vae_decoder": vae_decoder_params_from_state_dict(sd, config.vae)}, dtype, device))
    return params


def load_mirror(model_dir: str, config, *, device):
    """``RefUNet`` and ``RefAutoencoderKL`` with the checkpoint's weights in
    float32 on ``device``; prints any key the mirror does not share."""
    from sdtpu_torch.utils.native_safetensors import NativeSafetensors
    from sdtpu_torch.utils.weights import _find_weight_file

    ref = torch_ref()
    models = {"unet": ref.RefUNet(config.unet), "vae": ref.RefAutoencoderKL(config.vae)}
    for name, model in models.items():
        with NativeSafetensors(_find_weight_file(os.path.join(model_dir, name))) as f:
            sd = {}
            for k, v in f.state_dict().items():
                # checkpoints that store Transformer2D proj_in/out as linears
                if k.endswith(("proj_in.weight", "proj_out.weight")) and v.ndim == 2:
                    v = v[:, :, None, None]
                sd[k] = v.float()
            missing, unexpected = model.load_state_dict(sd, strict=False)
        if missing or unexpected:
            print(f"torch mirror {name} key mismatch: missing={missing[:5]} "
                  f"unexpected={unexpected[:5]}")
        model.eval().to(device)
    return models


def make_inputs(config, *, latent: int, batch: int, image: int, seed: int = 0) -> dict:
    """Seeded numpy inputs (NHWC) shared by both sides; for an SDXL UNet
    also ``text_embeds`` (drawn after the others) and ``time_ids`` (the JAX
    tool's ``[512, 512, 0, 0, 6.0, 512]``, its first five under an
    aesthetic score)."""
    rng = np.random.default_rng(seed)
    inputs = {
        "lat": rng.standard_normal((batch, latent, latent, config.unet.in_channels),
                                   dtype=np.float32),
        "ctx": rng.standard_normal((batch, config.text_config.max_length,
                                    config.unet.cross_attention_dim), dtype=np.float32),
        "ts": np.linspace(981.0, 1.0, batch).astype(np.float32),
        "z": rng.standard_normal((1, latent, latent, config.vae.latent_channels),
                                 dtype=np.float32),
        "img": rng.uniform(-1.0, 1.0, (1, image, image, config.vae.in_channels))
               .astype(np.float32),
    }
    ucfg = config.unet
    if ucfg.addition_embed_dim is not None:
        n_ids = 5 if config.requires_aesthetics_score else 6
        pooled_dim = ucfg.addition_embed_dim - n_ids * ucfg.addition_time_embed_dim
        inputs["text_embeds"] = rng.standard_normal((batch, pooled_dim), dtype=np.float32)
        inputs["time_ids"] = np.tile(
            np.asarray([[512, 512, 0, 0, 6.0, 512][:n_ids]], np.float32), (batch, 1))
    return inputs


def run_port(params: dict, config, inputs: dict, *, dtype, device) -> dict:
    """The port's three forwards on its default route (the kernels on a
    card, their plain versions on the CPU), float32 NHWC outputs."""
    from sdtpu_torch.models.unet import unet_forward
    from sdtpu_torch.models.vae import vae_decode, vae_encoder

    def t(name):
        return torch.from_numpy(inputs[name]).to(device)

    added = ({"text_embeds": t("text_embeds").to(dtype), "time_ids": t("time_ids")}
             if "time_ids" in inputs else None)
    with torch.inference_mode():
        return {
            "unet": unet_forward(t("lat").to(dtype), t("ts"), t("ctx").to(dtype),
                                 params["unet"], config.unet, added_cond=added).float(),
            "vae_decode": vae_decode(t("z").to(dtype), params["vae_decoder"],
                                     config.vae).float(),
            "vae_encode": vae_encoder(t("img").to(dtype), params["vae_encoder"],
                                      config.vae).float(),
        }


def run_mirror(models: dict, config, inputs: dict, *, device) -> dict:
    """The mirror's three forwards in float32 (TF32 off), NHWC outputs.
    ``device`` is the default device meanwhile: the mirror makes its
    timestep frequencies with ``torch.arange`` and no device."""
    def nchw(name):
        return torch.from_numpy(inputs[name]).permute(0, 3, 1, 2).contiguous().to(device)

    def nhwc(x):
        return x.permute(0, 2, 3, 1).contiguous()

    with torch.inference_mode(), no_tf32(), torch.device(device):
        return {
            "unet": nhwc(models["unet"](
                nchw("lat"), torch.from_numpy(inputs["ts"]).to(device),
                torch.from_numpy(inputs["ctx"]).to(device),
                **{k: torch.from_numpy(inputs[k]).to(device)
                   for k in ("text_embeds", "time_ids") if k in inputs})),
            "vae_decode": nhwc(models["vae"].decode(nchw("z"), config.vae.scaling_factor)),
            "vae_encode": nhwc(models["vae"].encode_moments(nchw("img"))),
        }


def errors(got: dict, want: dict) -> dict:
    """Per network: max |got - want|, the relative L2 error, and for the
    decode the PSNR (range 2)."""
    from sdtpu_torch.utils.image import psnr

    out = {}
    for name in NETWORKS:
        g, w = got[name].float(), want[name].float()
        d = (g - w).flatten()
        out[name] = {"max_abs": float(d.abs().max()),
                     "rel_l2": float(torch.linalg.vector_norm(d)
                                     / (torch.linalg.vector_norm(w.flatten()) + 1e-9))}
    out["vae_decode"]["psnr_db"] = psnr(got["vae_decode"].cpu().numpy(),
                                        want["vae_decode"].cpu().numpy())
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model_dir")
    ap.add_argument("--preset", default=None,
                    help="default: the checkpoint's own JSON configs, else the preset named "
                         "by the directory")
    ap.add_argument("--latent", type=int, default=32, help="latent grid of the UNet and decode")
    ap.add_argument("--batch", type=int, default=1, help="UNet batch")
    ap.add_argument("--image", type=int, default=256, help="image side of the encode")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("validate_checkpoint: --device cuda, but torch.cuda.is_available() is False",
              file=sys.stderr)
        raise SystemExit(2)
    dtype = getattr(torch, args.dtype)
    config = resolve_config(args.model_dir, args.preset)
    print(f"config: {config.name}; {args.dtype} on {device}")
    port = load_port(args.model_dir, config, dtype=dtype, device=device)
    mirror = load_mirror(args.model_dir, config, device=device)
    inputs = make_inputs(config, latent=args.latent, batch=args.batch, image=args.image,
                         seed=args.seed)
    errs = errors(run_port(port, config, inputs, dtype=dtype, device=device),
                  run_mirror(mirror, config, inputs, device=device))
    for name in NETWORKS:
        e = errs[name]
        verdict = ""
        if dtype == torch.float32:
            ok = e.get("psnr_db", 99.0) > 40.0 if name == "vae_decode" else e["rel_l2"] < 1e-3
            verdict = " OK" if ok else " INVESTIGATE"
        extra = f", PSNR {e['psnr_db']:.1f} dB" if "psnr_db" in e else ""
        print(f"{name:10s}: max abs err {e['max_abs']:.3e}, rel {e['rel_l2']:.3e}{extra}{verdict}")
    return errs


if __name__ == "__main__":
    main()
