"""Per-stage bf16 drift gates on the card, the counterpart of the JAX
package's ``tools/device_precision.py``::

    python -m sdtpu_torch.tools.device_precision [--preset tiny-sd] [--latent 64]
        [--device cuda]

The CPU tests pin bf16-versus-float32 drift per stage at small configs;
this tool runs the same comparisons at a preset's full width on the card,
where the hand-written kernels and the card's accumulation order take
part:

* reference side: the float32 tree through the library route
  (``attention_impl="xla"``, ``conv_impl="xla"``: SDPA and cuDNN), with TF32
  off in cuBLAS and cuDNN while it runs;
* candidate side: the same tree cast to bf16 through the kernel route
  (``attention_impl="flash"``, ``conv_impl="gemm"``: kernels A, B and C on
  the card, their plain versions on the CPU).

Every leaf is ``numpy.random.default_rng(99).standard_normal * 0.04`` in
float32, drawn in the JAX tool's leaf order.  One stage each: CLIP on two
rows of seeded ids, one CFG-batched UNet forward at ``--latent``^2 and
t = 500, one VAE decode.  Gates, the JAX tool's: ``clip_rel`` < 0.015,
``unet_rel`` < 0.03, ``vae_decode_rel`` < 0.03, ``vae_decode_psnr_db`` > 45.
Prints one JSON line with the JAX tool's keys; exits 0 only if every gate
passes, non-zero for ``cuda`` without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from sdtpu_torch.tools import no_tf32, verdict

# (name, gate, "lt" or "gt")
GATES = (("clip_rel", 0.015, "lt"), ("unet_rel", 0.03, "lt"), ("vae_decode_rel", 0.03, "lt"),
         ("vae_decode_psnr_db", 45.0, "gt"))


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """``|a - b| / (|a| + 1e-9)`` in float32 L2 norms, as the JAX tools."""
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm((a - b).flatten())
                 / (torch.linalg.vector_norm(a.flatten()) + 1e-9))


def precision_tree(config, device) -> dict:
    """The float32 tree of the JAX tool: each leaf 0.04 x float32 standard
    normals of its shape from ``numpy.random.default_rng(99)``, in jax's
    leaf order."""
    from sdtpu_torch.tools import map_jax_order, shapes_tree

    host = np.random.default_rng(99)
    return map_jax_order(lambda _, s: torch.from_numpy(
        host.standard_normal(tuple(s.shape), dtype=np.float32) * 0.04).to(device),
        shapes_tree(config))


def cast_tree(tree, dtype):
    """Every floating leaf cast to ``dtype`` (``cast_pytree``)."""
    from sdtpu_torch.tools import map_jax_order

    return map_jax_order(lambda _, t: t.to(dtype) if t.is_floating_point() else t, tree)


def stage_inputs(config, latent: int, device) -> dict:
    """The JAX tool's inputs from ``numpy.random.default_rng(3)``: UNet
    latents and context (batch 2), CLIP ids (2 rows), then the decode's
    latents (batch 1); t = 500."""
    rng = np.random.default_rng(3)
    inp = {"lat": rng.standard_normal((2, latent, latent, config.unet.in_channels))
           .astype(np.float32),
           "ctx": rng.standard_normal((2, config.clip.max_length,
                                       config.unet.cross_attention_dim)).astype(np.float32),
           "ids": rng.integers(1, config.clip.vocab_size, (2, config.clip.max_length)),
           "ts": np.full((2,), 500.0, np.float32)}
    inp["z"] = rng.standard_normal((1, latent, latent, config.vae.latent_channels)
                                   ).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in inp.items()}


def run_stages(config, p32: dict, inp: dict) -> dict:
    """``{stage: (reference float32, candidate bf16)}`` outputs of CLIP's
    hidden states, the UNet forward and the VAE decode, as float32."""
    from sdtpu_torch.models.clip import clip_encode
    from sdtpu_torch.models.unet import unet_forward
    from sdtpu_torch.models.vae import vae_decode

    p16 = cast_tree(p32, torch.bfloat16)
    bf = torch.bfloat16
    out = {}
    with torch.inference_mode():
        t0 = time.perf_counter()
        with no_tf32():
            ref = clip_encode(inp["ids"], p32["clip"], config.clip)[0]
        out["clip"] = (ref.float(), clip_encode(inp["ids"], p16["clip"], config.clip)[0].float())
        print(f"clip ({time.perf_counter() - t0:.1f}s)", file=sys.stderr)
        t0 = time.perf_counter()
        with no_tf32():
            ref = unet_forward(inp["lat"], inp["ts"], inp["ctx"], p32["unet"], config.unet,
                               attention_impl="xla", conv_impl="xla")
        out["unet"] = (ref.float(), unet_forward(
            inp["lat"].to(bf), inp["ts"], inp["ctx"].to(bf), p16["unet"], config.unet,
            attention_impl="flash", conv_impl="gemm").float())
        print(f"unet ({time.perf_counter() - t0:.1f}s)", file=sys.stderr)
        t0 = time.perf_counter()
        with no_tf32():
            ref = vae_decode(inp["z"], p32["vae_decoder"], config.vae, attention_impl="xla",
                             conv_impl="xla")
        out["vae_decode"] = (ref.float(), vae_decode(
            inp["z"].to(bf), p16["vae_decoder"], config.vae, attention_impl="flash",
            conv_impl="gemm").float())
        print(f"vae decode ({time.perf_counter() - t0:.1f}s)", file=sys.stderr)
    return out


def stage_checks(outputs: dict) -> dict:
    """The four gated values of :func:`run_stages`' outputs."""
    from sdtpu_torch.utils.image import psnr

    d32, d16 = outputs["vae_decode"]
    return {"clip_rel": rel(*outputs["clip"]), "unet_rel": rel(*outputs["unet"]),
            "vae_decode_rel": rel(d32, d16),
            "vae_decode_psnr_db": psnr(d32.cpu().numpy(), d16.cpu().numpy())}


def run(preset: str, latent: int, device) -> dict:
    """The tool's measurement on ``device``; prints the JSON line and
    returns it as a dict (``pass`` says whether every gate held)."""
    from sdtpu_torch.config import get_preset

    config = get_preset(preset)
    t0 = time.perf_counter()
    p32 = precision_tree(config, device)
    print(f"params in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    values = stage_checks(run_stages(config, p32, stage_inputs(config, latent, device)))
    route = "kernels A, B, C" if device.type == "cuda" else "their plain versions"
    results = verdict(values, GATES, 5, {
        "backend": device.type, "preset": preset,
        "candidate_path": f"bf16 attention=flash conv=gemm ({route})"})
    print(json.dumps(results))
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="tiny-sd")
    ap.add_argument("--latent", type=int, default=64, help="latent grid (64 = 512px)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from sdtpu_torch.tools import device_arg

    results = run(args.preset, args.latent, device_arg("device_precision", args.device))
    if not results["pass"]:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
