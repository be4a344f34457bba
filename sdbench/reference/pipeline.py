"""A request worked out again in plain float32: the text encoder(s), the
configuration's sampler (``samplers/<name>.py``), classifier-free guidance
where the configuration's ``cfg_scale`` is above 1, the UNet at every
step, the VAE (encode for img2img, decode) and the uint8 conversion.  It
reads the benchmark's config file and weights, and imports nothing of the
program."""

from __future__ import annotations

import importlib

import numpy as np
import torch

from sdbench import spec
from sdbench.reference import clip, prng, unet, vae
from sdbench.reference.nn import Ops


def uncond_row(vocab: int, length: int) -> np.ndarray:
    """The empty prompt: BOS, then EOS to the end (CLIP's tokenizer)."""
    row = np.full((length,), vocab - 1, np.int64)
    row[0] = vocab - 2
    return row


def encode_text(ops: Ops, ids: torch.Tensor, params: dict, cfg: dict, size: int):
    """Token rows -> (context, added) as the configuration states: one
    encoder's final-LN states (SD 1.x), or CLIP-L's and bigG's penultimate
    states side by side with bigG's projected pooled output and the time ids
    (size, size, 0, 0, size, size) (SDXL)."""
    parts, pooled = [], None
    if cfg.get("clip"):
        h, pooled = clip.encode(ops, ids, params["clip"], cfg["clip"])
        parts.append(h)
    if not cfg.get("clip_2"):
        return parts[0], None
    h2, pooled = clip.encode(ops, ids, params["clip_2"], cfg["clip_2"])
    parts.append(h2)
    tid = torch.tensor([[size, size, 0, 0, size, size]] * ids.shape[0], dtype=torch.float32,
                       device=ids.device)
    return torch.cat(parts, dim=-1), {"text_embeds": pooled, "time_ids": tid}


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round((img + 1.0) * 127.5), 0, 255).to(torch.uint8)


@torch.inference_mode()
def generate(params: dict, cfg: dict, req: dict, *, per_row: bool, ops: Ops = None,
             device="cuda") -> np.ndarray:
    """One request (``ids`` (77,) cond token ids, ``seed``, optional
    ``image`` (H, W, 3) uint8 and ``strength``) at ``cfg``'s size, steps,
    sampler and guidance -> (H, W, 3) uint8."""
    ops = ops or Ops()
    size, steps, scale = cfg["image_size"], cfg["steps"], cfg["cfg_scale"]
    vcfg, ucfg = cfg["vae"], cfg["unet"]
    guided = spec.guided(cfg)
    sampler = importlib.import_module(f"sdbench.reference.samplers.{cfg['sampler']}")
    f = 2 ** (len(vcfg["block_out_channels"]) - 1)
    lat_shape = (size // f, size // f, vcfg["latent_channels"])
    img2img = req.get("image") is not None
    tab = sampler.tables(cfg["scheduler"], steps, req.get("strength", 1.0) if img2img else 1.0)
    n = len(tab["timesteps"])
    text = cfg.get("clip") or cfg["clip_2"]
    rows = [np.asarray(req["ids"], np.int64)]
    if guided:
        rows.append(uncond_row(text["vocab_size"], text["max_length"]))
    ids = torch.from_numpy(np.stack(rows)).to(device)
    context, added = encode_text(ops, ids, params, cfg, size)
    heads = 2 if img2img else 1
    z = prng.normals(prng.request_keys(req["seed"], n, heads=heads, per_row=per_row),
                     lat_shape, device)[:, None]
    if img2img:
        image = torch.from_numpy(np.asarray(req["image"], np.float32) / 127.5 - 1.0)[None]
        lat0 = vae.encode(ops, image.to(device), z[0], params["vae_encoder"], vcfg)
        lat = sampler.noised(tab, lat0, z[1])
    else:
        lat = sampler.initial(tab, z[0])
    for i, t in enumerate(tab["timesteps"]):
        temb = unet.time_embedding(ops, torch.full((len(rows),), float(t), device=device),
                                   params["unet"], ucfg, added)
        x = sampler.model_input(tab, i, lat)
        eps = unet.forward(ops, torch.cat([x] * len(rows)), temb, context, params["unet"], ucfg)
        eps = eps[1] + scale * (eps[0] - eps[1]) if guided else eps[0:1]
        lat = sampler.step(tab, i, lat, eps, z[heads + i])
    img = vae.decode(ops, lat, params["vae_decoder"], vcfg)
    return to_uint8(img[0]).cpu().numpy()
