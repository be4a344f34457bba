"""Parameter trees for the port: conversion from the JAX package's tree,
and seeded random initialization.

The port's parameters are the JAX package's tree with the same keys and
layouts (NHWC/HWIO/(in, out)), as nested dicts and lists of tensors, so a
JAX tree converts leaf by leaf with no transposes.  Loading diffusers
checkpoints belongs to the weights slice.
"""

from __future__ import annotations

import numpy as np
import torch

from sdtpu_torch.config import PipelineConfig


def _leaf_to_torch(leaf, device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # torch rejects ml_dtypes' bfloat16; bf16 -> f32 -> bf16 is exact
        return torch.tensor(arr.astype(np.float32), device=device).to(torch.bfloat16)
    # a copy: the arrays of a JAX tree are read-only
    return torch.tensor(arr, device=device)


def params_from_numpy(tree, *, device="cuda"):
    """A nested dict/list tree of numpy arrays (e.g. the JAX package's
    parameters after ``jax.tree.map(np.asarray, params)``) -> the same tree
    of tensors on ``device``, each leaf keeping its own dtype."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device=device) for v in tree]
    return _leaf_to_torch(tree, device)


def init_pipeline_params(seed: int, config: PipelineConfig, *, device="cuda") -> dict:
    """Seeded random parameters for ``from_random``: the text encoder, the
    UNet and the VAE decoder, with the JAX package's shapes, dtypes
    (``config.param_dtype``; the CLIP embeddings stay float32) and fan-in
    bounds, drawn from one ``torch.Generator`` on ``device``.  The values
    are not the JAX package's (its numpy-Philox host init is not ported),
    and the VAE encoder belongs to the img2img slice."""
    from sdtpu_torch.models.clip import init_clip
    from sdtpu_torch.models.unet import init_unet
    from sdtpu_torch.models.vae import init_vae_decoder

    if config.clip is None or config.clip_2 is not None:
        raise NotImplementedError("dual / bigG-only text encoders: model-family slice")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    dtype = config.param_dtype
    return {
        "clip": init_clip(gen, config.clip, dtype=dtype),
        "unet": init_unet(gen, config.unet, dtype=dtype),
        "vae_decoder": init_vae_decoder(gen, config.vae, dtype=dtype),
    }
