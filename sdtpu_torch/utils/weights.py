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
from sdtpu_torch.utils import hostrng


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


def _to(tree, device):
    """Every leaf to ``device`` once, in its own dtype."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def init_pipeline_params(key, config: PipelineConfig, *, device="cuda") -> dict:
    """Seeded random parameters for ``from_random``: the text encoder, the
    UNet and the VAE decoder, equal to the JAX package's
    ``init_pipeline_params(key, config)`` leaf by leaf.  ``key`` (an int
    seed or a ``hostrng.HostKey``) splits five ways as there: CLIP, UNet,
    the VAE encoder (drawn by the img2img slice), the decoder, a second
    text encoder.  Every leaf is drawn on the host with numpy's Philox,
    rounded to ``config.param_dtype`` (the CLIP embeddings stay float32)
    and moved to ``device`` once."""
    from sdtpu_torch.models.clip import init_clip
    from sdtpu_torch.models.unet import init_unet
    from sdtpu_torch.models.vae import init_vae_decoder

    if config.clip is None or config.clip_2 is not None:
        raise NotImplementedError("dual / bigG-only text encoders: model-family slice")
    k1, k2, _k3, k4, _k5 = hostrng.split(hostrng.ensure_key(key), 5)
    dtype = config.param_dtype
    return _to({
        "clip": init_clip(k1, config.clip, dtype=dtype),
        "unet": init_unet(k2, config.unet, dtype=dtype),
        "vae_decoder": init_vae_decoder(k4, config.vae, dtype=dtype),
    }, device)


def _zeros(tree, device):
    if isinstance(tree, dict):
        return {k: _zeros(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros(v, device) for v in tree]
    return torch.zeros(tree.shape, dtype=tree.dtype, device=device)


def zero_pipeline_params(config: PipelineConfig, *, device="cuda") -> dict:
    """Zeros with ``init_pipeline_params``' tree, shapes and dtypes, made on
    ``device`` without drawing (benchmarks: speed does not depend on the
    weight values)."""
    with hostrng.shapes_only():
        shapes = init_pipeline_params(0, config, device="meta")
    return _zeros(shapes, device)
