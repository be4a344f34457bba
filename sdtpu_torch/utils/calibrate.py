"""int8 activation calibration for the matmuls whose input range is not
norm-pinned (attention out-projections, the GeGLU down-projection).

Counterpart of ``sdtpu/utils/calibrate.py``:

1. :func:`collect_unet_samples` runs a short real DDPM trajectory, so the
   activations are measured on-distribution;
2. :func:`calibrate_unet_act_ranges` replays the samples through the eager
   UNet forward under ``ops/linear.py:activation_capture``, max-accumulating
   the per-feature ``|x|`` at every dynamic site;
3. ``quantize_unet_int8(..., transformer="full", act_ranges=ranges)`` gives
   those sites static symmetric per-feature scales.

The forward runs the dense attention route, as the JAX package's eager
forward does, so that every site's input passes through ``linear``.  Site
paths are the JAX package's, letter for letter.  Calibration means
something only with real weights; on random ones the machinery still
round-trips.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from sdtpu_torch.config import UNetConfig


def iter_dynamic_sites(unet_params: dict):
    """Yield ``(path, linear_dict)`` for every un-normalized-input matmul
    that ``transformer="full"`` targets: the attn1/attn2 out-projections and
    the GeGLU down-projection of every transformer block."""

    def from_attn(prefix: str, attn: dict):
        for bi, b in enumerate(attn["blocks"]):
            yield f"{prefix}.blocks.{bi}.attn1.out", b["attn1"]["out"]
            yield f"{prefix}.blocks.{bi}.attn2.out", b["attn2"]["out"]
            yield f"{prefix}.blocks.{bi}.ff.out", b["ff"]["out"]

    for li, blk in enumerate(unet_params["down_blocks"]):
        for ai, a in enumerate(blk.get("attentions", [])):
            yield from from_attn(f"down_blocks.{li}.attentions.{ai}", a)
    if "mid_block" in unet_params:
        for ai, a in enumerate(unet_params["mid_block"]["attentions"]):
            yield from from_attn(f"mid_block.attentions.{ai}", a)
    for li, blk in enumerate(unet_params["up_blocks"]):
        for ai, a in enumerate(blk.get("attentions", [])):
            yield from from_attn(f"up_blocks.{li}.attentions.{ai}", a)


@torch.inference_mode()
def collect_unet_samples(
    params: dict,
    config: UNetConfig,
    scheduler_config,
    *,
    context: torch.Tensor,
    latent_size: int,
    num_steps: int = 6,
    seed: int = 0,
    added_cond: Optional[dict] = None,
) -> Iterable[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """A short DDPM trajectory yielding ``(latents_in, t, context)`` per
    step.  The initial latents and the per-step noise come from one
    ``torch.Generator`` on ``context``'s device, seeded with ``seed`` (not
    ``jax.random``'s bits); the trajectory is float32 and the UNet runs in
    ``context``'s dtype.  ``added_cond``: SDXL's add-embedding inputs."""
    from sdtpu_torch.models.unet import unet_forward
    from sdtpu_torch.samplers import get_sampler

    dev = context.device
    sdef = get_sampler("ddpm")
    schedule = sdef.make_schedule(scheduler_config, num_steps, 1.0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    batch = context.shape[0]
    lat = torch.randn((batch, latent_size, latent_size, config.in_channels),
                      generator=gen, device=dev)
    for i in range(num_steps):
        t = schedule.timesteps[i].float().expand(batch)
        yield lat, t, context
        eps = unet_forward(lat.to(context.dtype), t, context, params, config,
                           added_cond=added_cond, attention_impl="dense").float()
        noise = torch.randn(lat.shape, generator=gen, device=dev)
        lat = sdef.step(schedule, i, lat, eps, noise)


@torch.inference_mode()
def calibrate_unet_act_ranges(
    params: dict,
    config: UNetConfig,
    samples: Iterable[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    *,
    added_cond: Optional[dict] = None,
) -> Dict[str, np.ndarray]:
    """Replay ``(latents, t, context)`` samples through the eager UNet
    forward, capturing the per-feature input abs-max at every dynamic site:
    ``{site_path: (features,) float32 amax}`` for
    ``quantize_unet_int8(act_ranges=...)``."""
    from sdtpu_torch.models.unet import unet_forward
    from sdtpu_torch.ops.linear import activation_capture

    site_by_id = {id(lin["kernel"]): path
                  for path, lin in iter_dynamic_sites(params) if "kernel" in lin}
    store: Dict[str, np.ndarray] = {}
    with activation_capture(store, site_by_id):
        for lat, t, ctx in samples:
            unet_forward(lat.to(ctx.dtype), t, ctx, params, config, added_cond=added_cond,
                         attention_impl="dense")
    return store


def calibrate_pipeline_act_ranges(
    pipe,
    token_ids: np.ndarray,
    *,
    image_size: Optional[int] = None,
    num_steps: int = 6,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """One call for a pipeline: encode ``token_ids`` (a (B, L) batch of
    calibration prompts) with the text encoder(s), run a short DDPM
    trajectory in the pipeline's compute dtype, and return the captured
    ranges for ``pipe.quantize_int8(transformer="full", act_ranges=...)``.
    The prompts are encoded as a request's cond rows are
    (``StableDiffusionPipeline._encode``): an SDXL UNet takes bigG's pooled
    embedding and the time ids ``[size, size, 0, 0, size, size]``, or five
    with the preset's aesthetic score for a refiner, on every row."""
    config = pipe.config
    size = image_size or config.default_image_size
    with torch.inference_mode():
        context, added = pipe._encode(token_ids, 0, size=size, cfg=False)
    samples = collect_unet_samples(
        pipe.params["unet"], config.unet, config.scheduler,
        context=context,
        latent_size=size // config.vae.downscale_factor,
        num_steps=num_steps, seed=seed, added_cond=added,
    )
    return calibrate_unet_act_ranges(pipe.params["unet"], config.unet, samples,
                                     added_cond=added)
