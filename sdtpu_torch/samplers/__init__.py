"""Samplers.  Every sampler shares one protocol: ``make_schedule(config,
steps, strength, device=)`` returns per-step tables, ``step(schedule, i,
latents, eps, noise)`` is pure, ``add_noise`` forward-noises for img2img.
Only DDPM is ported; the other samplers of the JAX package belong to a
later slice."""

import dataclasses
from typing import Callable, Optional

from sdtpu_torch.samplers.ddpm import (
    DDPMSchedule,
    add_noise,
    ddpm_step,
    inference_timesteps,
    make_alphas_cumprod,
    make_betas,
    make_schedule,
)


@dataclasses.dataclass(frozen=True)
class SamplerDef:
    make_schedule: Callable
    step: Callable
    add_noise: Callable
    scale_model_input: Optional[Callable] = None
    stochastic: bool = False  # draws per-step variance noise
    multistep: bool = False
    state_init: Optional[Callable] = None


SAMPLERS = {
    "ddpm": SamplerDef(make_schedule, ddpm_step, add_noise, stochastic=True),
}


def get_sampler(name: str) -> SamplerDef:
    try:
        return SAMPLERS[name]
    except KeyError:
        raise NotImplementedError(
            f"sampler {name!r} is not ported yet (samplers slice); "
            f"available: {sorted(SAMPLERS)}"
        ) from None


__all__ = [
    "DDPMSchedule",
    "SAMPLERS",
    "SamplerDef",
    "add_noise",
    "ddpm_step",
    "get_sampler",
    "inference_timesteps",
    "make_alphas_cumprod",
    "make_betas",
    "make_schedule",
]
