"""Euler discrete sampler (sigma space) and its ancestral variant.

Counterpart of ``sdtpu/samplers/euler.py``: sigma_t = sqrt((1 - a_t) /
a_t); the model input is scaled by 1/sqrt(sigma^2 + 1); one Euler step
along d = (x - x0) / sigma: x_prev = x + (sigma_next - sigma) * d.  The
latents start at noise * ``init_sigma`` (sigma_max).  ``karras=True``
takes the Karras rho-7 sigma grid with fractional float32 timesteps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sdtpu_torch.config import SchedulerConfig
from sdtpu_torch.samplers.ddpm import (
    f32_table,
    inference_timesteps,
    karras_sigma_grid,
    make_alphas_cumprod,
    ve_sigmas,
)
from sdtpu_torch.utils.runtime import to_device


@dataclasses.dataclass(frozen=True)
class EulerSchedule:
    timesteps: torch.Tensor
    sigmas: torch.Tensor       # (S+1,), ends with 0
    input_scale: torch.Tensor  # (S,): 1/sqrt(sigma^2+1)
    init_sigma: float
    prediction_type: str = "epsilon"

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]

    # the DDPM/DDIM field names, for the protocol
    @property
    def sqrt_alpha_prod(self):
        s = self.sigmas[:-1]
        return 1.0 / torch.sqrt(s**2 + 1.0)

    @property
    def sqrt_one_minus_alpha_prod(self):
        s = self.sigmas[:-1]
        return s / torch.sqrt(s**2 + 1.0)


def make_schedule(config: SchedulerConfig, num_inference_steps: int, strength: float = 1.0,
                  *, karras: bool = False, device="cpu") -> EulerSchedule:
    if karras:
        sig, tsf = karras_sigma_grid(config, num_inference_steps, strength)
        ts = to_device(np.asarray(tsf, np.float32), device)  # fractional timesteps
    else:
        ac = make_alphas_cumprod(config)
        ts_i = inference_timesteps(config, num_inference_steps, strength)
        sig = ve_sigmas(ac[ts_i])  # the terminal zero-SNR entry floored finite
        ts = to_device(ts_i.astype(np.int64), device)
    sigmas = np.concatenate([sig, [0.0]])
    return EulerSchedule(
        timesteps=ts,
        sigmas=f32_table(sigmas, device),
        input_scale=f32_table(1.0 / np.sqrt(sig**2 + 1.0), device),
        init_sigma=float(sig[0]),
        prediction_type=config.prediction_type,
    )


def scale_model_input(schedule: EulerSchedule, step_index: int, x: torch.Tensor):
    return x * schedule.input_scale[step_index].to(x.dtype)


def _derivative(schedule: EulerSchedule, sigma, x, e):
    """d = (x - x0) / sigma for the schedule's prediction type."""
    if schedule.prediction_type == "v_prediction":
        # x is the unscaled sample (x = x0 + sigma * eps); the model saw
        # x / sqrt(sigma^2 + 1): x0 = -sigma/sqrt(sigma^2+1) v + x/(sigma^2+1)
        x0 = -sigma / torch.sqrt(sigma**2 + 1.0) * e + x / (sigma**2 + 1.0)
        return (x - x0) / sigma
    return e  # epsilon: x0 = x - sigma * eps


def euler_step(schedule: EulerSchedule, step_index: int, latents: torch.Tensor,
               eps_pred: torch.Tensor, noise=None) -> torch.Tensor:
    """``noise`` is unused."""
    x = latents.float()
    e = eps_pred.float()
    sigma = schedule.sigmas[step_index]
    sigma_next = schedule.sigmas[step_index + 1]
    d = _derivative(schedule, sigma, x, e)
    return (x + (sigma_next - sigma) * d).to(latents.dtype)


def euler_ancestral_step(schedule: EulerSchedule, step_index: int, latents: torch.Tensor,
                         eps_pred: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Euler-ancestral (diffusers' ``EulerAncestralDiscreteScheduler``): the
    Euler move goes to sigma_down and the variance sigma_up returns as
    fresh noise, sigma_up^2 = sigma_next^2 (sigma^2 - sigma_next^2) /
    sigma^2, sigma_down^2 = sigma_next^2 - sigma_up^2."""
    x = latents.float()
    e = eps_pred.float()
    sigma = schedule.sigmas[step_index]
    sigma_next = schedule.sigmas[step_index + 1]
    d = _derivative(schedule, sigma, x, e)
    up2 = torch.clamp(sigma_next**2 * (sigma**2 - sigma_next**2) / sigma**2, min=0.0)
    sigma_up = torch.sqrt(up2)
    sigma_down = torch.sqrt(torch.clamp(sigma_next**2 - up2, min=0.0))
    x_prev = x + (sigma_down - sigma) * d + sigma_up * noise.float()
    return x_prev.to(latents.dtype)


def add_noise(schedule: EulerSchedule, x0, noise, step_index: int = 0):
    sigma = schedule.sigmas[step_index]
    return (x0.float() + sigma * noise.float()).to(x0.dtype)
