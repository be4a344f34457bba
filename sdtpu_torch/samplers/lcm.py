"""LCM (Latent Consistency Model) sampler, 1-8 distilled steps.

Counterpart of ``sdtpu/samplers/lcm.py`` (sigma_data 0.5, timestep
scaling 10)::

    x0_hat   = (x - sqrt(1-a_t) eps) / sqrt(a_t)
    denoised = c_out(t) * x0_hat + c_skip(t) * x
    x_prev   = sqrt(a_prev) * denoised + sqrt(1-a_prev) * z   (no z on the last step)

The timesteps follow the distillation ladder: ``origin_steps`` (50) evenly
spaced training timesteps, subsampled to ``num_inference_steps``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sdtpu_torch.config import SchedulerConfig
from sdtpu_torch.samplers.ddpm import f32_table, make_alphas_cumprod, pred_x0_from_model_output
from sdtpu_torch.utils.runtime import to_device

SIGMA_DATA = 0.5
TIMESTEP_SCALING = 10.0


@dataclasses.dataclass(frozen=True)
class LCMSchedule:
    timesteps: torch.Tensor
    sqrt_alpha_prod: torch.Tensor
    sqrt_one_minus_alpha_prod: torch.Tensor
    sqrt_alpha_prod_prev: torch.Tensor
    sqrt_one_minus_alpha_prod_prev: torch.Tensor
    c_skip: torch.Tensor
    c_out: torch.Tensor
    noise_mask: torch.Tensor  # 1.0 except the final step
    prediction_type: str = "epsilon"

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]


def make_schedule(config: SchedulerConfig, num_inference_steps: int, strength: float = 1.0,
                  *, origin_steps: int = 50, device="cpu") -> LCMSchedule:
    ac = make_alphas_cumprod(config)
    k = config.num_train_timesteps // origin_steps
    ladder = np.arange(1, origin_steps + 1) * k - 1  # ascending
    skip = max(len(ladder) // num_inference_steps, 1)
    ts = ladder[::-1][::skip][:num_inference_steps]
    start = min(max(len(ts) - int(len(ts) * strength), 0), len(ts) - 1)
    ts = ts[start:]

    prev = np.concatenate([ts[1:], [0]])  # the next (lower) timestep; 0 at the end
    a_t, a_prev = ac[ts], ac[prev]
    scaled = ts.astype(np.float64) * TIMESTEP_SCALING
    c_skip = SIGMA_DATA**2 / (scaled**2 + SIGMA_DATA**2)
    c_out = scaled / np.sqrt(scaled**2 + SIGMA_DATA**2)
    noise_mask = np.ones(len(ts))
    noise_mask[-1] = 0.0
    return LCMSchedule(
        timesteps=to_device(ts.astype(np.int64), device),
        sqrt_alpha_prod=f32_table(np.sqrt(a_t), device),
        sqrt_one_minus_alpha_prod=f32_table(np.sqrt(1 - a_t), device),
        sqrt_alpha_prod_prev=f32_table(np.sqrt(a_prev), device),
        sqrt_one_minus_alpha_prod_prev=f32_table(np.sqrt(1 - a_prev), device),
        c_skip=f32_table(c_skip, device),
        c_out=f32_table(c_out, device),
        noise_mask=f32_table(noise_mask, device),
        prediction_type=config.prediction_type,
    )


def lcm_step(schedule: LCMSchedule, step_index: int, latents: torch.Tensor,
             eps_pred: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    x = latents.float()
    e = eps_pred.float()
    x0_hat = pred_x0_from_model_output(schedule, step_index, x, e)
    denoised = schedule.c_out[step_index] * x0_hat + schedule.c_skip[step_index] * x
    mask = schedule.noise_mask[step_index]
    x_prev = (schedule.sqrt_alpha_prod_prev[step_index] * denoised
              + schedule.sqrt_one_minus_alpha_prod_prev[step_index] * noise.float())
    return (mask * x_prev + (1.0 - mask) * denoised).to(latents.dtype)


def add_noise(schedule: LCMSchedule, x0, noise, step_index: int = 0):
    sa = schedule.sqrt_alpha_prod[step_index]
    sb = schedule.sqrt_one_minus_alpha_prod[step_index]
    return (sa * x0.float() + sb * noise.float()).to(x0.dtype)
