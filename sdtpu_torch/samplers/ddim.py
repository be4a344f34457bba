"""DDIM sampler, deterministic (eta = 0), on the DDPM beta schedule and
timestep spacing.

Counterpart of ``sdtpu/samplers/ddim.py``::

    x_prev = sqrt(a_prev) * x0_hat + sqrt(1 - a_prev) * eps_hat
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sdtpu_torch.config import SchedulerConfig
from sdtpu_torch.samplers.ddpm import (
    f32_table,
    inference_timesteps,
    make_alphas_cumprod,
    pred_x0_from_model_output,
)
from sdtpu_torch.utils.runtime import to_device


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    timesteps: torch.Tensor
    sqrt_alpha_prod: torch.Tensor
    sqrt_one_minus_alpha_prod: torch.Tensor
    sqrt_alpha_prod_prev: torch.Tensor
    sqrt_one_minus_alpha_prod_prev: torch.Tensor
    sigma: torch.Tensor  # zeros (eta = 0), kept for the protocol
    prediction_type: str = "epsilon"

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]


def make_schedule(config: SchedulerConfig, num_inference_steps: int, strength: float = 1.0,
                  *, device="cpu") -> DDIMSchedule:
    ac = make_alphas_cumprod(config)
    ts = inference_timesteps(config, num_inference_steps, strength)
    prev_ts = ts - config.num_train_timesteps // num_inference_steps
    a_t = ac[ts]
    a_prev = np.where(prev_ts >= 0, ac[np.maximum(prev_ts, 0)], 1.0)
    return DDIMSchedule(
        timesteps=to_device(ts.astype(np.int64), device),
        sqrt_alpha_prod=f32_table(np.sqrt(a_t), device),
        sqrt_one_minus_alpha_prod=f32_table(np.sqrt(1.0 - a_t), device),
        sqrt_alpha_prod_prev=f32_table(np.sqrt(a_prev), device),
        sqrt_one_minus_alpha_prod_prev=f32_table(np.sqrt(1.0 - a_prev), device),
        sigma=f32_table(np.zeros_like(a_t), device),
        prediction_type=config.prediction_type,
    )


def ddim_step(schedule: DDIMSchedule, step_index: int, latents: torch.Tensor,
              eps_pred: torch.Tensor, noise=None) -> torch.Tensor:
    """``noise`` is unused (eta = 0)."""
    x = latents.float()
    e = eps_pred.float()
    sa = schedule.sqrt_alpha_prod[step_index]
    sb = schedule.sqrt_one_minus_alpha_prod[step_index]
    x0_hat = pred_x0_from_model_output(schedule, step_index, x, e)
    # the direction term takes epsilon; under v: eps = sqrt(a) v + sqrt(1-a) x
    if schedule.prediction_type == "v_prediction":
        e = sa * e + sb * x
    x_prev = (schedule.sqrt_alpha_prod_prev[step_index] * x0_hat
              + schedule.sqrt_one_minus_alpha_prod_prev[step_index] * e)
    return x_prev.to(latents.dtype)


def add_noise(schedule: DDIMSchedule, x0, noise, step_index: int = 0):
    sa = schedule.sqrt_alpha_prod[step_index]
    sb = schedule.sqrt_one_minus_alpha_prod[step_index]
    return (sa * x0.float() + sb * noise.float()).to(x0.dtype)
