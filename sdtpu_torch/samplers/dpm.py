"""DPM-Solver++ (2M), second-order multistep, and its SDE variant.

Counterpart of ``sdtpu/samplers/dpm.py``.  Data prediction with alpha_t =
sqrt(abar), sigma_t = sqrt(1-abar), lambda_t = ln(alpha/sigma), h_i =
lambda_{t_next} - lambda_{t_i}::

    D      = x0 + inv_2r_i * (x0 - x0_prev)          (inv_2r_0 = 0: order 1)
    x_next = c1 * x + c2 * D [+ c3 * z]

ODE: c1 = sigma_next / sigma_t, c2 = -alpha_next * expm1(-h_i).  SDE
(``sde=True``, diffusers' ``sde-dpmsolver++`` midpoint, "DPM++ 2M SDE"):
c1 = (sigma_next / sigma_t) exp(-h_i), c2 = -alpha_next expm1(-2 h_i),
c3 = sigma_next sqrt(-expm1(-2 h_i)) with fresh noise z each step.  The
final step targets t = 0 and returns the predicted x0 (``inv_2r``'s
nan_to_num zeroes the infinite-h correction).  The multistep state is the
previous step's x0.
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
    pred_x0_from_model_output,
)
from sdtpu_torch.utils.runtime import to_device


@dataclasses.dataclass(frozen=True)
class DPMSchedule:
    timesteps: torch.Tensor
    sqrt_alpha_prod: torch.Tensor            # alpha_t (S,)
    sqrt_one_minus_alpha_prod: torch.Tensor  # sigma_t (S,)
    c1: torch.Tensor
    c2: torch.Tensor
    c3: torch.Tensor                          # SDE noise coefficient; zeros for the ODE
    inv_2r: torch.Tensor                      # 1 / (2 r_i); 0 at the first step
    prediction_type: str = "epsilon"

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]


def alpha_sigma_timesteps(config: SchedulerConfig, num_inference_steps: int,
                          strength: float, karras: bool, device):
    """(alpha_t, sigma_t) float64 on the inference grid, and the timesteps
    on ``device`` (int64, or fractional float32 for Karras)."""
    if karras:
        sig_ve, tsf = karras_sigma_grid(config, num_inference_steps, strength)
        # VE sigma -> VP (alpha, sigma): alpha = 1/sqrt(s^2+1), sigma = s*alpha
        alpha = 1.0 / np.sqrt(sig_ve**2 + 1.0)
        sigma = sig_ve * alpha
        ts = to_device(np.asarray(tsf, np.float32), device)
    else:
        ac = make_alphas_cumprod(config)
        ts_i = inference_timesteps(config, num_inference_steps, strength)
        # the terminal zero-SNR abar floored (2**-24, as diffusers' Euler)
        # so that lambda stays finite
        ac_t = np.maximum(ac[ts_i], 2.0**-24)
        alpha = np.sqrt(ac_t)
        sigma = np.sqrt(1.0 - ac_t)
        ts = to_device(ts_i.astype(np.int64), device)
    return alpha, sigma, ts


def make_schedule(config: SchedulerConfig, num_inference_steps: int, strength: float = 1.0,
                  *, karras: bool = False, sde: bool = False, device="cpu") -> DPMSchedule:
    alpha, sigma, ts = alpha_sigma_timesteps(config, num_inference_steps, strength, karras,
                                             device)
    lam = np.log(alpha / sigma)
    # each step targets the next entry; the final step t = 0 (sigma -> 0,
    # lambda -> +inf), by its limits
    lam_next = np.concatenate([lam[1:], [np.inf]])
    alpha_next = np.concatenate([alpha[1:], [1.0]])
    sigma_next = np.concatenate([sigma[1:], [0.0]])
    h = lam_next - lam
    with np.errstate(over="ignore"):
        if sde:
            c1 = (sigma_next / sigma) * np.exp(-h)
            c2 = -alpha_next * np.expm1(-2.0 * h)
            c3 = sigma_next * np.sqrt(-np.expm1(-2.0 * h))
        else:
            c1 = sigma_next / sigma
            c2 = -alpha_next * np.expm1(-h)
            c3 = np.zeros_like(c2)
    # r_i = h_{i-1} / h_i; the first step has no history: order 1
    h_prev = np.concatenate([[np.nan], h[:-1]])
    with np.errstate(invalid="ignore", divide="ignore"):
        inv_2r = np.where(np.isfinite(h_prev), h / (2.0 * h_prev), 0.0)
    inv_2r[0] = 0.0
    inv_2r = np.nan_to_num(inv_2r, nan=0.0, posinf=0.0, neginf=0.0)
    return DPMSchedule(
        timesteps=ts,
        sqrt_alpha_prod=f32_table(alpha, device),
        sqrt_one_minus_alpha_prod=f32_table(sigma, device),
        c1=f32_table(c1, device),
        c2=f32_table(c2, device),
        c3=f32_table(c3, device),
        inv_2r=f32_table(inv_2r, device),
        prediction_type=config.prediction_type,
    )


def dpm_step(schedule: DPMSchedule, step_index: int, latents: torch.Tensor,
             eps_pred: torch.Tensor, noise, state: torch.Tensor):
    """-> (x_next, x0).  ``noise`` is None for the ODE, whose c3 is 0."""
    x = latents.float()
    e = eps_pred.float()
    x0 = pred_x0_from_model_output(schedule, step_index, x, e)
    # the second-order correction vanishes at the first step (inv_2r[0] == 0)
    d = x0 + schedule.inv_2r[step_index] * (x0 - state.float())
    x_next = schedule.c1[step_index] * x + schedule.c2[step_index] * d
    if noise is not None:
        x_next = x_next + schedule.c3[step_index] * noise.float()
    return x_next.to(latents.dtype), x0.to(latents.dtype)


def state_init(latents: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(latents)


def add_noise(schedule: DPMSchedule, x0, noise, step_index: int = 0):
    sa = schedule.sqrt_alpha_prod[step_index]
    sb = schedule.sqrt_one_minus_alpha_prod[step_index]
    return (sa * x0.float() + sb * noise.float()).to(x0.dtype)
