"""DDPM sampler.

Counterpart of ``sdtpu/samplers/ddpm.py``: the schedule tables are built
with numpy in float64 exactly as the JAX package builds them, then held as
float32 tensors, copied to the device without a host sync;
``ddpm_step`` takes its noise as an argument.  The sigma-space helpers the
other samplers share live here too, as there: ``ve_sigmas``,
``karras_sigma_grid`` and ``f32_table``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sdtpu_torch.config import SchedulerConfig
from sdtpu_torch.utils.runtime import to_device


def make_betas(config: SchedulerConfig) -> np.ndarray:
    if config.beta_schedule == "scaled_linear":
        betas = np.linspace(config.beta_start**0.5, config.beta_end**0.5,
                            config.num_train_timesteps, dtype=np.float64) ** 2
    elif config.beta_schedule == "linear":
        betas = np.linspace(config.beta_start, config.beta_end,
                            config.num_train_timesteps, dtype=np.float64)
    else:
        raise ValueError(f"unknown beta schedule {config.beta_schedule!r}")
    if config.rescale_betas_zero_snr:
        betas = rescale_zero_terminal_snr(betas)
    return betas


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Shift and scale sqrt(alpha_bar) so the last training step has zero
    SNR (Lin et al. 2023, alg. 1)."""
    abar_sqrt = np.sqrt(np.cumprod(1.0 - betas))
    a0, a_t = abar_sqrt[0], abar_sqrt[-1]
    abar_sqrt = (abar_sqrt - a_t) * (a0 / (a0 - a_t))
    abar = abar_sqrt**2
    alphas = np.concatenate([abar[:1], abar[1:] / abar[:-1]])
    return 1.0 - alphas


def make_alphas_cumprod(config: SchedulerConfig) -> np.ndarray:
    return np.cumprod(1.0 - make_betas(config))


def ve_sigmas(alphas_cumprod: np.ndarray) -> np.ndarray:
    """alpha_bar -> VE sigma = sqrt((1-abar)/abar), the terminal zero-SNR
    entry (abar == 0) floored at 2**-24 as diffusers' Euler scheduler does,
    so that sigma-space samplers get a finite sigma_max."""
    ac = np.maximum(alphas_cumprod, 2.0**-24)
    return np.sqrt((1.0 - ac) / ac)


def inference_timesteps(
    config: SchedulerConfig, num_inference_steps: int, strength: float = 1.0
) -> np.ndarray:
    """Descending timesteps ("leading", "trailing" or "linspace" spacing),
    truncated for img2img strength."""
    n = num_inference_steps
    big_n = config.num_train_timesteps
    if config.timestep_spacing == "trailing":
        ts = np.round(np.arange(big_n, 0, -big_n / n)).astype(np.int64) - 1
    elif config.timestep_spacing == "linspace":
        ts = np.linspace(0, big_n - 1, n).round().astype(np.int64)[::-1]
    elif config.timestep_spacing == "leading":
        ts = (np.arange(n)[::-1] * (big_n // n)).round().astype(np.int64)
        ts += config.steps_offset
    else:
        raise ValueError(f"unknown timestep_spacing {config.timestep_spacing!r}")
    start = min(max(n - int(n * strength), 0), n - 1)
    return ts[start:]


def karras_sigma_grid(
    config: SchedulerConfig, num_inference_steps: int, strength: float = 1.0,
    rho: float = 7.0,
):
    """Karras et al. (2022) rho-7 sigma spacing over the (strength-
    truncated) inference window, VE convention.  Returns (sigmas,
    timesteps): descending (S,) float64 arrays; the timesteps are
    fractional (log-sigma interpolation against the training grid, as
    diffusers' ``use_karras_sigmas=True``)."""
    ac = make_alphas_cumprod(config)
    full = ve_sigmas(ac)
    ts = inference_timesteps(config, num_inference_steps, strength)
    smax, smin = full[ts[0]], full[ts[-1]]
    ramp = np.linspace(0.0, 1.0, len(ts))
    inv = 1.0 / rho
    sig = (smax**inv + ramp * (smin**inv - smax**inv)) ** rho
    t = np.interp(np.log(sig), np.log(full), np.arange(len(full)))
    return sig, t


def f32_table(a, device) -> torch.Tensor:
    """A float64 host table -> float32 on ``device``, cast once on the host
    and copied without a host sync."""
    return to_device(np.asarray(a, np.float32), device)


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    """Per-inference-step coefficients, each (S,) float32 (timesteps int64)."""

    timesteps: torch.Tensor
    coeff_x0: torch.Tensor
    coeff_xt: torch.Tensor
    sqrt_alpha_prod: torch.Tensor
    sqrt_one_minus_alpha_prod: torch.Tensor
    sigma: torch.Tensor
    prediction_type: str = "epsilon"

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]


def make_schedule(
    config: SchedulerConfig, num_inference_steps: int, strength: float = 1.0,
    *, device="cpu",
) -> DDPMSchedule:
    alphas_cumprod = make_alphas_cumprod(config)
    ts = inference_timesteps(config, num_inference_steps, strength)
    prev_ts = ts - config.num_train_timesteps // num_inference_steps
    alpha_prod_t = alphas_cumprod[ts]
    alpha_prod_prev = np.where(prev_ts >= 0, alphas_cumprod[np.maximum(prev_ts, 0)], 1.0)
    current_alpha = alpha_prod_t / alpha_prod_prev
    current_beta = 1.0 - current_alpha
    beta_prod_t = 1.0 - alpha_prod_t
    coeff_x0 = np.sqrt(alpha_prod_prev) * current_beta / beta_prod_t
    coeff_xt = np.sqrt(current_alpha) * (1.0 - alpha_prod_prev) / beta_prod_t
    variance = np.clip((1.0 - alpha_prod_prev) / beta_prod_t * current_beta, 1e-20, None)
    sigma = np.where(ts > 0, np.sqrt(variance), 0.0)

    def f32(a):
        return f32_table(a, device)

    return DDPMSchedule(
        timesteps=to_device(ts.astype(np.int64), device),
        coeff_x0=f32(coeff_x0),
        coeff_xt=f32(coeff_xt),
        sqrt_alpha_prod=f32(np.sqrt(alpha_prod_t)),
        sqrt_one_minus_alpha_prod=f32(np.sqrt(beta_prod_t)),
        sigma=f32(sigma),
        prediction_type=config.prediction_type,
    )


def pred_x0_from_model_output(schedule, step_index, latents_f32, model_out_f32):
    """x0 from the model output: epsilon or v parameterization."""
    sa = schedule.sqrt_alpha_prod[step_index]
    sb = schedule.sqrt_one_minus_alpha_prod[step_index]
    if schedule.prediction_type == "v_prediction":
        return sa * latents_f32 - sb * model_out_f32
    return (latents_f32 - sb * model_out_f32) / sa


def ddpm_step(
    schedule: DDPMSchedule, step_index: int, latents: torch.Tensor,
    eps_pred: torch.Tensor, noise: torch.Tensor,
) -> torch.Tensor:
    """x_prev = c0 * x0_hat + c1 * x + sigma * z, in float32, cast back to
    the latents' dtype."""
    x = latents.float()
    x0_hat = pred_x0_from_model_output(schedule, step_index, x, eps_pred.float())
    x_prev = schedule.coeff_x0[step_index] * x0_hat + schedule.coeff_xt[step_index] * x
    x_prev = x_prev + schedule.sigma[step_index] * noise.float()
    return x_prev.to(latents.dtype)


def add_noise(
    schedule: DDPMSchedule, x0: torch.Tensor, noise: torch.Tensor, step_index: int = 0
) -> torch.Tensor:
    """sqrt(a) * x0 + sqrt(1 - a) * z at the schedule's ``step_index``."""
    sa = schedule.sqrt_alpha_prod[step_index]
    sb = schedule.sqrt_one_minus_alpha_prod[step_index]
    return (sa * x0.float() + sb * noise.float()).to(x0.dtype)
