"""Samplers.  Every sampler shares one protocol: ``make_schedule(config,
steps, strength, device=)`` returns per-step tables on ``device``;
``step(schedule, i, latents, eps, noise)`` is pure (a multistep sampler
takes and returns its ``state`` too); ``add_noise`` forward-noises for
img2img; ``scale_model_input`` and ``schedule.init_sigma`` cover the
sigma-space samplers (Euler).

Counterpart of ``sdtpu/samplers/__init__.py``, with the same 13 names.
"""

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from sdtpu_torch.samplers import ddim as _ddim
from sdtpu_torch.samplers import dpm as _dpm
from sdtpu_torch.samplers import euler as _euler
from sdtpu_torch.samplers import lcm as _lcm
from sdtpu_torch.samplers import unipc as _unipc
from sdtpu_torch.samplers.ddpm import (
    DDPMSchedule,
    add_noise,
    ddpm_step,
    inference_timesteps,
    karras_sigma_grid,
    make_alphas_cumprod,
    make_betas,
    make_schedule,
    ve_sigmas,
)


@dataclasses.dataclass(frozen=True)
class SamplerDef:
    make_schedule: Callable
    step: Callable
    add_noise: Callable
    scale_model_input: Optional[Callable] = None
    stochastic: bool = False  # draws per-step variance noise
    # multistep solvers carry a state through the loop:
    # step(schedule, i, lat, eps, noise, state) -> (lat, state)
    multistep: bool = False
    state_init: Optional[Callable] = None


SAMPLERS = {
    "ddpm": SamplerDef(make_schedule, ddpm_step, add_noise, stochastic=True),
    "ddim": SamplerDef(_ddim.make_schedule, _ddim.ddim_step, _ddim.add_noise),
    "euler": SamplerDef(_euler.make_schedule, _euler.euler_step, _euler.add_noise,
                        scale_model_input=_euler.scale_model_input),
    "lcm": SamplerDef(_lcm.make_schedule, _lcm.lcm_step, _lcm.add_noise, stochastic=True),
    "dpm++": SamplerDef(_dpm.make_schedule, _dpm.dpm_step, _dpm.add_noise,
                        multistep=True, state_init=_dpm.state_init),
    # ancestral: the Euler move to sigma_down plus fresh noise sigma_up
    "euler-a": SamplerDef(_euler.make_schedule, _euler.euler_ancestral_step,
                          _euler.add_noise, scale_model_input=_euler.scale_model_input,
                          stochastic=True),
    # Karras rho-7 sigma spacing (fractional timesteps)
    "euler-karras": SamplerDef(functools.partial(_euler.make_schedule, karras=True),
                               _euler.euler_step, _euler.add_noise,
                               scale_model_input=_euler.scale_model_input),
    "dpm++-karras": SamplerDef(functools.partial(_dpm.make_schedule, karras=True),
                               _dpm.dpm_step, _dpm.add_noise, multistep=True,
                               state_init=_dpm.state_init),
    # "DPM++ 2M SDE": the midpoint correction, reverse-SDE integration with
    # fresh noise each step
    "dpm++-sde": SamplerDef(functools.partial(_dpm.make_schedule, sde=True), _dpm.dpm_step,
                            _dpm.add_noise, multistep=True, state_init=_dpm.state_init,
                            stochastic=True),
    "dpm++-sde-karras": SamplerDef(functools.partial(_dpm.make_schedule, karras=True, sde=True),
                                   _dpm.dpm_step, _dpm.add_noise, multistep=True,
                                   state_init=_dpm.state_init, stochastic=True),
    # UniPC bh2, order 2 (diffusers' UniPCMultistepScheduler defaults)
    "unipc": SamplerDef(_unipc.make_schedule, _unipc.unipc_step, _unipc.add_noise,
                        multistep=True, state_init=_unipc.state_init),
    "unipc-karras": SamplerDef(functools.partial(_unipc.make_schedule, karras=True),
                               _unipc.unipc_step, _unipc.add_noise, multistep=True,
                               state_init=_unipc.state_init),
    "euler-a-karras": SamplerDef(functools.partial(_euler.make_schedule, karras=True),
                                 _euler.euler_ancestral_step, _euler.add_noise,
                                 scale_model_input=_euler.scale_model_input, stochastic=True),
}


def _set0(t: torch.Tensor, i: int, value: float) -> torch.Tensor:
    t = t.clone()
    t[i] = value
    return t


def slice_schedule(schedule, *, num_train_timesteps: int,
                   denoising_end: Optional[float] = None,
                   denoising_start: Optional[float] = None):
    """Split a schedule at a denoising fraction, the SDXL base -> refiner
    handoff (diffusers' ``denoising_end``/``denoising_start``: the cutoff is
    ``round(N - frac * N)`` in training timesteps; the base keeps t >=
    cutoff, the refiner t < cutoff).  Every (S,) field is sliced, (S+1,)
    fields (Euler's sigmas) keep the boundary entry.  A start-slice cold-
    starts the multistep solvers: DPM++'s first ``inv_2r`` and UniPC's first
    corrector and second-order predictor term are zeroed, and UniPC's step-1
    corrector demoted to order 1.  Reads the timesteps on the host."""
    ts = schedule.timesteps.cpu().numpy()
    n = int(ts.shape[0])
    if (denoising_end is None) == (denoising_start is None):
        raise ValueError("pass exactly one of denoising_end/denoising_start")
    frac = denoising_end if denoising_end is not None else denoising_start
    if not 0.0 < frac < 1.0:
        raise ValueError("denoising fraction must be in (0, 1)")
    cutoff = round(num_train_timesteps - frac * num_train_timesteps)
    if denoising_end is not None:
        k = int((ts >= cutoff).sum())  # the high-noise head
        if not 0 < k <= n:
            raise ValueError(f"denoising_end={frac} leaves no steps to run")
        sl, sl1 = slice(0, k), slice(0, k + 1)
    else:
        k = int((ts < cutoff).sum())  # the low-noise tail
        if not 0 < k <= n:
            raise ValueError(f"denoising_start={frac} leaves no steps to run")
        sl, sl1 = slice(n - k, n), slice(n - k, n + 1)
    upd = {}
    for f in dataclasses.fields(schedule):
        v = getattr(schedule, f.name)
        if isinstance(v, torch.Tensor) and v.ndim >= 1:
            if v.shape[0] == n:
                upd[f.name] = v[sl]
            elif v.shape[0] == n + 1:
                upd[f.name] = v[sl1]
    out = dataclasses.replace(schedule, **upd)
    if denoising_start is not None and hasattr(out, "inv_2r"):
        out = dataclasses.replace(out, inv_2r=_set0(out.inv_2r, 0, 0.0))
    if denoising_start is not None and hasattr(out, "corr_on"):
        out = dataclasses.replace(out, corr_on=_set0(out.corr_on, 0, 0.0),
                                  pd=_set0(out.pd, 0, 0.0))
        if out.num_steps >= 2:
            # step 1's corrector would reach the pre-handoff m_prev2 (zeros)
            # through cc3: the order-1 corrector instead
            sa = out.sqrt_alpha_prod.cpu().numpy().astype(np.float64)
            sb = out.sqrt_one_minus_alpha_prod.cpu().numpy().astype(np.float64)
            lam = np.log(sa / sb)
            phi1 = np.expm1(-(lam[1] - lam[0]))
            a1 = float(out.sqrt_alpha_prod.cpu().numpy()[1])
            out = dataclasses.replace(out, cc3=_set0(out.cc3, 1, 0.0),
                                      cc4=_set0(out.cc4, 1, -a1 * float(phi1) * 0.5))
    return out


def get_sampler(name: str) -> SamplerDef:
    try:
        return SAMPLERS[name]
    except KeyError:
        raise ValueError(f"unknown sampler {name!r}; available: {sorted(SAMPLERS)}") from None


__all__ = [
    "DDPMSchedule",
    "SAMPLERS",
    "SamplerDef",
    "add_noise",
    "ddpm_step",
    "get_sampler",
    "inference_timesteps",
    "karras_sigma_grid",
    "make_alphas_cumprod",
    "make_betas",
    "make_schedule",
    "slice_schedule",
    "ve_sigmas",
]
