"""UniPC (order 2, B(h) = expm1(h), "bh2"), a predictor-corrector
multistep solver.

Counterpart of ``sdtpu/samplers/unipc.py`` (diffusers'
``UniPCMultistepScheduler`` with ``solver_order=2, solver_type="bh2",
predict_x0=True, lower_order_final=True``).  Every coefficient depends only
on the sigma grid and is precomputed on the host; a step is a few
multiply-adds::

    x^c    = cc1 x_{i-1} + cc2 m_prev + cc3 (m_prev2 - m_prev) + cc4 (m0 - m_prev)
    x^c    = corr_on x^c + (1 - corr_on) x                 (the corrector, i >= 1)
    x_next = pc1 x^c + pc2 m0 + pd (m_prev - m0)            (the predictor)

The state is (m_prev, m_prev2, last_sample): the two previous x0
predictions and the previous corrected sample.  The ``corr_on`` blend keeps
the zero state at i = 0 from leaking a NaN.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sdtpu_torch.config import SchedulerConfig
from sdtpu_torch.samplers.ddpm import f32_table, pred_x0_from_model_output
from sdtpu_torch.samplers.dpm import alpha_sigma_timesteps


@dataclasses.dataclass(frozen=True)
class UniPCSchedule:
    timesteps: torch.Tensor
    sqrt_alpha_prod: torch.Tensor            # alpha_t (S,)
    sqrt_one_minus_alpha_prod: torch.Tensor  # sigma_t (S,)
    pc1: torch.Tensor
    pc2: torch.Tensor
    pd: torch.Tensor                          # 0 where the predictor is order 1
    cc1: torch.Tensor
    cc2: torch.Tensor
    cc3: torch.Tensor
    cc4: torch.Tensor
    corr_on: torch.Tensor                     # 1.0 where the corrector runs
    prediction_type: str = "epsilon"

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]


def _phi_b(h):
    """(phi1, B, b1, b2) for one transition of log-SNR length h > 0, with
    hh = -h and B(h) = expm1(hh) ("bh2")."""
    hh = -h
    phi1 = np.expm1(hh)
    b = phi1
    b1 = (phi1 / hh - 1.0) / b
    b2 = ((phi1 / hh - 1.0) / hh - 0.5) * 2.0 / b
    return phi1, b, b1, b2


def make_schedule(config: SchedulerConfig, num_inference_steps: int, strength: float = 1.0,
                  *, karras: bool = False, device="cpu") -> UniPCSchedule:
    alpha, sigma, ts = alpha_sigma_timesteps(config, num_inference_steps, strength, karras,
                                             device)
    n = alpha.shape[0]
    lam = np.log(alpha / sigma)
    alpha_next = np.concatenate([alpha[1:], [1.0]])
    sigma_next = np.concatenate([sigma[1:], [0.0]])
    lam_next = np.concatenate([lam[1:], [np.inf]])
    h = lam_next - lam  # inf at the final step

    pc1, pc2, pd = np.zeros(n), np.zeros(n), np.zeros(n)
    cc1, cc2, cc3, cc4 = np.zeros(n), np.zeros(n), np.zeros(n), np.zeros(n)
    corr_on = np.zeros(n)
    for i in range(n):
        # the predictor over t_i -> t_{i+1}
        p_ord = min(2, i + 1, n - i)  # warm-up and lower_order_final
        if np.isinf(h[i]):  # the final step: sigma_next = 0 -> x0_hat
            pc1[i], pc2[i] = 0.0, 1.0
        else:
            phi1, b, _, _ = _phi_b(h[i])
            pc1[i] = sigma_next[i] / sigma[i]
            pc2[i] = -alpha_next[i] * phi1
            if p_ord == 2:
                r1 = (lam[i - 1] - lam[i]) / h[i]
                pd[i] = -alpha_next[i] * b * 0.5 / r1
        # the corrector over t_{i-1} -> t_i
        if i >= 1:
            c_ord = min(2, i, n - i + 1)
            h_c = lam[i] - lam[i - 1]
            phi1c, bc, b1, b2 = _phi_b(h_c)
            corr_on[i] = 1.0
            cc1[i] = sigma[i] / sigma[i - 1]
            cc2[i] = -alpha[i] * phi1c
            if c_ord == 1:
                cc4[i] = -alpha[i] * bc * 0.5
            else:
                r1c = (lam[i - 2] - lam[i - 1]) / h_c
                rho0 = (b1 - b2) / (1.0 - r1c)
                rho_last = b1 - rho0
                cc3[i] = -alpha[i] * bc * rho0 / r1c
                cc4[i] = -alpha[i] * bc * rho_last

    return UniPCSchedule(
        timesteps=ts,
        sqrt_alpha_prod=f32_table(alpha, device),
        sqrt_one_minus_alpha_prod=f32_table(sigma, device),
        pc1=f32_table(pc1, device),
        pc2=f32_table(pc2, device),
        pd=f32_table(pd, device),
        cc1=f32_table(cc1, device),
        cc2=f32_table(cc2, device),
        cc3=f32_table(cc3, device),
        cc4=f32_table(cc4, device),
        corr_on=f32_table(corr_on, device),
        prediction_type=config.prediction_type,
    )


def unipc_step(schedule: UniPCSchedule, step_index: int, latents: torch.Tensor,
               eps_pred: torch.Tensor, noise, state):
    """-> (x_next, (m0, m_prev, x^c)).  ``noise`` is unused (an ODE)."""
    m_prev, m_prev2, last_sample = (s.float() for s in state)
    i = step_index
    x = latents.float()
    e = eps_pred.float()
    m0 = pred_x0_from_model_output(schedule, i, x, e)
    xc = (schedule.cc1[i] * last_sample
          + schedule.cc2[i] * m_prev
          + schedule.cc3[i] * (m_prev2 - m_prev)
          + schedule.cc4[i] * (m0 - m_prev))
    xc = schedule.corr_on[i] * xc + (1.0 - schedule.corr_on[i]) * x
    x_next = schedule.pc1[i] * xc + schedule.pc2[i] * m0 + schedule.pd[i] * (m_prev - m0)
    dt = latents.dtype
    return x_next.to(dt), (m0.to(dt), m_prev.to(dt), xc.to(dt))


def state_init(latents: torch.Tensor):
    z = torch.zeros_like(latents)
    return (z, z, z)


def add_noise(schedule: UniPCSchedule, x0, noise, step_index: int = 0):
    sa = schedule.sqrt_alpha_prod[step_index]
    sb = schedule.sqrt_one_minus_alpha_prod[step_index]
    return (sa * x0.float() + sb * noise.float()).to(x0.dtype)
