"""DDPM (Ho et al. 2020; diffusers ``DDPMScheduler``): scaled-linear betas,
"leading" spacing, img2img truncation by strength, and one noise draw a
step.

A sampler's module (``sdbench/reference/samplers/<name>.py``, found by the
configuration's ``sampler``) supplies ``tables(sched, steps, strength)``
(its per-step tables, with the UNet's ``timesteps``), ``initial(tab,
noise)`` (the text-to-image start), ``noised(tab, lat0, noise)`` (the
image-to-image start from the encoded image), ``model_input(tab, i,
lat)`` and ``step(tab, i, lat, eps, noise)``.
"""

from __future__ import annotations

import numpy as np


def tables(sched: dict, steps: int, strength: float = 1.0) -> dict:
    """Per-step tables in float64 on the host, held as float32."""
    n_train = sched["num_train_timesteps"]
    if sched["beta_schedule"] != "scaled_linear" or sched["timestep_spacing"] != "leading":
        raise ValueError("the reference covers scaled-linear betas with leading spacing")
    betas = np.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5, n_train,
                        dtype=np.float64) ** 2
    ac = np.cumprod(1.0 - betas)
    ts = (np.arange(steps)[::-1] * (n_train // steps)).astype(np.int64) + sched["steps_offset"]
    ts = ts[min(max(steps - int(steps * strength), 0), steps - 1):]
    prev = ts - n_train // steps
    a_t = ac[ts]
    a_prev = np.where(prev >= 0, ac[np.maximum(prev, 0)], 1.0)
    cur_beta = 1.0 - a_t / a_prev
    b_t = 1.0 - a_t
    var = np.clip((1.0 - a_prev) / b_t * cur_beta, 1e-20, None)
    f32 = lambda a: [float(v) for v in np.asarray(a, np.float32)]  # noqa: E731
    return {"timesteps": [int(t) for t in ts],
            "c0": f32(np.sqrt(a_prev) * cur_beta / b_t),
            "ct": f32(np.sqrt(a_t / a_prev) * (1.0 - a_prev) / b_t),
            "sa": f32(np.sqrt(a_t)), "sb": f32(np.sqrt(b_t)),
            "sigma": f32(np.where(ts > 0, np.sqrt(var), 0.0))}


def initial(tab: dict, noise):
    return noise


def noised(tab: dict, lat0, noise):
    return tab["sa"][0] * lat0 + tab["sb"][0] * noise


def model_input(tab: dict, i: int, lat):
    return lat


def step(tab: dict, i: int, lat, eps, noise):
    x0 = (lat - tab["sb"][i] * eps) / tab["sa"][i]
    return tab["c0"][i] * x0 + tab["ct"][i] * lat + tab["sigma"][i] * noise
