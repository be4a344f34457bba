"""DDIM with eta = 0 (Song et al. 2021; diffusers ``DDIMScheduler``):
scaled-linear betas, "leading" spacing with ``steps_offset``, img2img
truncation by strength, and no noise after the start, for both training
objectives.  Under ``prediction_type`` "epsilon" the model gives eps and
x0 = (x - sqrt(1 - a) eps) / sqrt(a); under "v_prediction" it gives v, and
x0 = sqrt(a) x - sqrt(1 - a) v, eps = sqrt(a) v + sqrt(1 - a) x.  A step
is x_prev = sqrt(a_prev) x0 + sqrt(1 - a_prev) eps.

Departure from the published scheduler: the last step's a_prev is 1 (the
step lands on x0), where diffusers with ``set_alpha_to_one: false`` takes
alphas_cumprod[0] (0.99915 for SD 2.1).  The served program does the same;
the configuration lists it under ``assumed``.

The module interface is ``ddpm.py``'s; ``step`` takes the per-step noise
and ignores it.
"""

from __future__ import annotations

import numpy as np


def tables(sched: dict, steps: int, strength: float = 1.0) -> dict:
    """Per-step tables in float64 on the host, held as float32."""
    n_train = sched["num_train_timesteps"]
    if sched["beta_schedule"] != "scaled_linear" or sched["timestep_spacing"] != "leading":
        raise ValueError("the reference covers scaled-linear betas with leading spacing")
    if sched["prediction_type"] not in ("epsilon", "v_prediction"):
        raise ValueError(f"no DDIM step for prediction_type {sched['prediction_type']!r}")
    betas = np.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5, n_train,
                        dtype=np.float64) ** 2
    ac = np.cumprod(1.0 - betas)
    ts = (np.arange(steps)[::-1] * (n_train // steps)).astype(np.int64) + sched["steps_offset"]
    ts = ts[min(max(steps - int(steps * strength), 0), steps - 1):]
    prev = ts - n_train // steps
    a_t = ac[ts]
    a_prev = np.where(prev >= 0, ac[np.maximum(prev, 0)], 1.0)
    f32 = lambda a: [float(v) for v in np.asarray(a, np.float32)]  # noqa: E731
    return {"timesteps": [int(t) for t in ts], "v": sched["prediction_type"] == "v_prediction",
            "sa": f32(np.sqrt(a_t)), "sb": f32(np.sqrt(1.0 - a_t)),
            "sa_prev": f32(np.sqrt(a_prev)), "sb_prev": f32(np.sqrt(1.0 - a_prev))}


def initial(tab: dict, noise):
    return noise


def noised(tab: dict, lat0, noise):
    return tab["sa"][0] * lat0 + tab["sb"][0] * noise


def model_input(tab: dict, i: int, lat):
    return lat


def step(tab: dict, i: int, lat, out, noise=None):
    sa, sb = tab["sa"][i], tab["sb"][i]
    if tab["v"]:
        x0, eps = sa * lat - sb * out, sa * out + sb * lat
    else:
        x0, eps = (lat - sb * out) / sa, out
    return tab["sa_prev"][i] * x0 + tab["sb_prev"][i] * eps
