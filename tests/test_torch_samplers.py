"""The port's samplers against the JAX package's, on the CPU.

Schedules: every field of each of the 13 samplers' ``make_schedule`` equals
the JAX package's as float32 (within 1 ulp; both cast the same float64
tables), over timestep spacing x zero-SNR x prediction type (Karras through
the ``-karras`` names); ``slice_schedule`` likewise.  Steps: each sampler's
``step`` on seeded inputs within 1e-6 of the JAX step, over a 5-step chain
that carries the multistep state.  The pipeline: ``generate(sampler=...)``
at the TINY config within one uint8 level of the JAX package's image from
the same seed, ``rng="torch"`` and injected latents (scaled by
``init_sigma``) likewise.  On a card (``gpu`` mark): each step on the card
within 1e-6 of the CPU step.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdtpu.samplers as jsamplers
import sdtpu_torch.samplers as tsamplers
from conftest import assert_images_match
from sdtpu_torch import StableDiffusionPipeline
from test_pipeline import TINY, TOKENS
from test_torch_ops import port_config

torch.set_num_threads(1)

NAMES = sorted(jsamplers.SAMPLERS)
SCHEDULERS = [
    dataclasses.replace(TINY.scheduler, timestep_spacing=spacing, prediction_type=pred,
                        rescale_betas_zero_snr=zsnr)
    for spacing in ("leading", "trailing", "linspace")
    for pred, zsnr in (("epsilon", False), ("v_prediction", True))
]
SCHED_IDS = [f"{s.timestep_spacing}-{s.prediction_type}-zsnr{int(s.rescale_betas_zero_snr)}"
             for s in SCHEDULERS]
PIPELINE_SAMPLERS = ("ddim", "euler", "euler-a", "dpm++-karras", "dpm++-sde", "unipc", "lcm")


def test_the_port_has_the_jax_packages_samplers():
    assert sorted(tsamplers.SAMPLERS) == NAMES and len(NAMES) == 13
    for name in NAMES:
        j, t = jsamplers.get_sampler(name), tsamplers.get_sampler(name)
        assert (t.stochastic, t.multistep) == (j.stochastic, j.multistep), name
        assert (t.scale_model_input is None) == (j.scale_model_input is None), name
        assert (t.state_init is None) == (j.state_init is None), name
    with pytest.raises(ValueError, match="unknown sampler"):
        tsamplers.get_sampler("heun")


def assert_fields_equal(got, want):
    """Every field of two schedules: float32 within 1 ulp, the rest equal."""
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if not hasattr(w, "shape"):
            assert g == w, f.name
            continue
        w = np.asarray(w)
        g = g.cpu().numpy()
        assert g.shape == w.shape, f.name
        if w.dtype == np.float32:
            assert g.dtype == np.float32, f.name
            ulp = np.abs(g.view(np.int32).astype(np.int64) - w.view(np.int32).astype(np.int64))
            assert int(ulp.max(initial=0)) <= 1, (f.name, g, w)
        else:  # the integer timesteps: int32 there, int64 here
            assert g.dtype == np.int64, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)


@pytest.mark.parametrize("sched", SCHEDULERS, ids=SCHED_IDS)
@pytest.mark.parametrize("name", NAMES)
def test_schedule_fields_equal_the_jax_packages(name, sched):
    got = tsamplers.get_sampler(name).make_schedule(port_config(sched), 7)
    want = jsamplers.get_sampler(name).make_schedule(sched, 7)
    assert type(got).__name__ == type(want).__name__
    assert got.num_steps == want.num_steps
    assert_fields_equal(got, want)


@pytest.mark.parametrize("cut", [{"denoising_end": 0.6}, {"denoising_start": 0.6}],
                         ids=["end", "start"])
@pytest.mark.parametrize("name", NAMES)
def test_slice_schedule_equals_the_jax_packages(name, cut):
    sched = dataclasses.replace(TINY.scheduler, timestep_spacing="trailing")
    got = tsamplers.slice_schedule(
        tsamplers.get_sampler(name).make_schedule(port_config(sched), 10),
        num_train_timesteps=1000, **cut)
    want = jsamplers.slice_schedule(jsamplers.get_sampler(name).make_schedule(sched, 10),
                                    num_train_timesteps=1000, **cut)
    assert got.num_steps == want.num_steps < 10
    assert_fields_equal(got, want)


def test_slice_schedule_refuses_what_the_jax_package_refuses():
    sched = tsamplers.make_schedule(port_config(TINY.scheduler), 5)
    for kw, match in (({}, "exactly one"), ({"denoising_end": 1.2}, "in \\(0, 1\\)"),
                      ({"denoising_end": 0.5, "denoising_start": 0.5}, "exactly one")):
        with pytest.raises(ValueError, match=match):
            tsamplers.slice_schedule(sched, num_train_timesteps=1000, **kw)


def test_ve_sigmas_and_karras_grid_equal_the_jax_packages():
    from sdtpu.samplers import ddpm as jddpm
    from sdtpu_torch.samplers import ddpm as tddpm

    for zsnr in (False, True):
        sched = dataclasses.replace(TINY.scheduler, rescale_betas_zero_snr=zsnr,
                                    timestep_spacing="trailing")
        ac = jddpm.make_alphas_cumprod(sched)
        np.testing.assert_array_equal(tddpm.ve_sigmas(ac), jddpm.ve_sigmas(ac))
        for steps, strength in ((25, 1.0), (10, 0.6)):
            got = tddpm.karras_sigma_grid(port_config(sched), steps, strength)
            want = jddpm.karras_sigma_grid(sched, steps, strength)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def chain(sdef, schedule, latents, eps, noise, step_fn_state):
    """Run ``len(eps)`` steps, collecting each step's latents."""
    out = []
    lat, state = latents, step_fn_state
    for i in range(len(eps)):
        if sdef.multistep:
            lat, state = sdef.step(schedule, i, lat, eps[i], noise[i], state)
        else:
            lat = sdef.step(schedule, i, lat, eps[i], noise[i])
        out.append(lat)
    return out


@pytest.mark.parametrize("pred", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("name", NAMES)
def test_steps_match_the_jax_steps_over_a_chain(name, pred):
    """Five steps on seeded inputs, the multistep state carried: every
    step's latents within 1e-6 (relative, with a 1e-6 floor) of the JAX
    step's.  Deterministic samplers take no noise in the port (None) and
    zeros in the JAX package, as their pipelines pass them."""
    sched = dataclasses.replace(TINY.scheduler, timestep_spacing="trailing", prediction_type=pred)
    jdef, tdef = jsamplers.get_sampler(name), tsamplers.get_sampler(name)
    js, ts = jdef.make_schedule(sched, 5), tdef.make_schedule(port_config(sched), 5)
    rng = np.random.default_rng(3)
    lat = rng.normal(size=(1, 4, 4, 4)).astype(np.float32) * getattr(js, "init_sigma", 1.0)
    eps = [rng.normal(size=lat.shape).astype(np.float32) for _ in range(5)]
    noise = [rng.normal(size=lat.shape).astype(np.float32) for _ in range(5)]
    jnoise = noise if jdef.stochastic else [np.zeros_like(lat)] * 5
    want = chain(jdef, js, jnp.asarray(lat), [jnp.asarray(e) for e in eps],
                 [jnp.asarray(z) for z in jnoise],
                 jdef.state_init(jnp.asarray(lat)) if jdef.multistep else None)
    tnoise = [torch.from_numpy(z) for z in noise] if tdef.stochastic else [None] * 5
    got = chain(tdef, ts, torch.from_numpy(lat), [torch.from_numpy(e) for e in eps], tnoise,
                tdef.state_init(torch.from_numpy(lat)) if tdef.multistep else None)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6,
                                   err_msg=f"step {i}")
    if tdef.scale_model_input is not None:
        x = torch.from_numpy(lat)
        np.testing.assert_array_equal(tdef.scale_model_input(ts, 2, x).numpy(),
                                      np.asarray(jdef.scale_model_input(js, 2, jnp.asarray(lat))))
    np.testing.assert_allclose(
        tdef.add_noise(ts, torch.from_numpy(lat), torch.from_numpy(noise[0]), 1).numpy(),
        np.asarray(jdef.add_noise(js, jnp.asarray(lat), jnp.asarray(noise[0]), 1)),
        rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- pipeline --

@pytest.fixture(scope="module")
def port_pipe(tiny_pipe):
    import jax

    tree = jax.tree.map(np.asarray, tiny_pipe.params)
    return StableDiffusionPipeline.from_params(port_config(TINY), tree, device="cpu")


@pytest.mark.parametrize("sampler", PIPELINE_SAMPLERS)
def test_generate_with_a_sampler_matches_jax_within_one_level(tiny_pipe, port_pipe, sampler):
    want = tiny_pipe.generate("x", token_ids=TOKENS, num_inference_steps=3, seed=40,
                              sampler=sampler)
    got = port_pipe.generate(token_ids=TOKENS, num_inference_steps=3, seed=40, sampler=sampler)
    assert got.shape == want.shape == (1, 32, 32, 3)
    assert_images_match(got, want)


def test_rng_torch_latents_match_jax_within_one_level(tiny_pipe, port_pipe):
    """``rng="torch"``: the initial latents of ``torch.Generator().manual_seed``
    in NCHW, then NHWC; the per-step noise from the seed's key without the
    initial split, as with injected latents."""
    want = tiny_pipe.generate("x", token_ids=TOKENS, num_inference_steps=2, seed=12, rng="torch")
    got = port_pipe.generate(token_ids=TOKENS, num_inference_steps=2, seed=12, rng="torch")
    assert_images_match(got, want)
    hw = TINY.default_image_size // TINY.vae.downscale_factor
    lat = torch.randn((1, 4, hw, hw), generator=torch.Generator().manual_seed(12))
    same = port_pipe.generate(token_ids=TOKENS, num_inference_steps=2, seed=12,
                              latents=lat.numpy().transpose(0, 2, 3, 1))
    np.testing.assert_array_equal(got, same)
    with pytest.raises(ValueError, match="txt2img-only"):
        port_pipe.generate(token_ids=TOKENS, seed=1, rng="torch",
                           latents=np.zeros((hw, hw, 4), np.float32))
    with pytest.raises(ValueError, match="unknown rng"):
        port_pipe.generate(token_ids=TOKENS, seed=1, rng="numpy")


def test_injected_latents_are_scaled_by_init_sigma(tiny_pipe, port_pipe):
    """Euler starts at noise * sigma_max, injected noise too: the JAX
    package's image, and ``txt2img`` with the unscaled latents."""
    hw = TINY.default_image_size // TINY.vae.downscale_factor
    lat0 = np.random.default_rng(5).normal(size=(1, hw, hw, 4)).astype(np.float32)
    want = tiny_pipe.generate("x", token_ids=TOKENS, num_inference_steps=3, seed=2,
                              sampler="euler", latents=lat0)
    got = port_pipe.generate(token_ids=TOKENS, num_inference_steps=3, seed=2, sampler="euler",
                             latents=lat0)
    assert_images_match(got, want)
    sched = tsamplers.get_sampler("euler").make_schedule(port_pipe.config.scheduler, 3)
    assert sched.init_sigma > 1.0
    ids = port_pipe._tokenize("", "", True, TOKENS)
    direct = port_pipe.txt2img(ids, torch.from_numpy(lat0), None, cfg=True,
                               cfg_scale=TINY.default_cfg_scale, sampler="euler", steps=3)
    np.testing.assert_array_equal(direct, got)
    unscaled = port_pipe.txt2img(ids, torch.from_numpy(lat0 / np.float32(sched.init_sigma)),
                                 None, cfg=True, cfg_scale=TINY.default_cfg_scale,
                                 sampler="euler", steps=3)
    assert np.abs(unscaled.astype(int) - got.astype(int)).max() > 0


def test_a_stochastic_sampler_needs_its_noise(port_pipe):
    ids = port_pipe._tokenize("", "", True, TOKENS)
    with pytest.raises(ValueError, match="noise slice per step"):
        port_pipe.txt2img(ids, torch.zeros(1, 8, 8, 4), None, cfg=True, cfg_scale=7.5,
                          sampler="euler-a", steps=3)


# ----------------------------------------------------------------- card --

@pytest.mark.gpu
@pytest.mark.parametrize("name", NAMES)
def test_steps_on_the_card_match_the_cpu(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    sched = dataclasses.replace(port_config(TINY.scheduler), timestep_spacing="trailing")
    sdef = tsamplers.get_sampler(name)
    rng = np.random.default_rng(4)
    lat = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    eps = [rng.normal(size=lat.shape).astype(np.float32) for _ in range(5)]
    noise = [rng.normal(size=lat.shape).astype(np.float32) for _ in range(5)]
    outs = []
    for dev in ("cpu", "cuda"):
        s = sdef.make_schedule(sched, 5, device=dev)
        x = torch.from_numpy(lat).to(dev)
        z = [torch.from_numpy(n).to(dev) if sdef.stochastic else None for n in noise]
        outs.append(chain(sdef, s, x, [torch.from_numpy(e).to(dev) for e in eps], z,
                          sdef.state_init(x) if sdef.multistep else None))
    for i, (c, g) in enumerate(zip(*outs)):
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=f"step {i}")
