"""The port's models and sampler against the JAX package's, at the TINY test
config (``tests/test_pipeline.py``) in float32, with the JAX package's own
random weights carried over by ``params_from_numpy``.

The JAX side runs its CPU program (``xla`` convolutions and dense
attention); the port runs its kernel route, whose wrappers take their plain
versions on the CPU.  The two compute the same function: where the port's
resnets take GroupNorm statistics from the producing conv's moments
(E[x^2] - mean^2) the JAX CPU program takes the two-pass variance, which
agrees in float32 to about 1e-6 relative.  Tolerance: 1e-5 relative plus an
absolute term of 1e-5 of the output's scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import sdtpu.models.clip as jclip
import sdtpu.models.unet as junet
import sdtpu.models.vae as jvae
import sdtpu.samplers.ddpm as jddpm
import sdtpu_torch.models.clip as tclip
import sdtpu_torch.models.unet as tunet
import sdtpu_torch.models.vae as tvae
import sdtpu_torch.samplers as tsamplers
from sdtpu.utils.weights import init_pipeline_params as jax_init
from sdtpu_torch.utils.weights import init_pipeline_params, params_from_numpy
from test_pipeline import TINY
from test_torch_ops import nn, port_config, port_params, tt

torch.set_num_threads(1)

TTINY = port_config(TINY)


def close_scaled(got, want, rtol=1e-5):
    g, w = nn(got), nn(want)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * max(1.0, np.abs(w).max()))


@pytest.fixture(scope="module")
def jparams():
    return jax_init(0, TINY)


@pytest.fixture(scope="module")
def tparams(jparams):
    return port_params(jparams)


# ------------------------------------------------------------------ CLIP --

@pytest.mark.parametrize("clip_skip", [0, 1])
def test_clip_encode(jparams, tparams, clip_skip):
    ids = np.random.default_rng(1).integers(0, TINY.clip.vocab_size, (2, 16)).astype(np.int32)
    got_h, got_p = tclip.clip_encode(torch.from_numpy(ids), tparams["clip"], TTINY.clip,
                                     clip_skip=clip_skip)
    want_h, want_p = jclip.clip_encode(jnp.asarray(ids), jparams["clip"], TINY.clip,
                                       clip_skip=clip_skip)
    close_scaled(got_h, want_h)
    close_scaled(got_p, want_p)


def test_clip_encode_windows(jparams, tparams):
    """Two 16-token windows per row, each encoded on its own."""
    ids = np.random.default_rng(2).integers(0, TINY.clip.vocab_size, (2, 32)).astype(np.int32)
    got_h, got_p = tclip.clip_encode_windows(torch.from_numpy(ids), tparams["clip"], TTINY.clip)
    want_h, want_p = jclip.clip_encode_windows(jnp.asarray(ids), jparams["clip"], TINY.clip)
    close_scaled(got_h, want_h)
    close_scaled(got_p, want_p)
    with pytest.raises(ValueError, match="multiple of the CLIP window"):
        tclip.clip_encode_windows(torch.zeros((1, 20), dtype=torch.int64), tparams["clip"],
                                  TTINY.clip)


# ------------------------------------------------------------------ UNet --

def _unet_inputs(seed, cfg):
    rng = np.random.default_rng(seed)
    lat = rng.normal(size=(2, 4, 4, cfg.in_channels)).astype(np.float32)
    ts = np.array([981.0, 21.0], np.float32)
    ctx = rng.normal(size=(2, 16, cfg.cross_attention_dim)).astype(np.float32)
    return lat, ts, ctx


def test_unet_forward(jparams, tparams):
    lat, ts, ctx = _unet_inputs(3, TINY.unet)
    got = tunet.unet_forward(tt(lat), tt(ts), tt(ctx), tparams["unet"], TTINY.unet)
    want = junet.unet_forward(jnp.asarray(lat), jnp.asarray(ts), jnp.asarray(ctx),
                              jparams["unet"], TINY.unet)
    close_scaled(got, want)


def test_unet_forward_with_hoisted_projections(jparams, tparams):
    """The loop-invariant cross-attention K/V and the per-step time
    projections, computed before the loop as the pipeline does."""
    lat, _, ctx = _unet_inputs(4, TINY.unet)
    steps = np.array([901, 501, 1], np.int64)
    cache_t = tunet.precompute_time_projections(torch.from_numpy(steps), tparams["unet"],
                                                TTINY.unet, batch=2, dtype=torch.float32)
    cache_j = junet.precompute_time_projections(jnp.asarray(steps, jnp.int32), jparams["unet"],
                                                TINY.unet, batch=2, dtype=jnp.float32)
    kv_t = tunet.precompute_cross_kv(tt(ctx), tparams["unet"], TTINY.unet)
    kv_j = junet.precompute_cross_kv(jnp.asarray(ctx), jparams["unet"], TINY.unet)
    i = 1
    got = tunet.unet_forward(tt(lat), None, tt(ctx), tparams["unet"], TTINY.unet,
                             cross_kv=kv_t, time_cache=tunet.time_cache_step(cache_t, i))
    want = junet.unet_forward(jnp.asarray(lat), None, jnp.asarray(ctx), jparams["unet"],
                              TINY.unet, cross_kv=kv_j,
                              time_cache=jax.tree.map(lambda a: a[i], cache_j))
    close_scaled(got, want)


def test_unet_forward_with_mid_block():
    """Tiny-SD has no mid block; SD 1.5/2.1/SDXL do (resnet, attention,
    resnet between encoder and decoder)."""
    jcfg = dataclasses.replace(TINY.unet, mid_block=True)
    jp = junet.init_unet(7, jcfg)
    lat, ts, ctx = _unet_inputs(5, jcfg)
    got = tunet.unet_forward(tt(lat), tt(ts), tt(ctx), port_params(jp), port_config(jcfg))
    want = junet.unet_forward(jnp.asarray(lat), jnp.asarray(ts), jnp.asarray(ctx), jp, jcfg)
    close_scaled(got, want)


@pytest.mark.parametrize("heads,channels,want", [(8, 320, 8), (0, 640, 10), (0, 1280, 20)])
def test_heads_for_level(heads, channels, want):
    """A fixed head count, or the 0 sentinel for head_dim 64 (SD 2.x, SDXL)."""
    jcfg = dataclasses.replace(TINY.unet, num_attention_heads=heads)
    assert tunet._heads_for_level(port_config(jcfg), channels) == want
    assert junet._heads_for_level(jcfg, channels) == want


def test_unet_rejects_model_family_embeddings():
    """No longer refused: the SDXL add-embedding and the LCM guidance
    projection are drawn in the JAX package's key order, bitwise."""
    jcfg = dataclasses.replace(TINY.unet, addition_embed_dim=16 + 6 * 4,
                               addition_time_embed_dim=4, time_cond_proj_dim=8)
    got = tunet.init_unet(0, port_config(jcfg))
    want = junet.init_unet(0, jcfg)
    assert got["time_embedding"]["cond_proj"]["kernel"].shape == (8, 16)
    assert "bias" not in got["time_embedding"]["cond_proj"]
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert len(jax.tree.leaves(got)) == len(jax.tree.leaves(want))


# ------------------------------------------------------------------- VAE --

def test_vae_decode(jparams, tparams):
    lat = np.random.default_rng(6).normal(size=(1, 4, 4, 4)).astype(np.float32)
    got = tvae.vae_decode(tt(lat), tparams["vae_decoder"], TTINY.vae)
    want = jvae.vae_decode(jnp.asarray(lat), jparams["vae_decoder"], TINY.vae)
    f = TINY.vae.downscale_factor
    assert tuple(got.shape) == (1, 4 * f, 4 * f, 3)
    close_scaled(got, want)


# --------------------------------------------------------------- sampler --

@pytest.mark.parametrize("steps,spacing,strength", [
    (25, "leading", 1.0), (3, "leading", 1.0), (10, "trailing", 1.0),
    (7, "linspace", 1.0), (10, "leading", 0.6),
])
def test_ddpm_schedule(steps, spacing, strength):
    jc = dataclasses.replace(TINY.scheduler, timestep_spacing=spacing)
    got = tsamplers.make_schedule(port_config(jc), steps, strength)
    want = jddpm.make_schedule(jc, steps, strength)
    np.testing.assert_array_equal(got.timesteps.numpy(), np.asarray(want.timesteps))
    for f in ("coeff_x0", "coeff_xt", "sqrt_alpha_prod", "sqrt_one_minus_alpha_prod", "sigma"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


@pytest.mark.parametrize("prediction_type,zero_snr", [("epsilon", False),
                                                      ("v_prediction", True)])
def test_ddpm_step_and_add_noise(prediction_type, zero_snr):
    jc = dataclasses.replace(TINY.scheduler, prediction_type=prediction_type,
                             rescale_betas_zero_snr=zero_snr, timestep_spacing="trailing")
    ts, js = tsamplers.make_schedule(port_config(jc), 5), jddpm.make_schedule(jc, 5)
    rng = np.random.default_rng(8)
    lat, eps, noise = (rng.normal(size=(1, 4, 4, 4)).astype(np.float32) for _ in range(3))
    for i in range(5):
        got = tsamplers.ddpm_step(ts, i, tt(lat), tt(eps), tt(noise))
        want = jddpm.ddpm_step(js, i, jnp.asarray(lat), jnp.asarray(eps), jnp.asarray(noise))
        close_scaled(got, want)
    close_scaled(tsamplers.add_noise(ts, tt(lat), tt(noise), 2),
                 jddpm.add_noise(js, jnp.asarray(lat), jnp.asarray(noise), 2))


def test_only_ddpm_is_ported():
    """Every sampler of the JAX package is ported now
    (``test_torch_samplers.py``); an unknown name raises its ValueError."""
    assert tsamplers.get_sampler("ddpm").stochastic
    assert not tsamplers.get_sampler("euler").stochastic
    with pytest.raises(ValueError, match="unknown sampler"):
        tsamplers.get_sampler("heun")


# --------------------------------------------------------------- weights --

def test_params_from_numpy_keeps_each_leaf_dtype():
    bf = np.array([1.5, -2.25, 3.0e-3], dtype=ml_dtypes.bfloat16)
    tree = {"a": [np.arange(3, dtype=np.float32), bf], "b": {"c": np.arange(4, dtype=np.int32)}}
    got = params_from_numpy(tree, device="cpu")
    assert got["a"][0].dtype == torch.float32
    assert got["a"][1].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["a"][1].float().numpy(), bf.astype(np.float32))
    assert got["b"]["c"].dtype == torch.int32


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_init_pipeline_params_matches_jax_tree():
    """``init_pipeline_params(seed)`` is the JAX package's
    ``init_pipeline_params(seed)`` bitwise, leaf by leaf (keys, shapes,
    dtypes and values), under a float32 and a bf16 param dtype (the CLIP
    embeddings stay float32 there too), the VAE encoder included."""
    for dt in (jnp.float32, jnp.bfloat16):
        cfg = TINY.replace(param_dtype=dt)
        want = jax.tree.map(np.asarray, jax_init(0, cfg))
        got = init_pipeline_params(0, port_config(cfg), device="cpu")
        want_leaves, got_leaves = list(_leaves(want)), list(_leaves(got))
        assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
        for (path, g), (_, w) in zip(got_leaves, want_leaves):
            if w.dtype == ml_dtypes.bfloat16:
                assert g.dtype == torch.bfloat16, path
                np.testing.assert_array_equal(g.view(torch.int16).numpy(), w.view(np.int16),
                                              err_msg=str(path))
            else:
                assert g.dtype == torch.from_numpy(np.zeros(0, w.dtype)).dtype, path
                np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))


@pytest.mark.parametrize("name,init,jinit,cfg", [
    ("clip", tclip.init_clip, jclip.init_clip, TINY.clip),
    ("unet", tunet.init_unet, junet.init_unet, TINY.unet),
    ("vae_decoder", tvae.init_vae_decoder, jvae.init_vae_decoder, TINY.vae),
    ("vae_encoder", tvae.init_vae_encoder, jvae.init_vae_encoder, TINY.vae),
])
def test_model_init_from_a_seed_matches_jax(name, init, jinit, cfg):
    """Each model's ``init_*`` from an int seed (a ``HostKey`` underneath)
    draws the JAX package's leaves bitwise, on the CPU."""
    want = list(_leaves(jax.tree.map(np.asarray, jinit(9, cfg))))
    got = list(_leaves(init(9, port_config(cfg))))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.device.type == "cpu", path
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{name} {path}")
