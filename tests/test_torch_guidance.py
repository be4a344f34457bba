"""The port's denoise-step features against the JAX package on the CPU, at
the TINY config: Perturbed-Attention Guidance (``transformer_block``'s
identity tail on the dense route and on kernel G's plain route, the UNet's
PAG site at the mid block or the deepest attention level, the guidance
combines), FreeU (``fourier_filter``, ``apply_freeu``, ``unet_decode``),
CFG rescale (``rescale_noise_cfg``), the encoder cache (the grouped loop, a
remainder, k beyond the steps, a stochastic sampler, the engine), the hires
fix (``generate_hires``, ``bilinear_resize``), their buckets in the
ServingEngine, ``warmup``, every check's message, and the bench's and the
demo's flags.

Float32 values are held within 1e-5 (``test_torch_models.close_scaled``),
images within one uint8 level (``conftest.assert_images_match``); the
encoder cache at k = 1 is bitwise the plain image.  The JAX package runs
its CPU program; the port its kernel route, whose wrappers take their
plain versions on the CPU.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdtpu.models.unet as junet
import sdtpu.ops.attention  # noqa: F401
import sdtpu_torch.config as tcfg
import sdtpu_torch.models.unet as tunet
import sdtpu_torch.ops.attention  # noqa: F401
from conftest import assert_images_match
from sdtpu.config import UNetConfig
from sdtpu.pipeline.pipeline import StableDiffusionPipeline as JaxPipeline
from sdtpu.pipeline.pipeline import rescale_noise_cfg as jax_rescale
from sdtpu.utils.image import bilinear_resize as jax_bilinear
from sdtpu_torch import StableDiffusionPipeline
from sdtpu_torch.pipeline import serving
from sdtpu_torch.pipeline.pipeline import rescale_noise_cfg
from sdtpu_torch.pipeline.serving import ServingEngine
from sdtpu_torch.utils.image import bilinear_resize
from sdtpu_torch.utils.weights import params_from_numpy
from test_pipeline import TINY, TOKENS
from test_torch_models import close_scaled
from test_torch_ops import port_config, tt

torch.set_num_threads(1)

# the packages re-export a function named ``attention`` that shadows the module
jattn = sys.modules["sdtpu.ops.attention"]
tattn = sys.modules["sdtpu_torch.ops.attention"]

TINY9 = TINY.replace(name="test/tiny-inpaint", unet=dataclasses.replace(TINY.unet, in_channels=9))
TINY8 = TINY.replace(name="test/tiny-edit", unet=dataclasses.replace(TINY.unet, in_channels=8))
RNG = np.random.default_rng(17)
INIT = RNG.integers(0, 256, (32, 32, 3), dtype=np.uint8)
MASK = np.zeros((32, 32), np.uint8)
MASK[:, 16:] = 255
IDS2 = np.stack([TOKENS[0], TOKENS[1]])
FREEU = (1.5, 1.6, 0.9, 0.2)


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_of(jax_pipe, config):
    return StableDiffusionPipeline.from_params(port_config(config), numpy_tree(jax_pipe.params),
                                               device="cpu")


@pytest.fixture(scope="module")
def pipes(tiny_pipe):
    return tiny_pipe, port_of(tiny_pipe, TINY)


def both(pipes, method, *args, **kw):
    j, t = pipes
    return getattr(t, method)(*args, **kw), getattr(j, method)(*args, **kw)


# ------------------------------------------------------------------ PAG --

@pytest.fixture(scope="module")
def block():
    params = jattn.init_transformer_block(jax.random.key(3), 32, context_dim=24)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 16, 32)).astype(np.float32)
    ctx = rng.standard_normal((3, 7, 24)).astype(np.float32)
    return params, params_from_numpy(numpy_tree(params), device="cpu"), x, ctx


@pytest.mark.parametrize("tail", [0, 1, 3])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_transformer_block_pag_tail_matches_jax(block, tail, impl):
    """The tail rows take x + out(v(LN(x))), the head rows attention (the
    port's flash route: kernel C's plain version at the head's batch);
    cross-attention and the feed-forward take every row."""
    jp, tp, x, ctx = block
    want = jattn.transformer_block(jnp.asarray(x), jp, num_heads=4, context=jnp.asarray(ctx),
                                   implementation="xla", pag_tail=tail)
    got = tattn.transformer_block(tt(x), tp, num_heads=4, context=tt(ctx),
                                  implementation=impl, pag_tail=tail)
    close_scaled(got, want)


def test_transformer_block_pag_tail_on_the_packed_route(block, monkeypatch):
    """With the packed out-projection (kernel G's plain version here) the
    head rows' residual goes through G and the tail stays on ``linear``."""
    jp, tp, x, ctx = block
    calls = []
    real = tattn.out_proj_packed

    def counting(o, w, b, r):
        calls.append(tuple(o.shape))
        return real(o, w, b, r)

    monkeypatch.setattr(tattn, "_PACKED_OUT_PROJ", True)
    monkeypatch.setattr(tattn, "out_proj_packed", counting)
    want = jattn.transformer_block(jnp.asarray(x), jp, num_heads=4, context=jnp.asarray(ctx),
                                   implementation="xla", pag_tail=1)
    got = tattn.transformer_block(tt(x), tp, num_heads=4, context=tt(ctx),
                                  implementation="flash", pag_tail=1)
    assert calls == [(2, 4, 16, 8)]
    close_scaled(got, want)


@pytest.mark.parametrize("mid", [False, True], ids=["deepest", "mid"])
def test_unet_pag_site_matches_jax(mid):
    """The PAG site: the mid block's attention, or every attention block of
    the deepest attention level when there is no mid block; a duplicated
    row's head equals the clean forward and its tail the all-perturbed one."""
    cfg = UNetConfig(block_out_channels=(16, 24), layers_per_block=1,
                     attention_levels=(True, True), num_attention_heads=2,
                     cross_attention_dim=24, norm_num_groups=8, mid_block=mid)
    params = junet.init_unet(0, cfg)
    rng = np.random.default_rng(5)
    row = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    x = np.concatenate([row, row])
    crow = rng.standard_normal((1, 6, 24)).astype(np.float32)
    ctx = np.concatenate([crow, crow])
    t = np.asarray([3.0, 3.0], np.float32)
    tp = params_from_numpy(numpy_tree(params), device="cpu")
    for tail in (1, 2):
        want = junet.unet_forward(jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), params, cfg,
                                  pag_tail=tail)
        got = tunet.unet_forward(tt(x), tt(t), tt(ctx), tp, port_config(cfg), pag_tail=tail)
        close_scaled(got, want)
    clean = tunet.unet_forward(tt(x), tt(t), tt(ctx), tp, port_config(cfg))
    mixed = tunet.unet_forward(tt(x), tt(t), tt(ctx), tp, port_config(cfg), pag_tail=1)
    torch.testing.assert_close(mixed[0], clean[0], rtol=1e-5, atol=1e-6)
    assert float((mixed[1] - clean[1]).abs().max()) > 1e-4


@pytest.mark.parametrize("kw", [
    dict(pag_scale=3.0),
    dict(pag_scale=2.0, cfg=False),
    dict(pag_scale=2.0, guidance_rescale=0.5),
    dict(pag_scale=2.0, sampler="dpm++-karras"),
], ids=["cfg", "no-cfg", "rescale", "multistep"])
def test_pag_images_match_jax(pipes, kw):
    """Rows [cond, (uncond,) perturbed]: the CFG + PAG combine, PAG alone,
    and CFG + PAG with rescale on the cond rows."""
    ids = TOKENS[:1] if kw.get("cfg") is False else TOKENS
    got, want = both(pipes, "generate", "x", token_ids=ids, num_inference_steps=3, seed=5, **kw)
    assert_images_match(got, want)
    _, t = pipes
    plain = t.generate("x", token_ids=ids, num_inference_steps=3, seed=5,
                       **{k: v for k, v in kw.items() if k != "pag_scale"})
    assert not np.array_equal(got, plain)


def test_pag_batched_and_img2img_match_jax(pipes):
    got, want = both(pipes, "generate_batch", ["x", "y"], token_ids=IDS2, num_inference_steps=2,
                     seeds=[1, 2], pag_scale=2.0)
    assert_images_match(got, want)
    # num_images=2 at the batch's scale: the JAX package runs it as the
    # same compiled program (its key holds the rows and the scale)
    got, want = both(pipes, "generate", "x", token_ids=TOKENS, num_inference_steps=2, seed=5,
                     num_images=2, pag_scale=2.0)
    assert got.shape == (2, 32, 32, 3)
    assert_images_match(got, want)
    got, want = both(pipes, "generate", "x", token_ids=TOKENS, num_inference_steps=3, seed=5,
                     init_image=INIT, strength=0.7, pag_scale=2.0)
    assert_images_match(got, want)


def test_pag_with_the_inpaint_unet_matches_jax():
    """The 9-channel UNet's extra channels ride every branch, PAG's too."""
    j = JaxPipeline.from_random(TINY9, seed=0)
    got, want = both((j, port_of(j, TINY9)), "generate", "x", token_ids=TOKENS,
                     num_inference_steps=2, seed=3, init_image=INIT, mask_image=MASK,
                     strength=1.0, pag_scale=2.0)
    assert_images_match(got, want)


# ---------------------------------------------------------------- FreeU --

@pytest.mark.parametrize("scale,threshold", [(1.0, 1), (0.0, 1), (0.2, 1), (0.9, 2)])
def test_fourier_filter_matches_jax(scale, threshold):
    x = np.random.default_rng(1).standard_normal((2, 8, 6, 4)).astype(np.float32)
    want = junet.fourier_filter(jnp.asarray(x), scale, threshold)
    got = tunet.fourier_filter(tt(x), scale, threshold)
    close_scaled(got, want)
    if scale == 1.0:
        close_scaled(got, x)


def test_fourier_filter_low_passes():
    """A constant map is pure DC, the checkerboard the highest frequency:
    scale 0 zeroes the one and keeps the other."""
    const = torch.full((1, 8, 8, 2), 3.0)
    assert float(tunet.fourier_filter(const, 0.0).abs().max()) < 1e-5
    r = np.indices((8, 8)).sum(axis=0) % 2
    board = tt(((-1.0) ** r)[None, :, :, None])
    torch.testing.assert_close(tunet.fourier_filter(board, 0.0), board, rtol=0, atol=1e-5)


@pytest.mark.parametrize("rev", [0, 1, 2])
def test_apply_freeu_matches_jax(rev):
    rng = np.random.default_rng(rev)
    x = rng.standard_normal((2, 4, 4, 6)).astype(np.float32)
    skip = rng.standard_normal((2, 4, 4, 6)).astype(np.float32)
    wx, ws = junet.apply_freeu(rev, jnp.asarray(x), jnp.asarray(skip), FREEU)
    gx, gs = tunet.apply_freeu(rev, tt(x), tt(skip), FREEU)
    close_scaled(gx, wx)
    close_scaled(gs, ws)
    if rev > 1:
        np.testing.assert_array_equal(gx.numpy(), x)


def test_unet_decode_freeu_matches_jax():
    """FreeU at the first two up blocks' concats; unit factors change the
    output only by the skip's FFT round trip."""
    cfg = UNetConfig(block_out_channels=(16, 24, 32), layers_per_block=1,
                     attention_levels=(False, False, False), num_attention_heads=2,
                     cross_attention_dim=32, norm_num_groups=8)
    params = junet.init_unet(0, cfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 8, 32)).astype(np.float32)
    jt = junet.compute_time_embedding(jnp.array(3.0), params, cfg, batch=1, dtype=jnp.float32)
    jh, jsk = junet.unet_encode(jnp.asarray(x), jt, jnp.asarray(ctx), params, cfg)
    want = junet.unet_decode(jh, jsk, jt, jnp.asarray(ctx), params, cfg, freeu=FREEU)
    tp, tc = params_from_numpy(numpy_tree(params), device="cpu"), port_config(cfg)
    temb = tunet.compute_time_embedding(torch.tensor(3.0), tp, tc, batch=1, dtype=torch.float32)
    h, sk = tunet.unet_encode(tt(x), temb, tt(ctx), tp, tc)
    got = tunet.unet_decode(h, sk, temb, tt(ctx), tp, tc, freeu=FREEU)
    close_scaled(got, want)
    plain = tunet.unet_decode(h, sk, temb, tt(ctx), tp, tc)
    unit = tunet.unet_decode(h, sk, temb, tt(ctx), tp, tc, freeu=(1.0, 1.0, 1.0, 1.0))
    torch.testing.assert_close(unit, plain, rtol=0, atol=1e-4)
    assert float((got - plain).abs().max()) > 1e-3


def test_freeu_images_match_jax(pipes):
    got, want = both(pipes, "generate", "x", token_ids=TOKENS, num_inference_steps=3, seed=11,
                     freeu=FREEU)
    assert_images_match(got, want)
    got, want = both(pipes, "generate_batch", ["x", "y"], token_ids=IDS2, num_inference_steps=2,
                     seeds=[3, 4], freeu=(1.3, 1.4, 0.9, 0.2))
    assert_images_match(got, want)
    got, want = both(pipes, "generate", "x", token_ids=TOKENS, num_inference_steps=3, seed=2,
                     init_image=INIT, strength=0.7, freeu=(1.3, 1.4, 0.9, 0.2))
    assert_images_match(got, want)


# -------------------------------------------------------- CFG rescale --

def test_rescale_noise_cfg_matches_jax():
    """Per-row standard deviation divided by n, as jnp.std; a row whose
    combined deviation is 0 keeps factor 1."""
    rng = np.random.default_rng(3)
    cfg_eps = rng.standard_normal((3, 4, 4, 4)).astype(np.float32) * 3.0
    text = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    cfg_eps[1] = 0.5  # zero std
    for r in (0.0, 0.3, 0.7, 1.0):
        want = jax_rescale(jnp.asarray(cfg_eps), jnp.asarray(text), r)
        got = rescale_noise_cfg(tt(cfg_eps), tt(text), r)
        close_scaled(got, want)
    np.testing.assert_array_equal(got[1].numpy(), cfg_eps[1])


def test_rescale_images_match_jax(pipes):
    got, want = both(pipes, "generate", "x", token_ids=TOKENS, num_inference_steps=3, seed=7,
                     guidance_rescale=0.7, cfg_scale=9.0)
    assert_images_match(got, want)
    got, want = both(pipes, "generate_batch", ["x", "y"], token_ids=IDS2, num_inference_steps=2,
                     seeds=[5, 6], guidance_rescale=0.5)
    assert_images_match(got, want)


# ------------------------------------------------------ encoder cache --

def test_encode_decode_compose_to_unet_forward():
    cfg = port_config(TINY).unet
    params = tunet.init_unet(0, cfg)
    rng = np.random.default_rng(0)
    lat, ctx = tt(rng.standard_normal((2, 8, 8, 4))), tt(rng.standard_normal((2, 5, 32)))
    ts = torch.tensor([700.0, 30.0])
    want = tunet.unet_forward(lat, ts, ctx, params, cfg)
    temb = tunet.compute_time_embedding(ts, params, cfg, batch=2, dtype=torch.float32)
    got = tunet.unet_decode(*tunet.unet_encode(lat, temb, ctx, params, cfg), temb, ctx, params,
                            cfg)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_encoder_cache_k1_is_the_plain_image_bitwise(pipes):
    _, t = pipes
    kw = dict(token_ids=TOKENS, num_inference_steps=3, seed=5, sampler="ddim")
    np.testing.assert_array_equal(t.generate("x", encoder_cache_interval=1, **kw),
                                  t.generate("x", **kw))


@pytest.mark.parametrize("steps,k,sampler", [(5, 3, "ddim"), (3, 9, "ddim"), (4, 2, "ddpm"),
                                             (4, 2, "dpm++-karras")])
def test_encoder_cache_images_match_jax(pipes, steps, k, sampler):
    """Groups of k steps (the encoder at each group's first), a remainder
    in full, k beyond the steps (all in full), a stochastic and a multistep
    sampler."""
    got, want = both(pipes, "generate", "x", token_ids=TOKENS, num_inference_steps=steps,
                     seed=5, sampler=sampler, encoder_cache_interval=k, output="float")
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    _, t = pipes
    plain = t.generate("x", token_ids=TOKENS, num_inference_steps=steps, seed=5,
                       sampler=sampler, output="float")
    if k > steps:
        np.testing.assert_array_equal(got, plain)
    else:
        assert np.abs(got - plain).max() > 1e-4  # the approximation is active


def test_encoder_cache_latents_match_jax_in_float32(pipes):
    """The grouped loop's final latents with PAG and FreeU on, against the
    JAX program's, in float32."""
    got, want = both(pipes, "generate", "x", token_ids=TOKENS, num_inference_steps=5, seed=8,
                     sampler="ddim", encoder_cache_interval=2, pag_scale=2.0, freeu=FREEU,
                     output="latents")
    close_scaled(got, want)


def test_encoder_cache_through_the_engine_equals_direct(pipes):
    _, t = pipes
    direct = t.generate_batch(["p"], token_ids=TOKENS[:1], num_inference_steps=4, seeds=[5],
                              encoder_cache_interval=2)
    engine = ServingEngine(t, max_batch_size=2, max_wait_ms=30)
    try:
        got = engine.submit("p", token_ids=TOKENS[0], seed=5, num_inference_steps=4,
                            image_size=32, encoder_cache_interval=2).result(300)
        engine.submit("p", token_ids=TOKENS[0], seed=5, num_inference_steps=4,
                      image_size=32).result(300)
        stats = engine.stats()
    finally:
        engine.shutdown()
    np.testing.assert_array_equal(got, direct[0])
    assert stats["batches"] == 2


# ------------------------------------------------------------- serving --

def test_features_through_the_engine_equal_direct(pipes):
    """PAG, FreeU and CFG rescale requests each equal their direct batch row
    (bitwise on the CPU) and never share a bucket with the plain ones."""
    _, t = pipes
    kws = [dict(pag_scale=2.0), dict(freeu=FREEU), dict(guidance_rescale=0.5), {}]
    engine = ServingEngine(t, max_batch_size=4, max_wait_ms=50)
    try:
        futs = [engine.submit("p", token_ids=TOKENS[0], seed=9, num_inference_steps=2,
                              image_size=32, **kw) for kw in kws]
        served = [f.result(300) for f in futs]
        stats = engine.stats()
    finally:
        engine.shutdown()
    assert stats["batches"] == 4
    for img, kw in zip(served, kws):
        np.testing.assert_array_equal(
            img, t.generate_batch(["p"], token_ids=TOKENS[:1], num_inference_steps=2, seeds=[9],
                                  **kw)[0])


def test_bucket_fields_of_the_step_features():
    base = dict(prompt="p", negative_prompt="", seed=0, token_ids=None, future=None,
                image_size=32, steps=2, sampler="ddpm", cfg=True, cfg_scale=7.5)
    a = serving._Request(**base)
    for change in (dict(pag_scale=2.0), dict(freeu=FREEU), dict(guidance_rescale=0.5),
                   dict(encoder_cache_interval=2), dict(control_image=INIT)):
        assert serving._Request(**dict(base, **change)).bucket != a.bucket
    c = serving._Request(**dict(base, control_image=INIT, controlnet_scale=0.5))
    assert serving._Request(**dict(base, control_image=MASK, controlnet_scale=0.5)).bucket == \
        c.bucket
    for scale in (0.6, [0.5, 0.5]):
        assert serving._Request(**dict(base, control_image=INIT,
                                       controlnet_scale=scale)).bucket != c.bucket
    # the scale of a request without a map picks nothing
    assert serving._Request(**dict(base, controlnet_scale=0.3)).bucket == a.bucket


def test_warmup_takes_the_step_features(pipes, monkeypatch):
    _, t = pipes
    seen = []
    real = t.generate_batch

    def spy(prompts, **k):
        seen.append({n: k[n] for n in ("pag_scale", "freeu", "guidance_rescale",
                                       "encoder_cache_interval")})
        return real(prompts, **k)

    monkeypatch.setattr(t, "generate_batch", spy)
    assert t.warmup(image_sizes=(32,), step_counts=(2,), batch_sizes=(1, 2), pag_scale=2.0,
                    freeu=FREEU, guidance_rescale=0.5, encoder_cache_interval=2) == 2
    assert seen == [dict(pag_scale=2.0, freeu=FREEU, guidance_rescale=0.5,
                         encoder_cache_interval=2)] * 2


# ------------------------------------------------------------ hires fix --

def test_bilinear_resize_equals_jax():
    """The copy equals the JAX package's host resize bitwise, and
    jax.image.resize within 1e-5 on upscales."""
    x = np.random.default_rng(1).standard_normal((2, 12, 20, 3)).astype(np.float32)
    for h, w in ((30, 24), (24, 40), (12, 20), (6, 10)):
        np.testing.assert_array_equal(bilinear_resize(x, h, w), jax_bilinear(x, h, w))
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 24, 40, 3), "bilinear"))
    np.testing.assert_allclose(bilinear_resize(x, 24, 40), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(), dict(num_images=2), dict(pag_scale=2.0, freeu=FREEU)],
                         ids=["one", "two-rows", "features"])
def test_generate_hires_matches_jax(pipes, kw):
    """txt2img at the base size, the host upscale, img2img at the target
    size; two rows refine each row with seed + i."""
    got, want = both(pipes, "generate_hires", "x", token_ids=TOKENS, num_inference_steps=2,
                     seed=9, image_size=64, base_size=32, hires_strength=0.6, **kw)
    rows = kw.get("num_images", 1)
    assert got.shape == (rows, 64, 64, 3) and got.dtype == np.uint8
    assert_images_match(got, want)
    if rows == 2:
        assert not np.array_equal(got[0], got[1])


def test_generate_hires_float_output_matches_jax(pipes):
    got, want = both(pipes, "generate_hires", "x", token_ids=TOKENS, num_inference_steps=2,
                     seed=4, image_size=128, output="float")
    assert got.shape == (1, 128, 128, 3)  # the default base: half, at least 64
    close_scaled(got, want)


# --------------------------------------------------------------- checks --

@pytest.mark.parametrize("method,kw,match", [
    ("generate", dict(pag_scale=-1.0), "pag_scale must be >= 0"),
    ("generate", dict(freeu=(1.3, 1.4)), "freeu must be"),
    ("generate", dict(freeu="x"), "freeu must be"),
    ("generate", dict(guidance_rescale=1.5), r"guidance_rescale must be in \[0, 1\]"),
    ("generate", dict(guidance_rescale=0.5, cfg=False), "needs cfg=True"),
    ("generate", dict(encoder_cache_interval=0), "encoder_cache_interval must be >= 1"),
    ("generate_batch", dict(pag_scale=-2.0), "pag_scale must be >= 0"),
    ("generate_batch", dict(encoder_cache_interval=0), "encoder_cache_interval must be >= 1"),
    ("generate_hires", dict(image_size=32, base_size=32), "base_size must be smaller"),
    ("generate_hires", dict(image_size=64, base_size=36), "multiples of 8"),
    ("generate_hires", dict(image_size=64, base_size=32, init_image=INIT), "owns init_image"),
    ("generate_hires", dict(image_size=64, base_size=32, mask_image=MASK), "owns mask_image"),
    ("generate_hires", dict(image_size=64, base_size=32,
                            latents=np.zeros((1, 8, 8, 4), np.float32)), "owns latents"),
    ("generate_hires", dict(image_size=64, base_size=32, num_images=2, output="device"),
     "num_images"),
])
def test_feature_checks_raise_the_jax_messages(pipes, method, kw, match):
    args = (["x", "y"],) if method == "generate_batch" else ("x",)
    ids = IDS2 if method == "generate_batch" else TOKENS
    for pipe in pipes:
        with pytest.raises(ValueError, match=match):
            getattr(pipe, method)(*args, token_ids=ids, num_inference_steps=1, **kw)


def test_editing_checkpoints_refuse_pag_and_rescale():
    j = JaxPipeline.from_random(TINY8, seed=0)
    for pipe in (j, port_of(j, TINY8)):
        for kw, match in ((dict(pag_scale=2.0), "pag_scale is incompatible"),
                          (dict(guidance_rescale=0.5), "not defined for editing")):
            with pytest.raises(ValueError, match=match):
                pipe.generate("x", token_ids=TOKENS, num_inference_steps=1, init_image=INIT,
                              **kw)


# ---------------------------------------------------------- entry points --

@pytest.mark.parametrize("flags,variant", [
    (["--pag-scale", "3"], ""),
    (["--encoder-cache", "3"], "enc-cache3 "),
    (["--encoder-cache", "2", "--img2img", "--batch", "2"], "enc-cache2 img2img "),
])
def test_bench_feature_lines(monkeypatch, capsys, flags, variant):
    """The JAX bench's variant names; no FLOP count for the features."""
    from sdtpu_torch import bench

    monkeypatch.setitem(tcfg.PRESETS, "test/tiny", port_config(TINY))
    line = bench.main(["--preset", "test/tiny", "--device", "cpu", "--steps", "3",
                       "--repeats", "1", *flags])
    assert line["metric"] == f"test/tiny 32x32 {variant}3-step ddpm CFG images/sec/chip"
    assert line["value"] > 0 and line["program_tflops"] is None and line["mfu_pct"] is None
    capsys.readouterr()


def test_demo_feature_flags(tmp_path, monkeypatch, capsys):
    from sdtpu_torch import demo
    from sdtpu_torch.utils.image import read_png

    monkeypatch.setitem(tcfg.PRESETS, "test/tiny", port_config(TINY))
    out = str(tmp_path / "out.png")
    base = ["--preset", "test/tiny", "--device", "cpu", "--steps", "2", "--out", out]
    demo.main(base + ["--pag-scale", "2", "--freeu", "1.5,1.6,0.9,0.2",
                      "--guidance-rescale", "0.7", "--encoder-cache", "2"])
    assert read_png(out).shape == (32, 32, 3)
    demo.main(base + ["--hires-base", "32", "--image-size", "64", "--hires-strength", "0.5"])
    assert read_png(out).shape == (64, 64, 3)
    assert "wrote" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        demo.main(base + ["--hires-base", "32", "--init-image", out])
