"""The port's SDXL family and LCM guidance embedding against the JAX package
on the CPU, at tiny configs: two text encoders (CLIP-L and bigG with its
pooled projection), the add-embedding micro-conditioning (size/crop time
ids, the refiner's aesthetic scores), the base -> refiner handoff
(``denoising_end`` / ``denoising_start``), SDXL-Turbo's few-step Euler
without CFG, the refiner's img2img and the 9-channel SDXL inpaint UNet,
batched rows and the ServingEngine, the LCM guidance embedding, int8 calibration, ``from_pretrained`` of diffusers directories,
``validate_checkpoint``, and the bench and demo entry points.

TINY_XL's second UNet level has 64 channels with the head_dim-64 sentinel,
so the slab conv (A), its upsample mode (B) and flash attention (C) run
their plain versions here (counted below), as on the card they run the
kernels.  Leaves are held bitwise, float32 values within 1e-5 and images
within one uint8 level (``conftest.assert_images_match``).  The JAX
package runs its CPU program; both are float32.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

import sdtpu.config as jcfg
import sdtpu.models.unet as junet
import sdtpu.utils.calibrate as jcal
import sdtpu_torch.config as tcfg
import sdtpu_torch.models.unet as tunet
import sdtpu_torch.utils.calibrate as tcal
from conftest import assert_images_match
from sdtpu.config import CLIPConfig, PipelineConfig, SchedulerConfig, UNetConfig, VAEConfig
from sdtpu.ops import timestep_embedding as jax_timestep_embedding
from sdtpu.pipeline.pipeline import StableDiffusionPipeline as JaxPipeline
from sdtpu.pipeline.serving import ServingEngine as JaxEngine
from sdtpu.tokenizer.bpe import CLIPTokenizer as JaxTokenizer
from sdtpu.utils.weights import init_pipeline_params as jax_init
from sdtpu.utils.weights import load_pipeline_params as jax_load
from sdtpu_torch import StableDiffusionPipeline
from sdtpu_torch.pipeline.serving import ServingEngine
from sdtpu_torch.tokenizer.bpe import CLIPTokenizer
from sdtpu_torch.utils.weights import init_pipeline_params, zero_pipeline_params
from test_from_pretrained import _lin, _norm, _write_clip, _write_unet, _write_vae
from test_pipeline import TINY
from test_tokenizer import build_assets
from test_torch_checkpoint import assert_trees_equal
from test_torch_models import close_scaled
from test_torch_ops import port_config, tt

torch.set_num_threads(1)

TINY_XL = PipelineConfig(
    name="test/tiny-xl",
    clip=CLIPConfig(vocab_size=1024, hidden_size=16, intermediate_size=32, num_layers=2,
                    num_heads=2, max_length=12, use_final_layer_norm_output=False),
    clip_2=CLIPConfig(vocab_size=1024, hidden_size=32, intermediate_size=64, num_layers=2,
                      num_heads=2, max_length=12, use_final_layer_norm_output=False,
                      projection_dim=32),
    unet=UNetConfig(
        block_out_channels=(32, 64), layers_per_block=1, attention_levels=(False, True),
        transformer_layers_per_block=(1, 2),
        num_attention_heads=0,  # head_dim 64: one head at 64 channels
        cross_attention_dim=16 + 32, mid_block=True, norm_num_groups=8,
        addition_embed_dim=32 + 6 * 8,  # pooled 32 + 6 time ids x 8
        addition_time_embed_dim=8,
    ),
    vae=VAEConfig(block_out_channels=(8, 16, 16), layers_per_block=1, norm_num_groups=8,
                  scaling_factor=0.13025),
    scheduler=SchedulerConfig(),
    default_image_size=64,  # latents 16x16, the 64-channel level at 8x8
    compute_dtype=jnp.float32,
    param_dtype=jnp.float32,
)
TINY_REFINER = TINY_XL.replace(
    name="test/tiny-xl-refiner",
    clip=None,  # bigG only, as the published refiner
    clip_2=dataclasses.replace(TINY_XL.clip_2, hidden_size=48, projection_dim=48),
    unet=dataclasses.replace(TINY_XL.unet, cross_attention_dim=48,
                             addition_embed_dim=48 + 5 * 8),  # 5 ids: an aesthetic score
    requires_aesthetics_score=True,
)
TINY_TURBO = TINY_XL.replace(name="test/tiny-xl-turbo", default_cfg=False,
                             default_sampler="euler", default_steps=2)
TINY_LCM = TINY.replace(
    name="test/tiny-lcm", unet=dataclasses.replace(TINY.unet, time_cond_proj_dim=32),
    default_cfg=False, default_sampler="lcm", default_steps=4, default_cfg_scale=8.0)
TINY_XL_INPAINT = TINY_XL.replace(name="test/tiny-xl-inpaint",
                                  unet=dataclasses.replace(TINY_XL.unet, in_channels=9))
CONFIGS = {"xl": TINY_XL, "refiner": TINY_REFINER, "lcm": TINY_LCM,
           "xl-inpaint": TINY_XL_INPAINT}

RNG = np.random.default_rng(14)
INIT = RNG.integers(0, 256, (64, 64, 3), dtype=np.uint8)
MASK = np.zeros((64, 64), np.uint8)
MASK[:, 32:] = 255
IDS = np.array([[1, 9, 200, 3] + [0] * 8, [1, 2] + [0] * 10])
BIDS = np.array([[1, 9, 200, 3] + [0] * 8, [1, 7, 7, 7, 3] + [0] * 7, [1, 40] + [0] * 10])


def port_of(jax_pipe, config, tokenizer=None):
    return StableDiffusionPipeline.from_params(
        port_config(config), jax.tree.map(np.asarray, jax_pipe.params), device="cpu",
        tokenizer=tokenizer)


@pytest.fixture(scope="module")
def jpipes():
    return {k: JaxPipeline.from_random(c, seed=0, tokenizer=None) for k, c in CONFIGS.items()}


@pytest.fixture(scope="module")
def tpipes(jpipes):
    return {k: port_of(jpipes[k], CONFIGS[k]) for k in CONFIGS}


def both(jpipes, tpipes, name, method, *args, **kw):
    want = getattr(jpipes[name], method)(*args, **kw)
    got = getattr(tpipes[name], method)(*args, **kw)
    return got, want


@pytest.fixture
def kernel_calls(monkeypatch):
    """Count the calls of the wrappers of kernels A/B (the slab conv and its
    upsample mode) and C (flash attention), at every site ``chip_smoke.py``
    records them."""
    import sdtpu_torch.kernels.conv2d as kconv
    import sdtpu_torch.ops.conv as conv

    # sdtpu_torch.ops re-exports a function named like its submodule
    attn = sys.modules["sdtpu_torch.ops.attention"]
    calls = {"conv3x3_slab": 0, "conv3x3_slab_upsample": 0, "flash_attention": 0}
    slab, flash = kconv.conv3x3_slab, attn.flash_attention_packed

    def slab_shim(*a, **kw):
        calls["conv3x3_slab_upsample" if kw.get("upsample") else "conv3x3_slab"] += 1
        return slab(*a, **kw)

    def flash_shim(*a):
        calls["flash_attention"] += 1
        return flash(*a)

    for mod in (kconv, conv):
        monkeypatch.setattr(mod, "conv3x3_slab", slab_shim)
    monkeypatch.setattr(attn, "flash_attention_packed", flash_shim)
    return calls


# ---------------------------------------------------------------- params --

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_pipeline_params_equal_the_jax_packages(name):
    """clip_2 from the fifth key, no clip for the refiner, cond_proj and
    add_embedding in the JAX package's key order: every leaf bitwise; the
    zero tree has the same paths, shapes and dtypes."""
    cfg = CONFIGS[name]
    got = init_pipeline_params(3, port_config(cfg), device="cpu")
    want = jax.tree.map(np.asarray, jax_init(3, cfg))
    assert_trees_equal(got, want)
    assert ("clip" in got) == (cfg.clip is not None)
    assert ("clip_2" in got) == (cfg.clip_2 is not None)
    assert ("add_embedding" in got["unet"]) == (name != "lcm")
    assert got["unet"]["conv_in"]["kernel"].shape[2] == cfg.unet.in_channels
    assert ("cond_proj" in got["unet"]["time_embedding"]) == (name == "lcm")
    zeros = zero_pipeline_params(port_config(cfg), device="cpu")
    assert_trees_equal(zeros, jax.tree.map(np.zeros_like, want))


@pytest.mark.parametrize("name", ["xl", "refiner", "lcm"])
def test_init_unet_equals_the_jax_packages(name):
    ucfg = CONFIGS[name].unet
    assert_trees_equal(tunet.init_unet(11, port_config(ucfg)),
                       jax.tree.map(np.asarray, junet.init_unet(11, ucfg)))


# ---------------------------------------------------------- time embedding --

def _conditioning(name, batch, seed=0):
    """Seeded ``added_cond`` / ``timestep_cond`` for a config, as numpy."""
    rng = np.random.default_rng(seed)
    ucfg = CONFIGS[name].unet
    added = tcond = None
    if ucfg.addition_embed_dim is not None:
        n_ids = 5 if CONFIGS[name].requires_aesthetics_score else 6
        pooled = ucfg.addition_embed_dim - n_ids * ucfg.addition_time_embed_dim
        ids = np.tile(np.asarray([64, 64, 0, 0, 64, 64][:n_ids], np.float32), (batch, 1))
        ids[:, -1] = rng.uniform(1.0, 9.0, batch)  # a score or a size per row
        added = {"text_embeds": rng.standard_normal((batch, pooled)).astype(np.float32),
                 "time_ids": ids}
    if ucfg.time_cond_proj_dim is not None:
        tcond = rng.standard_normal((batch, ucfg.time_cond_proj_dim)).astype(np.float32)
    return added, tcond


def _jt(added, tcond, conv):
    return (None if added is None else {k: conv(v) for k, v in added.items()},
            None if tcond is None else conv(tcond))


@pytest.mark.parametrize("name", ["xl", "refiner", "lcm"])
def test_time_embedding_and_projections_match_jax(jpipes, tpipes, name):
    """compute_time_embedding (one step) and precompute_time_projections
    (every step) with the add-embedding and the guidance embedding."""
    cfg = CONFIGS[name]
    jp, tp = jpipes[name].params["unet"], tpipes[name].params["unet"]
    added, tcond = _conditioning(name, 3)
    ja, jc = _jt(added, tcond, jnp.asarray)
    ta, tc = _jt(added, tcond, tt)
    ts = np.asarray([981.0, 501.0, 21.0], np.float32)
    got = tunet.compute_time_embedding(tt(ts), tp, port_config(cfg.unet), batch=3,
                                       dtype=torch.float32, timestep_cond=tc, added_cond=ta)
    want = junet.compute_time_embedding(jnp.asarray(ts), jp, cfg.unet, batch=3,
                                        dtype=jnp.float32, timestep_cond=jc, added_cond=ja)
    close_scaled(got, want)
    steps = np.asarray([999, 666, 333, 0], np.int32)
    got = tunet.precompute_time_projections(torch.from_numpy(steps), tp, port_config(cfg.unet),
                                            batch=3, timestep_cond=tc, added_cond=ta,
                                            dtype=torch.float32)
    want = junet.precompute_time_projections(jnp.asarray(steps), jp, cfg.unet, batch=3,
                                             timestep_cond=jc, added_cond=ja,
                                             dtype=jnp.float32)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jax.tree.map(np.asarray, want))):
        close_scaled(g, w)
    with pytest.raises(ValueError, match="requires"):
        tunet.compute_time_embedding(tt(ts), tp, port_config(cfg.unet), batch=3,
                                     dtype=torch.float32)


@pytest.mark.parametrize("name", ["xl", "refiner", "lcm"])
def test_unet_forward_matches_jax(jpipes, tpipes, name, kernel_calls):
    cfg = CONFIGS[name]
    rng = np.random.default_rng(5)
    lat = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 12, cfg.unet.cross_attention_dim)).astype(np.float32)
    ts = np.asarray([901.0, 11.0], np.float32)
    added, tcond = _conditioning(name, 2, seed=1)
    ja, jc = _jt(added, tcond, jnp.asarray)
    ta, tc = _jt(added, tcond, tt)
    got = tunet.unet_forward(tt(lat), tt(ts), tt(ctx), tpipes[name].params["unet"],
                             port_config(cfg.unet), added_cond=ta, timestep_cond=tc)
    want = junet.unet_forward(jnp.asarray(lat), jnp.asarray(ts), jnp.asarray(ctx),
                              jpipes[name].params["unet"], cfg.unet, added_cond=ja,
                              timestep_cond=jc)
    close_scaled(got, want)
    if name != "lcm":  # the 64-channel level: A (mid block, up level), B, C
        # A: 2 mid + 2 up resnets x 2 convs; C: 8 transformer blocks' self-attention
        assert kernel_calls == {"conv3x3_slab": 8, "conv3x3_slab_upsample": 1,
                                "flash_attention": 8}, kernel_calls


# -------------------------------------------------------------- requests --

def test_sdxl_generate_with_cfg_matches_jax(jpipes, tpipes, kernel_calls):
    # 2 steps: the from_pretrained test's JAX program (one compile for both)
    got, want = both(jpipes, tpipes, "xl", "generate", "x", token_ids=IDS,
                     num_inference_steps=2, seed=4)
    assert got.shape == (1, 64, 64, 3) and got.dtype == np.uint8
    assert_images_match(got, want)
    assert kernel_calls["conv3x3_slab"] and kernel_calls["conv3x3_slab_upsample"]
    assert kernel_calls["flash_attention"]


def test_sdxl_euler_without_cfg_matches_jax(jpipes, tpipes):
    """SDXL-Turbo's request: Euler, no CFG, one cond row."""
    got, want = both(jpipes, tpipes, "xl", "generate", "x", token_ids=IDS[:1],
                     num_inference_steps=2, seed=7, cfg=False, sampler="euler")
    assert_images_match(got, want)


def test_sdxl_context_and_added_cond(tpipes):
    """CLIP-L's (16) and bigG's (32) penultimate states side by side, bigG's
    pooled projection and [size, size, 0, 0, size, size] on every row."""
    pipe = tpipes["xl"]
    ctx, added = pipe._encode(IDS, 0, size=48, cfg=True)
    assert tuple(ctx.shape) == (2, 12, 48)
    assert tuple(added["text_embeds"].shape) == (2, 32)
    np.testing.assert_array_equal(added["time_ids"].numpy(), [[48, 48, 0, 0, 48, 48]] * 2)


def test_refiner_aesthetic_rows_and_image_match_jax(jpipes, tpipes):
    """bigG alone (context 48) and five time ids: the score 6.0 on the cond
    rows, 2.5 on the uncond rows; without CFG the cond score only."""
    pipe = tpipes["refiner"]
    ctx, added = pipe._encode(IDS, 0, size=64, cfg=True)
    assert tuple(ctx.shape) == (2, 12, 48)
    np.testing.assert_array_equal(added["time_ids"].numpy(),
                                  [[64, 64, 0, 0, 6.0], [64, 64, 0, 0, 2.5]])
    _, added = pipe._encode(IDS[:1], 0, size=64, cfg=False)
    np.testing.assert_array_equal(added["time_ids"].numpy(), [[64, 64, 0, 0, 6.0]])
    got, want = both(jpipes, tpipes, "refiner", "generate", "x", token_ids=IDS,
                     num_inference_steps=2, seed=1)
    assert_images_match(got, want)
    # the negative score reaches only the uncond rows (JAX test_refiner's check)
    other = StableDiffusionPipeline(
        pipe.config.replace(default_negative_aesthetic_score=-50.0), pipe.params, device="cpu")
    kw = dict(token_ids=IDS, num_inference_steps=2, seed=1)
    assert np.abs(other.generate("x", **kw).astype(int) - got.astype(int)).max() > 0
    kw.update(token_ids=IDS[:1], cfg=False)
    np.testing.assert_array_equal(other.generate("x", **kw), pipe.generate("x", **kw))


@pytest.mark.parametrize("name,kw", [
    ("refiner", dict(init_image=INIT, strength=0.5)),  # the refiner's img2img mode
    ("xl-inpaint", dict(init_image=INIT, mask_image=MASK, strength=1.0)),  # 9 channels
])
def test_image_conditioned_sdxl_requests_match_jax(jpipes, tpipes, name, kw):
    got, want = both(jpipes, tpipes, name, "generate", "x", token_ids=IDS,
                     num_inference_steps=3, seed=2, **kw)
    assert got.shape == (1, 64, 64, 3)
    assert_images_match(got, want)


@pytest.mark.parametrize("sampler", ["euler", "ddpm"])
def test_base_to_refiner_handoff_matches_jax(jpipes, tpipes, sampler):
    """The base runs the head to 0.8 and returns its carry; the refiner
    takes it as it is (no init_sigma) and runs the tail; DDPM draws each
    side's step noise from its own request's keys."""
    kw = dict(token_ids=IDS, num_inference_steps=5, seed=7, sampler=sampler)
    got, want = both(jpipes, tpipes, "xl", "generate", "x", denoising_end=0.8,
                     output="latents", **kw)
    close_scaled(got, want)
    img, img_j = both(jpipes, tpipes, "refiner", "generate", "x", latents=want,
                      denoising_start=0.8, **kw)
    assert img.shape == (1, 64, 64, 3)
    assert_images_match(img, img_j)


@pytest.mark.parametrize("sampler", ["ddim", "euler"])
def test_split_run_equals_the_unsplit_run(tpipes, sampler):
    """One model, a deterministic sampler: the head then the tail from its
    carry equals the unsplit run (JAX test_refiner's pin on the handoff)."""
    pipe = tpipes["xl"]
    kw = dict(token_ids=IDS, num_inference_steps=4, seed=5, sampler=sampler, output="latents")
    full = pipe.generate("x", **kw)
    head = pipe.generate("x", denoising_end=0.5, **kw)
    assert np.abs(head - full).max() > 1e-3  # the head is still noisy
    tail = pipe.generate("x", latents=head, denoising_start=0.5, **kw)
    np.testing.assert_allclose(tail, full, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(denoising_start=0.5),
    dict(denoising_start=1.0, latents=np.zeros((1, 16, 16, 4), np.float32)),
    dict(denoising_end=0.0),
    dict(denoising_end=0.5, num_images=2),
    dict(denoising_end=0.001),  # leaves no steps to run
])
def test_denoising_checks_and_messages_equal_the_jax_packages(jpipes, tpipes, kw):
    def message(pipe):
        with pytest.raises(ValueError) as e:
            pipe.generate("x", token_ids=IDS, num_inference_steps=4, **kw)
        return str(e.value)

    assert message(tpipes["xl"]) == message(jpipes["xl"])


def test_lcm_image_matches_jax(jpipes, tpipes):
    """The guidance scale as an embedding ((8 - 1) * 1000 through the
    sinusoid and cond_proj), 4 LCM steps, UNet batch 1."""
    got, want = both(jpipes, tpipes, "lcm", "generate", "x", token_ids=IDS[:1],
                     num_inference_steps=4, seed=0, cfg_scale=8.0)
    assert got.shape == (1, 32, 32, 3)
    assert_images_match(got, want)
    other = tpipes["lcm"].generate("x", token_ids=IDS[:1], num_inference_steps=4, seed=0,
                                   cfg_scale=2.0)
    assert np.abs(other.astype(int) - got.astype(int)).max() > 0


def test_lcm_guidance_embedding_equals_jax():
    from sdtpu_torch.ops.embedding import timestep_embedding

    w = (np.float32(8.0) - np.float32(1.0)) * np.float32(1000.0)
    got = timestep_embedding(torch.full((3,), float(w)), 32, flip_sin_to_cos=False,
                             freq_shift=1.0)
    want = jax_timestep_embedding(jnp.broadcast_to((jnp.float32(8.0) - 1.0) * 1000.0, (3,)),
                                  32, flip_sin_to_cos=False, freq_shift=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["xl", "refiner"])
def test_generate_batch_with_per_request_keys_matches_jax(jpipes, tpipes, name):
    got, want = both(jpipes, tpipes, name, "generate_batch", ["x"] * 3, token_ids=BIDS,
                     seeds=[3, 9, 27], num_inference_steps=2)
    assert got.shape == (3, 64, 64, 3)
    assert_images_match(got, want)
    solo = tpipes[name].generate_batch(["x"], token_ids=BIDS[1:2], seeds=[9],
                                       num_inference_steps=2)
    np.testing.assert_array_equal(got[1], solo[0])


def _turbo_requests():
    return [dict(token_ids=BIDS[i % 3], seed=50 + i, num_inference_steps=2, cfg=False,
                 sampler="euler") for i in range(5)]


def _serve(engine_cls, pipe, reqs):
    engine = engine_cls(pipe, max_batch_size=4, max_wait_ms=100)
    try:
        futs = [engine.submit("x", **r) for r in reqs]
        out = [f.result(timeout=300) for f in futs]
        stats = engine.stats()
    finally:
        engine.shutdown()
    return out, stats


def test_sdxl_turbo_rows_through_the_engine_equal_their_solo_rows(jpipes, tpipes):
    """BASELINE.json's few-step serving: Euler without CFG through the
    ServingEngine; every row within one level of its solo row (a one-row
    request's (1, P) add-embedding matmuls round otherwise than a batch's
    on the CPU) and of the JAX package's engine."""
    turbo = StableDiffusionPipeline(port_config(TINY_TURBO), tpipes["xl"].params, device="cpu")
    jturbo = JaxPipeline(TINY_TURBO, jpipes["xl"].params)
    assert turbo.warmup(image_sizes=(64,), step_counts=(2,), batch_sizes=(2,), cfg=False,
                        sampler="euler") == 1
    reqs = _turbo_requests()
    served, stats = _serve(ServingEngine, turbo, reqs)
    assert stats["requests"] == 5 and stats["failures"] == 0 and stats["batches"] >= 2
    for r, img in zip(reqs, served):
        solo = turbo.generate_batch(["x"], token_ids=r["token_ids"][None], seeds=[r["seed"]],
                                    num_inference_steps=2, cfg=False, sampler="euler")
        assert_images_match(img, solo[0])
    j_served, _ = _serve(JaxEngine, jturbo, reqs)
    for got, want in zip(served, j_served):
        assert_images_match(got, want)


def test_sdxl_num_images_and_generate_async(jpipes, tpipes):
    got, want = both(jpipes, tpipes, "xl", "generate", "x", token_ids=IDS,
                     num_inference_steps=2, seed=11, num_images=2)
    assert got.shape == (2, 64, 64, 3)
    assert_images_match(got, want)
    pending = tpipes["xl"].generate_async(token_ids=IDS, num_inference_steps=2, seed=11)
    one = tpipes["xl"].generate(token_ids=IDS, num_inference_steps=2, seed=11)
    np.testing.assert_array_equal(pending.result(), one)


# ------------------------------------------------------ tokenizer padding --

@pytest.fixture(scope="module")
def tok_files(tmp_path_factory):
    return build_assets(tmp_path_factory.mktemp("xl_tok"))


def test_both_encoders_take_the_same_eos_padded_ids(jpipes, tpipes, tok_files, monkeypatch):
    """The JAX package feeds bigG the same EOS-padded rows as CLIP-L
    (where the published tokenizer_2 pads with id 0): the port records the
    ids each encoder gets, and they are the JAX package's rows."""
    import sdtpu_torch.pipeline.pipeline as tpl

    jtok, ttok = JaxTokenizer.from_files(*tok_files), CLIPTokenizer.from_files(*tok_files)
    pipe = StableDiffusionPipeline(tpipes["xl"].config, tpipes["xl"].params, ttok, device="cpu")
    jpipe = JaxPipeline(TINY_XL, jpipes["xl"].params, jtok)
    seen = []
    real = tpl.clip_encode_windows

    def spy(ids, params, config, **kw):
        seen.append((config.hidden_size, ids.numpy().copy()))
        return real(ids, params, config, **kw)

    monkeypatch.setattr(tpl, "clip_encode_windows", spy)
    pipe.generate("a cat", "blurry", num_inference_steps=1, seed=0)
    want = np.asarray(jpipe._tokenize("a cat", "blurry", True, None))
    assert [h for h, _ in seen] == [16, 32]
    for _, ids in seen:
        np.testing.assert_array_equal(ids, want)
    eos = ttok.eos_id
    assert (want[:, -1] == eos).all() and not (want == 0).any()


# ----------------------------------------------------------- calibration --

def test_calibrate_pipeline_act_ranges_matches_jax(jpipes, tpipes, monkeypatch):
    """Both encoders, the pooled embedding and 6 time ids into the replay:
    the same fixed latents through both packages' calibration."""
    lat = np.random.default_rng(2).standard_normal((2, 16, 16, 4)).astype(np.float32)

    def fixed(conv):
        def samples(params, config, sched, *, context, latent_size, num_steps, seed,
                    added_cond=None):
            for t in (901.0, 301.0):
                yield conv(lat), conv(np.full((2,), t, np.float32)), context
        return samples

    monkeypatch.setattr(tcal, "collect_unet_samples", fixed(tt))
    monkeypatch.setattr(jcal, "collect_unet_samples", fixed(jnp.asarray))
    got = tcal.calibrate_pipeline_act_ranges(tpipes["xl"], IDS, image_size=64)
    want = jcal.calibrate_pipeline_act_ranges(jpipes["xl"], IDS, image_size=64)
    assert sorted(got) == sorted(want) and len(got) == 8 * 3  # 8 blocks x 3 sites
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["xl", "refiner"])
def test_calibrate_then_quantize_generates(tpipes, name):
    pipe = tpipes[name]
    ranges = tcal.calibrate_pipeline_act_ranges(pipe, IDS, num_steps=2)
    q = StableDiffusionPipeline(pipe.config, pipe.params, device="cpu")
    q.quantize_int8(transformer="full", act_ranges=ranges, vae=False)
    img = q.generate("x", token_ids=IDS, num_inference_steps=2, seed=0)
    assert img.shape == (1, 64, 64, 3) and img.std() > 0


# ------------------------------------------------------------ checkpoints --

def _write_clip2(dirpath, config, seed):
    """A bigG-style text encoder with its text_projection."""
    from sdtpu.models.clip import init_clip

    params = init_clip(seed, config)
    sd = {"text_model.embeddings.token_embedding.weight":
          np.asarray(params["token_embedding"]["weight"], np.float32),
          "text_model.embeddings.position_embedding.weight":
          np.asarray(params["position_embedding"], np.float32)}
    for i in range(config.num_layers):
        layer = jax.tree.map(lambda x: x[i], params["layers"])
        p = f"text_model.encoder.layers.{i}"
        _norm(sd, f"{p}.layer_norm1", layer["norm1"])
        for name, key in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                          ("out_proj", "out")):
            _lin(sd, f"{p}.self_attn.{name}", layer["attn"][key])
        _norm(sd, f"{p}.layer_norm2", layer["norm2"])
        _lin(sd, f"{p}.mlp.fc1", layer["mlp"]["fc1"])
        _lin(sd, f"{p}.mlp.fc2", layer["mlp"]["fc2"])
    _norm(sd, "text_model.final_layer_norm", params["final_norm"])
    _lin(sd, "text_projection", params["text_projection"])
    dirpath.mkdir(parents=True)
    save_file(sd, str(dirpath / "model.safetensors"))


@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory):
    """Tiny SDXL base and refiner directories in diffusers' layout (the
    refiner with text_encoder_2 and tokenizer_2 only), named after presets
    registered by the tests."""
    root = tmp_path_factory.mktemp("xl_ckpt")
    dirs = {}
    for name, cfg in (("xl", TINY_XL), ("refiner", TINY_REFINER)):
        d = root / f"test-ckpt-{name}"
        if cfg.clip is not None:
            _write_clip(d / "text_encoder", cfg.clip)
        _write_clip2(d / "text_encoder_2", cfg.clip_2, 7)
        _write_unet(d / "unet", cfg.unet)
        _write_vae(d / "vae", cfg.vae)
        build_assets(d / ("tokenizer" if cfg.clip is not None else "tokenizer_2"))
        dirs[name] = d
    return dirs


@pytest.fixture
def ckpt_presets(monkeypatch):
    for name, cfg in (("xl", TINY_XL), ("refiner", TINY_REFINER)):
        monkeypatch.setitem(jcfg.PRESETS, f"test-ckpt-{name}", cfg)
        monkeypatch.setitem(tcfg.PRESETS, f"test-ckpt-{name}", port_config(cfg))


@pytest.mark.parametrize("name", ["xl", "refiner"])
def test_from_pretrained_equals_the_jax_packages(ckpt_dirs, ckpt_presets, name):
    """Leaves bitwise against sdtpu's loader (text_encoder skipped for the
    refiner, text_encoder_2 read), the tokenizer from tokenizer/ or
    tokenizer_2/, and the image within one level."""
    d = str(ckpt_dirs[name])
    got = StableDiffusionPipeline.from_pretrained(d, device="cpu")
    want = JaxPipeline.from_pretrained(d)
    assert got.config == port_config(want.config)
    assert_trees_equal(got.params, jax.tree.map(np.asarray, jax_load(d, want.config)))
    assert got.tokenizer is not None and got.tokenizer.vocab == want.tokenizer.vocab
    a = got.generate("hello world", num_inference_steps=2, seed=3)
    b = want.generate("hello world", num_inference_steps=2, seed=3)
    assert_images_match(a, b)


@pytest.mark.parametrize("name", ["xl", "refiner"])
def test_validate_checkpoint_holds_the_sdxl_unet_to_the_mirror(ckpt_dirs, ckpt_presets, name,
                                                                capsys):
    """The synthesized pooled embedding and time ids (6, or 5 for the
    refiner) into the port's UNet and the mirror's: every network within
    1e-3 in float32."""
    from sdtpu_torch.tools import validate_checkpoint

    inputs = validate_checkpoint.make_inputs(port_config(CONFIGS[name]), latent=8, batch=2,
                                             image=16)
    assert inputs["time_ids"].shape == (2, 5 if name == "refiner" else 6)
    errs = validate_checkpoint.main([str(ckpt_dirs[name]), "--preset", f"test-ckpt-{name}",
                                     "--device", "cpu", "--latent", "16", "--batch", "2",
                                     "--image", "16"])
    out = capsys.readouterr().out
    assert "key mismatch" not in out and out.count(" OK") == 3, out
    assert all(errs[n]["rel_l2"] < 1e-3 for n in validate_checkpoint.NETWORKS), errs


# ---------------------------------------------------------- entry points --

@pytest.fixture
def cli_presets(monkeypatch):
    for cfg in (TINY_XL, TINY_REFINER, TINY_TURBO, TINY_LCM):
        monkeypatch.setitem(tcfg.PRESETS, cfg.name, port_config(cfg))


@pytest.mark.parametrize("argv", [
    ["--preset", "test/tiny-xl", "--steps", "2"],
    ["--preset", "test/tiny-xl-turbo", "--batch", "2"],
    ["--preset", "test/tiny-xl-refiner", "--steps", "2"],
    ["--preset", "test/tiny-lcm"],
])
def test_bench_presets_on_the_cpu(cli_presets, capsys, argv):
    from sdtpu_torch import bench

    line = bench.main([*argv, "--repeats", "1", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == line
    assert line["value"] > 0 and line["device"] == "cpu" and line["mfu_pct"] is None
    assert line["program_tflops"] >= 0 and argv[1] in line["metric"]


def test_demo_refiner_on_the_cpu(cli_presets, tmp_path, capsys):
    from sdtpu_torch import demo
    from sdtpu_torch.utils.image import read_png

    out = str(tmp_path / "out.png")
    demo.main(["--preset", "test/tiny-xl", "--refiner", "test/tiny-xl-refiner",
               "--denoising-split", "0.6", "--steps", "3", "--sampler", "euler",
               "--device", "cpu", "--out", out])
    assert read_png(out).shape == (64, 64, 3)
    text = capsys.readouterr().out
    assert "refiner preset test/tiny-xl-refiner: random weights" in text and "wrote" in text
