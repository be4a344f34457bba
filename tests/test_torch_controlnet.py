"""The port's ControlNet against the JAX package on the CPU: the seeded tree
and the diffusers state-dict loader (leaves bitwise), the cond embedding,
``controlnet_forward`` at the tiny, SD-1.5 (mid block) and SDXL
(micro-conditioning) topologies with non-zero zero convs, the UNet with
``control=``, the caches over a tree with no up blocks, and the pipeline:
single and multi-ControlNet images, with img2img, the 9-channel inpaint
UNet, ``generate_batch`` and the ServingEngine, every check's message, and
the bench and demo entry points.

Float32 values are held within 1e-5 (``test_torch_models.close_scaled``),
images within one uint8 level (``conftest.assert_images_match``).  The JAX
package runs its CPU program (``xla`` convolutions, dense attention); the
port its kernel route, whose wrappers take their plain versions on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

import sdtpu.models.controlnet as jcn
import sdtpu.models.unet as junet
import sdtpu.utils.weights as jweights
import sdtpu_torch.config as tcfg
import sdtpu_torch.models.controlnet as tcn
import sdtpu_torch.models.unet as tunet
import sdtpu_torch.utils.weights as tweights
from conftest import assert_images_match
from sdtpu.pipeline.pipeline import StableDiffusionPipeline as JaxPipeline
from sdtpu.pipeline.serving import ServingEngine as JaxEngine
from sdtpu_torch import StableDiffusionPipeline
from sdtpu_torch.pipeline.serving import ServingEngine
from test_pipeline import TINY, TOKENS
from test_torch_checkpoint import assert_trees_equal
from test_torch_models import close_scaled
from test_torch_ops import port_config, tt
from test_unet_full_golden import SD15_TOPO, SDXL_TOPO, TINY_TOPO
from torch_ref import RefControlNet, randomize_, state_dict_numpy

torch.set_num_threads(1)

COND_CHANNELS = (4, 8, 8, 16)   # a shrunk ladder with the 8x structure
COND_CHANNELS_4X = (4, 8, 16)   # TINY's VAE downscales 4x: one stride-2 pair fewer
TOPOS = {"tiny": TINY_TOPO, "sd15": SD15_TOPO, "sdxl": SDXL_TOPO}
TINY9 = TINY.replace(name="test/tiny-inpaint", unet=dataclasses.replace(TINY.unet, in_channels=9))
RNG = np.random.default_rng(15)
MAP_A = RNG.integers(0, 256, (32, 32, 3), dtype=np.uint8)
MAP_B = RNG.integers(0, 256, (40, 24), dtype=np.uint8)  # grey, resized
INIT = RNG.integers(0, 256, (32, 32, 3), dtype=np.uint8)
MASK = np.zeros((32, 32), np.uint8)
MASK[:, 16:] = 255
IDS2 = np.stack([TOKENS[0], TOKENS[0]])


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def ref_controlnet(cfg, seed):
    """A randomized diffusers-layout ControlNet (zero convs non-zero): its
    state dict and the JAX package's tree of it."""
    model = RefControlNet(cfg, cond_channels=COND_CHANNELS).eval()
    randomize_(model, seed=seed)
    sd = state_dict_numpy(model)
    return sd, jweights.controlnet_params_from_state_dict(sd, cfg)


def trained(cn, seed, scale=0.5):
    """A JAX ControlNet tree with seeded non-zero zero convs, as the JAX
    package's tests make one."""
    key = jax.random.key(seed)
    cn = dict(cn)
    cn["zero_convs"] = [{"kernel": scale * jax.random.normal(jax.random.fold_in(key, i),
                                                             zc["kernel"].shape),
                         "bias": zc["bias"]} for i, zc in enumerate(cn["zero_convs"])]
    return cn


def inputs(cfg, *, spatial=8, batch=2, ctx_len=7, seed=0):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((batch, spatial, spatial, cfg.in_channels)).astype(np.float32)
    ctx = rng.standard_normal((batch, ctx_len, cfg.cross_attention_dim)).astype(np.float32)
    cond = rng.uniform(0.0, 1.0, (batch, spatial * 8, spatial * 8, 3)).astype(np.float32)
    ts = np.linspace(900.0, 10.0, batch).astype(np.float32)
    added = None
    if cfg.addition_embed_dim is not None:
        pooled = cfg.addition_embed_dim - 6 * cfg.addition_time_embed_dim
        added = {"text_embeds": rng.standard_normal((batch, pooled)).astype(np.float32),
                 "time_ids": np.array([[512, 512, 0, 0, 512, 512],
                                       [768, 768, 10, 20, 512, 512]][:batch], np.float32)}
    return lat, ctx, cond, ts, added


def both_forward(cfg, cn_tree, lat, ctx, cond, ts, added, scale=0.8):
    """controlnet_forward in both packages on one tree; (port, jax)."""
    j_emb = jcn.controlnet_cond_embed(jnp.asarray(cond), cn_tree["cond_embedding"])
    jadd = None if added is None else {k: jnp.asarray(v) for k, v in added.items()}
    want = jcn.controlnet_forward(jnp.asarray(lat), jnp.asarray(ts), jnp.asarray(ctx), j_emb,
                                  cn_tree, cfg, conditioning_scale=scale, added_cond=jadd)
    tree = tweights.params_from_numpy(numpy_tree(cn_tree), device="cpu")
    tcfg_u = port_config(cfg)
    t_emb = tcn.controlnet_cond_embed(tt(cond), tree["cond_embedding"])
    tadd = None if added is None else {k: tt(v) for k, v in added.items()}
    got = tcn.controlnet_forward(tt(lat), tt(ts), tt(ctx), t_emb, tree, tcfg_u,
                                 conditioning_scale=scale, added_cond=tadd)
    return got, want


# ------------------------------------------------------------- the tree --

@pytest.mark.parametrize("name", sorted(TOPOS))
def test_init_controlnet_equals_jax_bitwise(name):
    """A seed gives the JAX package's tree: the encoder half of a whole base
    UNet drawn from the seed's first child, the zero convs and the cond
    embedding's conv_out zeros (SDXL's add_embedding carried over)."""
    cfg = TOPOS[name]
    want = jcn.init_controlnet(3, cfg, cond_channels=COND_CHANNELS)
    got = tcn.init_controlnet(3, port_config(cfg), cond_channels=COND_CHANNELS)
    assert_trees_equal(got, want)
    assert ("add_embedding" in got) == (cfg.addition_embed_dim is not None)
    assert ("zero_conv_mid" in got) == cfg.mid_block
    assert all(float(zc["kernel"].abs().max()) == 0.0 for zc in got["zero_convs"])


def test_init_controlnet_in_bf16_equals_jax_bitwise():
    want = jcn.init_controlnet(5, TINY_TOPO, dtype=jnp.bfloat16, cond_channels=COND_CHANNELS)
    got = tcn.init_controlnet(5, port_config(TINY_TOPO), dtype=torch.bfloat16,
                              cond_channels=COND_CHANNELS)
    assert_trees_equal(got, want)


@pytest.mark.parametrize("name", sorted(TOPOS))
def test_state_dict_loader_equals_jax_bitwise(name):
    """controlnet_params_from_state_dict on a diffusers ControlNetModel state
    dict, leaf by leaf, and the same structure as init_controlnet's."""
    cfg = TOPOS[name]
    sd, want = ref_controlnet(cfg, seed=4)
    got = tweights.controlnet_params_from_state_dict(sd, port_config(cfg))
    assert_trees_equal(got, want)
    inited = tcn.init_controlnet(0, port_config(cfg), cond_channels=COND_CHANNELS)
    assert jax.tree.structure(jax.tree.map(lambda a: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, inited))
    n_sd = sum(int(np.prod(v.shape)) for v in sd.values())
    assert n_sd == sum(int(t.numel()) for t in jax.tree.leaves(got))


def test_state_dict_loader_refuses_a_unet_state_dict():
    """A state dict with the encoder's keys and no zero convs raises the JAX
    loader's KeyError."""
    sd, _ = ref_controlnet(TINY_TOPO, seed=1)
    sd = {k: v for k, v in sd.items() if not k.startswith("controlnet_down_blocks")}
    with pytest.raises(KeyError, match="not a ControlNetModel"):
        jweights.controlnet_params_from_state_dict(sd, TINY_TOPO)
    with pytest.raises(KeyError, match="not a ControlNetModel"):
        tweights.controlnet_params_from_state_dict(sd, port_config(TINY_TOPO))


@pytest.mark.parametrize("as_dir", [False, True])
def test_load_controlnet_params_from_a_safetensors_file(tmp_path, as_dir):
    """The native reader on a written file (a directory finds its
    diffusion_pytorch_model.safetensors), against the JAX loader, in the
    pipeline's bf16 and kept as stored."""
    sd, _ = ref_controlnet(SD15_TOPO, seed=6)
    path = tmp_path / "diffusion_pytorch_model.safetensors"
    save_file(sd, str(path))
    where = str(tmp_path if as_dir else path)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (None, None)):
        want = jweights.load_controlnet_params(where, SD15_TOPO, dtype=jdt)
        got = tweights.load_controlnet_params(where, port_config(SD15_TOPO), dtype=tdt,
                                              device="cpu")
        assert_trees_equal(got, want)


def test_jax_tree_converts_leaf_by_leaf():
    """params_from_numpy on the JAX package's ControlNet tree keeps every
    leaf's dtype and bits (bf16 included); torch leaves pass through."""
    want = jcn.init_controlnet(2, SDXL_TOPO, dtype=jnp.bfloat16, cond_channels=COND_CHANNELS)
    got = tweights.params_from_numpy(numpy_tree(want), device="cpu")
    assert_trees_equal(got, want)
    assert_trees_equal(tweights.params_from_numpy(got, device="cpu"), want)


def test_zero_controlnet_params_have_the_init_tree():
    cfg = port_config(TINY)
    zeros = tweights.zero_controlnet_params(cfg, device="cpu")
    inited = tcn.init_controlnet(0, cfg.unet, dtype=cfg.param_dtype)
    z, i = jax.tree.leaves(zeros), jax.tree.leaves(inited)
    assert [tuple(a.shape) for a in z] == [tuple(a.shape) for a in i]
    assert all(float(a.abs().max()) == 0.0 for a in z)


# ------------------------------------------------------------ the model --

@pytest.mark.parametrize("name", sorted(TOPOS))
def test_precompute_caches_take_a_tree_without_up_blocks(name):
    """precompute_time_projections and precompute_cross_kv over a ControlNet
    tree (no up blocks), against the JAX package's."""
    cfg = TOPOS[name]
    _, tree = ref_controlnet(cfg, seed=7)
    lat, ctx, _, _, added = inputs(cfg)
    steps = np.array([900.0, 500.0, 20.0], np.float32)
    jadd = None if added is None else {k: jnp.asarray(v) for k, v in added.items()}
    tadd = None if added is None else {k: tt(v) for k, v in added.items()}
    want_t = junet.precompute_time_projections(jnp.asarray(steps), tree, cfg, batch=2,
                                               added_cond=jadd, dtype=jnp.float32)
    want_kv = junet.precompute_cross_kv(jnp.asarray(ctx), tree, cfg)
    ttree = tweights.params_from_numpy(numpy_tree(tree), device="cpu")
    got_t = tunet.precompute_time_projections(tt(steps), ttree, port_config(cfg), batch=2,
                                              added_cond=tadd, dtype=torch.float32)
    got_kv = tunet.precompute_cross_kv(tt(ctx), ttree, port_config(cfg))
    assert got_t["up"] == [] and got_kv["up"] == []
    for g, w in zip(jax.tree.leaves(got_t) + jax.tree.leaves(got_kv),
                    jax.tree.leaves(want_t) + jax.tree.leaves(want_kv)):
        close_scaled(g, w)


def test_cond_embed_matches_jax():
    """The conv ladder down 8x, with a non-zero conv_out."""
    _, tree = ref_controlnet(TINY_TOPO, seed=8)
    cond = np.random.default_rng(1).uniform(0, 1, (2, 64, 48, 3)).astype(np.float32)
    want = jcn.controlnet_cond_embed(jnp.asarray(cond), tree["cond_embedding"])
    ttree = tweights.params_from_numpy(numpy_tree(tree), device="cpu")
    got = tcn.controlnet_cond_embed(tt(cond), ttree["cond_embedding"])
    assert tuple(got.shape) == (2, 8, 6, TINY_TOPO.block_out_channels[0])
    assert float(np.abs(np.asarray(want)).max()) > 0.0
    close_scaled(got, want)


@pytest.mark.parametrize("name", sorted(TOPOS))
def test_controlnet_forward_matches_jax(name):
    """Every residual (one per saved skip, and the mid block's) of a
    randomized ControlNet, at the conditioning scale, in float32."""
    cfg = TOPOS[name]
    _, tree = ref_controlnet(cfg, seed=9)
    spatial = 16 if name == "sd15" else 8
    got, want = both_forward(cfg, tree, *inputs(cfg, spatial=spatial, seed=9))
    assert len(got["down"]) == len(want["down"])
    assert (got["mid"] is None) == (not cfg.mid_block)
    for g, w in zip(got["down"], want["down"]):
        assert float(np.abs(np.asarray(w)).max()) > 0.0
        close_scaled(g, w)
    if cfg.mid_block:
        close_scaled(got["mid"], want["mid"])


def test_controlnet_forward_refuses_a_grid_mismatch():
    tree = tcn.init_controlnet(0, port_config(TINY_TOPO), cond_channels=COND_CHANNELS_4X)
    lat, ctx, cond, ts, _ = inputs(TINY_TOPO)
    emb = tcn.controlnet_cond_embed(tt(cond), tree["cond_embedding"])  # 4x: 16x16 != 8x8
    with pytest.raises(ValueError, match="cond_embedding grid"):
        tcn.controlnet_forward(tt(lat), tt(ts), tt(ctx), emb, tree, port_config(TINY_TOPO))


@pytest.mark.parametrize("name", ["tiny", "sd15"])
def test_unet_forward_with_control_matches_jax(name):
    """The residuals go to the saved skips (never the running activation)
    and the mid output."""
    cfg = TOPOS[name]
    _, tree = ref_controlnet(cfg, seed=10)
    spatial = 16 if name == "sd15" else 8
    lat, ctx, cond, ts, added = inputs(cfg, spatial=spatial, seed=10)
    got_c, want_c = both_forward(cfg, tree, lat, ctx, cond, ts, added)
    unet = junet.init_unet(11, cfg)
    want = junet.unet_forward(jnp.asarray(lat), jnp.asarray(ts), jnp.asarray(ctx), unet, cfg,
                              control=want_c)
    tunet_p = tweights.params_from_numpy(numpy_tree(unet), device="cpu")
    got = tunet.unet_forward(tt(lat), tt(ts), tt(ctx), tunet_p, port_config(cfg), control=got_c)
    base = tunet.unet_forward(tt(lat), tt(ts), tt(ctx), tunet_p, port_config(cfg))
    assert float((got - base).abs().max()) > 1e-3
    close_scaled(got, want)


def test_fresh_controlnet_is_an_exact_no_op():
    """Zero convs: every residual is exactly 0 and the UNet's output is
    bitwise its output without them; the scale is linear in the residuals."""
    cfg = port_config(TINY_TOPO)
    tree = tcn.init_controlnet(0, cfg, cond_channels=COND_CHANNELS)
    lat, ctx, cond, ts, _ = inputs(TINY_TOPO)
    emb = tcn.controlnet_cond_embed(tt(cond), tree["cond_embedding"])
    ctrl = tcn.controlnet_forward(tt(lat), tt(ts), tt(ctx), emb, tree, cfg)
    assert ctrl["mid"] is None and all(float(r.abs().max()) == 0.0 for r in ctrl["down"])
    unet = tunet.init_unet(1, cfg)
    torch.testing.assert_close(
        tunet.unet_forward(tt(lat), tt(ts), tt(ctx), unet, cfg, control=ctrl),
        tunet.unet_forward(tt(lat), tt(ts), tt(ctx), unet, cfg), rtol=0, atol=0)
    _, jtree = ref_controlnet(TINY_TOPO, seed=12)
    tree = tweights.params_from_numpy(numpy_tree(jtree), device="cpu")
    emb = tcn.controlnet_cond_embed(tt(cond), tree["cond_embedding"])
    one = tcn.controlnet_forward(tt(lat), tt(ts), tt(ctx), emb, tree, cfg)
    half = tcn.controlnet_forward(tt(lat), tt(ts), tt(ctx), emb, tree, cfg,
                                  conditioning_scale=0.5)
    for a, b in zip(one["down"], half["down"]):
        torch.testing.assert_close(0.5 * a, b, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------- the pipeline --

def port_of(jax_pipe, config):
    return StableDiffusionPipeline.from_params(port_config(config), numpy_tree(jax_pipe.params),
                                               device="cpu")


@pytest.fixture(scope="module")
def nets():
    """Two ControlNets for TINY (4x ladder): a trained one and another."""
    a = trained(jcn.init_controlnet(7, TINY.unet, cond_channels=COND_CHANNELS_4X), 11)
    b = trained(jcn.init_controlnet(21, TINY.unet, cond_channels=COND_CHANNELS_4X), 22, 0.3)
    return a, b


@pytest.fixture(scope="module")
def pipes(nets):
    j = JaxPipeline.from_random(TINY, seed=0)
    t = port_of(j, TINY)
    j.load_controlnet(nets[0])
    t.load_controlnet(numpy_tree(nets[0]))
    return j, t


def both(pipes, method, *args, **kw):
    j, t = pipes
    return getattr(t, method)(*args, **kw), getattr(j, method)(*args, **kw)


def test_controlnet_image_matches_jax(pipes):
    kw = dict(token_ids=TOKENS, num_inference_steps=3, seed=3, control_image=MAP_A,
              controlnet_scale=0.7)
    got, want = both(pipes, "generate", "x", **kw)
    assert_images_match(got, want)
    j, t = pipes
    plain = t.generate("x", token_ids=TOKENS, num_inference_steps=3, seed=3)
    assert np.abs(got.astype(int) - plain.astype(int)).max() > 1
    # a grey map (nearest-resized, broadcast to 3 channels) and scale 0
    got, want = both(pipes, "generate", "x", token_ids=TOKENS, num_inference_steps=2, seed=4,
                     control_image=MAP_B, sampler="euler")
    assert_images_match(got, want)
    np.testing.assert_array_equal(
        t.generate("x", token_ids=TOKENS, num_inference_steps=3, seed=3, control_image=MAP_A,
                   controlnet_scale=0.0), plain)


def test_fresh_controlnet_gives_the_plain_image_bitwise(pipes):
    _, t = pipes
    saved = t.controlnet
    try:
        t.load_controlnet(tcn.init_controlnet(7, port_config(TINY).unet,
                                              cond_channels=COND_CHANNELS_4X))
        kw = dict(token_ids=TOKENS, num_inference_steps=2, seed=3)
        np.testing.assert_array_equal(t.generate("x", control_image=MAP_A, **kw),
                                      t.generate("x", **kw))
    finally:
        t.controlnet = saved


def test_multi_controlnet_matches_jax(pipes, nets):
    """Two nets, one map each, per-net scales: the residuals summed."""
    j, t = pipes
    try:
        j.load_controlnet(list(nets))
        t.load_controlnet([numpy_tree(n) for n in nets])
        got, want = both(pipes, "generate", "x", token_ids=TOKENS, num_inference_steps=3,
                         seed=3, control_image=[MAP_A, MAP_B], controlnet_scale=[1.0, 0.6])
        assert_images_match(got, want)
        got, want = both(pipes, "generate_batch", ["a", "b"], token_ids=IDS2,
                         num_inference_steps=2, seeds=[1, 2],
                         control_images=[[MAP_A, MAP_B], [MAP_B, MAP_A]],
                         controlnet_scale=[1.0, 0.6])
        assert got.shape == (2, 32, 32, 3)
        assert_images_match(got, want)
        for pipe in pipes:
            with pytest.raises(ValueError, match="one map per net"):
                pipe.generate("x", token_ids=TOKENS, num_inference_steps=1,
                              control_image=MAP_A)
            with pytest.raises(ValueError, match="controlnet_scale list"):
                pipe.generate("x", token_ids=TOKENS, num_inference_steps=1,
                              control_image=[MAP_A, MAP_B], controlnet_scale=[1.0])
    finally:
        j.load_controlnet(nets[0])
        t.load_controlnet(numpy_tree(nets[0]))


def test_controlnet_with_img2img_matches_jax(pipes):
    got, want = both(pipes, "generate", "x", token_ids=TOKENS, num_inference_steps=4, seed=2,
                     init_image=INIT, strength=0.5, control_image=MAP_A)
    assert_images_match(got, want)


def test_controlnet_with_generate_batch_matches_jax(pipes):
    got, want = both(pipes, "generate_batch", ["a", "b"], token_ids=IDS2,
                     num_inference_steps=2, seeds=[1, 2], control_images=[MAP_A, MAP_B],
                     controlnet_scale=0.8)
    assert_images_match(got, want)
    got, want = both(pipes, "generate", "x", token_ids=TOKENS, num_inference_steps=2, seed=6,
                     num_images=2, control_image=MAP_A)
    assert got.shape == (2, 32, 32, 3)
    assert_images_match(got, want)


def test_controlnet_reads_four_channels_under_the_inpaint_unet(nets):
    """The nets read the 4-channel latents while the 9-channel UNet takes
    the mask and the masked image's latents."""
    j = JaxPipeline.from_random(TINY9, seed=0)
    t = port_of(j, TINY9)
    j.load_controlnet(nets[0])
    t.load_controlnet(numpy_tree(nets[0]))
    got, want = both((j, t), "generate", "x", token_ids=TOKENS, num_inference_steps=2, seed=3,
                     init_image=INIT, mask_image=MASK, strength=1.0, control_image=MAP_A)
    assert_images_match(got, want)


def test_controlnet_through_the_engine_equals_direct(pipes):
    """Control requests coalesce per scale; each image equals its direct
    batch row (bitwise on the CPU) and a request without a map never shares
    their bucket."""
    _, t = pipes
    direct = t.generate_batch(["p"], token_ids=TOKENS[:1], num_inference_steps=2, seeds=[5],
                              control_images=[MAP_A], controlnet_scale=0.7)
    engine = ServingEngine(t, max_batch_size=2, max_wait_ms=50)
    try:
        fa = engine.submit("p", token_ids=TOKENS[0], seed=5, num_inference_steps=2,
                           image_size=32, control_image=MAP_A, controlnet_scale=0.7)
        fb = engine.submit("p", token_ids=TOKENS[0], seed=6, num_inference_steps=2,
                           image_size=32, control_image=MAP_B, controlnet_scale=0.7)
        a, b = fa.result(300), fb.result(300)
        engine.submit("p", token_ids=TOKENS[0], seed=5, num_inference_steps=2,
                      image_size=32).result(300)
        stats = engine.stats()
    finally:
        engine.shutdown()
    np.testing.assert_array_equal(a, direct[0])
    assert (a != b).any() and stats["batches"] >= 2


def test_controlnet_checks_raise_the_jax_messages(tiny_pipe):
    """Each misuse raises the JAX package's ValueError with its message, in
    both packages."""
    j = tiny_pipe
    t = port_of(j, TINY)
    ctrl = np.zeros((32, 32, 3), np.uint8)
    cases = [
        ("generate", dict(control_image=ctrl), "load_controlnet"),
        ("generate_batch", dict(control_images=[ctrl, ctrl]), "load_controlnet"),
    ]
    for method, kw, match in cases:
        for pipe in (j, t):
            args = ("x",) if method == "generate" else (["x", "y"],)
            with pytest.raises(ValueError, match=match):
                getattr(pipe, method)(*args, token_ids=TOKENS if method == "generate" else IDS2,
                                      num_inference_steps=1, **kw)
    cn = jcn.init_controlnet(0, TINY.unet, cond_channels=COND_CHANNELS_4X)
    j.load_controlnet(cn)
    t.load_controlnet(numpy_tree(cn))
    try:
        for pipe in (j, t):
            with pytest.raises(ValueError, match="incompatible"):
                pipe.generate("x", token_ids=TOKENS, num_inference_steps=2, control_image=ctrl,
                              encoder_cache_interval=2)
            with pytest.raises(ValueError, match="control_images must match"):
                pipe.generate_batch(["x", "y"], token_ids=IDS2, num_inference_steps=1,
                                    control_images=[ctrl])
            with pytest.raises(ValueError, match=r"control image must be \(H, W"):
                pipe.generate("x", token_ids=TOKENS, num_inference_steps=1,
                              control_image=np.zeros((32, 32, 2), np.uint8))
        with pytest.raises(ValueError, match="incompatible with ControlNet"):
            t.denoise(torch.zeros(4, 5, 32), torch.zeros(2, 8, 8, 4), None,
                      tcfg_schedule(), cfg=True, cfg_scale=7.5, encoder_cache_interval=2,
                      control=[(t.controlnet, np.zeros((2, 32, 32, 3), np.float32), 1.0)])
    finally:
        j.controlnet = None
    for engine in (JaxEngine(j, max_batch_size=2), ServingEngine(t, max_batch_size=2)):
        engine.pipeline.controlnet = None
        try:
            with pytest.raises(ValueError, match="load_controlnet"):
                engine.submit("p", token_ids=TOKENS[0], image_size=32, num_inference_steps=1,
                              control_image=ctrl)
        finally:
            engine.shutdown()


def tcfg_schedule():
    from sdtpu_torch.samplers import get_sampler

    return get_sampler("ddim").make_schedule(port_config(TINY).scheduler, 2)


# ---------------------------------------------------------- entry points --

def test_bench_controlnet_line(monkeypatch, capsys):
    """``--controlnet``: a zero ControlNet of the preset's shapes and a
    seeded map; the JAX bench's variant name, no FLOP count."""
    from sdtpu_torch import bench

    # the default cond-embedding ladder downscales 8x: a VAE with four levels
    cfg = TINY.replace(vae=dataclasses.replace(TINY.vae, block_out_channels=(8, 16, 16, 16)))
    monkeypatch.setitem(tcfg.PRESETS, "test/tiny8x", port_config(cfg))
    line = bench.main(["--preset", "test/tiny8x", "--device", "cpu", "--steps", "2",
                       "--repeats", "1", "--controlnet", "--image-size", "64"])
    assert line["metric"] == "test/tiny8x 64x64 controlnet 2-step ddpm CFG images/sec/chip"
    assert line["value"] > 0 and line["mfu_pct"] is None and line["program_tflops"] is None
    line = bench.main(["--preset", "test/tiny8x", "--device", "cpu", "--steps", "2",
                       "--repeats", "1", "--controlnet", "--serving", "--requests", "2",
                       "--batch", "2", "--image-size", "64"])
    assert line["requests"] == 2
    capsys.readouterr()


def test_demo_controlnet_flags(tmp_path, monkeypatch, capsys):
    """``--controlnet`` reads a diffusers ControlNet file, ``--control-image``
    a PNG; two nets take two maps and two scales."""
    from sdtpu_torch import demo
    from sdtpu_torch.utils.image import read_png, save_png

    monkeypatch.setitem(tcfg.PRESETS, "test/tiny", port_config(TINY))
    model = RefControlNet(TINY.unet, cond_channels=COND_CHANNELS_4X).eval()
    randomize_(model, seed=3)
    cn = str(tmp_path / "cn.safetensors")
    save_file(state_dict_numpy(model), cn)
    ctrl = str(tmp_path / "ctrl.png")
    save_png(MAP_A, ctrl)
    out = str(tmp_path / "out.png")
    base = ["--preset", "test/tiny", "--device", "cpu", "--steps", "2", "--out", out]
    demo.main(base + ["--controlnet", cn, "--control-image", ctrl])
    assert read_png(out).shape == (32, 32, 3)
    demo.main(base + ["--controlnet", cn, "--control-image", ctrl, "--controlnet-scale", "0.5",
                      "--controlnet", cn, "--control-image", ctrl, "--controlnet-scale", "0.2"])
    assert "controlnet" in capsys.readouterr().out
    for flags in (["--control-image", ctrl], ["--controlnet", cn],
                  ["--controlnet", cn, "--control-image", ctrl, "--controlnet-scale", "1",
                   "--controlnet-scale", "2"]):
        with pytest.raises(SystemExit):
            demo.main(base + flags)
