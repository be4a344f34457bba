"""The port's checkpoint route against the JAX package's, on the CPU.

``config_from_checkpoint`` on every fixture of ``test_config_infer.py``;
the native and the plain safetensors readers against
``safetensors.numpy.load_file`` (bitwise, BF16 compared as bits), the
native library built into ``build/`` and ``native/`` left as it is; the
loaders' leaves against the JAX package's loaders on the same state dicts
(bitwise, float32, and bf16 through float32 from f32 and f16 files); the
loaded trees' forwards against ``torch_ref.py``'s mirror within the
tolerances of ``test_unet_full_golden.py`` / ``test_vae_full_golden.py``;
the VAE encoder against the JAX package's; ``from_pretrained`` on the
TINY_CKPT directory of ``test_from_pretrained.py`` (config, leaves, and
``generate(seed=...)`` within one uint8 level); the native tokenizer
against the port's ``bpe.py`` copy.  On a card (``gpu`` mark):
``from_pretrained(device="cuda")`` leaves equal the CPU load's.
"""

import json
import os
import pathlib
import struct

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

import sdtpu.config as jcfg
import sdtpu.models.vae as jvae
import sdtpu.utils.weights as jw
import sdtpu_torch.config as tcfg
import sdtpu_torch.models.vae as tvae
import sdtpu_torch.utils.weights as tw
import test_config_infer as fx
from conftest import assert_allclose, assert_images_match
from sdtpu.pipeline.pipeline import StableDiffusionPipeline as JaxPipeline
from sdtpu_torch import StableDiffusionPipeline
from sdtpu_torch.models.unet import unet_forward
from sdtpu_torch.tokenizer.bpe import CLIPTokenizer
from sdtpu_torch.tokenizer.native import NativeCLIPTokenizer
from sdtpu_torch.utils import native_safetensors as ns
from test_from_pretrained import TINY_CKPT, _write_clip, _write_unet, _write_vae
from test_pipeline import TINY
from test_tokenizer import PROMPTS, build_assets
from test_torch_ops import port_config
from torch_ref import RefAutoencoderKL, RefUNet, randomize_, state_dict_numpy

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
TCKPT = port_config(TINY_CKPT)


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def assert_trees_equal(got, want):
    """A port tree (tensors) against a JAX tree (arrays): keys, shapes,
    dtypes and bits."""
    g, w = list(leaves(got)), list(leaves(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        b = np.asarray(b)
        a = a.cpu()
        assert tuple(a.shape) == b.shape, path
        if b.dtype == ml_dtypes.bfloat16:
            assert a.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(a.view(torch.int16).numpy(), b.view(np.int16),
                                          err_msg=str(path))
        else:
            assert a.numpy().dtype == b.dtype, path
            np.testing.assert_array_equal(a.numpy(), b, err_msg=str(path))


# ---------------------------------------------------------------- configs --

KNOWN = {
    "sd15": dict(unet=fx.SD15_UNET, vae=fx.SD_VAE, sched=fx.SD15_SCHED, te=fx.SD15_TE),
    "sd21": dict(unet=fx.SD21_UNET, vae=fx.SD_VAE, sched=fx.SD21_SCHED, te=fx.SD21_TE),
    "sdxl": dict(unet=fx.SDXL_UNET, vae=fx.SDXL_VAE, sched=fx.SDXL_SCHED, te=fx.SD15_TE,
                 te2=fx.SDXL_TE2),
    "refiner": dict(unet=dict(fx.SDXL_UNET, block_out_channels=[384, 768, 1536, 1536],
                              attention_head_dim=[6, 12, 24, 24],
                              transformer_layers_per_block=[1, 4, 4, 4],
                              cross_attention_dim=1280,
                              down_block_types=["DownBlock2D", "CrossAttnDownBlock2D",
                                                "CrossAttnDownBlock2D", "DownBlock2D"],
                              projection_class_embeddings_input_dim=2560),
                    vae=fx.SDXL_VAE, sched=fx.SDXL_SCHED, te2=fx.SDXL_TE2),
    "lcm": dict(unet=dict(fx.SD15_UNET, time_cond_proj_dim=256), vae=fx.SD_VAE,
                sched=fx.SD15_SCHED, te=fx.SD15_TE),
    "inpaint": dict(unet=dict(fx.SD15_UNET, in_channels=9), vae=fx.SD_VAE,
                    sched=fx.SD15_SCHED, te=fx.SD15_TE),
    "no-scheduler-config": dict(unet=fx.SD15_UNET, vae=fx.SD_VAE, sched=fx.SD15_SCHED,
                                te=fx.SD15_TE),
}


@pytest.mark.parametrize("name", sorted(KNOWN))
def test_config_from_checkpoint_equals_the_jax_packages(tmp_path, name):
    d = fx._write_ckpt(str(tmp_path / f"{name}-like"), **KNOWN[name])
    if name == "no-scheduler-config":
        os.remove(os.path.join(d, "scheduler", "scheduler_config.json"))
    got = tcfg.config_from_checkpoint(d)
    assert got == port_config(jcfg.config_from_checkpoint(d))
    assert got.name == f"{name}-like"


@pytest.mark.parametrize("case", ["not-a-checkpoint", "no-text-encoder", "head-layout",
                                  "layers-per-block"])
def test_config_errors_equal_the_jax_packages(tmp_path, case):
    d = str(tmp_path / case)
    if case == "no-text-encoder":
        fx._write_ckpt(d, unet=fx.SD15_UNET, vae=fx.SD_VAE, sched=fx.SD15_SCHED)
    elif case == "head-layout":
        fx._write_ckpt(d, unet=dict(fx.SD15_UNET, attention_head_dim=[3, 7, 11, 13]),
                       vae=fx.SD_VAE, sched=fx.SD15_SCHED, te=fx.SD15_TE)
    elif case == "layers-per-block":
        fx._write_ckpt(d, unet=dict(fx.SD15_UNET, layers_per_block=[1, 2, 2, 2]),
                       vae=fx.SD_VAE, sched=fx.SD15_SCHED, te=fx.SD15_TE)
    with pytest.raises(ValueError) as want:
        jcfg.config_from_checkpoint(d)
    with pytest.raises(ValueError) as got:
        tcfg.config_from_checkpoint(d)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- readers --

def _all_dtypes():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.normal(size=(3, 5)).astype(np.float32),
        "f16": rng.normal(size=(4, 2, 3)).astype(np.float16),
        "bf16": rng.normal(size=(7,)).astype(ml_dtypes.bfloat16),
        "i64": rng.integers(-2**40, 2**40, (2, 3)),
        "i32": rng.integers(-9, 9, (5,)).astype(np.int32),
        "i16": rng.integers(-9, 9, (5,)).astype(np.int16),
        "i8": rng.integers(-9, 9, (2, 2)).astype(np.int8),
        "u8": rng.integers(0, 255, (3,)).astype(np.uint8),
        "bool": rng.integers(0, 2, (4,)).astype(bool),
        "scalar": np.array(1.5, np.float32),
        "empty": np.zeros((0, 4), np.float32),
    }


@pytest.mark.parametrize("load", [ns.load, ns.load_plain, tw.load_safetensors],
                         ids=["native", "plain", "load_safetensors"])
def test_readers_equal_safetensors_bitwise(tmp_path, load):
    path = str(tmp_path / "t.safetensors")
    save_file(_all_dtypes(), path, metadata={"format": "pt"})
    want = load_file(path)
    got = load(path)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == w.shape, k
        if w.dtype == ml_dtypes.bfloat16:
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy(), w.view(np.int16))
        else:
            assert g.numpy().dtype == w.dtype, k
            np.testing.assert_array_equal(g.numpy(), w, err_msg=k)


def _write_raw(path, header: dict, data: bytes):
    raw = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw + data)


@pytest.mark.parametrize("reader", [ns.NativeSafetensors, ns.PlainSafetensors],
                         ids=["native", "plain"])
def test_readers_refuse_an_unknown_dtype(tmp_path, reader):
    path = str(tmp_path / "f8.safetensors")
    _write_raw(path, {"a": {"dtype": "F8_E4M3", "shape": [2], "data_offsets": [0, 2]},
                      "b": {"dtype": "U8", "shape": [2], "data_offsets": [2, 4]}}, b"\1\2\3\4")
    with reader(path) as f:
        assert f.tensor("b").tolist() == [3, 4]
        with pytest.raises(ValueError, match="F8_E4M3"):
            f.tensor("a")


def test_native_views_are_zero_copy_and_the_library_builds_into_build(tmp_path):
    """The views share the mapped file's bytes; the library lands in
    ``build/`` under a hash of the sources and the Makefile's flags, and
    ``native/`` gains no file and keeps its sources."""
    native = REPO / "native"

    def snapshot():
        # the JAX package's own Makefile target may appear there from its tests
        return {p.name: p.read_bytes() for p in native.iterdir()
                if p.name != "libsdtpu_native.so"}

    before = snapshot()
    lib = ns.build()
    assert os.path.dirname(lib) == str(REPO / "build") and os.path.isfile(lib)
    assert snapshot() == before
    makefile = (native / "Makefile").read_text()
    flags = next(ln for ln in makefile.splitlines() if ln.startswith("CXXFLAGS"))
    assert flags.split("?=")[1].split() == ns.CXXFLAGS
    path = str(tmp_path / "v.safetensors")
    save_file({"x": np.arange(6, dtype=np.float32)}, path)
    with ns.NativeSafetensors(path) as f:
        a, b = f.tensor("x"), f.tensor("x")
        assert a.data_ptr() == b.data_ptr() and a.tolist() == list(range(6))
        assert f.keys() == ["x"]
    with pytest.raises(OSError, match="cannot open"):
        ns.NativeSafetensors(str(tmp_path / "missing.safetensors"))


# ---------------------------------------------------------------- loaders --

UNET = TINY_CKPT.unet
VAE = TINY_CKPT.vae


@pytest.fixture(scope="module")
def state_dicts(tmp_path_factory):
    """Randomized mirror networks at TINY_CKPT's config and the JAX init's
    CLIP keys, as f32 and f16 diffusers directories."""
    unet = RefUNet(UNET).eval()
    randomize_(unet, seed=1)
    vae = RefAutoencoderKL(VAE).eval()
    randomize_(vae, seed=2)
    root = tmp_path_factory.mktemp("sd")
    _write_clip(root / "f32" / "text_encoder", TINY_CKPT.clip)
    sds = {"unet": state_dict_numpy(unet), "vae": state_dict_numpy(vae),
           "text_encoder": load_file(str(root / "f32" / "text_encoder" / "model.safetensors"))}
    for variant, dt in (("f32", np.float32), ("f16", np.float16)):
        for sub, sd in sds.items():
            (root / variant / sub).mkdir(parents=True, exist_ok=True)
            save_file({k: v.astype(dt) for k, v in sd.items()},
                      str(root / variant / sub / "diffusion_pytorch_model.safetensors"))
    return {"sd": sds, "root": root, "unet": unet, "vae": vae}


def test_unet_and_vae_loaders_equal_the_jax_packages(state_dicts):
    sd = state_dicts["sd"]
    assert_trees_equal(tw.unet_params_from_state_dict(sd["unet"], port_config(UNET)),
                       jw.unet_params_from_state_dict(sd["unet"], UNET))
    assert_trees_equal(tw.vae_encoder_params_from_state_dict(sd["vae"], port_config(VAE)),
                       jw.vae_encoder_params_from_state_dict(sd["vae"], VAE))
    assert_trees_equal(tw.vae_decoder_params_from_state_dict(sd["vae"], port_config(VAE)),
                       jw.vae_decoder_params_from_state_dict(sd["vae"], VAE))
    assert_trees_equal(tw.clip_params_from_state_dict(sd["text_encoder"], TCKPT.clip),
                       jw.clip_params_from_state_dict(sd["text_encoder"], TINY_CKPT.clip))
    # torch tensors map like numpy arrays, and every transposed leaf is contiguous
    tree = tw.unet_params_from_state_dict(state_dicts["unet"].state_dict(), port_config(UNET))
    assert all(t.is_contiguous() for _, t in leaves(tree))
    assert_trees_equal(tree, jw.unet_params_from_state_dict(sd["unet"], UNET))


def test_clip_loader_takes_keys_without_the_prefix(state_dicts):
    sd = state_dicts["sd"]["text_encoder"]
    bare = {k.removeprefix("text_model."): v for k, v in sd.items()}
    assert_trees_equal(tw.clip_params_from_state_dict(bare, TCKPT.clip),
                       jw.clip_params_from_state_dict(sd, TINY_CKPT.clip))


def _jax_load(model_dir, config, dtype):
    """The JAX package's ``load_pipeline_params``, its files read by
    ``safetensors.numpy`` (its own native reader would build into
    ``native/``)."""
    def sd(sub):
        return load_file(jw._find_weight_file(os.path.join(model_dir, sub)))

    vae = sd("vae")
    return jw.cast_pytree({
        "clip": jw.clip_params_from_state_dict(sd("text_encoder"), config.clip),
        "unet": jw.unet_params_from_state_dict(sd("unet"), config.unet),
        "vae_encoder": jw.vae_encoder_params_from_state_dict(vae, config.vae),
        "vae_decoder": jw.vae_decoder_params_from_state_dict(vae, config.vae),
    }, dtype)


@pytest.mark.parametrize("variant,dtype", [("f32", "float32"), ("f32", "bfloat16"),
                                           ("f16", "bfloat16"), ("f16", "float32")])
def test_load_pipeline_params_equals_the_jax_packages(state_dicts, variant, dtype):
    model_dir = str(state_dicts["root"] / variant)
    got = tw.load_pipeline_params(model_dir, TCKPT, dtype=getattr(torch, dtype), device="cpu")
    want = jax.tree.map(np.asarray, _jax_load(model_dir, TINY_CKPT, getattr(jnp, dtype)))
    assert_trees_equal(got, want)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(x):
    return x.numpy().transpose(0, 2, 3, 1)


def test_loaded_networks_match_the_torch_mirror(state_dicts):
    """The port's UNet forward, VAE encoder and VAE decode on the trees
    ``load_pipeline_params`` read from the f32 files, against the mirror
    that wrote them (``test_*_full_golden.py``'s tolerances)."""
    params = tw.load_pipeline_params(str(state_dicts["root"] / "f32"), TCKPT,
                                     dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((2, 8, 8, UNET.in_channels)).astype(np.float32)
    ctx = rng.standard_normal((2, 9, UNET.cross_attention_dim)).astype(np.float32)
    ts = np.linspace(981.0, 1.0, 2).astype(np.float32)
    img = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        want_unet = _nhwc(state_dicts["unet"](_nchw(lat), torch.from_numpy(ts),
                                              torch.from_numpy(ctx)))
        want_enc = _nhwc(state_dicts["vae"].encode_moments(_nchw(img)))
        want_dec = _nhwc(state_dicts["vae"].decode(_nchw(lat), VAE.scaling_factor))
        got_unet = unet_forward(torch.from_numpy(lat), torch.from_numpy(ts),
                                torch.from_numpy(ctx), params["unet"], TCKPT.unet)
        got_enc = tvae.vae_encoder(torch.from_numpy(img), params["vae_encoder"], TCKPT.vae)
        got_dec = tvae.vae_decode(torch.from_numpy(lat), params["vae_decoder"], TCKPT.vae)
    for got, want in ((got_unet, want_unet), (got_enc, want_enc), (got_dec, want_dec)):
        assert tuple(got.shape) == want.shape
        assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-3)


# ------------------------------------------------------------ VAE encoder --

@pytest.fixture(scope="module")
def encoder_trees():
    jtree = jvae.init_vae_encoder(5, TINY.vae)
    return jtree, tvae.init_vae_encoder(5, port_config(TINY.vae))


def test_init_vae_encoder_equals_the_jax_packages(encoder_trees):
    jtree, ttree = encoder_trees
    assert_trees_equal(ttree, jax.tree.map(np.asarray, jtree))


@pytest.mark.parametrize("mode", ["encoder", "sample", "mode", "unscaled"])
def test_vae_encoder_and_encode_match_the_jax_packages(encoder_trees, mode):
    """On the kernel route (each wrapper's plain version on the CPU) and
    the ``"xla"`` route, against the JAX package's CPU program."""
    jtree, ttree = encoder_trees
    rng = np.random.default_rng(7)
    img = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    noise = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    cfg, tcfg_vae = TINY.vae, port_config(TINY.vae)
    if mode == "encoder":
        want = jvae.vae_encoder(jnp.asarray(img), jtree, cfg)
    else:
        want = jvae.vae_encode(jnp.asarray(img), None if mode == "mode" else jnp.asarray(noise),
                               jtree, cfg, apply_scaling=mode != "unscaled")
    for impl in ("gemm", "xla"):
        kw = dict(attention_impl="flash" if impl == "gemm" else "xla", conv_impl=impl)
        with torch.no_grad():
            if mode == "encoder":
                got = tvae.vae_encoder(torch.from_numpy(img), ttree, tcfg_vae, **kw)
            else:
                got = tvae.vae_encode(torch.from_numpy(img),
                                      None if mode == "mode" else torch.from_numpy(noise),
                                      ttree, tcfg_vae, apply_scaling=mode != "unscaled", **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=impl)


def test_vae_encode_clamps_logvar_in_float32():
    """A logvar beyond [-30, 20] takes the clamp's bound: std = exp(10)."""
    cfg = port_config(TINY.vae)
    tree = tvae.init_vae_encoder(1, cfg)
    tree["quant_conv"]["bias"] = torch.tensor([0.0] * 4 + [1e4] * 4)
    tree["quant_conv"]["kernel"] = torch.zeros_like(tree["quant_conv"]["kernel"])
    img = torch.zeros((1, 32, 32, 3))
    out = tvae.vae_encode(img, torch.ones((1, 8, 8, 4)), tree, cfg, apply_scaling=False)
    np.testing.assert_allclose(out.numpy(), np.exp(10.0), rtol=1e-6)


# -------------------------------------------------------- from_pretrained --

UNET_JSON = {"_class_name": "UNet2DConditionModel", "_diffusers_version": "0.27.2",
             "in_channels": 4, "out_channels": 4, "sample_size": 8,
             "block_out_channels": [16, 24, 32], "layers_per_block": 1,
             "attention_head_dim": 2, "cross_attention_dim": 32, "norm_num_groups": 8,
             "down_block_types": ["CrossAttnDownBlock2D"] * 3,
             "up_block_types": ["CrossAttnUpBlock2D"] * 3, "mid_block_type": None,
             "flip_sin_to_cos": True, "freq_shift": 0}
VAE_JSON = {"_class_name": "AutoencoderKL", "in_channels": 3, "out_channels": 3,
            "latent_channels": 4, "block_out_channels": [8, 16, 16], "layers_per_block": 1,
            "norm_num_groups": 8, "scaling_factor": 0.18215}
TE_JSON = {"architectures": ["CLIPTextModel"], "vocab_size": 1024, "hidden_size": 32,
           "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 2,
           "max_position_embeddings": 16, "hidden_act": "quick_gelu", "layer_norm_eps": 1e-5}
SCHED_JSON = {"_class_name": "DDIMScheduler", "num_train_timesteps": 1000,
              "beta_start": 0.00085, "beta_end": 0.012, "beta_schedule": "scaled_linear",
              "steps_offset": 1, "prediction_type": "epsilon", "timestep_spacing": "trailing"}


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """``test_from_pretrained.py``'s TINY_CKPT directory, with its JSON
    configs (so that a basename outside the presets derives the config)."""
    root = tmp_path_factory.mktemp("ckpt") / "test-ckpt-tiny"
    _write_clip(root / "text_encoder", TINY_CKPT.clip)
    _write_unet(root / "unet", TINY_CKPT.unet)
    _write_vae(root / "vae", TINY_CKPT.vae)
    (root / "tokenizer").mkdir()
    build_assets(root / "tokenizer")
    for sub, cfg in (("unet", UNET_JSON), ("vae", VAE_JSON), ("text_encoder", TE_JSON)):
        (root / sub / "config.json").write_text(json.dumps(cfg))
    (root / "scheduler").mkdir()
    (root / "scheduler" / "scheduler_config.json").write_text(json.dumps(SCHED_JSON))
    return root


@pytest.mark.parametrize("route", ["preset", "basename", "json"])
def test_from_pretrained_matches_the_jax_package(ckpt_dir, monkeypatch, route):
    """The same config, leaves bitwise, and the JAX package's image within
    one uint8 level.  ``preset``: an explicit preset; ``basename``: the
    directory's name among the presets; ``json``: neither, so the
    checkpoint's own JSON configs give it (a trailing-spacing scheduler)."""
    model_dir = str(ckpt_dir)
    kw, jkw = {}, {}
    if route == "preset":
        monkeypatch.setitem(jcfg.PRESETS, "ckpt-preset", TINY_CKPT)
        monkeypatch.setitem(tcfg.PRESETS, "ckpt-preset", TCKPT)
        kw, jkw = {"preset": "ckpt-preset"}, {"preset": "ckpt-preset"}
    elif route == "basename":
        monkeypatch.setitem(jcfg.PRESETS, "test-ckpt-tiny", TINY_CKPT)
        monkeypatch.setitem(tcfg.PRESETS, "test-ckpt-tiny", TCKPT)
    else:
        kw, jkw = {"dtype": torch.float32}, {"dtype": jnp.float32}
    want = JaxPipeline.from_pretrained(model_dir, **jkw)
    got = StableDiffusionPipeline.from_pretrained(model_dir, device="cpu", **kw)
    assert got.config == port_config(want.config)
    if route == "json":
        assert got.config.scheduler.timestep_spacing == "trailing"
    assert_trees_equal(got.params, jax.tree.map(np.asarray, want.params))
    assert got.tokenizer is not None and got.tokenizer.vocab == want.tokenizer.vocab
    a = got.generate("hello world", num_inference_steps=2, seed=3)
    b = want.generate("hello world", num_inference_steps=2, seed=3)
    assert a.shape == (1, 32, 32, 3)
    assert_images_match(a, b)


@pytest.mark.parametrize("family", ["sdxl", "lcm", "refiner"])
def test_from_pretrained_refuses_a_family_it_cannot_run(tmp_path, family, monkeypatch):
    """The model family is no longer refused: from the JSON configs alone
    (full-size SDXL, refiner, LCM) ``from_pretrained`` derives the JAX
    package's config and asks the loader for its trees; here the loader
    returns the zero tree on the meta device, which has the family's
    leaves (``clip_2``, no ``clip`` for the refiner, ``add_embedding``,
    ``cond_proj``)."""
    d = fx._write_ckpt(str(tmp_path / f"{family}-like"), **KNOWN[family])
    monkeypatch.setattr(tw, "load_pipeline_params",
                        lambda model_dir, config, device: tw.zero_pipeline_params(
                            config, device="meta"))
    pipe = StableDiffusionPipeline.from_pretrained(d, device="cpu")
    assert pipe.config == port_config(jcfg.config_from_checkpoint(d))
    params = pipe.params
    assert ("clip" in params) == (family != "refiner")
    assert ("clip_2" in params) == (family != "lcm")
    assert ("add_embedding" in params["unet"]) == (family != "lcm")
    assert ("cond_proj" in params["unet"]["time_embedding"]) == (family == "lcm")
    assert pipe.config.requires_aesthetics_score == (family == "refiner")


# ------------------------------------------------------ native tokenizer --

@pytest.fixture(scope="module")
def tok_files(tmp_path_factory):
    return build_assets(tmp_path_factory.mktemp("ntok"))


@pytest.mark.parametrize("prompt", PROMPTS + ["a cat 🐱 café", "ÀÉÎ õü", "", "x " * 90])
def test_native_tokenizer_equals_the_bpe_copy(tok_files, prompt):
    native = NativeCLIPTokenizer(*map(str, tok_files))
    ref = CLIPTokenizer.from_files(*map(str, tok_files))
    assert native.native_available
    for max_length in (77, 16):
        assert native.encode(prompt, max_length=max_length) == ref.encode(
            prompt, max_length=max_length)
    assert native.encode(prompt, max_length=None) == ref.encode(prompt, max_length=None)
    assert (native.bos_id, native.eos_id) == (ref.bos_id, ref.eos_id)


def test_a_failed_native_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    """No quiet switch to another reader or tokenizer: the build raises."""
    script = tmp_path / "cxx"
    script.write_text("#!/bin/sh\necho 'cxx: no such target' >&2\nexit 3\n")
    script.chmod(0o755)
    monkeypatch.setenv("CXX", str(script))
    monkeypatch.setattr(ns, "library_path", lambda: str(tmp_path / "libnative.so"))
    with pytest.raises(RuntimeError, match="(?s)exit 3.*no such target"):
        ns.build()
    assert not (tmp_path / "libnative.so").exists()


# ------------------------------------------------------------------- card --

@pytest.mark.gpu
def test_from_pretrained_on_the_card_equals_the_cpu_load(ckpt_dir):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cpu = StableDiffusionPipeline.from_pretrained(str(ckpt_dir), device="cpu",
                                                  dtype=torch.bfloat16)
    card = StableDiffusionPipeline.from_pretrained(str(ckpt_dir), device="cuda",
                                                   dtype=torch.bfloat16)
    g, w = list(leaves(card.params)), list(leaves(cpu.params))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.device.type == "cuda" and a.dtype == b.dtype, path
        assert torch.equal(a.cpu(), b), path


# ------------------------------------------------------ validate_checkpoint --

def test_validate_checkpoint_holds_the_port_to_the_mirror(ckpt_dir, capsys):
    """The tool on the CPU in float32: every network within 1e-3 of the
    mirror (relative L2), the decode over 40 dB."""
    from sdtpu_torch.tools import validate_checkpoint

    errs = validate_checkpoint.main([str(ckpt_dir), "--device", "cpu", "--latent", "8",
                                     "--batch", "2", "--image", "32"])
    out = capsys.readouterr().out
    assert "config: test-ckpt-tiny" in out and out.count(" OK") == 3, out
    assert all(errs[n]["rel_l2"] < 1e-3 for n in validate_checkpoint.NETWORKS), errs
    assert errs["vae_decode"]["psnr_db"] > 40.0


def test_validate_checkpoint_needs_a_card_for_cuda(ckpt_dir):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from sdtpu_torch.tools import validate_checkpoint

    with pytest.raises(SystemExit) as e:
        validate_checkpoint.main([str(ckpt_dir), "--device", "cuda"])
    assert e.value.code != 0
