"""The port's image-conditioned requests against the JAX package at the
TINY config (32 px, CFG): img2img, latent-blend inpainting, the 9-channel
inpaint UNet and InstructPix2Pix (8 channels), ``generate_batch`` with
per-request seeds and per-row negative prompts, ``num_images``; each
program's request keys; the input preparation; the checks; and the PNG
reader and writer behind ``python -m sdtpu_torch.demo``.

Images are held to the JAX package's within one uint8 level
(``conftest.assert_images_match``), latents in float32 within 1e-5.  The
JAX package runs its CPU program (``xla`` convolutions and dense
attention); the port runs its kernel route, whose wrappers take the plain
PyTorch versions on the CPU.  Both are float32.
"""

import dataclasses
import io
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_images_match
from sdtpu.ops.resize import resize_image as jax_resize_image
from sdtpu.pipeline.pipeline import StableDiffusionPipeline as JaxPipeline
from sdtpu.tokenizer.bpe import CLIPTokenizer as JaxTokenizer
from sdtpu_torch import StableDiffusionPipeline
from sdtpu_torch.ops.resize import resize_image
from sdtpu_torch.pipeline.pipeline import PROGRAMS, request_keys, request_noise
from sdtpu_torch.tokenizer.bpe import CLIPTokenizer
from sdtpu_torch.utils import prng
from sdtpu_torch.utils.image import load_image, read_png, save_png
from test_pipeline import TINY, TOKENS
from test_tokenizer import build_assets
from test_torch_ops import port_config

torch.set_num_threads(1)

TINY9 = TINY.replace(name="test/tiny-inpaint", unet=dataclasses.replace(TINY.unet, in_channels=9))
TINY8 = TINY.replace(name="test/tiny-edit", unet=dataclasses.replace(TINY.unet, in_channels=8))
RNG = np.random.default_rng(13)
INIT = RNG.integers(0, 256, (40, 24, 3), dtype=np.uint8)   # non-square: the resize runs
INIT_B = RNG.integers(0, 256, (32, 32, 3), dtype=np.uint8)
MASK = np.zeros((32, 32), np.uint8)
MASK[:, 16:] = 255
IDS2 = np.stack([TOKENS[0], TOKENS[0]])


def port_of(jax_pipe, config, tokenizer=None):
    return StableDiffusionPipeline.from_params(
        port_config(config), jax.tree.map(np.asarray, jax_pipe.params), device="cpu",
        tokenizer=tokenizer)


@pytest.fixture(scope="module")
def pipes(tiny_pipe):
    return tiny_pipe, port_of(tiny_pipe, TINY)


@pytest.fixture(scope="module")
def pipes9():
    j = JaxPipeline.from_random(TINY9, seed=0)
    return j, port_of(j, TINY9)


@pytest.fixture(scope="module")
def pipes8():
    j = JaxPipeline.from_random(TINY8, seed=0)
    return j, port_of(j, TINY8)


@pytest.fixture(scope="module")
def tok_pipes(tmp_path_factory):
    files = build_assets(tmp_path_factory.mktemp("i2i_tok"))
    cfg = TINY.replace(clip=dataclasses.replace(TINY.clip, vocab_size=1024))
    j = JaxPipeline.from_random(cfg, seed=0, tokenizer=JaxTokenizer.from_files(*files))
    return j, port_of(j, cfg, CLIPTokenizer.from_files(*files))


def both(pipes, method, *args, **kw):
    j, t = pipes
    want = getattr(j, method)(*args, **kw)
    got = getattr(t, method)(*args, **kw)
    return got, want


# ------------------------------------------------------- against JAX --

@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "euler-a"])
def test_img2img_matches_jax_within_one_level(pipes, sampler):
    got, want = both(pipes, "generate", "x", token_ids=TOKENS, num_inference_steps=4, seed=3,
                     init_image=INIT, strength=0.6, sampler=sampler)
    assert got.shape == want.shape == (1, 32, 32, 3) and got.dtype == np.uint8
    assert_images_match(got, want)


def test_img2img_latents_match_jax_in_float32(pipes):
    got, want = both(pipes, "generate", "x", token_ids=TOKENS, num_inference_steps=3, seed=8,
                     init_image=INIT_B, strength=0.8, sampler="ddim", output="latents")
    assert got.shape == want.shape == (1, 8, 8, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mask", [MASK, np.repeat(MASK[:, :, None], 3, -1) / 255.0])
def test_latent_blend_inpaint_matches_jax_within_one_level(pipes, mask):
    """A 4-channel UNet: the preserved region is pasted back after each
    step; a uint8 (H, W) mask and a float (H, W, 3) one."""
    got, want = both(pipes, "generate", "x", token_ids=TOKENS, num_inference_steps=4, seed=3,
                     init_image=INIT, mask_image=mask, strength=0.7)
    assert_images_match(got, want)


@pytest.mark.parametrize("strength", [1.0, 0.7])
def test_inpaint_unet_matches_jax_within_one_level(pipes9, strength):
    """The 9-channel UNet: [latents, mask, masked-image latents]; at strength
    1 the run starts from pure noise."""
    got, want = both(pipes9, "generate", "x", token_ids=TOKENS, num_inference_steps=3, seed=3,
                     init_image=INIT_B, mask_image=MASK, strength=strength)
    assert_images_match(got, want)


def test_inpaint_unet_per_request_keys_match_jax(pipes9):
    """Per-request keys with a stochastic sampler: step 1's noise is the
    masked image's encoder noise (salt 3) in both packages."""
    got, want = both(pipes9, "generate_batch", ["x", "y"], token_ids=IDS2,
                     num_inference_steps=3, seeds=[3, 8], init_images=[INIT_B, INIT],
                     mask_images=[MASK, MASK[::-1]], strength=0.8)
    assert got.shape == (2, 32, 32, 3)
    assert_images_match(got, want)


@pytest.mark.parametrize("cfg", [True, False])
def test_ip2p_matches_jax_within_one_level(pipes8, cfg):
    """InstructPix2Pix: three guidance branches under CFG (rows [image,
    image, zeros]), one without; the image's unscaled posterior mode."""
    got, want = both(pipes8, "generate", "x", token_ids=TOKENS if cfg else TOKENS[:1],
                     num_inference_steps=3, seed=3, init_image=INIT, cfg=cfg,
                     image_guidance_scale=1.8, cfg_scale=6.0)
    assert_images_match(got, want)


def test_ip2p_ignores_strength(pipes8):
    _, t = pipes8
    kw = dict(token_ids=TOKENS, num_inference_steps=2, seed=3, init_image=INIT)
    np.testing.assert_array_equal(t.generate(strength=0.3, **kw), t.generate(strength=0.9, **kw))


def test_generate_batch_seeds_match_jax_within_one_level(pipes):
    got, want = both(pipes, "generate_batch", ["x", "y"], token_ids=np.stack(TOKENS),
                     num_inference_steps=3, seeds=[5, 9], sampler="ddpm")
    assert got.shape == (2, 32, 32, 3)
    assert_images_match(got, want)


def test_generate_batch_batch_key_matches_jax_within_one_level(pipes):
    """Without seeds one key draws the whole batch (one normal of (B, ...))."""
    got, want = both(pipes, "generate_batch", ["x", "y"], token_ids=np.stack(TOKENS),
                     num_inference_steps=3, seed=21, init_images=[INIT, INIT_B],
                     strength=0.7)
    assert_images_match(got, want)


def test_generate_batch_per_row_negatives_match_jax_within_one_level(tok_pipes):
    got, want = both(tok_pipes, "generate_batch", ["hello world", "a cat"],
                     negative_prompt=["cat", "dog"], num_inference_steps=2, seeds=[7, 8])
    assert_images_match(got, want)
    got, want = both(tok_pipes, "generate_batch", ["hello world", "a cat"],
                     negative_prompt="dog", num_inference_steps=2, seeds=[7, 8])
    assert_images_match(got, want)


@pytest.mark.parametrize("init", [None, INIT])
def test_num_images_matches_jax_within_one_level(pipes, init):
    """``num_images=2`` runs generate_batch with seeds seed + i (and, as in
    the JAX package, only the first token row, each row's uncond made)."""
    got, want = both(pipes, "generate", "x", token_ids=TOKENS, num_inference_steps=3, seed=4,
                     num_images=2, init_image=init, strength=0.7)
    assert got.shape == want.shape == (2, 32, 32, 3)
    assert_images_match(got, want)


def test_generate_batch_outputs(pipes):
    """uint8, device and float outputs; ``output="latents"`` returns the
    decoded float images, as the JAX package's ``generate_batch`` (which
    never asks its program for latents) does, also through
    ``generate(num_images=2)``."""
    j, t = pipes
    kw = dict(token_ids=np.stack(TOKENS), num_inference_steps=2, seeds=[1, 2])
    u8 = t.generate_batch(["x", "y"], **kw)
    dev = t.generate_batch(["x", "y"], output="device", **kw)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.uint8
    np.testing.assert_array_equal(dev.numpy(), u8)
    flt = t.generate_batch(["x", "y"], output="float", **kw)
    assert flt.shape == (2, 32, 32, 3) and flt.dtype == np.float32
    lat = t.generate_batch(["x", "y"], output="latents", **kw)
    want = j.generate_batch(["x", "y"], output="latents", **kw)
    assert lat.shape == want.shape == (2, 32, 32, 3) and lat.dtype == want.dtype
    np.testing.assert_array_equal(lat, flt)
    np.testing.assert_allclose(lat, want, rtol=0, atol=1e-4)
    got, want = both(pipes, "generate", "x", token_ids=TOKENS, num_inference_steps=2, seed=1,
                     num_images=2, output="latents")
    assert got.shape == want.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="unknown output"):
        t.generate_batch(["x", "y"], output="png", **kw)


# ------------------------------------------------------------- the keys --

def jax_keys(seed_or_seeds, steps, program):
    """The JAX program's key derivation (sdtpu/pipeline/pipeline.py:
    1919-1978, 2051-2067, 1763-1778), as raw key data."""
    if np.ndim(seed_or_seeds):
        keys = jax.vmap(jax.random.key)(jnp.asarray(seed_or_seeds, jnp.uint32))
        salts = {"init": 0, "enc": 0, "fwd": 1, "masked": 3}
        out = [jax.vmap(lambda k, s=salts[h]: jax.random.fold_in(k, s))(keys)
               for h in PROGRAMS[program]]
        out += [jax.vmap(lambda k, i=i: jax.random.fold_in(k, i + 2))(keys)
                for i in range(steps)]
        return np.stack([np.asarray(jax.random.key_data(k)) for k in out])
    key = jax.random.key(np.uint32(seed_or_seeds))
    out = []
    if program == "txt2img":
        key, k = jax.random.split(key)
        out.append(k)
    elif program in ("img2img", "inpaint"):
        key, k_enc, k_fwd = jax.random.split(key, 3)
        out += [k_enc, k_fwd]
        if program == "inpaint":
            key, k_m = jax.random.split(key)
            out.append(k_m)
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(sub)
    return np.stack([np.asarray(jax.random.key_data(k)) for k in out])


@pytest.mark.parametrize("program", sorted(PROGRAMS))
@pytest.mark.parametrize("seeds", [40, [40, 7, 2**32 - 1]])
def test_request_keys_equal_the_jax_derivation(program, seeds):
    """Keys bitwise; the normals within 4 float32 ulp of jax.random's."""
    key = prng.key(seeds) if np.ndim(seeds) == 0 else np.stack([prng.key(s) for s in seeds])
    got = request_keys(key, 3, program=program)
    want = jax_keys(seeds, 3, program)
    np.testing.assert_array_equal(got, want)
    batch = 1 if np.ndim(seeds) == 0 else len(seeds)
    shape = (batch, 4, 4, 4)
    draws = request_noise(key, 3, shape, "cpu", program=program).numpy()
    assert draws.shape == (len(want), *shape)
    for n, k in enumerate(want):
        if np.ndim(seeds) == 0:
            ref = np.asarray(jax.random.normal(jax.random.wrap_key_data(k), shape, jnp.float32))
        else:
            ref = np.stack([np.asarray(jax.random.normal(jax.random.wrap_key_data(kk), shape[1:],
                                                         jnp.float32)) for kk in k])
        ulp = np.abs(draws[n].view(np.int32).astype(np.int64) - ref.view(np.int32).astype(np.int64))
        assert ulp.max() <= 4


def test_salt_3_collision_in_both_packages():
    """A fault of the reference that the port reproduces: under per-request
    keys the masked image's encoder noise (``fold_in(k, 3)``) and step 1's
    variance noise (``fold_in(k, 1 + 2)``) are one draw, though the JAX
    program's comment calls its salts disjoint."""
    k = jax.random.key(np.uint32(40))
    shape = (4, 4, 4)
    masked = np.asarray(jax.random.normal(jax.random.fold_in(k, 3), shape, jnp.float32))
    step1 = np.asarray(jax.random.normal(jax.random.fold_in(k, 1 + 2), shape, jnp.float32))
    np.testing.assert_array_equal(masked, step1)
    draws = request_noise(prng.key(40)[None], 3, (1, *shape), "cpu", program="inpaint")
    heads = len(PROGRAMS["inpaint"])
    assert torch.equal(draws[2], draws[heads + 1])  # "masked" is the third head
    np.testing.assert_allclose(draws[2, 0].numpy(), masked, rtol=0, atol=1e-6)
    assert not torch.equal(draws[heads], draws[heads + 1])


# ------------------------------------------------------- input preparation --

@pytest.mark.parametrize("shape,size", [((40, 24, 3), 32), ((8, 8, 3), 32), ((32, 32, 3), 16),
                                        ((2, 20, 36, 3), 32)])
def test_resize_image_equals_jax_bitwise(shape, size):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    got = resize_image(torch.from_numpy(x), size, size + 8).numpy()
    want = np.asarray(jax_resize_image(jnp.asarray(x), size, size + 8))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("image", [INIT, INIT_B, INIT_B[None].astype(np.float32) / 200.0,
                                   np.random.default_rng(2).uniform(-1, 1, (16, 48, 3))])
def test_prep_image_equals_jax_bitwise(image):
    got = StableDiffusionPipeline._prep_image(image, 32)
    want = np.asarray(JaxPipeline._prep_image(None, image, 32))
    assert got.shape == (1, 32, 32, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mask", [MASK, MASK[:, :, None], np.repeat(MASK[:, :, None], 3, -1),
                                  np.random.default_rng(3).uniform(0, 1, (20, 44)),
                                  np.random.default_rng(4).uniform(-0.5, 1.5, (32, 32, 3))])
def test_prep_mask_equals_jax_bitwise(pipes, pipes9, mask):
    """Area-averaged to the latent grid for a 4-channel UNet, the pixel grid
    for a 9-channel one."""
    for j, t in (pipes, pipes9):
        got, want = t._prep_mask(mask, 32), j._prep_mask(mask, 32)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert pipes[1]._prep_mask(mask, 32).shape == (1, 8, 8, 1)
    assert pipes9[1]._prep_mask(mask, 32).shape == (1, 32, 32, 1)
    with pytest.raises(ValueError, match="mask must be"):
        pipes[1]._prep_mask(np.zeros((2, 32, 32, 1)), 32)


# ------------------------------------------------------------ the checks --

CHECKS = [
    ("generate", {"strength": 0.0}),
    ("generate", {"strength": 1.5}),
    ("generate", {"num_inference_steps": 0}),
    ("generate", {"image_size": 30}),
    ("generate", {"mask_image": MASK}),
    ("generate", {"init_image": INIT, "rng": "torch"}),
    ("generate", {"rng": "numpy"}),
    ("generate", {"init_image": INIT, "latents": np.zeros((1, 8, 8, 4), np.float32)}),
    ("generate", {"encoder_cache_interval": 0}),
    ("generate", {"guidance_rescale": 1.5}),
    ("generate", {"guidance_rescale": 0.5, "cfg": False, "token_ids": TOKENS[:1]}),
    ("generate", {"pag_scale": -1.0}),
    ("generate", {"freeu": (1.0, 2.0)}),
    ("generate_batch", {"negative_prompt": ["a"]}),
    ("generate_batch", {"seeds": [1]}),
    ("generate_batch", {"negative_prompt": ["a", "b"]}),
    ("generate_batch", {"mask_images": [MASK, MASK]}),
    ("generate_batch", {"init_images": [INIT, INIT], "strength": 0.0}),
    ("generate_batch", {"init_images": [INIT, INIT], "mask_images": [MASK]}),
    ("generate_batch", {"num_inference_steps": 0}),
]
EDIT_CHECKS = [
    ("generate", {"init_image": INIT, "mask_image": MASK}),
    ("generate", {"init_image": INIT, "guidance_rescale": 0.5}),
    ("generate", {"init_image": INIT, "pag_scale": 2.0}),
    ("generate_batch", {"init_images": [INIT, INIT], "mask_images": [MASK, MASK]}),
]


def raised(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("method,kw", CHECKS)
def test_checks_raise_as_jax_does(pipes, method, kw):
    """The same ValueError with the same message (the port has no tokenizer
    here, so a negative prompt needs one in both)."""
    j, t = pipes
    args = ("x",) if method == "generate" else (["x", "y"],)
    base = dict(num_inference_steps=1) if method == "generate" else dict(
        num_inference_steps=1, token_ids=np.stack(TOKENS))
    kw = {**base, **({"token_ids": TOKENS} if method == "generate" else {}), **kw}
    assert raised(lambda: getattr(t, method)(*args, **kw)) == \
        raised(lambda: getattr(j, method)(*args, **kw))


@pytest.mark.parametrize("method,kw", EDIT_CHECKS)
def test_edit_checks_raise_as_jax_does(pipes8, method, kw):
    j, t = pipes8
    args = ("x",) if method == "generate" else (["x", "y"],)
    kw = dict(num_inference_steps=1, token_ids=TOKENS if method == "generate"
              else np.stack(TOKENS), **kw)
    assert raised(lambda: getattr(t, method)(*args, **kw)) == \
        raised(lambda: getattr(j, method)(*args, **kw))


@pytest.mark.parametrize("kw,slice_name", [
    # a mesh runs now (tests/test_torch_mesh.py); one that is no mesh raises
    pytest.param({"mesh": object()}, "mesh must be", id="kw0-multi-card"),
    ({"control_images": [INIT, INIT]}, "load_controlnet"),
    # the text features run now; their refusals are the JAX package's
    pytest.param({"prompt_weighting": True}, "parses the prompt strings",
                 id="kw2-text-features"),
    pytest.param({"token_weights": np.ones((2, 8))}, "must match", id="kw3-text-features"),
    ({"pag_scale": -2.0}, "pag_scale must be >= 0"),
    ({"freeu": (1.5, 1.6)}, "freeu must be"),
    ({"guidance_rescale": 1.5}, r"guidance_rescale must be in \[0, 1\]"),
    ({"encoder_cache_interval": 0}, "encoder_cache_interval must be >= 1"),
])
def test_generate_batch_later_slices_raise(pipes, kw, slice_name):
    """A mesh that is not the port's raises TypeError; the step features
    raise the JAX package's ValueError for an invalid value, in both
    packages, as control maps do with no ControlNet loaded, and prompt
    weights with token ids or token weights of another shape."""
    j, t = pipes
    is_mesh = "mesh" in kw
    with pytest.raises(TypeError if is_mesh else ValueError, match=slice_name):
        t.generate_batch(["x", "y"], token_ids=np.stack(TOKENS), num_inference_steps=1, **kw)
    if not is_mesh:
        with pytest.raises(ValueError, match=slice_name):
            j.generate_batch(["x", "y"], token_ids=np.stack(TOKENS), num_inference_steps=1,
                             **kw)


# -------------------------------------------------------- PNG and the demo --

@pytest.mark.parametrize("shape", [(5, 7, 3), (1, 9, 13, 3), (6, 4)])
def test_png_round_trip_and_pil(tmp_path, shape):
    """save_png writes what PIL reads; read_png reads what PIL writes (grey,
    RGB, RGBA), each bitwise; load_image gives RGB as PIL's convert does."""
    from PIL import Image

    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "a.png")
    save_png(img, path)
    flat = img[0] if img.ndim == 4 else img
    np.testing.assert_array_equal(np.asarray(Image.open(path)), flat)
    np.testing.assert_array_equal(read_png(path), flat)
    for mode in ("L", "RGB", "RGBA"):
        src = Image.fromarray(np.random.default_rng(1).integers(0, 256, (11, 6, 4),
                                                                  dtype=np.uint8), "RGBA")
        src = src.convert(mode)
        p = str(tmp_path / f"{mode}.png")
        src.save(p)
        np.testing.assert_array_equal(read_png(p), np.asarray(src))
        np.testing.assert_array_equal(load_image(p), np.asarray(src.convert("RGB")))


def test_read_png_refuses_what_it_does_not_read(tmp_path):
    from PIL import Image

    p = str(tmp_path / "p.png")
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(p)
    with pytest.raises(ValueError, match="colour type 3"):
        read_png(p)
    p16 = str(tmp_path / "i16.png")
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(p16)
    with pytest.raises(ValueError, match="bit depth"):
        read_png(p16)
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as f:
        f.write(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(bad)
    ok = io.BytesIO()
    Image.fromarray(np.zeros((2, 2, 3), np.uint8)).save(ok, format="PNG")
    data = bytearray(ok.getvalue())
    data[-20] ^= 0xFF  # corrupt the IDAT payload or its checksum
    with open(bad, "wb") as f:
        f.write(bytes(data))
    with pytest.raises((ValueError, zlib.error)):
        read_png(bad)


def test_demo_img2img_inpaint_and_refused_flags(tmp_path, monkeypatch, capsys):
    import sdtpu_torch.config as tcfg
    from sdtpu_torch import demo

    monkeypatch.setitem(tcfg.PRESETS, "test/tiny", port_config(TINY))
    init, mask = str(tmp_path / "init.png"), str(tmp_path / "mask.png")
    save_png(INIT, init)
    save_png(MASK, mask)
    out = str(tmp_path / "out.png")
    base = ["--preset", "test/tiny", "--device", "cpu", "--steps", "2", "--out", out]
    demo.main(base + ["--init-image", init, "--mask-image", mask, "--strength", "0.6"])
    img = read_png(out)
    assert img.shape == (32, 32, 3) and img.dtype == np.uint8
    assert "wrote" in capsys.readouterr().out
    demo.main(base + ["--no-cfg", "--sampler", "euler", "--seed", "5", "--image-size", "16"])
    assert read_png(out).shape == (16, 16, 3)
    # the text-feature flags run now (tests/test_torch_text_features.py):
    # without a tokenizer --prompt-weighting is refused, a missing file raises
    with pytest.raises(SystemExit, match="needs a tokenizer"):
        demo.main(base + ["--prompt-weighting"])
    for flags in (["--textual-inversion", "x.safetensors"], ["--lora", "x.safetensors"]):
        with pytest.raises(OSError, match="x.safetensors"):
            demo.main(base + flags)
    # --refiner is no longer refused; as in the JAX demo it is txt2img only
    with pytest.raises(SystemExit) as e:
        demo.main(base + ["--refiner", "sdxl-refiner", "--init-image", init])
    assert e.value.code == 2
    assert "--refiner composes with txt2img only" in capsys.readouterr().err
