"""The port's txt2img pipeline end to end, its tokenizer copy, and the import
rule that keeps JAX out of the port.

End-to-end parity: ``sdtpu_torch`` at the TINY config (32 px, 3 DDPM steps,
CFG) with the JAX package's own initial latents and per-step noise injected
matches ``sdtpu``'s ``generate(seed=...)`` within one uint8 level
(``conftest.assert_images_match``).  The JAX package runs its CPU program
(``xla`` convolutions and dense attention); the port runs its kernel route,
whose wrappers take the plain PyTorch versions on the CPU.  Both are float32.
"""

import ast
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_images_match
from sdtpu.tokenizer.bpe import CLIPTokenizer as JaxTokenizer
from sdtpu_torch import StableDiffusionPipeline
from sdtpu_torch.kernels import launch_counts, reset_launch_counts
from sdtpu_torch.tokenizer.bpe import CLIPTokenizer
from test_pipeline import TINY, TOKENS
from test_tokenizer import build_assets
from test_torch_ops import port_config

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
TTINY = port_config(TINY)


def jax_noise(seed, steps, shape):
    """The JAX pipeline's draws for one txt2img request: ``make_key(seed)``,
    one split for the initial latents, then one split per step."""
    key = jax.random.key(np.uint32(seed))
    key, k_init = jax.random.split(key)
    lat0 = np.array(jax.random.normal(k_init, shape, jnp.float32))
    noise = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        noise.append(np.array(jax.random.normal(sub, shape, jnp.float32)))
    return torch.from_numpy(lat0), torch.from_numpy(np.stack(noise))


@pytest.fixture(scope="module")
def port_pipe(tiny_pipe):
    tree = jax.tree.map(np.asarray, tiny_pipe.params)
    return StableDiffusionPipeline.from_params(TTINY, tree, device="cpu")


@pytest.mark.parametrize("rows", [2, 1])
def test_txt2img_matches_jax_within_one_level(tiny_pipe, port_pipe, rows):
    """``rows=1``: only the cond row is given, and both packages synthesize
    the empty prompt's row (BOS, then EOS padding) for CFG."""
    steps, seed = 3, 40
    tokens = TOKENS[:rows]
    want = tiny_pipe.generate("x", token_ids=tokens, num_inference_steps=steps, seed=seed)
    lat = TINY.default_image_size // TINY.vae.downscale_factor
    lat0, noise = jax_noise(seed, steps, (1, lat, lat, TINY.vae.latent_channels))
    ids = port_pipe._tokenize("", "", True, tokens)
    got = port_pipe.txt2img(ids, lat0, noise, cfg=True, cfg_scale=TINY.default_cfg_scale)
    assert got.shape == want.shape == (1, 32, 32, 3) and got.dtype == np.uint8
    assert_images_match(got, want)


def test_generate_is_seeded_and_outputs(port_pipe):
    a = port_pipe.generate(token_ids=TOKENS, num_inference_steps=2, seed=7)
    b = port_pipe.generate(token_ids=TOKENS, num_inference_steps=2, seed=7)
    c = port_pipe.generate(token_ids=TOKENS, num_inference_steps=2, seed=8)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a.astype(int) - c.astype(int)).max() > 0
    lat = port_pipe.generate(token_ids=TOKENS[:1], num_inference_steps=1, seed=7,
                             output="latents")
    assert lat.shape == (1, 8, 8, 4) and lat.dtype == np.float32
    img = port_pipe.generate(token_ids=TOKENS[:1], num_inference_steps=1, seed=7,
                             cfg=False, output="float")
    assert img.shape == (1, 32, 32, 3) and np.isfinite(img).all()


def test_injected_latents_replace_the_draw(port_pipe):
    lat0 = np.random.default_rng(0).normal(size=(8, 8, 4)).astype(np.float32)
    a = port_pipe.generate(token_ids=TOKENS, num_inference_steps=1, seed=1, latents=lat0)
    b = port_pipe.generate(token_ids=TOKENS, num_inference_steps=1, seed=1, latents=lat0[None])
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kwargs,slice_name", [
    ({"init_image": np.zeros((32, 32, 3), np.uint8)}, "img2img"),
    ({"mask_image": np.zeros((32, 32), np.uint8)}, "img2img"),
    ({"control_image": np.zeros((32, 32, 3), np.uint8)}, "ControlNet"),
    ({"prompt_weighting": True}, "features"),
    ({"pag_scale": 3.0}, "features"),
    ({"freeu": (1.5, 1.6, 0.9, 0.2)}, "features"),
    ({"encoder_cache_interval": 2}, "features"),
    ({"num_images": 2}, "serving"),
    ({"sampler": "euler"}, "samplers"),
])
def test_later_slices_raise(port_pipe, kwargs, slice_name):
    with pytest.raises(NotImplementedError, match=slice_name):
        port_pipe.generate(token_ids=TOKENS, num_inference_steps=1, **kwargs)


def test_generate_batch_and_other_routes_raise(port_pipe):
    with pytest.raises(NotImplementedError, match="serving"):
        port_pipe.generate_batch(["x"])
    with pytest.raises(NotImplementedError, match="kernel routes"):
        StableDiffusionPipeline(TTINY.replace(attention_impl="xla"), port_pipe.params,
                                device="cpu")
    with pytest.raises(ValueError, match="multiple of"):
        port_pipe.generate(token_ids=TOKENS, image_size=30)


# -------------------------------------------------------------- tokenizer --

@pytest.fixture(scope="module")
def tok_files(tmp_path_factory):
    return build_assets(tmp_path_factory.mktemp("tok"))


@pytest.mark.parametrize("text", ["a cat flying a spaceship", "", "the dog " * 30,
                                  "(hello:1.3) [world] cat"])
def test_tokenizer_copy_matches_jax_package(tok_files, text):
    ours, ref = CLIPTokenizer.from_files(*tok_files), JaxTokenizer.from_files(*tok_files)
    assert ours.encode(text) == ref.encode(text)
    assert ours.encode_long(text, window=16) == ref.encode_long(text, window=16)
    got_ids, got_w = ours.encode_weighted(text)
    want_ids, want_w = ref.encode_weighted(text)
    assert got_ids == want_ids and np.allclose(got_w, want_w)


def test_generate_with_a_tokenizer(tok_files):
    tok = CLIPTokenizer.from_files(*tok_files)
    cfg = TTINY.replace(clip=TTINY.clip.__class__(
        **{**TTINY.clip.__dict__, "vocab_size": len(tok.vocab)}))
    pipe = StableDiffusionPipeline.from_random(cfg, seed=0, device="cpu", tokenizer=tok)
    img = pipe.generate("a cat", "the dog", num_inference_steps=1, seed=3)
    ids = np.stack([tok.encode_long(t, window=16) for t in ("a cat", "the dog")])
    want = pipe.generate(token_ids=ids, num_inference_steps=1, seed=3)
    np.testing.assert_array_equal(img, want)


# ------------------------------------------------------------ import rule --

def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_sdtpu():
    files = sorted((REPO / "sdtpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "sdtpu", "tests", "conftest")]
    assert bad == []


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """No card: a non-zero exit and no result line, also from a directory
    that holds the script and nothing else of the repository."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for cwd in (REPO, tmp_path):
        script = REPO / "chip_smoke.py"
        if cwd == tmp_path:
            script = tmp_path / "chip_smoke.py"
            script.write_text((REPO / "chip_smoke.py").read_text())
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


# ------------------------------------------------------------------ card --

@pytest.mark.gpu
def test_cuda_txt2img_runs_through_the_kernels():
    """A small config on the card whose level-0 resnets and up-sample pass
    the slab routing rule (64 channels, 8x8 latent maps; the others take
    the op path, as in the JAX package): every kernel of the bf16 flash
    route launches, the slab conv's pre-pass and split-K reduction among
    them, and those of the int8, ring and packed routes and of the probes
    (E, H, I, J) do not."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    unet = TTINY.unet.__class__(**{**TTINY.unet.__dict__,
                                   "block_out_channels": (64, 64, 64)})
    cfg = TTINY.replace(unet=unet, compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    pipe = StableDiffusionPipeline.from_random(cfg, seed=0, device="cuda")
    reset_launch_counts()
    img = pipe.generate(token_ids=TOKENS, num_inference_steps=2, seed=1, image_size=64)
    assert img.shape == (1, 64, 64, 3) and img.dtype == np.uint8
    others = ("conv3x3_slab_int8", "flash_attention_stats", "out_proj_packed", "conv3x3_gemm",
              "flash_attention_legacy", "flash_attention_nq", "dot_bf16", "dot_bf16_splitk",
              "dot_int8",
              "flash_attention_merge")  # the merge runs only at head dims above 160
    assert all(launch_counts[k] == 0 for k in others), launch_counts
    assert all(n > 0 for k, n in launch_counts.items() if k not in others), launch_counts
