"""The port's text features against the JAX package on the CPU: LoRA
adapters fused into the tree (``utils/lora.py``, ``load_lora`` /
``unload_loras``), textual-inversion rows (``utils/textual_inversion.py``,
``load_textual_inversion``), weighted prompts (``prompt_weighting``,
``token_weights`` through ``generate``, ``generate_batch`` and the
``ServingEngine``), two-window prompts, and the demo's ``--lora``,
``--textual-inversion`` and ``--prompt-weighting``.

Tolerances: fused leaves, their pre-fuse snapshots, grown token tables,
registered ids and the apply reports equal the JAX package's exactly
(bitwise, float32 and bf16 trees); weighted contexts within 1e-5 of the
JAX package's (float32); images within one uint8 level of the JAX
package's (``conftest.assert_images_match``); unit weights, a scale-0
adapter and an unloaded adapter give the port's own unweighted or base
image bitwise.  The configs are TINY (``tests/test_pipeline.py``), TINY
with a 1024-id vocabulary for the test tokenizer, and TINY_XL /
TINY_REFINER (``tests/test_torch_sdxl.py``), float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

import sdtpu.models.unet as junet
import sdtpu.utils.lora as jlora
import sdtpu.utils.textual_inversion as jti
import sdtpu_torch.config as tcfg
import sdtpu_torch.utils.lora as tlora
import sdtpu_torch.utils.textual_inversion as tti
from conftest import assert_images_match
from sdtpu.pipeline.pipeline import StableDiffusionPipeline as JaxPipeline
from sdtpu.tokenizer.bpe import CLIPTokenizer as JaxTokenizer
from sdtpu.utils.quant import quantize_pipeline_int8 as jax_quantize
from sdtpu.utils.weights import cast_pytree
from sdtpu.utils.weights import init_pipeline_params as jax_init
from sdtpu.utils.weights import load_safetensors as jax_load_safetensors
from sdtpu_torch import StableDiffusionPipeline
from sdtpu_torch.kernels import launch_counts, reset_launch_counts
from sdtpu_torch.pipeline.serving import ServingEngine
from sdtpu_torch.tokenizer.bpe import CLIPTokenizer
from sdtpu_torch.utils.quant import quantize_pipeline_int8
from sdtpu_torch.utils.weights import params_from_numpy
from test_pipeline import TINY, TOKENS
from test_tokenizer import build_assets
from test_torch_checkpoint import assert_trees_equal
from test_torch_ops import port_config
from test_torch_sdxl import TINY_REFINER, TINY_XL

torch.set_num_threads(1)

RANK = 4
# TINY with a vocabulary that holds the test tokenizer's ids
TOK = TINY.replace(name="test/tiny-text",
                   clip=dataclasses.replace(TINY.clip, vocab_size=1024))
PW_PROMPT = "a (red:1.4) cat on the [dog]"
NEG = "hello world"
LONG = "a cat flying a spaceship over the quick brown fox"  # two 16-token windows
STEPS = 2


# ---------------------------------------------------------------- fixtures --

@pytest.fixture(scope="module")
def jax_trees(tiny_pipe):
    """The JAX package's trees (numpy leaves) of TINY (the suite's shared
    seed-0 pipeline) and TINY_XL, float32 and bf16."""
    xl = jax.tree.map(np.asarray, jax_init(0, TINY_XL))
    tiny = jax.tree.map(np.asarray, tiny_pipe.params)
    out = {"tiny": tiny, "xl": xl}
    for name in ("tiny", "xl"):
        out[name + "-bf16"] = jax.tree.map(np.asarray, cast_pytree(out[name], jnp.bfloat16))
    return out


@pytest.fixture(scope="module")
def tok_files(tmp_path_factory):
    return build_assets(tmp_path_factory.mktemp("tok"))


@pytest.fixture(scope="module")
def tok_pipes(tok_files):
    """TOK in both packages with the test tokenizer: the JAX pipeline's
    seed-0 tree, the port's from it."""
    j = JaxPipeline.from_random(TOK, seed=0, tokenizer=JaxTokenizer.from_files(*tok_files))
    t = StableDiffusionPipeline.from_params(
        port_config(TOK), jax.tree.map(np.asarray, j.params), device="cpu",
        tokenizer=CLIPTokenizer.from_files(*tok_files))
    return j, t


# ------------------------------------------------------------------ LoRA --

def _factors(rng, kernel_shape, rank, *, flat_conv=False, conv1x1=False):
    """A torch-layout (down, up) pair for a kernel of this tree: (r, I) /
    (O, r) for a linear, (r, I, kh, kw) / (O, r, 1, 1) for a conv (the
    down flattened to (r, I*kh*kw) with ``flat_conv``, as LoCon files
    store it); ``conv1x1``: a linear's factors as 1x1 convs."""
    if len(kernel_shape) == 4:
        kh, kw, ci, co = kernel_shape
        down = rng.standard_normal((rank, ci, kh, kw)).astype(np.float32)
        if flat_conv:
            down = down.reshape(rank, -1)
        return down, rng.standard_normal((co, rank, 1, 1)).astype(np.float32)
    ci, co = kernel_shape[-2:]
    down = rng.standard_normal((rank, ci)).astype(np.float32)
    up = rng.standard_normal((co, rank)).astype(np.float32)
    if conv1x1:
        return down[:, :, None, None], up[:, :, None, None]
    return down, up


def _pair(sd, key, down, up, alpha=None, peft=False):
    if peft:
        sd[f"{key}.lora_A.weight"], sd[f"{key}.lora_B.weight"] = down, up
    else:
        sd[f"{key}.lora_down.weight"], sd[f"{key}.lora_up.weight"] = down, up
    if alpha is not None:
        sd[f"{key}.alpha"] = np.asarray(alpha, np.float32)


def full_adapter(tree, rng, rank=RANK):
    """A kohya adapter over every module ``_index_unet`` and ``_index_clip``
    list: 3x3 convs with a flattened (LoCon) down, 1x1 shortcuts, every
    text-encoder row (``lora_te_`` / ``lora_te1_`` and ``lora_te2_``)."""
    sd = {}
    for name, (leaf, _) in sorted(tlora._index_unet(tree["unet"]).items()):
        shape = tuple(leaf["kernel"].shape)
        d, u = _factors(rng, shape, rank, flat_conv=shape[:2] == (3, 3))
        _pair(sd, f"lora_unet_{name}", d, u, alpha=rng.uniform(1, 8))
    prefixes = {"clip": "lora_te1_" if "clip_2" in tree else "lora_te_", "clip_2": "lora_te2_"}
    for tag, prefix in prefixes.items():
        if tag in tree:
            for name, (leaf, i) in sorted(tlora._index_clip(tree[tag]).items()):
                d, u = _factors(rng, tuple(leaf["kernel"].shape[1:]), rank)
                _pair(sd, f"{prefix}{name}", d, u)
    return sd


ATTN_Q = "down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q"
FF_OUT = "up_blocks.1.attentions.0.transformer_blocks.0.ff.net.2"
CONV1 = "down_blocks_0_resnets_0_conv1"
PROJ_IN = "down_blocks_1_attentions_0_proj_in"
TE_Q1 = "text_model_encoder_layers_1_self_attn_q_proj"


def lora_case(case, tree, rng):
    """The adapter of one case (numpy float32 factors)."""
    u = tlora._index_unet(tree["unet"])
    shape = {n: tuple(leaf["kernel"].shape) for n, (leaf, _) in u.items()}
    sd = {}
    if case == "kohya-linear":
        _pair(sd, f"lora_unet_{ATTN_Q}", *_factors(rng, shape[ATTN_Q], RANK), alpha=2.0)
    elif case == "peft-linear":
        _pair(sd, f"unet.{FF_OUT}", *_factors(rng, shape[FF_OUT.replace(".", "_")], RANK),
              peft=True)
    elif case == "conv3x3":
        _pair(sd, f"lora_unet_{CONV1}", *_factors(rng, shape[CONV1], RANK), alpha=3.0)
    elif case == "locon-flat":
        _pair(sd, f"lora_unet_{CONV1}",
              *_factors(rng, shape[CONV1], RANK, flat_conv=True), alpha=3.0)
    elif case == "proj_in-1x1":
        _pair(sd, f"lora_unet_{PROJ_IN}",
              *_factors(rng, shape[PROJ_IN], RANK, conv1x1=True))
    elif case == "te-row":
        q = tree["clip"]["layers"]["attn"]["q"]["kernel"]
        _pair(sd, f"lora_te_{TE_Q1}", *_factors(rng, tuple(q.shape[1:]), RANK))
    elif case == "unmatched-unrecognized":
        d, up = _factors(rng, (8, 8), RANK)
        sd["some_other_format.weight"] = d
        _pair(sd, "lora_unet_down_blocks_9_resnets_0_conv1", d, up)
        sd[f"lora_unet_{ATTN_Q}.lora_down.weight"] = d  # no up: an incomplete pair
        _pair(sd, f"lora_unet_{CONV1}", *_factors(rng, (3, 3, 5, 7), RANK))  # wrong shape
    elif case in ("everything", "xl-te1-te2"):
        sd = full_adapter(tree, rng)
    return sd


LORA_CASES = [("tiny", c) for c in ("kohya-linear", "peft-linear", "conv3x3", "locon-flat",
                                    "proj_in-1x1", "te-row", "unmatched-unrecognized",
                                    "everything")] + [("xl", "xl-te1-te2")]


def _apply_both(jtree, sd, scale):
    want, want_rep = jlora.apply_lora(jtree, sd, scale=scale)
    got, got_rep = tlora.apply_lora(params_from_numpy(jtree, device="cpu"), sd, scale=scale)
    return got, got_rep, jax.tree.map(np.asarray, want), want_rep


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("config,case", LORA_CASES)
def test_apply_lora_equals_the_jax_packages(jax_trees, config, case, dtype):
    """Fused leaves, untouched leaves, the pre-fuse snapshots and the report
    (applied, skipped with its messages, unrecognized) equal the JAX
    package's bitwise, on float32 and bf16 trees."""
    jtree = jax_trees[config if dtype == "f32" else f"{config}-bf16"]
    sd = lora_case(case, jax_trees[config], np.random.default_rng(7))
    got, got_rep, want, want_rep = _apply_both(jtree, sd, 0.7)
    assert_trees_equal(got, want)
    got_orig, want_orig = got_rep.pop("originals"), want_rep.pop("originals")
    assert got_rep == want_rep
    assert sorted(got_orig) == sorted(want_orig)
    assert_trees_equal({"/".join(k): v for k, v in got_orig.items()},
                       {"/".join(k): v for k, v in want_orig.items()})
    if case == "unmatched-unrecognized":
        assert got_rep["applied"] == 0 and len(got_rep["skipped"]) == 3
    else:
        assert got_rep["applied"] > 0 and not got_rep["skipped"]


def test_an_adapter_file_in_bf16(jax_trees, tmp_path):
    """A kohya adapter over every module written as a bf16 safetensors file
    (by the ``safetensors`` package), read by each package's own reader
    and fused into the bf16 tree: bitwise equal, and ``load_lora(path)``
    gives the same tree."""
    import ml_dtypes

    sd = full_adapter(params_from_numpy(jax_trees["tiny"], device="cpu"),
                      np.random.default_rng(3))
    path = str(tmp_path / "adapter.safetensors")
    save_file({k: np.asarray(v, np.float32).astype(ml_dtypes.bfloat16) for k, v in sd.items()},
              path)
    jtree = jax_trees["tiny-bf16"]
    want, want_rep = jlora.apply_lora(jtree, jax_load_safetensors(path), scale=0.8)
    pipe = StableDiffusionPipeline(port_config(TINY).replace(param_dtype=torch.bfloat16),
                                   params_from_numpy(jtree, device="cpu"), device="cpu")
    report = pipe.load_lora(path, scale=0.8)
    want_rep.pop("originals")
    assert report == want_rep and report["applied"] > 40
    assert_trees_equal(pipe.params, jax.tree.map(np.asarray, want))


def test_apply_lora_refuses_a_quantized_leaf(jax_trees):
    """An int8-quantized conv has no ``kernel``: both packages raise."""
    tree = params_from_numpy(jax_trees["tiny"], device="cpu")
    sd = lora_case("conv3x3", tree, np.random.default_rng(1))
    with pytest.raises(ValueError, match="apply LoRA before") as got:
        tlora.apply_lora(quantize_pipeline_int8(tree, min_ch=8), sd)
    with pytest.raises(ValueError, match="apply LoRA before") as want:
        jlora.apply_lora(jax_quantize(jax_trees["tiny"], min_ch=8), sd)
    assert str(got.value) == str(want.value)


def test_load_lora_and_unload_loras(tiny_pipe):
    """Scale 0 is the identity bitwise; at 0.35 the image is within one
    level of the JAX pipeline's after the same ``load_lora``; a second
    adapter stacks; ``unload_loras`` puts back the tree and the image
    bitwise (both packages count the same modules), and a second unload
    returns 0.  The input tree, shared with the suite's pipeline, is never
    written."""
    tree = jax.tree.map(np.asarray, tiny_pipe.params)
    j = JaxPipeline(TINY, tiny_pipe.params)
    t = StableDiffusionPipeline.from_params(port_config(TINY), tree, device="cpu")
    before = t.params
    kw = dict(token_ids=TOKENS[:1], num_inference_steps=STEPS, seed=11)
    base = t.generate(**kw)
    rng = np.random.default_rng(5)
    sd = full_adapter(t.params, rng)
    assert t.load_lora(sd, scale=0.0)["applied"] > 40
    np.testing.assert_array_equal(t.generate(**kw), base)
    second = lora_case("te-row", t.params, rng)
    for pipe in (j, t):
        pipe.load_lora(sd, scale=0.35)
        pipe.load_lora(second, scale=0.5)
    got = t.generate(**kw)
    assert_images_match(got, j.generate("x", **kw))
    assert not np.array_equal(got, base)
    assert t.unload_loras() == j.unload_loras() == len(tlora._parse_lora_sd(sd)[0])
    assert_trees_equal(t.params, tree)
    np.testing.assert_array_equal(t.generate(**kw), base)
    assert t.unload_loras() == 0
    assert_trees_equal(before, jax.tree.map(np.asarray, tiny_pipe.params))


# ------------------------------------------------------ textual inversion --

def _jax_pipe_tree(config):
    return jax.tree.map(np.asarray, jax_init(0, config))


@pytest.mark.parametrize("config,layout", [
    ("tiny", "diffusers"), ("tiny", "emb_params"), ("tiny", "1d"), ("tiny", "two-files"),
    ("xl", "dual"), ("refiner", "dual"), ("refiner", "diffusers")])
def test_textual_inversion_equals_the_jax_packages(jax_trees, config, layout):
    """The grown table(s) bitwise and the ids, for each layout: both
    tables of TINY_XL from a dual-encoder file, the refiner's bigG table
    alone (its G rows, or a single-encoder file)."""
    cfg = {"tiny": TINY, "xl": TINY_XL, "refiner": TINY_REFINER}[config]
    jtree = jax_trees.get(config) or _jax_pipe_tree(cfg)
    rng = np.random.default_rng(9)
    dim_l = (cfg.clip or cfg.clip_2).hidden_size
    dim_g = (cfg.clip_2 or cfg.clip).hidden_size
    files = {
        "diffusers": [({"<thing>": rng.standard_normal((2, dim_l)).astype(np.float32)}, None)],
        "emb_params": [({"emb_params": rng.standard_normal((3, dim_l))}, "<x>")],
        "1d": [({"<v>": rng.standard_normal((dim_l,)).astype(np.float32)}, None)],
        "two-files": [({"<a>": rng.standard_normal((1, dim_l)).astype(np.float32)}, None),
                      ({"<b>": rng.standard_normal((2, dim_l)).astype(np.float32)}, None)],
        "dual": [({"clip_l": rng.standard_normal((2, TINY_XL.clip.hidden_size)),
                   "clip_g": rng.standard_normal((2, dim_g))}, "<d>")],
    }[layout]
    got, want = params_from_numpy(jtree, device="cpu"), jtree
    for sd, token in files:
        got, got_ids = tti.apply_textual_inversion(got, sd, token=token)
        want, want_ids = jti.apply_textual_inversion(want, sd, token=token)
        assert got_ids == want_ids
    assert_trees_equal(got, jax.tree.map(np.asarray, want))
    table = (got.get("clip") or got["clip_2"])["token_embedding"]["weight"]
    assert table.shape[0] > jtree.get("clip", jtree.get("clip_2"))["token_embedding"][
        "weight"].shape[0]


@pytest.mark.parametrize("config,sd,token", [
    ("tiny", {"emb_params": np.ones((1, 32))}, None),
    ("tiny", {"clip_l": np.ones((1, 32)), "clip_g": np.ones((1, 32))}, None),
    ("tiny", {"clip_l": np.ones((1, 32)), "clip_g": np.ones((1, 32))}, "<x>"),
    ("tiny", {"<bad>": np.ones((1, 48))}, None),
    ("tiny", {"<bad>": np.ones((2, 2, 32))}, None),
    ("tiny", {"string_to_param": np.ones((1, 32))}, None),
    ("xl", {"<one>": np.ones((1, 16))}, None),
])
def test_textual_inversion_errors_equal_the_jax_packages(jax_trees, config, sd, token):
    """Each layout's refusal: the same ValueError and message."""
    with pytest.raises(ValueError) as want:
        jti.apply_textual_inversion(jax_trees[config], sd, token=token)
    with pytest.raises(ValueError) as got:
        tti.apply_textual_inversion(params_from_numpy(jax_trees[config], device="cpu"), sd,
                                    token=token)
    assert str(got.value) == str(want.value)


def test_load_textual_inversion_registers_and_images_match(tok_pipes, tok_files):
    """``load_textual_inversion`` registers the placeholder with the port's
    tokenizer as with the JAX package's (the same ids for a prompt that
    uses it); the image from it is within one level of the JAX package's,
    and differs from the image without the concept."""
    jbase, tbase = tok_pipes
    # pipelines of their own over the shared trees: the tables and the
    # tokenizers grow
    j = JaxPipeline(TOK, jbase.params, JaxTokenizer.from_files(*tok_files))
    t = StableDiffusionPipeline(tbase.config, tbase.params,
                                CLIPTokenizer.from_files(*tok_files), device="cpu")
    emb = {"<cat-toy>": np.random.default_rng(4).standard_normal((2, 32)).astype(np.float32)}
    assert t.load_textual_inversion(emb) == j.load_textual_inversion(emb) == {
        "<cat-toy>": [1024, 1025]}
    prompt = "a <cat-toy> flying"
    ids = t.tokenizer.encode(prompt, max_length=16)
    assert ids == j.tokenizer.encode(prompt, max_length=16) and ids[2:4] == [1024, 1025]
    kw = dict(num_inference_steps=STEPS, seed=7)
    got = t.generate(prompt, **kw)
    assert_images_match(got, j.generate(prompt, **kw))
    assert not np.array_equal(got, t.generate("a cat flying", **kw))
    assert tbase.params["clip"]["token_embedding"]["weight"].shape[0] == 1024


def test_native_tokenizer_has_no_placeholders_in_either_package(tok_files, jax_trees):
    """A fault of the reference the port reproduces: the native tokenizer
    has no ``add_placeholder``, so ``load_textual_inversion`` on a pipeline
    that holds it raises AttributeError after growing the table, in both
    packages."""
    from sdtpu.tokenizer.native import NativeCLIPTokenizer as JaxNative
    from sdtpu_torch.tokenizer.native import NativeCLIPTokenizer

    emb = {"<t>": np.ones((1, 32), np.float32)}
    j = JaxPipeline(TINY, jax_trees["tiny"], JaxNative(*tok_files))
    t = StableDiffusionPipeline.from_params(port_config(TINY), jax_trees["tiny"], device="cpu",
                                            tokenizer=NativeCLIPTokenizer(*tok_files))
    for pipe in (j, t):
        with pytest.raises(AttributeError, match="add_placeholder"):
            pipe.load_textual_inversion(emb)


# -------------------------------------------------------- weighted prompts --

@pytest.mark.parametrize("config", ["tiny", "xl"])
def test_weighted_context_is_the_jax_packages(tok_pipes, tok_files, monkeypatch, config):
    """The weighted encode (cond and uncond rows, both parsed; for TINY_XL
    CLIP-L's and bigG's states each weighted apart, then side by side)
    within 1e-5 of the context the JAX program hands the UNet (read out of
    its program by a debug callback on ``precompute_cross_kv``), float32."""
    if config == "tiny":
        j, t = tok_pipes
        cfg = TOK
    else:
        cfg = TINY_XL
        j = JaxPipeline.from_random(cfg, seed=0, tokenizer=JaxTokenizer.from_files(*tok_files))
        t = StableDiffusionPipeline.from_params(
            port_config(cfg), jax.tree.map(np.asarray, j.params), device="cpu",
            tokenizer=CLIPTokenizer.from_files(*tok_files))
    seen = []
    real = junet.precompute_cross_kv

    def spy(context, *a, **kw):
        jax.debug.callback(lambda c: seen.append(np.asarray(c)), context)
        return real(context, *a, **kw)

    monkeypatch.setattr(junet, "precompute_cross_kv", spy)
    # a config of its own, so that the JAX program is traced with the spy
    spied = JaxPipeline(cfg.replace(name=cfg.name + "-ctx"), j.params, j.tokenizer)
    spied.generate(PW_PROMPT, NEG, num_inference_steps=1, seed=1, prompt_weighting=True)
    ids, w = t._tokenize(PW_PROMPT, NEG, True, None, weighted=True)
    assert sorted(set(w.ravel().round(4))) == [round(1 / 1.1, 4), 1.0, 1.4]
    size = cfg.default_image_size
    ctx, _ = t._encode(ids, 0, size=size, cfg=True, token_weights=w)
    plain, _ = t._encode(ids, 0, size=size, cfg=True)
    assert len(seen) == 1 and seen[0].shape == tuple(ctx.shape)
    np.testing.assert_allclose(ctx.numpy(), seen[0], rtol=0, atol=1e-5)
    assert np.abs(ctx.numpy() - plain.numpy()).max() > 1e-3


def test_unit_weights_give_the_unweighted_images_bitwise(tok_pipes):
    """Weights of 1 (explicit ``:1.0`` emphasis, all-ones ``token_weights``)
    reproduce the unweighted image bitwise, through ``generate`` and
    ``generate_batch``; a weight off 1 changes it."""
    _, t = tok_pipes
    kw = dict(num_inference_steps=STEPS, seed=3)
    base = t.generate("a cat flying", NEG, **kw)
    np.testing.assert_array_equal(
        t.generate("a (cat:1.0) flying", NEG, prompt_weighting=True, **kw), base)
    ids = t._tokenize("a cat flying", NEG, True, None)
    np.testing.assert_array_equal(
        t.generate(token_ids=ids, token_weights=np.ones(ids.shape), **kw), base)
    w = np.ones(ids.shape[1], np.float32)
    w[2] = 1.6
    assert not np.array_equal(t.generate(token_ids=ids, token_weights=w, **kw), base)
    bkw = dict(num_inference_steps=STEPS, seeds=[1, 2])
    bids = np.stack([ids[0], ids[1]])
    np.testing.assert_array_equal(
        t.generate_batch(["a", "b"], token_ids=bids, token_weights=np.ones(bids.shape), **bkw),
        t.generate_batch(["a", "b"], token_ids=bids, **bkw))


@pytest.mark.parametrize("rows", [1, 2])
def test_weighted_images_match_the_jax_packages(tok_pipes, rows):
    """``prompt_weighting`` and ``token_weights`` through ``generate``
    (``rows`` 1), and through ``generate(num_images=2)`` and
    ``generate_batch`` of two prompts with per-row negatives (``rows`` 2),
    each within one level of the JAX package's image."""
    j, t = tok_pipes
    kw = dict(num_inference_steps=STEPS, seed=5)
    ids = t._tokenize("a cat flying", NEG, True, None)
    w = np.ones(ids.shape[1], np.float32)
    w[2] = 1.5
    if rows == 1:
        assert_images_match(t.generate(PW_PROMPT, NEG, prompt_weighting=True, **kw),
                            j.generate(PW_PROMPT, NEG, prompt_weighting=True, **kw))
        assert_images_match(t.generate(token_ids=ids[:1], token_weights=w, **kw),
                            j.generate("x", token_ids=ids[:1], token_weights=w, **kw))
        return
    assert_images_match(t.generate(token_ids=ids[:1], token_weights=w, num_images=2, **kw),
                        j.generate("x", token_ids=ids[:1], token_weights=w, num_images=2,
                                   **kw))
    bkw = dict(num_inference_steps=STEPS, seeds=[3, 4], prompt_weighting=True)
    prompts, negs = [PW_PROMPT, "(a cat:0.8) flying"], [NEG, "[the dog]"]
    got = t.generate_batch(prompts, negs, **bkw)
    assert got.shape == (2, 32, 32, 3)
    assert_images_match(got, j.generate_batch(prompts, negs, **bkw))


def test_a_two_window_prompt_matches_the_jax_package(tok_pipes):
    """A prompt over one 16-token window chunks into two (the negative
    prompt padded to two); the image is within one level of the JAX
    package's."""
    j, t = tok_pipes
    ids = t._tokenize(LONG, NEG, True, None)
    assert ids.shape == (2, 32)
    kw = dict(num_inference_steps=STEPS, seed=8)
    assert_images_match(t.generate(LONG, NEG, **kw), j.generate(LONG, NEG, **kw))


@pytest.mark.parametrize("method,kwargs,match", [
    ("generate", {"prompt_weighting": True, "token_ids": TOKENS}, "parses the prompt string"),
    ("generate", {"prompt_weighting": True}, "needs a tokenizer"),
    ("generate", {"token_weights": np.ones((1, 16))}, "token_weights requires token_ids"),
    ("generate_batch", {"prompt_weighting": True, "token_ids": TOKENS},
     "parses the prompt strings"),
    ("generate_batch", {"prompt_weighting": True}, "needs a tokenizer"),
    ("generate_batch", {"token_weights": np.ones((2, 16))}, "token_weights requires token_ids"),
    ("generate_batch", {"token_ids": TOKENS, "token_weights": np.ones((2, 8))}, "must match"),
])
def test_weighting_errors_equal_the_jax_packages(tiny_pipe, tok_pipes, method, kwargs, match):
    """Every refusal of the weighted path, with the JAX package's message:
    "needs a tokenizer" on pipelines without one, the others on pipelines
    with the test tokenizer (``generate`` asks for a tokenizer before it
    reads ``token_weights``)."""
    if match == "needs a tokenizer":
        j = tiny_pipe
        t = StableDiffusionPipeline.from_params(port_config(TINY), jax.tree.map(
            np.asarray, tiny_pipe.params), device="cpu")
    else:
        j, t = tok_pipes
    args = ("x",) if method == "generate" else (["x", "y"],)
    with pytest.raises(ValueError, match=match) as got:
        getattr(t, method)(*args, num_inference_steps=1, **kwargs)
    with pytest.raises(ValueError, match=match) as want:
        getattr(j, method)(*args, num_inference_steps=1, **kwargs)
    assert str(got.value) == str(want.value)


def test_the_engine_buckets_weighted_requests_and_rows_match_solo(tok_pipes):
    """Prompt-weighted, token-weighted and unweighted requests take three
    buckets; the weighted ones coalesce (two rows a batch) and every row
    equals its solo ``generate_batch`` image bitwise, a two-window weighted
    request's too."""
    from sdtpu_torch.pipeline import serving

    _, t = tok_pipes
    ids = t._tokenize("a cat flying", "", True, None)[0]
    w = np.ones(16, np.float32)
    w[3] = 1.5
    reqs = [dict(prompt=PW_PROMPT, negative_prompt=NEG, prompt_weighting=True, seed=21),
            dict(prompt="(a cat:1.3) flying", prompt_weighting=True, seed=22),
            dict(prompt="x", token_ids=ids, token_weights=w, seed=23),
            dict(prompt="x", token_ids=ids, token_weights=np.ones(16), seed=24),
            dict(prompt=PW_PROMPT, seed=25),
            dict(prompt=LONG, prompt_weighting=True, seed=26)]
    engine = ServingEngine(t, max_batch_size=4, max_wait_ms=300)
    try:
        futs = [engine.submit(num_inference_steps=STEPS, **r) for r in reqs]
        got = [f.result(timeout=300) for f in futs]
        stats = engine.stats()
    finally:
        engine.shutdown()
    # the long prompt's two windows keep it out of the other weighted rows
    assert stats["batches"] == 4 and stats["requests"] == 6
    for r, img in zip(reqs, got):
        r = dict(r)
        prompt, neg, seed = r.pop("prompt"), r.pop("negative_prompt", ""), r.pop("seed")
        if "token_ids" in r:
            r.update(token_ids=r["token_ids"][None],
                     token_weights=np.asarray(r["token_weights"], np.float32)[None])
        solo = t.generate_batch([prompt], neg, seeds=[seed], num_inference_steps=STEPS, **r)
        np.testing.assert_array_equal(img, solo[0])
    assert not np.array_equal(got[0], got[4])  # the emphasis is applied
    a = serving._Request(prompt="p", negative_prompt="", seed=0, token_ids=None, future=None,
                         image_size=32, steps=1, sampler="ddpm", cfg=True, cfg_scale=7.5)
    assert len({a.bucket, dataclasses.replace(a, prompt_weighting=True).bucket,
                dataclasses.replace(a, token_weights=w).bucket}) == 3


# ------------------------------------------------------------------ demo --

def test_demo_text_feature_flags(tmp_path, monkeypatch, capsys):
    """``--lora PATH[:SCALE]`` (twice), ``--textual-inversion PATH[:TOKEN]``
    and ``--prompt-weighting`` on a diffusers directory with a tokenizer
    (``tests/test_from_pretrained.py``'s TINY_CKPT): the report lines the
    JAX demo prints, then the image; without a tokenizer
    ``--prompt-weighting`` is refused."""
    from sdtpu_torch import demo
    from sdtpu_torch.utils.image import read_png
    from test_from_pretrained import TINY_CKPT, _write_clip, _write_unet, _write_vae

    root = tmp_path / "ckpt"
    _write_clip(root / "text_encoder", TINY_CKPT.clip)
    _write_unet(root / "unet", TINY_CKPT.unet)
    _write_vae(root / "vae", TINY_CKPT.vae)
    build_assets(root / "tokenizer")
    monkeypatch.setitem(tcfg.PRESETS, "test/ckpt-tiny", port_config(TINY_CKPT))
    monkeypatch.setitem(tcfg.PRESETS, "test/tiny", port_config(TINY))
    tree = StableDiffusionPipeline.from_pretrained(str(root), preset="test/ckpt-tiny",
                                                   device="cpu").params
    rng = np.random.default_rng(2)
    lora_a, lora_b, ti = (str(tmp_path / n) for n in ("a.safetensors", "b.safetensors",
                                                      "ti.safetensors"))
    save_file(full_adapter(tree, rng), lora_a)
    save_file(lora_case("te-row", tree, rng) | {"unet.nothing.lora_A.weight": np.ones((4, 4))},
              lora_b)
    save_file({"emb_params": rng.standard_normal((2, 32)).astype(np.float32)}, ti)
    out = str(tmp_path / "out.png")
    demo.main(["--model-dir", str(root), "--preset", "test/ckpt-tiny", "--device", "cpu",
               "--steps", "1", "--out", out, "--lora", f"{lora_a}:0.5", "--lora", lora_b,
               "--textual-inversion", f"{ti}:<x>", "--prompt-weighting",
               "--prompt", "a (<x>:1.2) cat [flying]"])
    lines = capsys.readouterr().out.splitlines()
    n = len(tlora._parse_lora_sd(full_adapter(tree, rng))[0])
    assert lines[0] == f"lora {lora_a} (scale 0.5): {n} modules"
    assert lines[1] == f"lora {lora_b} (scale 1.0): 1 modules, skipped 1"
    assert lines[2] == f"textual inversion {ti}: <x> -> [1024, 1025]"
    assert lines[3].startswith(f"wrote {out} (32x32)")
    assert read_png(out).shape == (32, 32, 3)
    with pytest.raises(SystemExit, match="--prompt-weighting needs a tokenizer"):
        demo.main(["--preset", "test/tiny", "--device", "cpu", "--steps", "1", "--out", out,
                   "--prompt-weighting"])


# ------------------------------------------------------------------ card --

TOL_REL = 2e-2  # chip_smoke.py's: max |kernel - plain| <= TOL_REL * max |plain|


def _card_config():
    """TINY at 64 channels in bf16: its level-0 resnets and up-sample take
    the slab kernels, its attention the flash kernel."""
    unet = dataclasses.replace(port_config(TINY).unet, block_out_channels=(64, 64, 64))
    return port_config(TINY).replace(unet=unet, compute_dtype=torch.bfloat16,
                                     param_dtype=torch.bfloat16)


@pytest.mark.gpu
def test_a_fused_unet_runs_the_kernels_on_the_card():
    """A fused tree's UNet forward on the card launches A, B and C, and
    holds to the plain versions (the same tree and inputs on the CPU) by
    ``chip_smoke.py`` phase 4's rule for a whole network: relative L2
    within max(2 x the plain route's own bf16-vs-float32 difference,
    1e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    from sdtpu_torch.models.unet import unet_forward
    from sdtpu_torch.utils.weights import cast_tree, init_pipeline_params

    cfg = _card_config()
    tree = init_pipeline_params(0, cfg, device="cpu")
    fused, report = tlora.apply_lora(tree, full_adapter(tree, np.random.default_rng(0)),
                                     scale=0.8)
    assert report["applied"] > 40
    gen = torch.Generator().manual_seed(0)
    lat = torch.randn((2, 8, 8, 4), generator=gen)
    ctx = torch.randn((2, 16, 32), generator=gen)
    ts = torch.full((2,), 501.0)

    def forward(unet, dt, device):
        unet = cast_tree(unet, dt, device)
        return unet_forward(lat.to(device, dt), ts.to(device), ctx.to(device, dt), unet,
                            cfg.unet).float().cpu()

    plain = forward(fused["unet"], torch.bfloat16, "cpu")
    plain32 = forward(fused["unet"], torch.float32, "cpu")
    reset_launch_counts()
    got = forward(fused["unet"], torch.bfloat16, "cuda")
    assert launch_counts["conv3x3_slab"] > 0 and launch_counts["conv3x3_slab_upsample"] > 0
    assert launch_counts["flash_attention"] > 0

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    assert rel(got, plain) <= max(2 * rel(plain, plain32), 1e-2)


@pytest.mark.gpu
def test_unit_weights_are_bitwise_on_the_card():
    """All-ones token weights give the unweighted image bitwise on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    pipe = StableDiffusionPipeline.from_random(_card_config(), seed=0, device="cuda")
    kw = dict(token_ids=TOKENS, num_inference_steps=2, seed=1, image_size=64)
    base = pipe.generate(**kw)
    np.testing.assert_array_equal(pipe.generate(token_weights=np.ones(TOKENS.shape), **kw), base)
