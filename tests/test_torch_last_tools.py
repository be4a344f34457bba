"""The last tools of the port (``sdtpu_torch/tools/``: ``ab_conv_stats``,
``ab_packed_proj``, ``ab_flash_nq``, ``probe_slab_halo``,
``probe_out_proj``, ``probe_flash_blocks``, ``probe_head_packing``,
``probe_flash_int8``, ``ab_slab_grid``, ``generate_grid``,
``capture_trace``, ``summarize_trace``) and the switch one of them needs,
``kernels/conv2d.py:CONV_STATS_CHAIN``.

* The switch against the JAX package's ``sdtpu.kernels.conv2d.
  CONV_STATS_CHAIN``, set the same way, in float32: the UNet forward and
  the VAE decode at TINY (whose 16-32 channels take no slab, Ci >= 64
  being the slab rule's, so on and off are bitwise one function there) and
  at TINY's topology widened to 64 channels and 32 groups (``Q64``, its
  VAE one level deep), where the first level's resnets take the slab, its
  transformer's GroupNorm (and the VAE mid block's attention's) reads
  their moments, and the switch changes the computation.  The JAX package
  reads the switch when it traces, so each setting gets a fresh
  ``jax.jit``; its slab kernel runs in interpret mode.
  Tolerance 1e-5 relative plus 1e-5 of the output's scale
  (``test_torch_models.py``: the two differ in summation order only).
* Each card probe's shape lists equal the JAX tool's where they carry
  over (the JAX tools loaded by path, as ``test_torch_probes.py`` does):
  the stated exceptions are ``probe_out_proj``'s head dim (the TPU padded
  it to 128 lanes; the port takes channels / heads) and
  ``probe_flash_blocks``' ``BLOCKS`` (TPU tile sizes).
* The three A/B chains run on the CPU at a tiny preset and print every
  variant; on seeded float32 weights each pair of chains agrees within
  1e-5 (``stats=off``/``ON``; ``packed=off``/``ON``, kernel G's plain
  version against the einsum) and every plan of ``ab_flash_nq`` is the
  same function on the CPU.
* ``generate_grid``: the grid's shape, each tile bitwise the port's
  ``generate_batch`` row, and the seed-0 tile within one uint8 level of
  the JAX tool's for the same ids (``conftest.assert_images_match``).
* ``summarize_trace`` on a written ``trace.json`` with known nested spans
  (exact busy time, idle share, gaps and their stages, self times, the
  window), then on ``capture_trace --device cpu``'s trace of a TINY
  request (host ops, no device activity).
"""

import dataclasses
import importlib.util
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import sdtpu.kernels.conv2d as jconv
import sdtpu.models.unet as junet
import sdtpu.models.vae as jvae
import sdtpu_torch.config as tcfg
import sdtpu_torch.kernels.conv2d as tconv
import sdtpu_torch.kernels.flash_attention as tfa
import sdtpu_torch.models.unet as tunet
import sdtpu_torch.models.vae as tvae
from conftest import assert_images_match
from sdtpu.config import UNetConfig, VAEConfig
from sdtpu_torch.tools import (
    ab_conv_stats,
    ab_flash_nq,
    ab_packed_proj,
    ab_slab_grid,
    ab_unet,
    capture_trace,
    generate_grid,
    probe_flash_blocks,
    probe_flash_int8,
    probe_head_packing,
    probe_out_proj,
    probe_slab_halo,
    summarize_trace,
)
from test_pipeline import TINY
from test_torch_ops import nn, port_config, port_params, tt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q64 = TINY.replace(
    name="test/q64",
    unet=UNetConfig(block_out_channels=(64, 64), layers_per_block=1,
                    attention_levels=(True, False), num_attention_heads=2,
                    cross_attention_dim=32, norm_num_groups=32),
    vae=VAEConfig(block_out_channels=(64,), layers_per_block=1, norm_num_groups=32))


def jax_tool(name):
    """The JAX package's ``tools/<name>.py`` as a module (``tools`` is not a
    package)."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def close_scaled(got, want, rtol=1e-5):
    g, w = nn(got), nn(want)
    assert g.shape == w.shape and np.isfinite(g).all()
    np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * max(1.0, np.abs(w).max()))


@pytest.fixture
def tiny_preset(monkeypatch):
    monkeypatch.setitem(tcfg.PRESETS, "test/tiny", port_config(TINY))


# ----------------------------------------------------------- the switch --

def test_conv_stats_chain_reads_the_jax_packages_variable(monkeypatch):
    """On unless ``SDTPU_CONV_STATS`` is 0 or false, as in the JAX package
    (each value read by a fresh copy of the module, not the one in use)."""
    assert tconv.CONV_STATS_CHAIN is True and jconv.CONV_STATS_CHAIN is True

    def fresh():
        spec = importlib.util.spec_from_file_location("conv2d_copy", tconv.__file__)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.CONV_STATS_CHAIN

    for value, want in (("0", False), ("false", False), ("1", True), (None, True)):
        if value is None:
            monkeypatch.delenv("SDTPU_CONV_STATS")
        else:
            monkeypatch.setenv("SDTPU_CONV_STATS", value)
        assert fresh() is want


@pytest.mark.parametrize("cfg", [TINY, Q64], ids=["tiny", "q64"])
def test_conv_stats_chain_off_and_on_match_the_jax_package(cfg, monkeypatch):
    """The UNet forward (batch 2, 8 x 8 latents) and the VAE decode (8 x 8
    latents) with the switch on and off in both packages; with it on the
    port's output is bitwise its default's.  At Q64 off differs from on
    (GroupNorm statistics from the map, not from the moments)."""
    rng = np.random.default_rng(3)
    ju, jv = junet.init_unet(5, cfg.unet), jvae.init_vae_decoder(6, cfg.vae)
    tu, tv = port_params(ju), port_params(jv)
    ucfg, vcfg = port_config(cfg.unet), port_config(cfg.vae)
    lat = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 16, 32)).astype(np.float32)
    ts = np.array([500.0, 20.0], np.float32)
    z = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)

    def port():
        return (tunet.unet_forward(tt(lat), tt(ts), tt(ctx), tu, ucfg),
                tvae.vae_decode(tt(z), tv, vcfg))

    default = port()
    got = {}
    for on in (False, True):
        monkeypatch.setattr(tconv, "CONV_STATS_CHAIN", on)
        monkeypatch.setattr(jconv, "CONV_STATS_CHAIN", on)
        got[on] = port()
        fwd = jax.jit(lambda p: junet.unet_forward(jnp.asarray(lat), jnp.asarray(ts),
                                                   jnp.asarray(ctx), p, cfg.unet,
                                                   conv_impl="gemm"))
        dec = jax.jit(lambda p: jvae.vae_decode(jnp.asarray(z), p, cfg.vae, conv_impl="gemm"))
        with pltpu.force_tpu_interpret_mode():
            want = fwd(ju), dec(jv)
        for g, w in zip(got[on], want):
            close_scaled(g, w)
    for g, d in zip(got[True], default):
        assert torch.equal(g, d)
    same = [torch.equal(a, b) for a, b in zip(got[False], got[True])]
    assert same == ([True, True] if cfg is TINY else [False, False])


# ---------------------------------------------------- shapes of the tools --

@pytest.mark.parametrize("tool,names", [
    ("probe_slab_halo", ("HALO_SHAPES", "UP_SHAPES")),
    ("probe_out_proj", ("SHAPES",)),
    ("probe_flash_blocks", ("SHAPES",)),
    ("probe_head_packing", ("CASES", "CHAIN")),
    ("probe_flash_int8", ("SHAPES",)),
    ("ab_slab_grid", ("SHAPES",)),
])
def test_shape_lists_are_the_jax_tools(tool, names):
    """Each probe's shapes are its JAX tool's; the TPU-only ``BLOCKS`` rows
    of ``probe_flash_blocks`` have no counterpart."""
    port = {"probe_slab_halo": probe_slab_halo, "probe_out_proj": probe_out_proj,
            "probe_flash_blocks": probe_flash_blocks, "probe_head_packing": probe_head_packing,
            "probe_flash_int8": probe_flash_int8, "ab_slab_grid": ab_slab_grid}[tool]
    jt = jax_tool(tool)
    for name in names:
        assert getattr(port, name) == getattr(jt, name), name
    if tool == "probe_flash_blocks":
        assert hasattr(jt, "BLOCKS") and not hasattr(port, "BLOCKS")
    if tool == "probe_out_proj":
        # the real head dims: tiny-sd 40/80/160, SDXL and SD2.1 64 (the TPU padded to 128)
        assert [c // h for _, _, h, _, c in port.SHAPES] == [40, 80, 160, 64, 64, 64]
        o, w, bias, res = probe_out_proj.inputs(1, 2, 8, 16, device="cpu")
        assert (o.shape, w.shape, bias.shape, res.shape) == ((1, 2, 8, 8), (2, 8, 16), (16,),
                                                             (1, 8, 16))


@pytest.mark.parametrize("tool", ["capture_trace", "summarize_trace"])
def test_trace_tools_take_the_jax_tools_flags(tool):
    """Every flag of the JAX tool's parser is the port's (the port adds
    ``--device`` to ``capture_trace`` and ``--split`` to the summary)."""
    with open(os.path.join(REPO, "tools", f"{tool}.py")) as f:
        want = set(re.findall(r'add_argument\(\s*"(--[\w-]+)"', f.read()))
    port = capture_trace if tool == "capture_trace" else summarize_trace
    with open(port.__file__) as f:
        got = set(re.findall(r'add_argument\(\s*"(--[\w-]+)"', f.read()))
    assert want and want <= got, want - got


# ------------------------------------------------------- plans and rules --

@pytest.mark.parametrize("bh,lq,lk,d,want", [
    (16, 4096, 4096, 40, [(64, 1), (128, 1)]),
    (10, 9216, 9216, 64, [(64, 1)]),
    (20, 4096, 4096, 64, [(64, 1)]),
    (16, 256, 77, 160, [(64, 1)]),
    (1, 4096, 4096, 512, [(64, s) for s in range(1, 17)]),
])
def test_flash_plans_hold_the_plan(bh, lq, lk, d, want):
    """The plans C's launch takes (its tiles, its key splits past d = 160);
    ``plan_flash``'s choice is among them."""
    plans = tfa.flash_plans(bh, lq, lk, d)
    assert plans == want and tfa.plan_flash(bh, lq, lk, d) in plans


def test_ab_flash_nq_rules():
    """``bq=128`` where the padded depth takes it, else the plan's; ``bq=64``
    everywhere to d = 160; past it the plan's split; unknown names refused."""
    plan = tfa.plan_flash
    r64, r128 = ab_flash_nq.plan_rule("bq=64", plan), ab_flash_nq.plan_rule("bq=128", plan)
    assert ab_flash_nq.plan_rule("plan", plan) is plan
    assert r128(16, 4096, 4096, 40) == (128, 1) and r64(16, 4096, 4096, 40) == (64, 1)
    assert r128(10, 9216, 9216, 64) == (64, 1) == plan(10, 9216, 9216, 64)
    assert r64(1, 4096, 4096, 512) == r128(1, 4096, 4096, 512) == plan(1, 4096, 4096, 512)
    with pytest.raises(ValueError, match="unknown plan"):
        ab_flash_nq.plan_rule("nq=2", plan)


def test_ab_slab_grid_split_cap_is_the_plans():
    """S from 1 to the plan's cap; the plan's own S lies in that range."""
    for b, h, w, ci, co in ab_slab_grid.SHAPES:
        cap = ab_slab_grid.split_cap(ci)
        assert 1 <= tconv.plan_conv3x3_split(b, h, w, ci, co) <= cap
    assert [ab_slab_grid.split_cap(ci) for *_, ci, _ in ab_slab_grid.SHAPES] == [16, 16, 16, 16, 4]


# ------------------------------------------------------------- A/B chains --

def test_ab_chains_print_every_variant(tiny_preset, monkeypatch, capsys):
    """``ab_conv_stats`` (the UNet and ``--vae`` chains), ``ab_packed_proj``
    and ``ab_flash_nq`` on the CPU at the tiny preset (``--vae`` decodes with
    tiny-sd's VAE config: TINY's stands in for it here), a line per variant,
    medians returned, the switches restored."""
    monkeypatch.setitem(tcfg.PRESETS, "tiny-sd", port_config(TINY))
    pat = r": +[\d.]+ ms / 2 {unit}s = +[\d.]+ ms/{unit}  \(min +[\d.]+\)"
    for main, names, tail, argv, unit in (
            (ab_conv_stats.main, ab_conv_stats.NAMES, "conv-stats chain: ",
             ["test/tiny", "32", "2"], "step"),
            (ab_conv_stats.main, ab_conv_stats.NAMES, "conv-stats chain: ",
             ["--vae", "8", "2"], "call"),
            (ab_packed_proj.main, ab_packed_proj.NAMES, "packed out-proj: ",
             ["test/tiny", "32", "2"], "step")):
        meds = main(argv + ["--device", "cpu"])
        lines = capsys.readouterr().out.splitlines()
        assert list(meds) == list(names) and all(v > 0 for v in meds.values())
        assert [ln.split(":")[0] for ln in lines[:2]] == [n for n in names]
        for name in names:
            assert any(re.fullmatch(re.escape(name) + pat.format(unit=unit), ln)
                       for ln in lines), (name, lines)
        assert lines[-1].startswith(tail)
    assert tconv.CONV_STATS_CHAIN is True
    assert importlib_attention()._PACKED_OUT_PROJ is False
    res = ab_flash_nq.main(["test/tiny", "32", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [name for name, _ in res] == ["plan", "bq=64", "bq=128", "plan"]
    for line, (name, _) in zip(lines, res):
        assert re.fullmatch(re.escape(name) + r": +[\d.]+ ms / 2 steps = +[\d.]+ ms/step  "
                            r"\(first [\d.]+s, min +[\d.]+\)", line), line
    assert tfa.plan_flash.__name__ == "plan_flash"


def importlib_attention():
    import importlib

    return importlib.import_module("sdtpu_torch.ops.attention")


def test_ab_chain_variants_agree_in_float32():
    """On seeded float32 Q64 weights (8 x 8 latents: the first level's
    resnets on the slab), the chains of each pair agree within 1e-5: the
    statistics from the moments or from the map, the out-projection by G's
    plain version or by the einsum."""
    from sdtpu_torch.utils.weights import init_pipeline_params

    cfg = port_config(Q64)
    params = init_pipeline_params(0, cfg, device="cpu")["unet"]
    rng = np.random.default_rng(0)
    x0, ctx = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 8, 8, 4), (2, 16, 32)))
    fn = ab_unet.make_chain(cfg, params, x0, torch.full((2,), 500.0), ctx, None, attn="flash",
                            conv="gemm", hoist=True, chain=2)
    off, on = (ab_conv_stats.with_chaining(fn, v)() for v in (False, True))
    close_scaled(off, on)
    assert not torch.equal(off, on)
    off, on = (ab_packed_proj.with_packed(fn, v)() for v in (False, True))
    close_scaled(off, on)
    assert tconv.CONV_STATS_CHAIN is True and importlib_attention()._PACKED_OUT_PROJ is False


# ------------------------------------------------------------ the grid --

def test_generate_grid_tiles_are_the_batch_rows(tiny_preset, tmp_path, tiny_pipe):
    """2 seeds x 1 prompt, 2 dpm++ steps at 32 x 32: the grid (32, 64, 3),
    each tile bitwise the port's ``generate_batch`` row with the tool's ids
    (no tokenizer: the prompt's hash), the PNG read back equal; the seed-0
    tile within one level of the JAX tool's batch for the same ids."""
    from sdtpu_torch import StableDiffusionPipeline
    from sdtpu_torch.utils.image import read_png

    out = str(tmp_path / "grid.png")
    grid = generate_grid.main(["--preset", "test/tiny", "--seeds", "0", "1", "--steps", "2",
                               "--image-size", "32", "--out", out, "--device", "cpu"])
    assert grid.shape == (32, 64, 3) and grid.dtype == np.uint8
    np.testing.assert_array_equal(read_png(out), grid)
    ids = generate_grid.prompt_ids("a cat flying a spaceship", TINY.clip.vocab_size,
                                   TINY.clip.max_length, 2)
    kw = dict(seeds=[0, 1], num_inference_steps=2, image_size=32, sampler="dpm++",
              cfg_scale=7.5, token_ids=ids)
    pipe = StableDiffusionPipeline.from_random("test/tiny", device="cpu")
    rows = pipe.generate_batch(["a cat flying a spaceship"] * 2, **kw)
    for j in range(2):
        np.testing.assert_array_equal(grid[:, 32 * j:32 * (j + 1)], rows[j])
    want = tiny_pipe.generate_batch(["a cat flying a spaceship"] * 2, **kw)
    assert_images_match(grid[None, :, :32], np.asarray(want)[:1])


# ------------------------------------------------------------ the traces --

def _written_trace(path):
    """Known spans (us): stages clip [0, 10], unet_step [10, 30] and
    [30, 50], vae_decode [50, 60]; host ops nested in them; three launches
    (correlation 1-3) and their kernels on stream 7, a memcpy without one;
    metadata, a flow and a device-side annotation that are not spans of
    the summary."""
    host = dict(pid=11, tid=11)
    dev = dict(pid=0, tid=7)
    ev = [
        {"ph": "M", "name": "process_name", "pid": 11, "tid": 0, "args": {"name": "python"}},
        {"ph": "X", "cat": "user_annotation", "name": "clip", "ts": 0.0, "dur": 10.0, **host},
        {"ph": "X", "cat": "user_annotation", "name": "unet_step", "ts": 10.0, "dur": 20.0,
         **host},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv", "ts": 12.0, "dur": 8.0, **host},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 14.0, "dur": 4.0, **host},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 18.5, "dur": 0.5,
         "args": {"correlation": 1}, **host},
        {"ph": "X", "cat": "user_annotation", "name": "unet_step", "ts": 30.0, "dur": 20.0,
         **host},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 32.0, "dur": 2.0, **host},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 33.0, "dur": 0.5,
         "args": {"correlation": 2}, **host},
        {"ph": "X", "cat": "user_annotation", "name": "vae_decode", "ts": 50.0, "dur": 10.0,
         **host},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 52.0, "dur": 1.0,
         "args": {"correlation": 3}, **host},
        {"ph": "X", "cat": "kernel", "ts": 19.0, "dur": 10.0, "args": {"correlation": 1},
         "name": "void (anonymous namespace)::flash_reg_kernel<64, 1, 128, false, 0, 4>"
                 "(bf16 const*)", **dev},
        {"ph": "X", "cat": "kernel", "ts": 34.0, "dur": 2.0, "args": {"correlation": 2},
         "name": "void at::native::vectorized_elementwise_kernel<4>(int)", **dev},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_bf16", "ts": 53.0, "dur": 5.0,
         "args": {"correlation": 3}, **dev},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)", "ts": 58.0,
         "dur": 1.0, **dev},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "unet_step", "ts": 19.0, "dur": 17.0,
         **dev},
        {"ph": "s", "cat": "ac2g", "name": "launch", "id": 1, "ts": 18.5, **host},
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


def test_summarize_trace_on_a_written_trace(tmp_path, capsys):
    """Exact figures of the written trace: busy 18 us of a 60 us window
    (idle 0.7), the gaps with their stages, the device time by kind, and
    the self-time attribution inside and outside the unet_step window
    (device work by its launch's time; nested host spans counted once)."""
    _written_trace(tmp_path / "trace.json")
    events = summarize_trace.load_trace(str(tmp_path))
    assert len(events) == 15
    split = summarize_trace.trace_split(events, 0.5)
    assert split["window_ms"] == pytest.approx(0.060) and split["device_events"] == 4
    assert split["device_busy_ms"] == pytest.approx(0.018)
    assert split["idle_share"] == pytest.approx(0.7)
    assert [(round(g["ms"], 6), round(g["at_ms"], 6), g["stage"])
            for g in split["longest_idle_gaps"]] == [
        (0.019, 0.0, "clip"), (0.017, 0.036, "unet_step"), (0.005, 0.029, "unet_step"),
        (0.001, 0.059, "vae_decode")]
    assert {k: (round(v["ms"], 6), v["count"]) for k, v in split["device_ms_by_kind"].items()} \
        == {"hand-written kernels": (0.010, 1), "PyTorch elementwise and reductions": (0.002, 1),
            "library GEMM, conv and attention": (0.005, 1), "copies and sets": (0.001, 1)}
    assert split["host_stage_ms"] == pytest.approx(
        {"clip": 0.010, "unet_step": 0.040, "vae_decode": 0.010})

    def rounded(d):
        return {k: round(v, 6) for k, v in d.items()}

    inside = summarize_trace.summarize(events, steps=2)
    assert inside["spans"] == 2 and inside["window_ms"] == pytest.approx(0.040)
    dev_ms, dev_n = inside["device"]
    assert rounded(dev_ms) == {
        "void (anonymous namespace)::flash_reg_kernel<64, 1, 128, false, 0, 4>(bf16 const*)":
            0.010, "void at::native::vectorized_elementwise_kernel<4>(int)": 0.002}
    host_ms, host_n = inside["host"]
    assert rounded(host_ms) == {"unet_step": 0.030, "aten::conv": 0.0035, "aten::mm": 0.004,
                                "aten::add": 0.0015, "cudaLaunchKernel": 0.001}
    assert host_n["unet_step"] == 2 and host_n["cudaLaunchKernel"] == 2
    out = capsys.readouterr().out
    assert "window: 2 unet_step spans, 0.040 ms of host time" in out
    assert "device self time in the unet_step window: 0.012 ms (0.006 ms/step" in out
    outside = summarize_trace.attribute(events, outside=True)
    assert rounded(outside["device"][0]) == {"sm90_xmma_gemm_bf16": 0.005,
                                             "Memcpy DtoH (Device -> Pinned)": 0.001}
    assert rounded(outside["host"][0]) == {"clip": 0.010, "vae_decode": 0.009,
                                           "cudaLaunchKernel": 0.001}
    raw = summarize_trace.main([str(tmp_path / "trace.json"), "--raw"])
    assert raw["user_annotation"]["unet_step"] == [pytest.approx(0.040), 2]


def test_capture_trace_on_the_cpu_and_its_summary(tiny_preset, tmp_path, capsys):
    """``capture_trace --device cpu`` at the tiny preset (2 steps, 2
    pipelined requests) writes ``trace.json``; the summary finds 4
    unet_step spans, host ops in them, no device activity; ``--split``
    finds every stage and an idle share of 1."""
    path = capture_trace.main(["--preset", "test/tiny", "--steps", "2", "--repeats", "1",
                               "--out", str(tmp_path / "cap"), "--device", "cpu"])
    assert path == str(tmp_path / "cap" / "trace.json") and os.path.exists(path)
    res = summarize_trace.main([str(tmp_path / "cap"), "--steps", "2", "--top", "5"])
    assert res["spans"] == 4 and res["device"] == ({}, {})
    host_ms, host_n = res["host"]
    assert host_n["unet_step"] == 4 and any(n.startswith("aten::") for n in host_ms)
    assert sum(host_ms.values()) == pytest.approx(res["window_ms"], rel=1e-6)
    split = summarize_trace.main([path, "--split"])
    assert split["device_events"] == 0 and split["idle_share"] == 1.0
    assert set(split["host_stage_ms"]) >= {"clip", "precompute", "unet_step", "vae_decode"}
    capsys.readouterr()


def test_dataclass_configs_carry_over():
    """Q64 is TINY's UNet at 64 channels (the slab's minimum) and 32
    groups, a transformer on its first level; its first level's resnets
    take the slab, TINY's none."""
    from sdtpu_torch.utils.quant import slab_plan_ok

    assert dataclasses.replace(Q64.unet, block_out_channels=(16, 24, 32),
                               attention_levels=(True, True, True),
                               norm_num_groups=8) == TINY.unet
    assert Q64.unet.attention_levels[0]  # the slab level's resnet feeds a transformer
    assert slab_plan_ok((2, 8, 8, 64), (3, 3, 64, 64))
    assert not slab_plan_ok((2, 8, 8, 16), (3, 3, 16, 16))
