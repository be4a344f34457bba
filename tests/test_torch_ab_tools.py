"""The port's A/B and probe tools (``sdtpu_torch/tools/probe_int8_slab.py``,
``ab_unet.py``, ``ab_quant.py``) and the card-only entry of every tool
that defaults to the card (with ``device_precision.py``, ``check_int8.py``
and the last tools, ``tests/test_torch_last_tools.py``): each ``main``
runs on the CPU at a tiny size and prints the JAX tool's lines; each
refuses ``cuda`` without a card; on a card (``gpu``-marked, skipped here)
each runs at a small size and launches its kernels.  Times are not
checked on the CPU: the tools time the plain versions there.
"""

import json
import re

import numpy as np
import pytest
import torch

import sdtpu_torch.config as tcfg
import sdtpu_torch.kernels.conv2d as tconv
from sdtpu_torch.kernels import launch_counts, reset_launch_counts
from sdtpu_torch.tools import (
    ab_conv_stats,
    ab_flash_nq,
    ab_packed_proj,
    ab_quant,
    ab_slab_grid,
    ab_unet,
    capture_trace,
    check_int8,
    device_precision,
    generate_grid,
    probe_flash_blocks,
    probe_flash_int8,
    probe_head_packing,
    probe_int8_slab,
    probe_out_proj,
    probe_slab_halo,
)
from test_pipeline import TINY
from test_torch_ops import port_config

torch.set_num_threads(1)

TOOLS = {"device_precision": device_precision.main, "check_int8": check_int8.main,
         "probe_int8_slab": probe_int8_slab.main, "ab_unet": ab_unet.main,
         "ab_quant": ab_quant.main,
         # the last tools (tests/test_torch_last_tools.py)
         "ab_conv_stats": ab_conv_stats.main, "ab_packed_proj": ab_packed_proj.main,
         "ab_flash_nq": ab_flash_nq.main, "probe_slab_halo": probe_slab_halo.main,
         "probe_out_proj": probe_out_proj.main, "probe_flash_blocks": probe_flash_blocks.main,
         "probe_head_packing": probe_head_packing.main,
         "probe_flash_int8": probe_flash_int8.main, "ab_slab_grid": ab_slab_grid.main,
         "generate_grid": generate_grid.main, "capture_trace": capture_trace.main}


@pytest.fixture
def tiny_preset(monkeypatch):
    monkeypatch.setitem(tcfg.PRESETS, "test/tiny", port_config(TINY))


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_each_tool_refuses_cuda_without_a_card(name, monkeypatch, capsys):
    """The card is the default; asked for ``cuda`` with none present, each
    tool exits non-zero before it makes anything, naming itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        TOOLS[name]([])
    assert exc.value.code == 2
    assert name in capsys.readouterr().err


def test_probe_int8_slab_prints_both_kernels_per_shape(capsys):
    """At a shape the slab rule takes, a line for A (bf16) and for D (int8)
    with ms per conv, the peak share and the split S; "no slab plan" where
    it refuses one; no launches on the CPU."""
    calls = probe_int8_slab.main(["2", "1x8x8x64x64", "1x8x8x32x64", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert calls == {}
    assert re.fullmatch(r"8x8 64->64 S=\d+ bf16: +[\d.]+ ms/conv \( *[\d.]+% of the bf16 peak; "
                        r"first chain [\d.]+s\)", out[0]), out[0]
    assert out[1].startswith("8x8 64->64 S=1 int8:") and "of the int8 peak" in out[1]
    assert out[2] == "8x8 32->64: no slab plan"
    assert len(probe_int8_slab.SHAPES) == 6 and all(
        tconv.plan_conv3x3_int8_split(b, h, w, ci, co) >= 1
        for b, h, w, ci, co in probe_int8_slab.SHAPES)


def test_probe_int8_slab_raises_where_a_kernel_fails(monkeypatch, capsys):
    """The JAX probe printed FAIL and went on; the port's ends the run with
    the kernel's exception."""
    def broken(*a, **kw):
        raise RuntimeError("kernel refused")

    monkeypatch.setattr(tconv, "conv3x3_slab", broken)
    with pytest.raises(RuntimeError, match="kernel refused"):
        probe_int8_slab.main(["1", "1x8x8x64x64", "--device", "cpu"])
    assert "FAIL" not in capsys.readouterr().out


def test_ab_unet_prints_every_route(tiny_preset, capsys):
    """The JAX tool's five variants, each a chain of UNet steps fed back,
    then each one's ratio to the dense-xla chain."""
    res = ab_unet.main(["test/tiny", "32", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert list(res) == [name for name, *_ in ab_unet.ROUTES] and all(v > 0 for v in res.values())
    for line, (name, *_) in zip(lines, ab_unet.ROUTES):
        assert re.fullmatch(re.escape(name) + r": +[\d.]+ ms / 2 steps = +[\d.]+ ms/step +"
                            r"\(first [\d.]+s, min +[\d.]+\)", line), line
    assert lines[5:] == [f"{name}: {res[ab_unet.ROUTES[0][0]] / res[name]:5.2f}x vs dense-xla"
                         for name, *_ in ab_unet.ROUTES]


def test_ab_unet_hoisted_step_equals_the_unhoisted_step(tiny_preset):
    """The hoisted variant (cross K/V and time projections once per chain,
    t over linspace(999, 1) as in the JAX tool) computes the unhoisted
    step at t = 999, on non-zero weights; its chain runs finite."""
    from sdtpu_torch.utils.weights import init_pipeline_params

    cfg = port_config(TINY)
    params = init_pipeline_params(0, cfg, device="cpu")["unet"]
    rng = np.random.default_rng(0)
    x0, ctx = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 4, 4, 4), (2, 77, 32)))
    ts = torch.full((2,), 500.0)
    plain, hoisted = (ab_unet.make_chain(cfg, params, x0, ts, ctx, None, attn="flash",
                                         conv="gemm", hoist=h, chain=3)() for h in (False, True))
    assert plain.shape == hoisted.shape == x0.shape
    assert bool(torch.isfinite(hoisted).all()) and not torch.equal(plain, hoisted)
    single = ab_unet.make_chain(cfg, params, x0, torch.full((2,), 999.0), ctx, None,
                                attn="flash", conv="gemm", hoist=False, chain=1)()
    once = ab_unet.make_chain(cfg, params, x0, ts, ctx, None, attn="flash", conv="gemm",
                              hoist=True, chain=1)()
    np.testing.assert_allclose(once.numpy(), single.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("variant,want", [
    ("bf16", {}), ("int8", {"transformer": False, "vae": False}),
    ("int8+vae", {"transformer": False, "vae": True}),
    ("int8+t", {"transformer": True, "vae": False}),
    ("int8+tfull+vae", {"transformer": "full", "vae": True}), ("vae", {"vae_only": True}),
])
def test_ab_quant_variant_grammar(variant, want):
    """The JAX tool's grammar: bf16 | int8[+t|+tfull][+vae] | vae."""
    assert ab_quant.parse_variant(variant) == want


def test_ab_quant_prints_one_line_per_run(tiny_preset, capsys):
    res = ab_quant.main(["--preset", "test/tiny", "--steps", "2", "--repeats", "2",
                         "--variants", "bf16", "int8+t", "vae", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res
    assert {k: line[k] for k in ("preset", "steps", "size", "sampler", "cfg")} == {
        "preset": "test/tiny", "steps": 2, "size": TINY.default_image_size, "sampler": "ddpm",
        "cfg": True}
    for variant in ("bf16", "int8+t", "vae"):
        assert set(line[variant]) == {"p50_s", "images_per_sec"} and line[variant]["p50_s"] > 0
    with pytest.raises(ValueError, match="unknown variant"):
        ab_quant.main(["--preset", "test/tiny", "--variants", "int4", "--device", "cpu"])


# ------------------------------------------------------------------ card --

@pytest.mark.gpu
def test_cuda_tools_run_at_a_small_size(monkeypatch, capsys):
    """Each tool on the card at a small size: the probe launches A and D as
    its calls say, the A/B tools print their lines, the gates print theirs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    cfg = port_config(TINY)  # 64-channel levels: head dim 32, the slab rule's widths
    unet = cfg.unet.__class__(**{**cfg.unet.__dict__, "block_out_channels": (64, 64, 64)})
    monkeypatch.setitem(tcfg.PRESETS, "test/tiny-bf16", cfg.replace(
        unet=unet, compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16))
    reset_launch_counts()
    calls = probe_int8_slab.main(["3", "2x16x16x320x320"])
    torch.cuda.synchronize()
    assert calls and {k: launch_counts[k] for k in calls} == dict(calls)
    assert ab_unet.main(["test/tiny-bf16", "64", "2"])
    assert ab_quant.main(["--preset", "test/tiny-bf16", "--steps", "2", "--repeats", "2",
                          "--image-size", "64"])
    assert "vae_decode_psnr_db" in device_precision.run("test/tiny-bf16", 8, torch.device("cuda"))
    res = check_int8.run(check_int8.parse_args(["--preset", "test/tiny-bf16", "--steps", "2",
                                                "--image-size", "64"]), torch.device("cuda"))
    assert 0 < res["kernel_rel_vs_float"] < check_int8.GATES[0][1]
