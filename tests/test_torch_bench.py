"""The port's measurement entry points on the CPU: ``python -m
sdtpu_torch.bench`` (the counterpart of ``bench.py``), ``tools/
profile_stages.py``, the FLOP count behind ``mfu_pct`` against the JAX
package's, and ``utils/profiling.py`` / ``utils/runtime.py``.

The bench and the stage timer run at the TINY test config, registered as a
preset for the test: at tiny-sd's widths a CPU run would take minutes.
Their times on the CPU measure nothing; the tests check what is printed
and that the refused flags name their slice.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import sdtpu.config as jcfg
import sdtpu.utils.flops as jflops
import sdtpu_torch.config as tcfg
import sdtpu_torch.utils.flops as tflops
from sdtpu_torch import StableDiffusionPipeline, bench
from sdtpu_torch.tools import profile_stages
from sdtpu_torch.utils import profiling
from sdtpu_torch.utils.runtime import device_sync, to_device
from test_pipeline import TINY, TOKENS
from test_torch_ops import port_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_KEYS = {"metric", "value", "unit", "vs_baseline", "baseline_definition",
                  "p50_latency_s", "p50_latency_semantics", "timing_mode", "batch", "device",
                  "program_tflops", "mfu_pct"}


@pytest.fixture
def tiny_preset(monkeypatch):
    monkeypatch.setitem(tcfg.PRESETS, "test/tiny", port_config(TINY))
    return "test/tiny"


def _json_line(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, out
    return json.loads(lines[0])


@pytest.mark.parametrize("extra,mode", [([], "pipelined"), (["--no-overlap"], "sequential"),
                                        (["--int8"], "pipelined")])
def test_bench_prints_the_reference_json_line(tiny_preset, capsys, extra, mode):
    result = bench.main(["--preset", tiny_preset, "--device", "cpu", "--steps", "2",
                         "--repeats", "2", *extra])
    line = _json_line(capsys.readouterr().out)
    assert line == result
    assert REFERENCE_KEYS <= set(line)
    assert line["timing_mode"] == mode and line["device"] == "cpu" and line["value"] > 0
    assert ("p50_request_latency_s" in line) == (mode == "pipelined")
    assert line["metric"] == (f"test/tiny 32x32 {'int8 ' if '--int8' in extra else ''}"
                              "2-step ddpm CFG images/sec/chip")
    # a CPU run reports no share of the card's peak
    assert line["mfu_pct"] is None
    flops = tflops.pipeline_flops(port_config(TINY), 32, 2, 1)
    assert line["program_tflops"] == round(flops / 1e12, 2)


@pytest.mark.parametrize("flags,slice_name", [
    (["--img2img", "--controlnet", "--encoder-cache", "2"], "incompatible with ControlNet"),
    (["--controlnet", "--encoder-cache", "3"], "incompatible with ControlNet"),
    (["--pag-scale", "-3"], "pag_scale must be >= 0"),
    (["--encoder-cache", "0"], "encoder_cache_interval must be >= 1"),
    (["--serving", "--pag-scale", "-3"], "pag_scale must be >= 0"),
    (["--batch", "2", "--encoder-cache", "0"], "encoder_cache_interval must be >= 1"),
    (["--sampler", "heun"], "unknown sampler"),
])
def test_bench_refuses_unported_flags(tiny_preset, flags, slice_name, monkeypatch):
    """``--controlnet``, ``--pag-scale`` and ``--encoder-cache`` run
    (``test_torch_controlnet.py``, ``test_torch_guidance.py``); an invalid
    value of theirs, also beside ``--img2img``, ``--serving`` and
    ``--batch``, and an unknown ``--sampler`` raise the JAX package's
    ValueError before any parameter is made."""
    from sdtpu_torch.utils import weights

    monkeypatch.setattr(weights, "zero_pipeline_params", None)  # never reached
    with pytest.raises(ValueError, match=slice_name):
        bench.main(["--preset", tiny_preset, "--device", "cpu", *flags])


SERVING_KEYS = {"metric", "value", "unit", "vs_baseline", "baseline_definition", "requests",
                "mean_batch_size", "batches", "wall_s", "device", "request_latency_p50_s",
                "request_latency_p95_s"}


@pytest.mark.parametrize("flags,metric", [
    (["--img2img", "--strength", "0.5"], "test/tiny 32x32 img2img 2-step ddpm CFG images/sec/chip"),
    (["--batch", "2"], "test/tiny 32x32 2-step ddpm CFG images/sec/chip"),
    (["--serving", "--requests", "5", "--batch", "2", "--device-batch", "1"],
     "test/tiny 32x32 2-step ddpm CFG serving images/sec/chip"),
])
def test_bench_img2img_batch_and_serving_lines(tiny_preset, capsys, flags, metric):
    """``bench.py``'s JSON keys for an img2img request, a ``generate_batch``
    of 2 and the serving engine (5 requests in batches of 2: 4 served)."""
    result = bench.main(["--preset", tiny_preset, "--device", "cpu", "--steps", "2",
                         "--repeats", "2", *flags])
    line = _json_line(capsys.readouterr().out)
    assert line == result and line["metric"] == metric and line["value"] > 0
    if "--serving" in flags:
        assert set(line) == SERVING_KEYS and line["requests"] == 4
        assert line["mean_batch_size"] <= 2
        return
    assert REFERENCE_KEYS | {"p50_request_latency_s"} == set(line)
    flops = tflops.pipeline_flops(port_config(TINY), 32, 2, line["batch"],
                                  img2img="--img2img" in flags, strength=0.5)
    assert line["program_tflops"] == round(flops / 1e12, 2)


def test_bench_conditioned_presets_take_their_inputs(monkeypatch, capsys):
    """A 9-channel inpaint preset runs img2img with a mask at strength 1, an
    8-channel editing preset img2img; neither line has a FLOP count, as in
    the JAX bench."""
    import dataclasses

    for ch in (9, 8):
        cfg = port_config(TINY.replace(unet=dataclasses.replace(TINY.unet, in_channels=ch)))
        monkeypatch.setitem(tcfg.PRESETS, f"test/tiny{ch}", cfg)
        line = bench.main(["--preset", f"test/tiny{ch}", "--device", "cpu", "--steps", "2",
                           "--repeats", "1"])
        assert "img2img" in line["metric"] and line["value"] > 0
        assert "program_tflops" not in line and "mfu_pct" not in line
    assert _json_line(capsys.readouterr().out.splitlines()[-1])["batch"] == 1


def test_bench_module_exits_non_zero_naming_the_slice():
    """``python -m sdtpu_torch.bench`` with a refused flag value: a non-zero
    exit and the JAX package's message in the error, before any parameter
    is made."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "sdtpu_torch.bench", "--device", "cpu",
                           "--controlnet", "--encoder-cache", "2"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "encoder_cache_interval is incompatible with ControlNet" in proc.stderr
    assert '"metric"' not in proc.stdout


def test_profile_stages_on_the_cpu(tiny_preset, capsys):
    out = profile_stages.main([tiny_preset, "32", "--device", "cpu", "--n", "2"])
    text = capsys.readouterr().out
    for name in ("clip (2x16)", "unet step (2x8x8)", "vae decode (1x8x8)", "ideal 25-step"):
        assert name in text
    assert set(out) == {"clip", "unet step", "vae decode", "ideal_total"}
    best, med = out["unet step"]
    assert 0 < best <= med
    assert out["ideal_total"] == pytest.approx(
        out["clip"][0] + 25 * best + out["vae decode"][0])


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_pipeline_flops_equal_the_jax_packages(name):
    jc, tc = jcfg.get_preset(name), tcfg.get_preset(name)
    for size, steps, cfg in ((512, 25, True), (256, 4, False)):
        assert tflops.pipeline_flops(tc, size, steps, 1, cfg=cfg) == jflops.pipeline_flops(
            jc, size, steps, 1, cfg=cfg)
    assert tflops.pipeline_flops(tc, 512, 25, 2, img2img=True, strength=0.6) == (
        jflops.pipeline_flops(jc, 512, 25, 2, img2img=True, strength=0.6))


# ------------------------------------------------------------- profiling --

def test_stage_timer_records_the_pipelines_stages():
    cfg = port_config(TINY)
    pipe = StableDiffusionPipeline.from_random(cfg, seed=0, device="cpu")
    timer = profiling.StageTimer()
    with timer.record():
        img = pipe.generate(token_ids=TOKENS, num_inference_steps=3, seed=1)
    assert img.shape == (1, 32, 32, 3)
    # the TINY UNet's 9 resnets a step are under the slab rule's widths (>= 64),
    # so each is a plain-route span inside its step
    assert timer.counts == {"request": 1, "tokenize": 1, "prepare": 1, "upload": 1,
                            "noise": 1, "clip": 1, "precompute": 1, "unet_step": 3,
                            "unet.plain_resnet": 27, "vae_decode": 1, "to_uint8": 1}
    assert all(t >= 0 for t in timer.totals.values())
    assert "unet_step" in timer.report() and "x3" in timer.report()
    # outside record() the stages time nothing
    pipe.generate(token_ids=TOKENS, num_inference_steps=1, seed=1)
    assert timer.counts["unet_step"] == 3
    with timer.time("holder", [torch.zeros(2)]):
        pass
    assert timer.counts["holder"] == 1


def test_trace_writes_a_chrome_trace_with_the_stages(tmp_path):
    cfg = port_config(TINY)
    pipe = StableDiffusionPipeline.from_random(cfg, seed=0, device="cpu")
    with profiling.trace(str(tmp_path)) as prof:
        pipe.generate(token_ids=TOKENS, num_inference_steps=2, seed=1)
    names = {e.name for e in prof.events()}
    assert {"tokenize", "clip", "precompute", "unet_step", "vae_decode", "to_uint8"} <= names
    with open(tmp_path / "trace.json") as f:
        trace = json.load(f)
    assert any(e.get("name") == "unet_step" for e in trace["traceEvents"])


def test_checked_raises_on_non_finite_outputs():
    ok = profiling.checked(lambda x: {"a": x * 2, "ids": torch.arange(3)})
    assert torch.equal(ok(torch.ones(2))["a"], torch.full((2,), 2.0))

    def nan_at_b(x):
        return [x, {"b": x / 0.0 * 0.0}]

    with pytest.raises(FloatingPointError, match="nan_at_b.*'b'"):
        profiling.checked(nan_at_b)(torch.ones(2))
    with pytest.raises(FloatingPointError):
        profiling.checked(lambda: np.array([1.0, np.inf]))()


def test_runtime_helpers_on_the_cpu():
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    a.setflags(write=False)
    t = to_device(a, "cpu", torch.int64)
    assert t.dtype == torch.int64 and t.tolist() == a.tolist()
    device_sync(t)
    device_sync({"x": [t]})
    device_sync()
