"""Stable Diffusion 2.1 (768-v) through the port's normal path, on the CPU
at a toy size: DDIM with v-prediction (and with eps) and ``steps_offset``
1 against the benchmark's float32 reference, the reference sampler's
tables against the program's, the ``unet.plain_resnet`` span where the
slab rule refuses a map, and the two benchmark cells added with the
configuration."""

import copy
import json
import types

import numpy as np
import pytest
import torch

from sdbench import check, drive, spec, traffic, work
from sdbench.tests.test_sdbench_trace import span, synthetic
from sdbench.tests.tiny import TINY, TINY_LIMIT, mix
from sdbench.trace import View, split
from sdbench.weights import pipeline_params
from sdtpu_torch import StableDiffusionPipeline
from sdtpu_torch.config import SD21
from sdtpu_torch.utils import profiling

# SD 2.1's shape at a toy size: four UNet levels whose deepest map (4x4 at
# a 32x32 latent) is not a multiple of 8, so its resnets take the plain
# route as SD 2.1's 12x12 does at 768x768 (2 down, 2 mid, 3 up a step);
# head size 64 (``num_attention_heads`` 0), a mid block, a 2-layer erf-GELU
# encoder read at its final LayerNorm, DDIM with v-prediction and
# ``steps_offset`` 1, 2 steps, CFG
TINY_21 = copy.deepcopy(TINY)
TINY_21.update(name="tiny-21", image_size=64, steps=2, sampler="ddim")
TINY_21["clip"].update(hidden_act="gelu")
TINY_21["unet"].update(block_out_channels=[64, 64, 128, 128], layers_per_block=2,
                       attention_levels=[True, True, True, False],
                       transformer_layers_per_block=[1, 1, 1, 1], num_attention_heads=0,
                       mid_block=True)
TINY_21["scheduler"].update(prediction_type="v_prediction", steps_offset=1)
PLAIN_PER_STEP = 7
SPAN = "unet.plain_resnet"

# tiny-sd's shape: every map (32, 16, 8) a multiple of 8, every width >= 64
TINY_SD = copy.deepcopy(TINY)
TINY_SD.update(name="tiny-sd-shaped", image_size=64)
TINY_SD["unet"].update(block_out_channels=[64, 128, 128], attention_levels=[True, True, True],
                       transformer_layers_per_block=[1, 1, 1])


def _objective(cfg, prediction_type):
    out = copy.deepcopy(cfg)
    out["scheduler"]["prediction_type"] = prediction_type
    return out


def _serve(cfg, seed=5, steps=None, **replace):
    """The batched cell's call (``generate_batch``, 2 rows) with the spans
    recorded: (params, records, spans)."""
    pc = spec.pipeline_config(cfg)
    if replace:
        pc = pc.replace(**replace)
    params = pipeline_params(pc, seed, "cpu")
    pipe = StableDiffusionPipeline(pc, params, device="cpu")
    m = mix("batch8", batch=2)
    reqs = [drive.Inputs(seed, m, cfg)(j) for j in range(2)]
    run = dict(cfg, steps=steps or cfg["steps"])
    profiling.clear_spans()
    with profiling.record_spans():
        out = traffic.kind(m).call(pipe, run, m, reqs).numpy()
    recorded = profiling.spans()
    return params, [drive.Record(req=r, image=out[j]) for j, r in enumerate(reqs)], recorded


@pytest.fixture(scope="module")
def served_v():
    return _serve(TINY_21)


def _levels(recs, params, cfg):
    refs = check.references(recs, params, cfg, per_row=True, device="cpu")
    return [check.image_readings(r.image, ref, ["mean_abs_levels"])["mean_abs_levels"]
            for r, ref in zip(recs, refs)]


@pytest.mark.parametrize("objective", ["v_prediction", "epsilon"])
def test_program_matches_the_reference(objective, served_v):
    """bf16 program within the tiny limit of the float32 reference; under v,
    the reference reading the same model output as eps is beyond it."""
    cfg = _objective(TINY_21, objective)
    params, recs, _ = served_v if objective == "v_prediction" else _serve(cfg)
    assert max(_levels(recs, params, cfg)) <= TINY_LIMIT
    if objective == "v_prediction":
        as_eps = _objective(cfg, "epsilon")
        assert min(_levels(recs, params, as_eps)) > TINY_LIMIT


def test_float32_program_is_the_reference():
    """With float32 weights and compute the program and the reference do the
    same arithmetic, v-prediction DDIM and the plain route included: the
    images agree to the level."""
    cfg = dict(TINY_21, dtype="float32")
    params, recs, _ = _serve(cfg)
    assert max(_levels(recs, params, cfg)) <= 0.01


def test_reference_ddim_matches_the_program_sampler():
    from sdbench.reference.samplers import ddim as ref
    from sdtpu_torch.config import SchedulerConfig
    from sdtpu_torch.samplers.ddim import ddim_step, make_schedule

    sched = json.loads((spec.HERE / "configs" / "sd21-768.json").read_text())["scheduler"]
    assert ref.tables(sched, 25)["timesteps"][::24] == [961, 1]
    for steps, strength in ((25, 1.0), (25, 0.3)):
        tab = ref.tables(sched, steps, strength)
        prog = make_schedule(SchedulerConfig(**sched), steps, strength)
        assert tab["timesteps"] == prog.timesteps.tolist()
        for a, b in (("sa", "sqrt_alpha_prod"), ("sb", "sqrt_one_minus_alpha_prod"),
                     ("sa_prev", "sqrt_alpha_prod_prev"),
                     ("sb_prev", "sqrt_one_minus_alpha_prod_prev")):
            np.testing.assert_allclose(np.float32(tab[a]), getattr(prog, b).numpy(),
                                       rtol=1e-7, atol=0)
    g = torch.Generator().manual_seed(3)
    lat, out = torch.randn(2, 8, 8, 4, generator=g), torch.randn(2, 8, 8, 4, generator=g)
    for objective in ("v_prediction", "epsilon"):
        s = dict(sched, prediction_type=objective)
        tab, prog = ref.tables(s, 25), make_schedule(SchedulerConfig(**s), 25)
        for i in (0, 24):
            np.testing.assert_allclose(ref.step(tab, i, lat, out, None).numpy(),
                                       ddim_step(prog, i, lat, out).numpy(), rtol=0, atol=1e-6)


def test_plain_resnet_spans(served_v):
    """The plain route's span once per refused resnet and step, inside a
    ``unet_step``; none where every map takes the slab route, and none on
    the op route (``conv_impl="xla"``)."""
    spans = served_v[2]
    steps = {s["id"] for s in spans if s["name"] == "unet_step"}
    plain = [s for s in spans if s["name"] == SPAN]
    assert len(steps) == TINY_21["steps"]
    assert len(plain) == PLAIN_PER_STEP * TINY_21["steps"]
    assert {s["parent"] for s in plain} == steps
    assert {s["attrs"]["hw"] for s in plain} == {(4, 4)}
    for cfg, replace in ((TINY_SD, {}), (TINY_21, {"conv_impl": "xla"})):
        recorded = _serve(dict(cfg, cfg_scale=1.0), steps=1, **replace)[2]
        assert any(s["name"] == "unet_step" for s in recorded)
        assert not any(s["name"] == SPAN for s in recorded)


def _ctx(events):
    view = View(events) if events is not None else None
    return types.SimpleNamespace(cfg=TINY, mix={"batch": 1}, view=view,
                                 split=split(view) if view else None, work=work)


def test_cells_and_their_metric():
    from sdbench.run import load_metric

    cell = spec.load_cell("sd21-768-b4")
    cfg = cell.config
    assert (cfg["name"], cfg["image_size"], cfg["steps"], cfg["sampler"]) == \
        ("sd21-768", 768, 25, "ddim")
    assert cfg["reduced"] == [] and cfg["scheduler"]["prediction_type"] == "v_prediction"
    assert cfg["scheduler"]["steps_offset"] == 1
    pc = spec.pipeline_config(cfg)
    assert (pc.clip, pc.unet, pc.vae) == (SD21.clip, SD21.unet, SD21.vae)  # the published widths
    assert cell.traffic["kind"] == "batched" and cell.traffic["batch"] == 4
    assert cell.traffic["in_flight"] == 2 and cell.check["sample"] == 4
    # the rate whose bound its spread fits (PERF.md section 2)
    assert {m["name"] for m in cell.end_to_end} == {"images_per_s.i2i", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        n + ".i2i" for n in ("mfu_pct", "host_launch_calls_per_step", "elementwise_ms_per_step",
                             "rowwise_ms_per_step", "conv3x3_roofline", "attention_roofline",
                             "device_idle_pct")} | {"plain_resnet_ms_per_step"}

    b1 = spec.load_cell("tinysd-b1")
    assert b1.config["name"] == "tiny-sd" and b1.traffic == spec.load_cell("sdxl-1024").traffic
    assert b1.check["sample"] == 2 and b1.chips == cell.chips == 1
    assert {m["name"] for m in b1.end_to_end} == {"images_per_s.sdxl", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in b1.per_layer} == {
        m["name"] for m in spec.load_cell("sdxl-1024").per_layer}
    for c in (cell, b1):
        assert c.check["limits"] and set(c.check["limits"]) <= set(check.READINGS)

    read = load_metric("plain_resnet_ms_per_step")
    assert read(_ctx(None)) is None
    assert read(_ctx(synthetic())) is None  # no span: the parent's program
    # spans over request 1's first step's first two launches (two 10 us
    # at::native kernels) and its second step's first (10 us); one in the
    # unfetched request 2's step, one outside any step
    ev = synthetic() + [span(SPAN, 15, 30), span(SPAN, 125, 10), span(SPAN, 375, 10),
                        span(SPAN, 232, 5)]
    assert read(_ctx(ev)) == pytest.approx(0.015)
