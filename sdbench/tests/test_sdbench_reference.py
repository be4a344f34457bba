"""The plain float32 reference against the program on the CPU, and the
control: the reference in the program's place with fp8 operands."""

import dataclasses

import numpy as np
import pytest

from sdbench import check, drive, spec, traffic
from sdbench.tests.tiny import TINY, TINY_LIMIT, TINY_XL, mix
from sdbench.weights import pipeline_params


def _served(cfg, mix_, seed=11, n=2):
    from sdtpu_torch import StableDiffusionPipeline

    pc = spec.pipeline_config(cfg)
    params = pipeline_params(pc, seed, "cpu")
    pipe = StableDiffusionPipeline(pc, params, device="cpu")
    inputs = drive.Inputs(seed, mix_, cfg)
    reqs = [inputs(j) for j in range(n)]
    out = traffic.kind(mix_).call(pipe, cfg, mix_, reqs).numpy()
    return params, [drive.Record(req=r, image=out[j]) for j, r in enumerate(reqs)]


def _levels(images, refs):
    return [check.image_readings(a, b, ["mean_abs_levels"])["mean_abs_levels"]
            for a, b in zip(images, refs)]


def _refs(recs, params, cfg, m, lowp="f32"):
    return check.references(recs, params, cfg, per_row=traffic.kind(m).PER_ROW, device="cpu",
                            lowp=lowp)


CASES = [("batch8", TINY, {"batch": 2}), ("single2", TINY, {}), ("i2i-batch8", TINY, {"batch": 2}),
         ("batch8", TINY_XL, {"batch": 2}), ("batch8", dict(TINY, cfg_scale=1.0), {"batch": 2})]
IDS = ["batched", "single", "img2img", "xl", "unguided"]


@pytest.mark.parametrize("name,config,changes", CASES, ids=IDS)
def test_reference_equals_program_in_float32(name, config, changes):
    """With float32 weights and compute the program and the reference do the
    same arithmetic: the images agree to the level."""
    cfg = dict(config, dtype="float32")
    m = mix(name, **changes)
    params, recs = _served(cfg, m)
    levels = _levels([r.image for r in recs], _refs(recs, params, cfg, m))
    assert max(levels) <= 0.01, levels


@pytest.mark.parametrize("name,config,changes", CASES, ids=IDS)
def test_control_fails_where_the_program_passes(name, config, changes):
    """bf16 program within the tiny configuration's limit; the fp8 control,
    the reference with fp8 operands in the program's place, beyond it and
    at least three times the program's reading."""
    m = mix(name, **changes)
    params, recs = _served(config, m)
    refs = _refs(recs, params, config, m)
    program = max(_levels([r.image for r in recs], refs))
    control = min(_levels(_refs(recs, params, config, m, "fp8"), refs))
    assert program <= TINY_LIMIT < control
    assert control >= 3 * program


def test_prng_matches_the_program():
    from sdbench.reference import prng as ref
    from sdtpu_torch.pipeline.pipeline import request_noise
    from sdtpu_torch.utils import prng

    for seeds, heads in (([5, 2**32 - 1], 1), ([7], 2)):
        key = np.stack([prng.key(s) for s in seeds])
        program = "txt2img" if heads == 1 else "img2img"
        got = request_noise(key, 3, (len(seeds), 4, 4, 4), "cpu", program=program)
        for j, s in enumerate(seeds):
            want = ref.normals(ref.request_keys(s, 3, heads=heads, per_row=True), (4, 4, 4),
                               "cpu")
            np.testing.assert_allclose(want.numpy(), got[:, j].numpy(), rtol=0, atol=2e-6)
    got = request_noise(prng.key(9), 3, (1, 4, 4, 4), "cpu", program="txt2img")
    want = ref.normals(ref.request_keys(9, 3, heads=1, per_row=False), (1, 4, 4, 4), "cpu")
    np.testing.assert_allclose(want.numpy(), got.numpy(), rtol=0, atol=2e-6)


def test_schedule_matches_the_program():
    from sdbench.reference.samplers.ddpm import tables as schedule
    from sdtpu_torch.samplers.ddpm import make_schedule

    cfg = spec.pipeline_config(TINY).scheduler
    for steps, strength in ((25, 1.0), (25, 0.3), (7, 0.75)):
        ours = schedule(dataclasses.asdict(cfg), steps, strength)
        theirs = make_schedule(cfg, steps, strength)
        assert ours["timesteps"] == theirs.timesteps.tolist()
        for a, b in (("c0", "coeff_x0"), ("ct", "coeff_xt"), ("sa", "sqrt_alpha_prod"),
                     ("sb", "sqrt_one_minus_alpha_prod"), ("sigma", "sigma")):
            np.testing.assert_array_equal(np.float32(ours[a]), getattr(theirs, b).numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["tinysd-b8", "sdxl-1024", "tinysd-serve",
                                      "tinysd-i2i-b8"])
def test_control_fails_the_cells_limit_on_the_card(workload):
    """At the cell's own size: one seed's program readings within each of
    the cell's limits; its int8 path's, and the fp8 control's, beyond one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sdbench.control import seed_readings

    cell = spec.load_cell(workload)
    limits = cell.check["limits"]
    r = seed_readings(cell, 3_100_000_007, 4.0, True)
    assert all(r["program"][k] <= lim for k, lim in limits.items()), r
    for control in ("int8", "fp8"):
        assert any(r[control][k] > lim for k, lim in limits.items()), (control, r)
