"""A whole run (set-up, window, check) on the CPU with the timed path broken
underneath: ``correct`` comes out false for each fault a cell can have.

- the sampler's step returns its state unchanged;
- half of a batch's rows left out, their images taken from the rows that
  ran (batched entries and the engine's device batches);
- an answer altered where it is produced: every image shifted by 12
  levels, or each request given its neighbour's image.

Every cell runs on one chip, so no exchange between chips can be left out.
The sound run passes the same check (``test_sdbench_result.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from sdbench import run
from sdbench.tests.tiny import cell, mix

MIXES = {"batched": ("batch8", {"batch": 2}), "single": ("single2", {}),
         "img2img": ("i2i-batch8", {"batch": 2}),
         "engine": ("poisson-b8", {"rate_per_s": 3.0, "warm_batch_sizes": [1, 2, 3],
                                   "max_batch_size": 3, "device_batch_size": 3,
                                   "max_wait_ms": 300.0})}


def step_unchanged(monkeypatch):
    from sdtpu_torch import samplers

    sdef = samplers.SAMPLERS["ddpm"]
    monkeypatch.setitem(samplers.SAMPLERS, "ddpm", dataclasses.replace(
        sdef, step=lambda schedule, i, lat, eps, noise: lat))


def half_batch(monkeypatch):
    from sdtpu_torch import StableDiffusionPipeline

    original = StableDiffusionPipeline.generate_batch

    def halved(self, prompts, *args, **kw):
        n = len(prompts)
        if n < 2:
            return original(self, prompts, *args, **kw)
        h = (n + 1) // 2
        cut = {k: (v[:h] if isinstance(v, (list, np.ndarray)) and len(v) == n else v)
               for k, v in kw.items()}
        out = original(self, prompts[:h], *args, **cut)
        return torch.cat([out, out])[:n] if isinstance(out, torch.Tensor) else \
            np.concatenate([out, out])[:n]

    monkeypatch.setattr(StableDiffusionPipeline, "generate_batch", halved)


def shifted(monkeypatch):
    import sdtpu_torch.pipeline.pipeline as pl

    original = pl.to_uint8
    monkeypatch.setattr(pl, "to_uint8", lambda img: torch.clamp(
        original(img).to(torch.int16) + 12, 0, 255).to(torch.uint8))


def swapped(monkeypatch):
    from sdtpu_torch import StableDiffusionPipeline

    original = StableDiffusionPipeline.generate_batch

    def rolled(self, prompts, *args, **kw):
        out = original(self, prompts, *args, **kw)
        if len(prompts) < 2:
            return out
        return torch.roll(out, 1, 0) if isinstance(out, torch.Tensor) else np.roll(out, 1, 0)

    monkeypatch.setattr(StableDiffusionPipeline, "generate_batch", rolled)


FAULTS = {"step_unchanged": step_unchanged, "half_batch": half_batch, "shifted": shifted,
          "swapped": swapped}
CASES = [(m, f) for m in MIXES for f in FAULTS
         if not (m == "single" and f in ("half_batch", "swapped"))]


@pytest.mark.parametrize("mix_name,fault", CASES, ids=[f"{m}-{f}" for m, f in CASES])
def test_a_broken_timed_path_is_not_correct(monkeypatch, mix_name, fault):
    name, changes = MIXES[mix_name]
    FAULTS[fault](monkeypatch)
    seconds = 2.0 if mix_name == "engine" else 0.5
    r = run.run_cell(cell(mix(name, **changes), sample=3), 2**31 + 4242, seconds, False, "cpu")
    assert r["attempted"] >= 1
    assert r["correct"] is False, r["check"]
