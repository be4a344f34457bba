"""The port's batched serving on the CPU at the TINY config: batched rows
against solo rows, the ``ServingEngine`` (buckets, two batches in flight,
device-batch chunks, retries, stats, refusals), ``warmup``, and the ports
of ``tools/check_batch_invariance.py`` and ``tools/ab_serving.py``.

A batched row is held to its solo row bitwise, as ``tests/test_serving.py``
holds the JAX package's at these sizes: per-request keys and per-row
uncond rows make the math row-independent, and torch's CPU kernels keep
it so.  Every test that starts an engine waits on its futures with a
timeout and shuts the engine down in ``finally``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import sdtpu_torch.config as tcfg
from sdtpu.pipeline.serving import ServingEngine as JaxEngine
from sdtpu_torch import StableDiffusionPipeline
from sdtpu_torch.pipeline import serving
from sdtpu_torch.pipeline.serving import DEFAULT_DEVICE_BATCH, ServingEngine
from sdtpu_torch.tokenizer.bpe import CLIPTokenizer
from test_pipeline import TINY, TOKENS
from test_tokenizer import build_assets
from test_torch_ops import port_config

torch.set_num_threads(1)

IDS = TOKENS[0]
TIMEOUT = 120
RNG = np.random.default_rng(21)
INIT = RNG.integers(0, 256, (32, 32, 3), dtype=np.uint8)
INIT_B = RNG.integers(0, 256, (24, 40, 3), dtype=np.uint8)
MASK = np.zeros((32, 32), np.uint8)
MASK[:, 16:] = 255


@pytest.fixture(scope="module")
def pipe(tiny_pipe):
    import jax

    return StableDiffusionPipeline.from_params(port_config(TINY),
                                               jax.tree.map(np.asarray, tiny_pipe.params),
                                               device="cpu")


@pytest.fixture(scope="module")
def tok_pipe(tmp_path_factory):
    files = build_assets(tmp_path_factory.mktemp("serve_tok"))
    cfg = port_config(TINY.replace(clip=dataclasses.replace(TINY.clip, vocab_size=1024)))
    return StableDiffusionPipeline.from_random(cfg, seed=0, device="cpu",
                                               tokenizer=CLIPTokenizer.from_files(*files))


def results(futures):
    return [f.result(timeout=TIMEOUT) for f in futures]


def solo(pipe, i_seed, **kw):
    return pipe.generate_batch(["p"], seeds=[i_seed], **kw)[0]


# -------------------------------------------------------- batch vs solo --

@pytest.mark.parametrize("sampler", ["ddpm", "euler", "dpm++"])
def test_batched_rows_equal_their_solo_rows_bitwise(pipe, sampler):
    kw = dict(num_inference_steps=3, sampler=sampler)
    ids3 = np.stack([IDS, TOKENS[1], IDS])
    batch = pipe.generate_batch(["a", "b", "c"], token_ids=ids3, seeds=[7, 8, 9], **kw)
    for i, s in enumerate((7, 8, 9)):
        np.testing.assert_array_equal(batch[i], solo(pipe, s, token_ids=ids3[i:i + 1], **kw))
    other = pipe.generate_batch(["a", "b"], token_ids=ids3[[2, 0]], seeds=[9, 7], **kw)
    np.testing.assert_array_equal(other[0], batch[2])
    np.testing.assert_array_equal(other[1], batch[0])


def test_batched_img2img_and_inpaint_rows_equal_their_solo_rows_bitwise(pipe):
    kw = dict(token_ids=np.stack([IDS, IDS]), num_inference_steps=3, strength=0.7)
    for masks in (None, [MASK, MASK[::-1]]):
        batch = pipe.generate_batch(["a", "b"], seeds=[3, 4], init_images=[INIT, INIT_B],
                                    mask_images=masks, **kw)
        for i, (s, im) in enumerate(((3, INIT), (4, INIT_B))):
            one = dict(kw, token_ids=kw["token_ids"][:1])
            got = solo(pipe, s, init_images=[im],
                       mask_images=None if masks is None else [masks[i]], **one)
            np.testing.assert_array_equal(batch[i], got)


def test_per_row_negative_prompts(tok_pipe):
    kw = dict(num_inference_steps=2)
    both = tok_pipe.generate_batch(["hello world"] * 2, negative_prompt=["cat", "dog"],
                                   seeds=[7, 8], **kw)
    np.testing.assert_array_equal(both[0], tok_pipe.generate_batch(
        ["hello world"], negative_prompt="cat", seeds=[7], **kw)[0])
    np.testing.assert_array_equal(both[1], tok_pipe.generate_batch(
        ["hello world"], negative_prompt="dog", seeds=[8], **kw)[0])
    same_seed = tok_pipe.generate_batch(["hello world"] * 2, negative_prompt=["cat", "dog"],
                                        seeds=[7, 7], **kw)
    assert (same_seed[0] != same_seed[1]).any()
    with pytest.raises(ValueError, match="negative_prompt list"):
        tok_pipe.generate_batch(["a", "b"], negative_prompt=["x"], seeds=[1, 2], **kw)


# --------------------------------------------------------------- engine --

def test_engine_returns_each_requests_solo_image(tok_pipe):
    """Two buckets (txt2img with two negative prompts, img2img), parked
    requests served after their bucket's batch, every image its solo row's."""
    reqs = []
    for i in range(7):
        r = dict(seed=10 + i, num_inference_steps=2, negative_prompt="cat" if i % 2 else "")
        if i in (1, 4):
            r.update(init_image=INIT if i == 1 else INIT_B, strength=0.6)
        reqs.append(r)
    engine = ServingEngine(tok_pipe, max_batch_size=4, max_wait_ms=50)
    try:
        served = results([engine.submit("hello world", **r) for r in reqs])
        stats = engine.stats()
    finally:
        engine.shutdown()
    assert stats["requests"] == 7 and stats["failures"] == 0 and stats["batches"] >= 2
    for r, img in zip(reqs, served):
        kw = dict(seeds=[r["seed"]], num_inference_steps=2,
                  negative_prompt=[r["negative_prompt"]])
        if "init_image" in r:
            kw.update(init_images=[r["init_image"]], strength=r["strength"])
        np.testing.assert_array_equal(img, tok_pipe.generate_batch(["hello world"], **kw)[0])


def test_engine_inpaint_and_img2img_do_not_share_a_bucket(pipe):
    engine = ServingEngine(pipe, max_batch_size=4, max_wait_ms=50)
    try:
        fa = engine.submit("p", token_ids=IDS, seed=5, num_inference_steps=2, image_size=32,
                           init_image=INIT, mask_image=MASK, strength=1.0)
        fb = engine.submit("p", token_ids=IDS, seed=5, num_inference_steps=2, image_size=32,
                           init_image=INIT, strength=1.0)
        fc = engine.submit("p", token_ids=IDS, seed=5, num_inference_steps=2, image_size=32)
        a, b, c = results([fa, fb, fc])
        stats = engine.stats()
    finally:
        engine.shutdown()
    assert stats["batches"] == 3
    np.testing.assert_array_equal(a, solo(pipe, 5, token_ids=IDS[None], num_inference_steps=2,
                                          init_images=[INIT], mask_images=[MASK], strength=1.0))
    assert (a != b).any() and (b != c).any()


def test_bucket_fields():
    base = dict(prompt="p", negative_prompt="", seed=0, token_ids=None, future=None,
                image_size=32, steps=2, sampler="ddpm", cfg=True, cfg_scale=7.5)
    a = serving._Request(**base)
    assert a.bucket == serving._Request(**dict(base, negative_prompt="x", seed=3)).bucket
    for change in (dict(image_size=64), dict(steps=3), dict(sampler="euler"), dict(cfg=False),
                   dict(cfg_scale=5.0), dict(init_image=INIT), dict(clip_skip=1),
                   dict(n_windows=2)):
        assert serving._Request(**dict(base, **change)).bucket != a.bucket
    i2i = serving._Request(**dict(base, init_image=INIT))
    assert serving._Request(**dict(base, init_image=INIT_B)).bucket == i2i.bucket
    for change in (dict(strength=0.5), dict(mask_image=MASK), dict(image_guidance_scale=2.0)):
        assert serving._Request(**dict(base, init_image=INIT, **change)).bucket != i2i.bucket


@pytest.mark.parametrize("device_batch", [1, 2, None])
def test_device_batch_chunks_equal_the_whole_batch(pipe, device_batch):
    """A collected batch of 4 runs as chunks of ``device_batch_size`` rows
    (None: one request), two in flight; every row is its solo image."""
    engine = ServingEngine(pipe, max_batch_size=4, max_wait_ms=200,
                           device_batch_size=device_batch)
    try:
        imgs = results([engine.submit("p", token_ids=IDS, seed=20 + i, num_inference_steps=2,
                                      image_size=32) for i in range(4)])
        stats = engine.stats()
    finally:
        engine.shutdown()
    whole = pipe.generate_batch(["p"] * 4, token_ids=np.stack([IDS] * 4), seeds=[20, 21, 22, 23],
                                num_inference_steps=2)
    for i in range(4):
        np.testing.assert_array_equal(imgs[i], whole[i])
    assert stats["requests"] == 4
    assert stats["batches"] >= (4 // device_batch if device_batch else 1)


def test_stats_keys_equal_the_jax_engines(pipe, tiny_pipe):
    def served_stats(engine):
        try:
            results([engine.submit("p", token_ids=IDS, seed=1, num_inference_steps=1,
                                   image_size=32)])
            return engine.stats()
        finally:
            engine.shutdown()

    ours = served_stats(ServingEngine(pipe, max_wait_ms=5))
    theirs = served_stats(JaxEngine(tiny_pipe, max_wait_ms=5))
    # the port leaves out the JAX engine's batch times: its engine.dispatch
    # and engine.fetch spans (utils/profiling.py) time each batch
    assert set(ours) == set(theirs) - {"batch_seconds", "mean_batch_latency_s"}
    assert ours["requests"] == ours["batches"] == 1 and ours["mean_batch_size"] == 1.0
    assert 0 < ours["request_latency_p50_s"] <= ours["request_latency_p95_s"]
    assert DEFAULT_DEVICE_BATCH == serving.DEFAULT_DEVICE_BATCH == 4


class Flaky:
    """A pipeline whose generate_batch fails ``fails`` times with ``exc``,
    then returns zeros."""

    def __init__(self, pipe, exc, fails):
        self.config, self.tokenizer = pipe.config, None
        self.exc, self.fails, self.calls = exc, fails, 0

    def generate_batch(self, prompts, output="uint8", **kw):
        self.calls += 1
        if self.calls <= self.fails:
            raise self.exc
        images = torch.zeros((len(prompts), 32, 32, 3), dtype=torch.uint8)
        return images if output == "device" else images.numpy()


@pytest.mark.parametrize("exc,fails,ok,retries,calls", [
    (RuntimeError("transient"), 1, True, 1, 2),      # the dispatch fails, the sync run works
    (RuntimeError("transient"), 2, True, 2, 3),      # ... and the sync run's retry
    (RuntimeError("down"), 5, False, 2, 3),          # out of retries: the future fails
    (ValueError("bad request"), 5, False, 0, 1),     # deterministic: no retry
])
def test_retry_policy(pipe, exc, fails, ok, retries, calls):
    flaky = Flaky(pipe, exc, fails)
    engine = ServingEngine(flaky, max_batch_size=1, max_wait_ms=5)
    try:
        fut = engine.submit("p", token_ids=IDS, seed=1, num_inference_steps=1, image_size=32)
        if ok:
            assert fut.result(timeout=TIMEOUT).shape == (32, 32, 3)
        else:
            with pytest.raises(type(exc)):
                fut.result(timeout=TIMEOUT)
        stats = engine.stats()
    finally:
        engine.shutdown()
    assert stats["retries"] == retries and flaky.calls == calls
    assert stats["failures"] == (0 if ok else 1)


@pytest.mark.parametrize("kw,slice_name", [
    ({"control_image": INIT}, "load_controlnet"),
    # the weighted fields run now; a batch refuses prompt weights with
    # token ids, and token weights of another shape, as the JAX package does
    pytest.param({"prompt_weighting": True}, "parses the prompt strings",
                 id="kw1-text-features"),
    pytest.param({"token_weights": np.ones(8)}, "must match", id="kw2-text-features"),
    ({"guidance_rescale": 1.5}, r"guidance_rescale must be in \[0, 1\]"),
    ({"pag_scale": -2.0}, "pag_scale must be >= 0"),
    ({"freeu": (1.5, 1.6)}, "freeu must be"),
    ({"encoder_cache_interval": 0}, "encoder_cache_interval must be >= 1"),
])
def test_submit_refuses_fields_of_later_slices(pipe, kw, slice_name):
    """A control map with no ControlNet loaded raises the JAX engine's
    ValueError at ``submit``; an invalid step feature, or weights the batch
    refuses, fail the future with the JAX package's ValueError."""
    engine = ServingEngine(pipe, max_wait_ms=5)
    try:
        if "control_image" in kw:
            with pytest.raises(ValueError, match=slice_name):
                engine.submit("p", token_ids=IDS, **kw)
        else:
            fut = engine.submit("p", token_ids=IDS, num_inference_steps=1, image_size=32, **kw)
            with pytest.raises(ValueError, match=slice_name):
                fut.result(timeout=TIMEOUT)
    finally:
        engine.shutdown()


def test_engine_checks_and_shutdown(pipe):
    with pytest.raises(TypeError, match="mesh must be"):
        ServingEngine(pipe, mesh=object())
    with pytest.raises(ValueError, match="device_batch_size"):
        ServingEngine(pipe, device_batch_size=0)
    engine = ServingEngine(pipe, max_wait_ms=5)
    try:
        with pytest.raises(ValueError, match="init_image"):
            engine.submit("p", token_ids=IDS, mask_image=MASK)
        bad = engine.submit("p", token_ids=IDS, seed=1, num_inference_steps=1, image_size=30)
        with pytest.raises(ValueError, match="multiple of"):
            bad.result(timeout=TIMEOUT)
    finally:
        engine.shutdown()
    assert not engine._worker.is_alive()
    with pytest.raises(RuntimeError, match="shut down"):
        engine.submit("p", token_ids=IDS)


def test_cancelled_future_does_not_fail_its_batch(pipe):
    engine = ServingEngine(pipe, max_batch_size=2, max_wait_ms=2000)
    try:
        fa = engine.submit("p", token_ids=IDS, seed=1, num_inference_steps=1, image_size=32)
        assert fa.cancel()
        fb = engine.submit("p", token_ids=IDS, seed=2, num_inference_steps=1, image_size=32)
        assert fb.result(timeout=TIMEOUT).shape == (32, 32, 3)
        stats = engine.stats()
    finally:
        engine.shutdown()
    assert stats["failures"] == 0 and stats["retries"] == 0


# --------------------------------------------------------------- warmup --

@pytest.mark.parametrize("kw,n", [({}, 1), ({"batch_sizes": (1, 2)}, 2),
                                  ({"img2img": True, "step_counts": (1, 2)}, 2),
                                  ({"inpaint": True, "strength": 1.0}, 1)])
def test_warmup_runs_each_program_once(pipe, monkeypatch, kw, n):
    kw = dict(kw)
    seen = []
    real = pipe.generate_batch

    def spy(prompts, **k):
        seen.append((len(prompts), k["num_inference_steps"], k.get("init_images") is not None,
                     k.get("mask_images") is not None, tuple(k["seeds"])))
        return real(prompts, **k)

    monkeypatch.setattr(pipe, "generate_batch", spy)
    assert pipe.warmup(image_sizes=(32,), step_counts=kw.pop("step_counts", (1,)), **kw) == n
    assert len(seen) == n
    assert all(s[4] == tuple(range(s[0])) for s in seen)
    assert all(s[2] == (kw.get("img2img", False) or kw.get("inpaint", False)) for s in seen)
    # PAG's program too (test_torch_guidance.py holds the other features)
    assert pipe.warmup(image_sizes=(32,), step_counts=(1,), pag_scale=2.0) == 1
    with pytest.raises(ValueError, match="pag_scale must be >= 0"):
        pipe.warmup(image_sizes=(32,), step_counts=(1,), pag_scale=-2.0)


# ---------------------------------------------------------------- tools --

def test_check_batch_invariance_on_the_cpu(monkeypatch, capsys):
    from sdtpu_torch.tools import check_batch_invariance

    monkeypatch.setitem(tcfg.PRESETS, "test/tiny", port_config(TINY))
    result = check_batch_invariance.main(["--preset", "test/tiny", "--device", "cpu",
                                          "--image-size", "32", "--batch", "4", "--rows", "0",
                                          "3", "--bitwise"])
    assert result["pass"] and result["bitwise_identical"]
    assert [r["row"] for r in result["rows"]] == [0, 3]
    assert result["max_level_gate"] == 0 and result["backend"] == "cpu"
    assert '"check": "serving batch-invariance' in capsys.readouterr().out
    defaults = check_batch_invariance.parse_args([])
    assert (defaults.steps, defaults.batch, defaults.sampler, defaults.rows, defaults.max_level,
            defaults.max_frac) == (4, 8, "euler", [0, 3, 7], 1, 0.03)


def test_ab_serving_on_the_cpu(monkeypatch):
    from sdtpu_torch.tools import ab_serving

    monkeypatch.setitem(tcfg.PRESETS, "test/tiny", port_config(TINY))
    out = ab_serving.main(["--preset", "test/tiny", "--device", "cpu", "--steps", "1",
                           "--image-size", "32", "--requests", "4", "--batches", "1", "2",
                           "--engine-batches", "2", "--repeats", "2", "--device-batch", "1"])
    assert set(out["raw_program"]) == {1, 2}
    assert set(out["engine"]) == {"engine_b2", "engine_b2_db1"}
    assert out["single_shot_async"]["images_per_sec"] > 0


def test_jax_and_port_engines_agree_on_img2img(pipe, tiny_pipe):
    """The same img2img request through both engines: within one level."""
    from conftest import assert_images_match

    def serve(engine):
        try:
            return results([engine.submit("p", token_ids=IDS, seed=9, num_inference_steps=2,
                                          image_size=32, init_image=INIT_B, strength=0.6)])[0]
        finally:
            engine.shutdown()

    assert_images_match(serve(ServingEngine(pipe, max_wait_ms=5)),
                        serve(JaxEngine(tiny_pipe, max_wait_ms=5)))

