"""The port's dp/tp mesh (``sdtpu_torch.parallel``: ``make_mesh``,
``global_mesh``, ``shard_params_tp``, ``generate_batch(mesh=)``,
``ServingEngine(mesh=)``) against the JAX package and against the port's
one-process run, on the CPU.

The port runs one process per rank; the tests start four gloo processes
(one spawn per test, a ``file://`` rendezvous, ``OMP_NUM_THREADS=1``)
through ``sdtpu_torch.tools.dryrun_multichip.run_ranks``, and hold what
they return to the same calls in this process.  Tolerances, as the JAX
package's ``tests/test_parallel.py`` holds its mesh:

* dp: bitwise against the port's one-process run (per-request keys and
  a scalar key alike: each rank draws the whole batch's noise), within
  one uint8 level of the JAX package's single-device ``generate_batch``;
* tp in float32: within 2e-4 of the one-process images and of the JAX
  package's single-device images (the partial sums add in another order);
  in int8, within 2e-2 of both, the JAX package's bound for its sharded
  int8 pipeline;
* ``tp_spec_for``: equal to the JAX ``PartitionSpec`` on every leaf.

The test marked ``gpu`` runs on the card and skips without one.
"""

import dataclasses
import pickle
import sys

import numpy as np
import pytest
import torch

from sdtpu_torch import StableDiffusionPipeline
from sdtpu_torch.kernels import launch_counts, reset_launch_counts
from sdtpu_torch.ops.activations import geglu
from sdtpu_torch.parallel import (
    batch_spec,
    global_mesh,
    health_check,
    initialize,
    make_mesh,
    shard_batch,
    tp_spec_for,
)
from sdtpu_torch.parallel.mesh import shard_leaf
from sdtpu_torch.pipeline.serving import ServingEngine
from sdtpu_torch.tools.dryrun_multichip import dryrun_multichip, run_ranks

torch.set_num_threads(1)

IDS = np.tile(np.array([[1, 5, 9, 2] + [0] * 12]), (8, 1))


def _port_tiny():
    from test_pipeline import TINY
    from test_torch_ops import port_config

    return port_config(TINY)


def _spawn(tmp_path, worker: str):
    """Run ``worker`` on four gloo ranks with the port's TINY config in
    ``tmp_path/config.pkl``; returns rank 0's ``out.npz``."""
    with open(tmp_path / "config.pkl", "wb") as f:
        pickle.dump(_port_tiny(), f)
    run_ranks([sys.executable, "-c", _PRELUDE + worker, str(tmp_path)], 4, timeout=300)
    return np.load(tmp_path / "out.npz")


_PRELUDE = r"""
import os, pickle, sys
import numpy as np, torch
from sdtpu_torch import StableDiffusionPipeline
from sdtpu_torch.parallel import *
torch.set_num_threads(1)
out, rank, world, url = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
initialize(url, world, rank, backend="gloo")
config = pickle.load(open(out + "/config.pkl", "rb"))
pipe = StableDiffusionPipeline.from_random(config, seed=0, device="cpu")
IDS = np.tile(np.array([[1, 5, 9, 2] + [0] * 12]), (8, 1))
kw = dict(token_ids=IDS, num_inference_steps=2)

def raises(fn, match):
    try:
        fn()
    except ValueError as exc:
        assert match in str(exc), str(exc)
        return True
    raise AssertionError(f"no ValueError ({match})")
"""

# ------------------------------------------------------------------ specs --


def _jax_specs(tree):
    import jax

    from sdtpu.parallel.mesh import _path_str
    from sdtpu.parallel.mesh import tp_spec_for as jax_spec

    return {_path_str(p): tuple(jax_spec(p, leaf))
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_specs(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _port_specs(sub, path + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _port_specs(sub, path + (i,)).items()}
    return {"/".join(map(str, path)): tp_spec_for(path, tree)}


def _spec_trees(name):
    """(the JAX package's tree, the port's) of one configuration."""
    from sdtpu.models.controlnet import init_controlnet as jax_controlnet
    from sdtpu.utils.quant import quantize_pipeline_int8 as jax_quantize
    from sdtpu.utils.weights import init_pipeline_params as jax_init
    from sdtpu_torch.models.controlnet import init_controlnet
    from sdtpu_torch.utils.quant import quantize_pipeline_int8
    from sdtpu_torch.utils.weights import init_pipeline_params
    from test_pipeline import TINY
    from test_torch_ops import port_config
    from test_torch_sdxl import TINY_XL

    import jax

    config = {"tiny": TINY, "controlnet": TINY.replace(name="dryrun/tiny"), "sdxl": TINY_XL,
              "inpaint9": TINY.replace(unet=dataclasses.replace(TINY.unet, in_channels=9)),
              "int8": TINY}[name]
    want = jax_init(0, config)
    got = init_pipeline_params(0, port_config(config), device="cpu")
    if name == "controlnet":
        want = {**want, "controlnet": jax_controlnet(jax.random.key(5), config.unet,
                                                     cond_channels=(4, 8, 16))}
        got = {**got, "controlnet": init_controlnet(5, port_config(config).unet,
                                                    cond_channels=(4, 8, 16))}
    if name == "int8":
        want = jax_quantize(want, min_ch=8, transformer=True)
        got = quantize_pipeline_int8(got, min_ch=8, transformer=True)
    return want, got


@pytest.mark.parametrize("name", ["tiny", "controlnet", "sdxl", "inpaint9", "int8"])
def test_tp_spec_for_equals_the_jax_spec_on_every_leaf(name):
    """The same path gives the same spec: the port's trees keep the JAX
    package's keys, CLIP's stacked (L, in, out) leaves included; an int8
    leaf's spec is the JAX one (``shard_params_tp`` keeps the int8
    projection whole, as the JAX package runs that tree replicated)."""
    want, got = _spec_trees(name)
    jax_specs, port_specs = _jax_specs(want), _port_specs(got)
    assert port_specs == jax_specs
    assert ("tp",) in port_specs.values() and (None, None, "tp") in port_specs.values()


@pytest.mark.parametrize("tp", [2, 4])
def test_geglu_half_wise_shards_rebuild_ff_proj(rng, tp):
    """Each rank's ``ff/proj`` slice is its block of the value half and of
    the gate half; the blocks rebuild both halves, and GEGLU on a rank's
    slice is that rank's block of GEGLU on the whole projection (the
    columns ``ff/out``'s row slice takes)."""
    d, hidden = 8, 16 * tp
    kernel = torch.from_numpy(rng.standard_normal((d, 2 * hidden), dtype=np.float32))
    bias = torch.from_numpy(rng.standard_normal(2 * hidden, dtype=np.float32))
    path = ("unet", "down_blocks", 0, "attentions", 0, "blocks", 0, "ff", "proj")
    x = torch.from_numpy(rng.standard_normal((3, d), dtype=np.float32))
    whole = geglu(x @ kernel + bias)
    ks = [shard_leaf(path + ("kernel",), kernel, tp, r) for r in range(tp)]
    bs = [shard_leaf(path + ("bias",), bias, tp, r) for r in range(tp)]
    w = hidden // tp
    for half in (0, 1):
        rebuilt = torch.cat([k[:, half * w:(half + 1) * w] for k in ks], dim=1)
        assert torch.equal(rebuilt, kernel[:, half * hidden:(half + 1) * hidden])
        assert torch.equal(torch.cat([b[half * w:(half + 1) * w] for b in bs]),
                           bias[half * hidden:(half + 1) * hidden])
    for r in range(tp):
        torch.testing.assert_close(geglu(x @ ks[r] + bs[r]), whole[:, r * w:(r + 1) * w],
                                   rtol=0, atol=1e-6)
    out = ("unet", "down_blocks", 0, "attentions", 0, "blocks", 0, "ff", "out", "kernel")
    row = torch.zeros((hidden, d))
    assert shard_leaf(out, row, tp, 1).shape == (w, d)
    with pytest.raises(ValueError, match="GEGLU half"):
        shard_leaf(path + ("kernel",), kernel[:, :2 * hidden - 2], tp, 0)


def test_mesh_helpers_in_one_process_raise_and_no_op_as_jax_does():
    """``TestDistributedHelpers`` and ``test_too_many_devices_raises`` of the
    JAX package, in a process with no group: this process is the one
    device."""
    initialize(num_processes=1)  # must not raise or touch a cluster
    assert not torch.distributed.is_initialized()
    mesh = make_mesh()
    assert mesh.axis_names == ("dp", "tp") and mesh.devices.shape == (1, 1)
    assert mesh.shape == {"dp": 1, "tp": 1}
    with pytest.raises(ValueError, match="need 32 devices, have 1"):
        make_mesh(16, 2)
    assert global_mesh().devices.shape == (1, 1)
    with pytest.raises(ValueError, match="does not divide"):
        global_mesh(tp=3)
    with pytest.raises(ValueError, match="dp\\*tp"):
        global_mesh(dp=2)
    report = health_check(mesh)
    assert report["ok"] and report["devices"] == 1 and report["device_errors"] == {}
    x = np.arange(12).reshape(4, 3)
    assert batch_spec(x) == ("dp", None)
    np.testing.assert_array_equal(shard_batch(x, mesh), x)


# ------------------------------------------------------------- four ranks --


def test_dryrun_multichip_over_four_gloo_processes():
    """The JAX dry run's four segments at its config over (dp=2, tp=2):
    txt2img, inpainting, a replicated ControlNet over tp-sharded params,
    the ring over four ranks; each within 2e-4 of one process."""
    line = dryrun_multichip(4)
    assert line.startswith("dryrun_multichip OK: mesh(dp=2, tp=2) over 4 ranks"), line


_DP_WORKER = r"""
from sdtpu_torch.pipeline.serving import ServingEngine
mesh = make_mesh(4, 1)
seeds = pipe.generate_batch(["p"] * 8, seeds=list(range(8)), mesh=mesh, **kw)
scalar = pipe.generate_batch(["p"] * 8, seed=3, mesh=mesh, **kw)
raises(lambda: pipe.generate_batch(["p"] * 6, mesh=mesh, token_ids=IDS[:6],
                                   num_inference_steps=1), "does not divide over dp=4")
report = health_check(mesh)
mine = replicate({"a": [torch.full((3,), float(rank))]}, mesh)["a"][0]
assert torch.equal(mine, torch.zeros(3)), mine
assert np.array_equal(shard_batch(np.arange(8), mesh), [2 * rank, 2 * rank + 1])
assert global_mesh(tp=2).shape == {"dp": 2, "tp": 2}
raises(lambda: global_mesh(tp=3), "tp=3 does not divide device count 4")
raises(lambda: global_mesh(dp=1, tp=2), "dp*tp = 2 != device count 4")
os.environ["LOCAL_WORLD_SIZE"] = "1"
raises(lambda: global_mesh(tp=2), "exceeds local device count 1")
engine = ServingEngine(pipe, max_batch_size=8, max_wait_ms=2000.0, device_batch_size=4,
                       mesh=mesh)
served = tail = None
try:
    if rank == 0:
        futs = [engine.submit("p", token_ids=IDS[i], seed=i, num_inference_steps=2)
                for i in range(8)]
        served = np.stack([f.result(timeout=120) for f in futs])
        # three requests: one chunk of 3, padded to 4 rows over dp=4
        futs = [engine.submit("p", token_ids=IDS[0], seed=i, num_inference_steps=2)
                for i in (8, 9, 10)]
        tail = np.stack([f.result(timeout=120) for f in futs])
        stats = engine.stats()
    else:
        try:
            engine.submit("p", token_ids=IDS[0])
        except RuntimeError as exc:
            assert "rank 0" in str(exc)
        else:
            raise AssertionError("a follower took a request")
finally:
    engine.shutdown()
assert not engine._worker.is_alive()
if rank == 0:
    np.savez(out + "/out.npz", seeds=seeds, scalar=scalar, served=served, tail=tail,
             batches=stats["batches"], requests=stats["requests"], ok=report["ok"],
             devices=report["devices"])
torch.distributed.destroy_process_group()
"""


def test_dp_generate_batch_and_engine_over_four_gloo_processes(tiny_pipe, tmp_path):
    """``generate_batch(mesh=make_mesh(4, 1))`` of 8 rows: bitwise the
    port's one-process run with per-request seeds and with a scalar seed,
    and within one level of the JAX package's single-device run (the JAX
    ``test_generate_batch_over_mesh_matches_single_device``); a dp=4
    ``ServingEngine`` (device batches of 4, rank 0 deciding, the other
    ranks replaying) gives the one-process engine's 8 images, and three
    more requests (a chunk of 3, padded to dp's 4 rows) their solo rows;
    ``health_check(mesh)`` is ok over 4; ``replicate``, ``shard_batch`` and
    ``global_mesh``'s three refusals over the world."""
    res = _spawn(tmp_path, _DP_WORKER)
    pipe = StableDiffusionPipeline.from_random(_port_tiny(), seed=0, device="cpu")
    kw = dict(token_ids=IDS, num_inference_steps=2)
    want = pipe.generate_batch(["p"] * 8, seeds=list(range(8)), **kw)
    np.testing.assert_array_equal(res["seeds"], want)
    np.testing.assert_array_equal(res["scalar"], pipe.generate_batch(["p"] * 8, seed=3, **kw))
    jax_want = tiny_pipe.generate_batch(["p"] * 8, seeds=list(range(8)), **kw)
    assert np.abs(res["seeds"].astype(np.int32) - np.asarray(jax_want, np.int32)).max() <= 1
    engine = ServingEngine(pipe, max_batch_size=8, max_wait_ms=2000.0, device_batch_size=4)
    try:
        futs = [engine.submit("p", token_ids=IDS[i], seed=i, num_inference_steps=2)
                for i in range(8)]
        served = np.stack([f.result(timeout=120) for f in futs])
    finally:
        engine.shutdown()
    np.testing.assert_array_equal(res["served"], served)
    np.testing.assert_array_equal(res["tail"], pipe.generate_batch(
        ["p"] * 3, seeds=[8, 9, 10], token_ids=IDS[:3], num_inference_steps=2))
    assert int(res["batches"]) == 3 and int(res["requests"]) == 11
    assert bool(res["ok"]) and int(res["devices"]) == 4


_TP_WORKER = r"""
mesh = make_mesh(2, 2)
sharded = StableDiffusionPipeline(config, shard_params_tp(pipe.params, mesh), device="cpu")
q = sharded.params["unet"]["down_blocks"][0]["attentions"][0]["blocks"][0]["attn1"]["q"]
assert q.split == "col" and q["kernel"].shape == (16, 8), q["kernel"].shape
got = sharded.generate_batch(["p"] * 4, seeds=[0, 1, 2, 3], mesh=mesh, output="float",
                             token_ids=IDS[:4], num_inference_steps=2)
# a sharded tree outside its mesh, and the fusions that need whole leaves
raises(lambda: sharded.generate_batch(["p"], token_ids=IDS[:1], num_inference_steps=1),
       "tp_context")
raises(lambda: sharded.load_lora({}), "before shard_params_tp")
raises(lambda: sharded.quantize_int8(), "before shard_params_tp")
raises(lambda: sharded.load_textual_inversion({"emb_params": torch.zeros(1, 32)},
                                              token="<x>"), "before shard_params_tp")
q8 = StableDiffusionPipeline(config, pipe.params, device="cpu").quantize_int8(
    min_ch=8, transformer="full")
q8 = StableDiffusionPipeline(config, shard_params_tp(q8.params, mesh), device="cpu")
got_q8 = q8.generate_batch(["p"] * 2, seeds=[0, 1], mesh=mesh, output="float", pag_scale=2.0,
                           token_ids=IDS[:2], num_inference_steps=2)
other = make_mesh(4, 1)
raises(lambda: sharded.generate_batch(["p"] * 4, mesh=other, token_ids=IDS[:4],
                                      num_inference_steps=1), "sharded for")
if rank == 0:
    np.savez(out + "/out.npz", got=got, got_q8=got_q8)
torch.distributed.destroy_process_group()
"""


def test_tp_generate_batch_over_four_gloo_processes(tiny_pipe, tmp_path):
    """A (2, 2) mesh on ``shard_params_tp``'s tree in float32: within 2e-4
    of the one-process images and of the JAX package's single-device
    images (GEGLU's halves, the VAE's single head gathered, CLIP's stacked
    layers sliced); an int8 tree (``transformer="full"``: int8 q/k/v and
    out-projections stay whole, the float cross-attention K/V are sliced)
    with PAG's identity rows, within 2e-2 of the one-process run and of the
    JAX package's int8 pipeline, the JAX package's bound for its sharded
    int8 pipeline (an int8 code can flip where the sums add in another
    order); the sharded tree refuses a forward outside its mesh, a request
    on another mesh, and LoRA, int8 quantization and textual inversion,
    which fuse into whole leaves."""
    from sdtpu.pipeline.pipeline import StableDiffusionPipeline as JaxPipeline

    res = _spawn(tmp_path, _TP_WORKER)
    pipe = StableDiffusionPipeline.from_random(_port_tiny(), seed=0, device="cpu")
    kw = dict(seeds=[0, 1, 2, 3], output="float", token_ids=IDS[:4], num_inference_steps=2)
    want = pipe.generate_batch(["p"] * 4, **kw)
    assert np.isfinite(res["got"]).all()
    np.testing.assert_allclose(res["got"], want, rtol=0, atol=2e-4)
    np.testing.assert_allclose(res["got"], np.asarray(tiny_pipe.generate_batch(["p"] * 4, **kw)),
                               rtol=0, atol=2e-4)
    pipe.quantize_int8(min_ch=8, transformer="full")
    kw = dict(seeds=[0, 1], output="float", pag_scale=2.0, token_ids=IDS[:2],
              num_inference_steps=2)
    np.testing.assert_allclose(res["got_q8"], pipe.generate_batch(["p"] * 2, **kw),
                               rtol=0, atol=2e-2)
    jax_q8 = JaxPipeline(tiny_pipe.config, tiny_pipe.params).quantize_int8(
        min_ch=8, transformer="full")
    np.testing.assert_allclose(res["got_q8"], np.asarray(jax_q8.generate_batch(["p"] * 2, **kw)),
                               rtol=0, atol=2e-2)


# ------------------------------------------------------------------ card --


@pytest.mark.gpu
def test_one_rank_mesh_on_the_card_equals_no_mesh():
    """On the card a 1x1 mesh gives bitwise the images and exactly the
    launches of the same request without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    pipe = StableDiffusionPipeline.from_random("tiny-sd", seed=0, device="cuda")
    ids = np.ones((2, 77), np.int64)
    kw = dict(token_ids=ids, seeds=[0, 1], num_inference_steps=2, image_size=256)
    reset_launch_counts()
    want = pipe.generate_batch(["p"] * 2, **kw)
    counts = dict(launch_counts)
    reset_launch_counts()
    got = pipe.generate_batch(["p"] * 2, mesh=make_mesh(), **kw)
    assert dict(launch_counts) == counts and counts["flash_attention"] > 0
    np.testing.assert_array_equal(got, want)
