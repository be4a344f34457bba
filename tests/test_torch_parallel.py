"""The port's ring attention (``sdtpu_torch.parallel``), kernel F
(``flash_attention_stats``) and kernel G (``out_proj_packed``) against the
JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX ring runs on a 4-device virtual CPU mesh (``tests/conftest.py``); the
port's on ``LocalRing(4)`` in this process and on ``ProcessGroupRing``
over four gloo processes.  Pallas kernels run with ``interpret=True``, as
``tests/test_kernels.py`` runs them.  Tolerances:

* float32: about 1e-5 -- the same function in float32, differing in
  summation order only;
* bfloat16 (kernels only): max |port - jax| <= 2e-2 * max |jax|, one bf16
  rounding step where an accumulation-order difference lands on a rounding
  boundary;
* the two transports: bitwise equal (the same per-shard arithmetic in the
  same order);
* images: within one uint8 level (``conftest.assert_images_match``).

Tests marked ``gpu`` hold the CUDA kernels F and G against their plain
versions on the card; they skip on a machine without one.
"""

import functools
import importlib
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import sdtpu.kernels.flash_attention as jflash
import sdtpu.models.unet as junet
import sdtpu.ops as jops
import sdtpu_torch.kernels.flash_attention as tflash
import sdtpu_torch.models.unet as tunet
import sdtpu_torch.ops as tops
from conftest import assert_images_match
from sdtpu.config import UNetConfig
from sdtpu.pipeline.pipeline import StableDiffusionPipeline as JaxPipeline
from sdtpu_torch import StableDiffusionPipeline
from sdtpu_torch.kernels import _build, launch_counts, reset_launch_counts
from sdtpu_torch.parallel import (
    LocalRing,
    get_ring_context,
    health_check,
    maybe_ring_attention,
    ring_attention,
    ring_context,
)
from test_pipeline import TINY, TOKENS
from test_torch_ops import _block_params, close, nn, port_config, port_params, tt
from test_torch_pipeline import REPO, jax_noise

torch.set_num_threads(1)

# importlib: the packages re-export functions named ``attention`` and
# ``ring_attention`` that shadow their submodules
tattn = importlib.import_module("sdtpu_torch.ops.attention")
tring = importlib.import_module("sdtpu_torch.parallel.ring_attention")
jring = importlib.import_module("sdtpu.parallel.ring_attention")

BF16_REL = 2e-2
TTINY = port_config(TINY)


def _mesh(n=4):
    return Mesh(np.asarray(jax.devices()[:n]), ("sp",))


def _qkv(rng, b, l, h, d, scale=1.0):
    return [(rng.normal(size=(b, l, h, d)) * s).astype(np.float32)
            for s in (scale, scale, 1.0)]


@pytest.fixture
def ring_calls(monkeypatch):
    """The sequence lengths of the ring attention calls the route makes."""
    calls = []
    real = tring.ring_attention

    def counting(q, k, v, ring, **kw):
        calls.append(q.shape[1])
        return real(q, k, v, ring, **kw)

    monkeypatch.setattr(tring, "ring_attention", counting)
    return calls


def _bf16_close(got, want):
    g, w = nn(got), nn(want)
    assert np.abs(g - w).max() <= BF16_REL * np.abs(w).max()


# -------------------------------------------------------------- kernel F --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lq,lk", [(64, 64), (40, 200)])
def test_flash_attention_stats_plain_matches_pallas(rng, dtype, lq, lk):
    """Kernel F's plain version through the (B, L, H, D) entry, against the
    Pallas kernel in interpret mode: out, m and l.  lk = 200 is no multiple
    of the Pallas key block, so its padded keys carry the large negative
    mask there."""
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    q = rng.normal(size=(2, lq, 2, 40)).astype(np.float32)
    k, v = (rng.normal(size=(2, lk, 2, 40)).astype(np.float32) for _ in range(2))
    out, m, l = tflash.flash_attention_stats(tt(q, tdt), tt(k, tdt), tt(v, tdt))
    w_out, w_m, w_l = jflash.flash_attention_stats(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        block_q=16, block_k=128, interpret=True)
    assert tuple(out.shape) == (2, lq, 2, 40) and out.dtype == tdt
    assert tuple(m.shape) == tuple(l.shape) == (2, 2, lq) and m.dtype == l.dtype == torch.float32
    if dtype == "float32":
        close(out, w_out)
        close(m, w_m)
        close(l, w_l, rtol=1e-5, atol=1e-4)
    else:
        _bf16_close(out, w_out)
        np.testing.assert_allclose(nn(m), nn(w_m), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(nn(l), nn(w_l), rtol=1e-4)


def test_flash_attention_stats_entries_agree(rng):
    """The head-major entry (the one the ring calls) equals the (B, L, H, D)
    one, bitwise."""
    q, k, v = (tt(rng.normal(size=(1, 2, 8, 16))) for _ in range(3))
    out, m, l = tflash.flash_attention_stats_packed(q, k, v)
    o2, m2, l2 = tflash.flash_attention_stats(*(t.permute(0, 2, 1, 3) for t in (q, k, v)))
    torch.testing.assert_close(o2.permute(0, 2, 1, 3), out, rtol=0, atol=0)
    torch.testing.assert_close((m2, l2), (m, l), rtol=0, atol=0)


# -------------------------------------------------------------- kernel G --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,l,d,c,bias", [(2, 2, 48, 40, 64, True),
                                            (1, 1, 24, 64, 32, False)])
def test_out_proj_packed_plain_matches_pallas(rng, dtype, b, h, l, d, c, bias):
    """Kernel G's plain version at the real head dim against the Pallas
    kernel, which takes the head dim padded to 128 lanes with zeros."""
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    o = rng.normal(size=(b, h, l, d)).astype(np.float32)
    w = (rng.normal(size=(h, d, c)) * (h * d) ** -0.5).astype(np.float32)
    bv = rng.normal(size=(c,)).astype(np.float32) if bias else None
    res = rng.normal(size=(b, l, c)).astype(np.float32)
    got = tflash.out_proj_packed(tt(o, tdt), tt(w, tdt), None if bv is None else tt(bv),
                                 tt(res, tdt))
    want = jflash.out_proj_packed(
        jnp.asarray(np.pad(o, ((0, 0), (0, 0), (0, 0), (0, 128 - d))), jdt),
        jnp.asarray(np.pad(w, ((0, 0), (0, 128 - d), (0, 0))), jdt),
        None if bv is None else jnp.asarray(bv), jnp.asarray(res, jdt), interpret=True)
    assert tuple(got.shape) == (b, l, c) and got.dtype == tdt
    if dtype == "float32":
        close(got, want)
    else:
        _bf16_close(got, want)


# the packed route's calls of G at tiny-sd 512 (CFG batch 2) and their plans
PACKED_SHAPES = [((2, 8, 4096, 40), 320, (192, 1)), ((2, 8, 1024, 80), 640, (128, 1)),
                 ((2, 8, 256, 160), 1280, (128, 3)), ((1, 1, 4096, 512), 512, (128, 1))]


@pytest.mark.parametrize("o_shape,c,plan", PACKED_SHAPES)
def test_plan_out_proj_fills_one_wave_at_the_packed_shapes(o_shape, c, plan):
    """At each call of the packed route the plan is one wave of at most one
    block per SM over at least half of the 132 SMs, and at least 90% of them
    where it splits: level 2's 40 tiles of 128 x 128 take 3 K-splits (120
    blocks); level 1's 80 tiles stay unsplit (a split ran slower there on
    the card).  Its blocks cover every output element exactly once per
    split, the splits partition the K steps and each keeps at least
    OUT_PROJ_MIN_SPLIT of them.  Launches as out_proj_launches says."""
    b, h, l, d = o_shape
    bn, splits = tflash.plan_out_proj(b, h, l, d, c)
    assert (bn, splits) == plan
    m_tiles, c_tiles = -(-l // tflash.OUT_PROJ_BM), -(-c // bn)
    blocks = b * m_tiles * c_tiles * splits
    assert tflash.SMS <= 2 * blocks and blocks <= tflash.SMS
    assert splits == 1 or (2 * blocks // splits < tflash.SMS and 0.9 * tflash.SMS <= blocks)
    cover = np.zeros((b, l, c), dtype=np.int32)
    for bi in range(b):
        for mt in range(m_tiles):
            for ct in range(c_tiles):
                cover[bi, mt * tflash.OUT_PROJ_BM:(mt + 1) * tflash.OUT_PROJ_BM,
                      ct * bn:(ct + 1) * bn] += 1
    assert (cover == 1).all()
    steps = h * -(-d // tflash.OUT_PROJ_BK)
    bounds = [s * steps // splits for s in range(splits + 1)]
    assert bounds[0] == 0 and bounds[-1] == steps
    assert all(z - a >= tflash.OUT_PROJ_MIN_SPLIT for a, z in zip(bounds, bounds[1:]))
    assert tflash.out_proj_launches(o_shape, c) == (
        {"out_proj_packed": 1, "out_proj_packed_splitk": 1} if splits > 1
        else {"out_proj_packed": 1})


@pytest.mark.parametrize("b,h,l,d,c", [(0, 8, 10, 40, 8), (1, 0, 10, 40, 8), (1, 8, 10, 36, 8),
                                       (1, 8, 10, 40, 12)])
def test_plan_out_proj_raises_on_shapes_the_kernel_does_not_take(b, h, l, d, c):
    with pytest.raises(ValueError, match="no plan"):
        tflash.plan_out_proj(b, h, l, d, c)


@pytest.mark.parametrize("b,h,l,d,c", [(2, 8, 24, 40, 32), (2, 8, 16, 80, 64),
                                       (2, 8, 8, 160, 48), (1, 1, 16, 512, 24),
                                       (1, 3, 10, 24, 72)])
def test_out_proj_splitk_order_matches_plain(rng, b, h, l, d, c):
    """G's order of sums, emulated on the CPU at 1, 2 and 3 splits of the
    head/K loop: each split a contiguous range of the flattened (h, d)
    contraction, the f32 partials added in split order, then the bias, then
    the residual, one rounding.  Within one bf16 ulp of the plain version
    plus the float32 reordering bound (the same function, summed in another
    order); the reduction's own order bitwise."""
    o = tt(rng.standard_normal((b, h, l, d), dtype=np.float32), torch.bfloat16)
    w = tt(rng.standard_normal((h, d, c), dtype=np.float32) * (h * d) ** -0.5, torch.bfloat16)
    bias = tt(rng.standard_normal(c, dtype=np.float32))
    res = tt(rng.standard_normal((b, l, c), dtype=np.float32), torch.bfloat16)
    want = nn(tflash.out_proj_packed_plain(o, w, bias, res))
    mag = torch.einsum("bhld,hdc->blc", o.float().abs(), w.float().abs())
    reorder = 2 * h * d * 2.0 ** -24 * nn(mag)
    for splits in (1, 2, 3):
        got = nn(tflash.out_proj_splitk_plain(o, w, bias, res, splits))
        assert (np.abs(got - want) <= _bf16_ulp(want) + reorder).all()
    ws = tt(rng.standard_normal((3, b, l, c), dtype=np.float32))
    assert torch.equal(tflash.out_proj_splitk_reduce_plain(ws, bias, res),
                       ((((ws[0] + ws[1]) + ws[2]) + bias) + res.float()).to(torch.bfloat16))
    assert torch.equal(tflash.out_proj_splitk_reduce_plain(ws[:1], None, res),
                       (ws[0] + res.float()).to(torch.bfloat16))


def _bf16_ulp(a):
    """One bf16 ulp at |a| (8 significant bits)."""
    a = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("tiles,refused", [((128, 64, 4, 128, 192), False),
                                           ((128, 64, 4, 128, 160), True),
                                           ((64, 64, 4, 128, 192), True)])
def test_out_proj_loader_refuses_a_mismatched_tile(monkeypatch, tiles, refused):
    """The library of G is refused when the tiles it was built with differ
    from those plan_out_proj assumes, as the flash and J loaders do."""
    def tile(j):
        return tiles[j]

    fake = types.SimpleNamespace(out_proj_packed_launch=types.SimpleNamespace(),
                                 out_proj_packed_splitk_launch=types.SimpleNamespace(),
                                 out_proj_packed_tile=tile)
    monkeypatch.setattr(_build, "load", lambda name: fake)
    if refused:
        with pytest.raises(RuntimeError, match="plan_out_proj assumes"):
            tflash._out_proj_lib()
        assert not getattr(fake, "_typed", False)
    else:
        assert tflash._out_proj_lib() is fake and fake._typed


def test_out_proj_wrappers_run_plain_versions_on_the_cpu_and_count_nothing(rng):
    reset_launch_counts()
    o = tt(rng.standard_normal((1, 2, 5, 16), dtype=np.float32))
    w = tt(rng.standard_normal((2, 16, 8), dtype=np.float32))
    res = tt(rng.standard_normal((1, 5, 8), dtype=np.float32))
    ws = tt(rng.standard_normal((2, 1, 5, 8), dtype=np.float32))
    assert torch.equal(tflash.out_proj_packed(o, w, None, res),
                       tflash.out_proj_packed_plain(o, w, None, res))
    assert torch.equal(tflash.out_proj_splitk_reduce(ws, None, res),
                       tflash.out_proj_splitk_reduce_plain(ws, None, res))
    assert all(n == 0 for n in launch_counts.values()), launch_counts
    with pytest.raises(ValueError, match="unsupported device"):
        tflash.out_proj_splitk_reduce(ws.to("meta"), None, res.to("meta"))


def test_packed_route_transformer_block_matches_jax_flash_route(rng, monkeypatch):
    """With the flag on, each self-attention's out-projection and residual
    add go through G (its plain version here); the block equals the JAX
    flash route's (kernel C in interpret mode, whose CPU program computes
    the einsum form: same function, f32 ~1e-5)."""
    calls = []

    def counting(*args):
        calls.append(1)
        return tflash.out_proj_packed(*args)

    monkeypatch.setattr(tattn, "_PACKED_OUT_PROJ", True)
    monkeypatch.setattr(tattn, "out_proj_packed", counting)
    monkeypatch.setattr(jflash, "flash_attention_packed",
                        functools.partial(jflash.flash_attention_packed, interpret=True))
    p = _block_params(rng, 16, 12)
    x = rng.normal(size=(2, 10, 16)).astype(np.float32)
    ctx = rng.normal(size=(2, 5, 12)).astype(np.float32)
    got = tops.transformer_block(tt(x), port_params(p), num_heads=2, context=tt(ctx),
                                 implementation="flash")
    want = jops.transformer_block(jnp.asarray(x), p, num_heads=2, context=jnp.asarray(ctx),
                                  implementation="flash")
    assert len(calls) == 1  # attn1 only: the cross-attention has no flash route
    close(got, want)


# ------------------------------------------------------------------ ring --

@pytest.mark.parametrize("body", ["dense", "flash"])
@pytest.mark.parametrize("scale", [1.0, 50.0])
def test_ring_attention_matches_jax_ring(rng, body, scale):
    """LocalRing(4) against the JAX ring on a 4-device mesh, with the same
    body; scale 50 gives extreme logits (one key dominates each row)."""
    q, k, v = _qkv(rng, 2, 32, 2, 16, scale)
    got = ring_attention(tt(q), tt(k), tt(v), LocalRing(4), body=body)
    want = jring.ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), _mesh(),
                                axis_name="sp", body=body)
    assert np.isfinite(nn(got)).all()
    close(got, want, rtol=1e-5, atol=1e-5 * scale)


def test_ring_attention_bodies_agree_and_auto_is_dense_on_the_cpu(rng):
    q, k, v = (tt(a) for a in _qkv(rng, 1, 24, 2, 8))
    dense = ring_attention(q, k, v, LocalRing(3), body="dense")
    close(ring_attention(q, k, v, LocalRing(3), body="flash"), dense)
    torch.testing.assert_close(ring_attention(q, k, v, LocalRing(3)), dense, rtol=0, atol=0)
    with pytest.raises(ValueError, match="ring body"):
        ring_attention(q, k, v, LocalRing(3), body="xla")
    with pytest.raises(ValueError, match="divisible"):
        ring_attention(q, k, v, LocalRing(5))


@pytest.mark.parametrize("case", ["no_context", "cross", "ragged", "ring_of_one"])
def test_ring_fallbacks(rng, case):
    """maybe_ring_attention returns None -- no context, Lq != Lk, L not
    divisible by the ring, a ring of one -- and ``implementation="ring"``
    is then dense attention, as in the JAX package."""
    lq = 18 if case == "ragged" else 16
    lk = 7 if case == "cross" else lq
    q = tt(rng.normal(size=(1, lq, 2, 8)))
    k = tt(rng.normal(size=(1, lk, 2, 8)))
    ring = None if case == "no_context" else LocalRing(1 if case == "ring_of_one" else 4)
    p = {n: {"kernel": (rng.normal(size=(16, 16)) * 0.25).astype(np.float32)}
         for n in ("q", "k", "v", "out")}
    x = rng.normal(size=(1, lq, 16)).astype(np.float32)
    ctx = rng.normal(size=(1, lk, 16)).astype(np.float32) if case == "cross" else None
    kw = {} if ctx is None else {"context": tt(ctx)}
    with ring_context(ring):
        assert maybe_ring_attention(q, k, k) is None
        got = tops.attention(tt(x), port_params(p), num_heads=2, implementation="ring", **kw)
    assert get_ring_context() is None
    want = jops.attention(jnp.asarray(x), p, num_heads=2,
                          **({} if ctx is None else {"context": jnp.asarray(ctx)}))
    close(got, want)


def test_unet_forward_ring_matches_jax_ring(ring_calls):
    """``attention_impl="ring"`` through the whole UNet (16x16 latents:
    256/64/16 tokens, all divisible by 4) against the JAX UNet under a
    ring_context on a 4-device mesh."""
    rng = np.random.default_rng(5)
    cfg = UNetConfig(block_out_channels=(16, 24, 32), layers_per_block=1,
                     attention_levels=(True, True, True), num_attention_heads=2,
                     cross_attention_dim=16, norm_num_groups=8)
    params = junet.init_unet(0, cfg)
    x = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    ts = np.full((2,), 500.0, np.float32)
    ctx = rng.normal(size=(2, 7, 16)).astype(np.float32)
    with jring.ring_context(_mesh(), "sp"):
        want = jax.jit(lambda p, a, t, c: junet.unet_forward(
            a, t, c, p, cfg, attention_impl="ring"))(params, x, ts, ctx)
    with ring_context(LocalRing(4)):
        got = tunet.unet_forward(tt(x), tt(ts), tt(ctx), port_params(params),
                                 port_config(cfg), attention_impl="ring")
    # one self-attention per resnet: 1 down and 2 up at each level
    assert sorted(ring_calls) == [16] * 3 + [64] * 3 + [256] * 3
    np.testing.assert_allclose(nn(got), nn(want), atol=1e-4, rtol=1e-3)


def test_generate_ring_matches_jax_within_one_level(tiny_pipe, ring_calls):
    """txt2img with ``attention_impl="ring"`` under ``ring_context``, both
    packages, with the JAX package's own initial latents and noise (32 px:
    64/16/4 latent tokens, the VAE's attention at 64)."""
    steps, seed = 2, 4
    jpipe = JaxPipeline(TINY.replace(attention_impl="ring"), tiny_pipe.params)
    with jring.ring_context(_mesh(), "sp"):
        want = jpipe.generate("x", token_ids=TOKENS, num_inference_steps=steps, seed=seed)
    tree = jax.tree.map(np.asarray, tiny_pipe.params)
    pipe = StableDiffusionPipeline.from_params(TTINY.replace(attention_impl="ring"), tree,
                                               device="cpu")
    lat = TINY.default_image_size // TINY.vae.downscale_factor
    lat0, noise = jax_noise(seed, steps, (1, lat, lat, TINY.vae.latent_channels))
    with ring_context(LocalRing(4)):
        got = pipe.txt2img(pipe._tokenize("", "", True, TOKENS), lat0, noise, cfg=True,
                           cfg_scale=TINY.default_cfg_scale)
    assert_images_match(got, want)
    assert sorted(set(ring_calls)) == [4, 16, 64]


# ------------------------------------------------------- process groups --

_WORKER = r"""
import sys, numpy as np, torch
from sdtpu_torch.parallel import (LocalRing, ProcessGroupRing, health_check,
                                  initialize, ring_attention)
torch.set_num_threads(1)
rank, n, url, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
initialize(url, n, rank)
q, k, v = (torch.from_numpy(a) for a in np.load(out + "/qkv.npy"))
res = {b: ring_attention(q, k, v, ProcessGroupRing(), body=b).numpy()
       for b in ("dense", "flash")}
report = health_check()
if rank == 0:
    np.savez(out + "/ring.npz", ok=report["ok"], world=report["world_size"], **res)
torch.distributed.destroy_process_group()
"""


def test_process_group_ring_equals_local_ring_over_four_gloo_processes(rng, tmp_path):
    """Four processes on gloo, one shard each (P2P rotation, all_gather at
    the end), give LocalRing(4)'s result bitwise for both bodies, and
    health_check reports ok over the group."""
    qkv = np.stack(_qkv(rng, 2, 32, 2, 8))
    np.save(tmp_path / "qkv.npy", qkv)
    url = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), "4", url,
                               str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(4)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, logs
    res = np.load(tmp_path / "ring.npz")
    assert bool(res["ok"]) and int(res["world"]) == 4
    q, k, v = (torch.from_numpy(a) for a in qkv)
    for body in ("dense", "flash"):
        np.testing.assert_array_equal(
            res[body], ring_attention(q, k, v, LocalRing(4), body=body).numpy())


def test_health_check_without_a_group():
    report = health_check()
    assert report["ok"] and report["collective_ok"] and report["devices"] >= 1
    assert report["device_errors"] == {}


# ------------------------------------------------------------------ card --

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,lk", [((2, 8, 256, 40), 256), ((1, 2, 77, 80), 100),
                                      ((1, 1, 100, 512), 130),
                                      # the ring's shards at tiny-sd 512, n = 4
                                      ((2, 8, 64, 160), 64), ((1, 1, 1024, 512), 1024)])
def test_cuda_flash_attention_stats_matches_plain(rng, shape, lk):
    dev = _cuda_or_skip()
    b, h, lq, d = shape
    q = tt(rng.normal(size=shape), torch.bfloat16).to(dev)
    k, v = (tt(rng.normal(size=(b, h, lk, d)), torch.bfloat16).to(dev) for _ in range(2))
    reset_launch_counts()
    out, m, l = tflash.flash_attention_stats_packed(q, k, v)
    torch.cuda.synchronize()
    assert launch_counts["flash_attention_stats"] == 1
    w_out, w_m, w_l = tflash.flash_attention_stats_plain(q, k, v)
    _bf16_close(out.cpu(), w_out.cpu())
    np.testing.assert_allclose(m.cpu().numpy(), w_m.cpu().numpy(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(l.cpu().numpy(), w_l.cpu().numpy(), rtol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,l,d,c,bias", [
    *[(*o, c, True) for o, c, _ in PACKED_SHAPES],  # the packed route's calls (splits 1, 1, 3, 1)
    (2, 8, 256, 40, 320, True),
    (1, 3, 100, 24, 72, False),   # D = 24, L and C under one tile, no bias
    (1, 1, 64, 512, 512, True),
    (2, 4, 300, 80, 200, False),  # ragged L and C tiles
    (1, 8, 100, 160, 136, True),  # ragged, split in 3, a half box per head
])
def test_cuda_out_proj_packed_matches_plain(rng, b, h, l, d, c, bias):
    """G against its plain version, two calls bitwise equal (the split-K
    reduction adds in a fixed order), launches as ``out_proj_launches``
    says; the reduction alone bitwise against its plain version."""
    dev = _cuda_or_skip()
    o = tt(rng.normal(size=(b, h, l, d)), torch.bfloat16).to(dev)
    w = tt(rng.normal(size=(h, d, c)) * (h * d) ** -0.5, torch.bfloat16).to(dev)
    bv = tt(rng.normal(size=(c,))).to(dev) if bias else None
    res = tt(rng.normal(size=(b, l, c)), torch.bfloat16).to(dev)
    reset_launch_counts()
    got = tflash.out_proj_packed(o, w, bv, res)
    torch.cuda.synchronize()
    assert {k: n for k, n in launch_counts.items() if n} == tflash.out_proj_launches(
        (b, h, l, d), c)
    _bf16_close(got.cpu(), tflash.out_proj_packed_plain(o, w, bv, res).cpu())
    assert torch.equal(tflash.out_proj_packed(o, w, bv, res), got)
    splits = tflash.plan_out_proj(b, h, l, d, c)[1]
    if splits > 1:
        ws = torch.randn((splits, b, l, c), device=dev)
        assert torch.equal(tflash.out_proj_splitk_reduce(ws, bv, res),
                           tflash.out_proj_splitk_reduce_plain(ws, bv, res))


@pytest.mark.gpu
def test_cuda_ring_flash_body_matches_dense_body(rng):
    dev = _cuda_or_skip()
    q, k, v = (tt(a, torch.bfloat16).to(dev) for a in _qkv(rng, 2, 256, 4, 40))
    reset_launch_counts()
    got = ring_attention(q, k, v, LocalRing(4))
    torch.cuda.synchronize()
    assert launch_counts["flash_attention_stats"] == 16
    _bf16_close(got.cpu(), ring_attention(q, k, v, LocalRing(4), body="dense").cpu())
