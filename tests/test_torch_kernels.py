"""The port's kernels (``sdtpu_torch.kernels``) against the JAX package's
Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; here that version
is held against the Pallas kernel run as ``tests/test_kernels.py`` runs it
(``interpret=True`` with explicit tiles).  Tolerances:

* float32: about 1e-5 -- the same function with float32 accumulation, the
  two differing only in summation order;
* bfloat16: max |port - jax| <= 2e-2 * max |jax| -- both round the prologue
  output, P and the result to bf16 at the same points, so they differ by
  about one bf16 rounding step (2^-8 relative) where an accumulation-order
  difference lands on a rounding boundary.

Tests marked ``gpu`` hold the CUDA kernels against the plain versions on the
card; they skip on a machine without one.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdtpu.kernels import conv2d as jconv
from sdtpu.kernels import flash_attention as jflash
from sdtpu_torch.kernels import _build, launch_counts, reset_launch_counts
from sdtpu_torch.kernels import conv2d as tconv
from sdtpu_torch.kernels import flash_attention as tflash
from test_torch_ops import nn, tt

torch.set_num_threads(1)

BF16_REL = 2e-2
_DT = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def close_dtype(got, want, dtype):
    g, w = nn(got), nn(want)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=2e-5)
    else:
        assert np.abs(g - w).max() <= BF16_REL * np.abs(w).max()


def _conv_case(rng, x_shape, co, *, temb=False, residual=False, stats=False, up=False):
    b, h, w, ci = x_shape
    ho, wo = (2 * h, 2 * w) if up else (h, w)
    case = {
        "x": (rng.normal(size=x_shape) * 1.5 + 0.3).astype(np.float32),
        "k": (rng.normal(size=(3, 3, ci, co)) * (9 * ci) ** -0.5).astype(np.float32),
        "bias": (rng.normal(size=(co,)) * 0.1).astype(np.float32),
        "norm": {"scale": (1 + 0.2 * rng.normal(size=(ci,))).astype(np.float32),
                 "bias": (0.2 * rng.normal(size=(ci,))).astype(np.float32)},
    }
    if temb:
        case["temb"] = rng.normal(size=(b, ci)).astype(np.float32)
    if residual:
        case["residual"] = rng.normal(size=(b, ho, wo, co)).astype(np.float32)
    if stats:
        x = case["x"]
        case["stats"] = np.stack([x.mean(axis=(1, 2)), (x * x).mean(axis=(1, 2))], axis=1)
    return case


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("temb,residual,stats,emit", [
    (False, False, False, False),
    (True, True, False, False),
    (False, False, True, True),
    (True, True, True, True),
])
def test_gn_silu_conv3x3_slab_matches_pallas(rng, dtype, temb, residual, stats, emit):
    """Kernel A: the GN(+temb)+SiLU prologue, zero pad after the prologue,
    3x3 conv, bias, residual, and the moments of the cast output."""
    tdt, jdt = _DT[dtype]
    c = _conv_case(rng, (2, 8, 8, 32), 64, temb=temb, residual=residual, stats=stats)
    opt_t = {k: tt(c[k]) for k in ("temb", "stats") if k in c}
    opt_j = {k: jnp.asarray(c[k]) for k in ("temb", "stats") if k in c}
    if residual:
        opt_t["residual"] = tt(c["residual"], tdt)
        opt_j["residual"] = jnp.asarray(c["residual"], jdt)
    got = tconv.gn_silu_conv3x3_slab(
        tt(c["x"], tdt), {k: tt(v) for k, v in c["norm"].items()}, tt(c["k"], tdt),
        tt(c["bias"]), num_groups=8, eps=1e-6, emit_stats=emit, **opt_t)
    want = jconv.gn_silu_conv3x3_slab(
        jnp.asarray(c["x"], jdt), c["norm"], jnp.asarray(c["k"], jdt),
        jnp.asarray(c["bias"]), num_groups=8, eps=1e-6, emit_stats=emit,
        h_tile=8, co_tile=64, interpret=True, **opt_j)
    if emit:
        (got, got_st), (want, want_st) = got, want
        assert got_st.dtype == torch.float32 and tuple(got_st.shape) == (2, 2, 64)
        np.testing.assert_allclose(nn(got_st), nn(want_st), rtol=1e-5, atol=1e-5)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    close_dtype(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("emit", [False, True])
def test_upsample_conv3x3_slab_matches_pallas(rng, dtype, emit):
    """Kernel B: nearest-2x folded into the conv's input load."""
    tdt, jdt = _DT[dtype]
    c = _conv_case(rng, (2, 4, 4, 32), 64, up=True)
    got = tconv.conv3x3_slab(tt(c["x"], tdt), tt(c["k"], tdt), tt(c["bias"]),
                             upsample=True, emit_stats=emit)
    want = jconv.conv3x3_gemm_slab(
        jnp.asarray(c["x"], jdt), jnp.asarray(c["k"], jdt), jnp.asarray(c["bias"]),
        h_tile=8, co_tile=64, upsample=True, emit_stats=emit, interpret=True)
    if emit:
        (got, got_st), (want, want_st) = got, want
        np.testing.assert_allclose(nn(got_st), nn(want_st), rtol=1e-5, atol=1e-5)
    assert tuple(got.shape) == (2, 8, 8, 64) == want.shape
    close_dtype(got, want, dtype)


def test_slab_prologue_pads_with_zero_not_silu_of_bias(rng):
    """A pixel outside the map contributes 0 after the prologue: with a
    kernel that only reads the top-left neighbour, the first output row and
    column see the bias alone, however large SiLU(b) would be."""
    x = rng.normal(size=(1, 4, 4, 8)).astype(np.float32)
    k = np.zeros((3, 3, 8, 8), np.float32)
    k[0, 0] = np.eye(8)
    pro_b = np.full((1, 8), 5.0, np.float32)
    out = tconv.conv3x3_slab(tt(x), tt(k), None, prologue_scale=tt(np.ones((1, 8))),
                             prologue_bias=tt(pro_b))
    assert float(out[0, 0].abs().max()) == 0.0
    assert float(out[0, :, 0].abs().max()) == 0.0
    assert float(out[0, 1:, 1:].abs().min()) > 0.0


def test_slab_group_stats_cancel_at_large_mean_as_in_the_jax_kernel(rng):
    """A known fault of the JAX package that the port reproduces: without
    producer ``stats``, ``gn_silu_conv3x3_slab`` takes the group variance as
    E[x^2] - mean^2 with no clamp (``sdtpu/kernels/conv2d.py:569``).  For a
    group whose mean is large against its spread that difference cancels to
    a negative number and the output is NaN, in both packages, while the
    two-pass ``group_norm`` of the op path stays finite."""
    from sdtpu.ops import group_norm

    x = (1000.0 + 0.01 * rng.normal(size=(1, 8, 8, 32))).astype(np.float32)
    k = (rng.normal(size=(3, 3, 32, 64)) * 0.05).astype(np.float32)
    norm = {"scale": np.ones(32, np.float32), "bias": np.zeros(32, np.float32)}
    got = tconv.gn_silu_conv3x3_slab(tt(x), {n: tt(v) for n, v in norm.items()}, tt(k),
                                     num_groups=8)
    want = jconv.gn_silu_conv3x3_slab(jnp.asarray(x), norm, jnp.asarray(k), num_groups=8,
                                      h_tile=8, co_tile=64, interpret=True)
    assert np.isnan(nn(got)).any() and np.isnan(nn(want)).any()
    assert np.isfinite(nn(group_norm(jnp.asarray(x), norm, num_groups=8))).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_packed_matches_pallas(rng, dtype):
    """Kernel C, with a key count that is no multiple of the Pallas key
    block (so its masked tail is exercised); the port keeps the real head
    dim, the JAX kernel pads it to 128 lanes, which must hold zeros."""
    tdt, jdt = _DT[dtype]
    b, h, lq, lk, d = 2, 2, 96, 200, 40
    q, k, v = (rng.normal(size=(b, h, n, d)).astype(np.float32) for n in (lq, lk, lk))
    got = tflash.flash_attention_packed(tt(q, tdt), tt(k, tdt), tt(v, tdt))

    def pad(a):
        return jnp.asarray(np.pad(a, ((0, 0), (0, 0), (0, 0), (0, 128 - d))), jdt)

    want = jflash.flash_attention_packed(pad(q), pad(k), pad(v), d_real=d,
                                         block_q=32, block_k=128, interpret=True)
    assert tuple(got.shape) == (b, h, lq, d) and got.dtype == tdt
    close_dtype(torch.nn.functional.pad(got.float(), (0, 128 - d)), want, dtype)


def test_flash_attention_blhd_entry(rng):
    """The (B, L, H, D) wrapper, against the JAX package's (which pads and
    transposes around the same packed kernel)."""
    q, k, v = (rng.normal(size=(1, n, 2, 16)).astype(np.float32) for n in (24, 40, 40))
    got = tflash.flash_attention(tt(q), tt(k), tt(v))
    want = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  block_q=128, block_k=128, interpret=True)
    np.testing.assert_allclose(nn(got), nn(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ flash tile plan --

# The self-attention calls of the tiny-sd 512 main path (B, H, Lq, D) with
# Lk = Lq: the UNet's levels at batch 2 (CFG) and the VAE mid-block's one
# head; then the ring's shards (n = 4: a quarter of the rows against a
# quarter of the keys per F call).  chip_smoke.py records them on the card.
FLASH_MAIN_PATH = [(2, 8, 4096, 40), (2, 8, 1024, 80), (2, 8, 256, 160), (1, 1, 4096, 512)]
FLASH_RING = [(2, 8, 1024, 40), (2, 8, 256, 80), (2, 8, 64, 160), (1, 1, 1024, 512)]


@pytest.mark.parametrize("shape", FLASH_MAIN_PATH + FLASH_RING)
def test_flash_plan_on_the_main_path_and_the_ring(shape):
    """128-row tiles exactly where the padded depth is <= 48 and they give
    at least one block per SM, else 64; at D > 160 at least one block per
    SM through a key split that keeps at least MIN_SPLIT_TILES key tiles a
    split (and none below); the launches it derives."""
    b, h, lq, d = shape
    bq, splits = tflash.plan_flash(b * h, lq, lq, d)
    blocks = -(-lq // bq) * b * h * splits
    if d > 160:
        assert bq == tflash.FLASH_WIDE_BQ and blocks >= tflash.SMS
        assert -(-lq // tflash.FLASH_WIDE_BKV) // splits >= tflash.MIN_SPLIT_TILES
    else:
        assert splits == 1
        assert bq == (128 if tflash.flash_depth(d) <= tflash.FLASH_MT2_MAX_DP
                      and -(-lq // 128) * b * h >= tflash.SMS else 64)
    want = {"flash_attention": 1, **({"flash_attention_merge": 1} if splits > 1 else {})}
    assert tflash.flash_launches("flash_attention", shape, lq) == want


def test_flash_plan_examples():
    """The level-0 self-attention takes 128-row tiles (512 blocks); the
    1024-token level 64 (its depth 80 takes no 128), as do the 256-token
    level and every ring shard (the 1024-row one: 128-row tiles would give
    128 blocks); the VAE's d = 512 four key splits (256 blocks, two waves of
    one 8-warp block per SM), the ring's 1024-row shard sixteen; a short key
    run is not split below two tiles a split."""
    assert tflash.plan_flash(16, 4096, 4096, 40) == (128, 1)
    assert tflash.plan_flash(16, 1024, 1024, 80) == (64, 1)
    assert tflash.plan_flash(16, 4096, 4096, 80) == (64, 1)
    assert tflash.plan_flash(16, 4096, 4096, 64) == (64, 1)
    assert tflash.plan_flash(16, 4096, 4096, 48) == (128, 1)
    assert tflash.plan_flash(16, 256, 256, 160) == (64, 1)
    assert tflash.plan_flash(1, 4096, 4096, 512) == (64, 4)
    assert tflash.plan_flash(16, 1024, 1024, 40) == (64, 1)
    assert tflash.plan_flash(16, 64, 64, 160) == (64, 1)
    assert tflash.plan_flash(1, 1024, 1024, 512) == (64, 16)
    assert tflash.plan_flash(1, 100, 130, 512) == (64, 2)   # 5 key tiles: cap 2
    assert tflash.plan_flash(1, 77, 77, 256) == (64, 1)     # 3 key tiles: no split
    assert tflash.plan_flash(4096, 64, 64, 96) == (64, 1)   # 128 rows only at depth <= 80
    assert [tflash.flash_depth(d) for d in (8, 40, 72, 88, 104, 136, 168, 512)] == [
        32, 48, 80, 96, 128, 160, 512, 512]


@pytest.mark.parametrize("bh,lq,lk,d", [(1, 64, 64, 12), (1, 64, 64, 520), (1, 64, 64, 0),
                                        (0, 64, 64, 40), (1, 0, 64, 40), (1, 64, 0, 40)])
def test_flash_plan_refuses_what_the_kernels_do_not_take(bh, lq, lk, d):
    with pytest.raises(ValueError, match="no plan"):
        tflash.plan_flash(bh, lq, lk, d)


@pytest.mark.parametrize("d,lk,splits", [(512, 130, 2), (168, 200, 4)])
def test_flash_merge_of_key_splits_equals_the_unsplit_attention(rng, d, lk, splits):
    """The wide plan's merge, on a workspace written as the kernel writes
    it (each split's unnormalised f32 acc, m in log2 units, l), gives the
    unsplit kernel F's function: out within one bf16 rounding, m and l to
    float32 precision."""
    b, h, lq = 1, 2, 24
    q, k, v = (tt(rng.normal(size=(b, h, n, d))) for n in (lq, lk, lk))
    bounds = [sp * lk // splits for sp in range(splits + 1)]
    parts = [tflash._attention_parts(q, k[:, :, lo:hi], v[:, :, lo:hi])
             for lo, hi in zip(bounds, bounds[1:])]
    acc = torch.zeros((splits, b * h, lq, tflash.FLASH_WIDE_DP))
    acc[..., :d] = torch.stack([p[0].reshape(b * h, lq, d) for p in parts])
    m2 = torch.stack([p[1].reshape(b * h, lq) for p in parts]) / math.log(2.0)
    l = torch.stack([p[2].reshape(b * h, lq) for p in parts])
    ws = torch.cat([acc.flatten(), m2.flatten(), l.flatten()])
    got = tflash.flash_attention_merge(ws, b * h, lq, d, splits, stats=True)
    want = tflash.flash_attention_stats_plain(q, k, v)
    np.testing.assert_allclose(nn(got[0].float()), nn(want[0].reshape(b * h, lq, d)),
                               rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(nn(got[1]), nn(want[1].reshape(b * h, lq)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nn(got[2]), nn(want[2].reshape(b * h, lq)), rtol=1e-5)


# ------------------------------------------------ pre-pass and split-K --

# The float convs of the tiny-sd 512 main path (x shape, Co, upsample): the
# UNet's at batch 2 (CFG), the VAE decoder's at batch 1.  chip_smoke.py
# records them from the pipeline on the card.
MAIN_PATH_CONVS = [
    ((2, 64, 64, 320), 320, False), ((2, 32, 32, 320), 640, False),
    ((2, 32, 32, 640), 640, False), ((2, 16, 16, 640), 1280, False),
    ((2, 16, 16, 1280), 1280, False), ((2, 16, 16, 2560), 1280, False),
    ((2, 16, 16, 1920), 1280, False), ((2, 32, 32, 1920), 640, False),
    ((2, 32, 32, 960), 640, False), ((2, 64, 64, 960), 320, False),
    ((2, 64, 64, 640), 320, False), ((2, 16, 16, 1280), 1280, True),
    ((2, 32, 32, 640), 640, True),
    ((1, 64, 64, 512), 512, False), ((1, 128, 128, 512), 512, False),
    ((1, 256, 256, 512), 256, False), ((1, 256, 256, 256), 256, False),
    ((1, 512, 512, 256), 128, False), ((1, 512, 512, 128), 128, False),
    ((1, 64, 64, 512), 512, True), ((1, 128, 128, 512), 512, True),
    ((1, 256, 256, 256), 256, True),
]


@pytest.mark.parametrize("x_shape,co,up", MAIN_PATH_CONVS)
def test_split_plan_fills_one_wave_on_the_main_path(x_shape, co, up):
    """Every main-path conv gets a grid of at least one block per SM, or S
    at its cap; S = 1 where the unsplit grid is full; S never exceeds the K
    steps, and each slice keeps at least MIN_SLICE_K_STEPS of them."""
    b, hx, wx, ci = x_shape
    h, w = (2 * hx, 2 * wx) if up else (hx, wx)
    splits = tconv.plan_conv3x3_split(b, h, w, ci, co)
    blocks = tconv.slab_blocks(b, h, w, co)
    k_steps = tconv.slab_k_steps(ci)
    cap = min(tconv.MAX_SPLITS, k_steps // tconv.MIN_SLICE_K_STEPS)
    assert 1 <= splits <= k_steps
    assert splits * blocks >= tconv.SMS or splits == cap
    if blocks >= tconv.SMS:
        assert splits == 1
    else:
        assert (splits - 1) * blocks < tconv.SMS  # the smallest such S
    if splits > 1:
        assert k_steps // splits >= tconv.MIN_SLICE_K_STEPS
    keys = tconv.conv3x3_launches("conv3x3_slab_upsample" if up else "conv3x3_slab",
                                  x_shape, co, prologue=not up, upsample=up)
    assert keys.get("conv3x3_slab_splitk", 0) == int(splits > 1)


def test_split_plan_examples():
    """The UNet's 16x16 maps (40 blocks at Co = 1280) split in four, its
    32x32 maps (80 blocks at Co = 640) in two; a 64x64 map at batch 2 (192
    blocks at Co = 320, the third N tile ragged) is full; a small K caps S."""
    assert tconv.plan_conv3x3_split(2, 16, 16, 2560, 1280) == 4
    assert tconv.plan_conv3x3_split(2, 32, 32, 640, 640) == 2
    assert tconv.plan_conv3x3_split(2, 64, 64, 320, 320) == 1
    assert tconv.plan_conv3x3_split(1, 12, 20, 40, 72) == 2  # 18 K steps: cap 2
    assert tconv.plan_conv3x3_split(1, 4, 4, 8, 8) == 1      # 9 K steps: no split


@pytest.mark.parametrize("up", [False, True])
def test_prepass_then_plain_conv_equals_the_prologue_conv_bitwise(rng, up):
    """The rounding point did not move: the pre-pass rounds SiLU(x*a + c)
    to bf16, and the no-prologue conv on that map equals the conv with the
    prologue, bitwise in bf16, output and moments (the zero pad comes after
    the pre-pass in both)."""
    b, h, w, ci, co = 2, 6, 10, 24, 16
    x = tt(rng.normal(size=(b, h, w, ci)) * 2.0, torch.bfloat16)
    k = tt(rng.normal(size=(3, 3, ci, co)) * (9 * ci) ** -0.5, torch.bfloat16)
    a, c = tt(rng.uniform(0.5, 1.5, (b, ci))), tt(rng.normal(size=(b, ci)))
    bias = tt(rng.normal(size=(co,)) * 0.1)
    ho, wo = (2 * h, 2 * w) if up else (h, w)
    res = tt(rng.normal(size=(b, ho, wo, co)), torch.bfloat16)
    y = tconv.conv3x3_prologue(x, a, c)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y, tconv.conv3x3_prologue_plain(x, a, c), rtol=0, atol=0)
    got, got_st = tconv.conv3x3_slab_plain(y, k, bias, residual=res, upsample=up,
                                           emit_stats=True)
    want, want_st = tconv.conv3x3_slab_plain(x, k, bias, prologue_scale=a, prologue_bias=c,
                                             residual=res, upsample=up, emit_stats=True)
    assert torch.equal(got, want) and torch.equal(got_st, want_st)


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("splits", [2, 3, 5])
@pytest.mark.parametrize("up", [False, True])
def test_split_sum_then_one_rounding_within_one_ulp(rng, splits, up):
    """Slices of the flattened K loop summed in float32 in a fixed order,
    then bias, residual and one rounding, stay within one bf16 ulp of the
    unsplit conv; the slices' float32 sum is the unsplit accumulator up to
    summation order; the reduction's moments are those of its output."""
    b, h, w, ci, co = 1, 6, 8, 40, 24
    x = tt(rng.normal(size=(b, h, w, ci)), torch.bfloat16)
    k = tt(rng.normal(size=(3, 3, ci, co)) * (9 * ci) ** -0.5, torch.bfloat16)
    ho, wo = (2 * h, 2 * w) if up else (h, w)
    bias = tt(rng.normal(size=(co,)) * 0.1)
    res = tt(rng.normal(size=(b, ho, wo, co)), torch.bfloat16)
    ws = tconv.conv3x3_split_plain(x, k, splits, upsample=up)
    assert ws.shape == (splits, b, ho, wo, co) and ws.dtype == torch.float32
    acc = tconv.conv3x3_split_plain(x, k, 1, upsample=up)[0]
    np.testing.assert_allclose(nn(ws.sum(dim=0)), nn(acc), rtol=1e-5, atol=1e-5)
    got, got_st = tconv.conv3x3_splitk_reduce(ws, bias, res, emit_stats=True)
    want = tconv.conv3x3_slab_plain(x, k, bias, residual=res, upsample=up)
    assert got.dtype == torch.bfloat16
    g, wv = nn(got), nn(want)
    assert (np.abs(g - wv) <= _bf16_ulp(wv)).all()
    np.testing.assert_allclose(nn(got_st), nn(tconv._moments(got)), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------- wrappers --

def test_cpu_wrappers_run_plain_versions_and_count_nothing(rng):
    reset_launch_counts()
    c = _conv_case(rng, (1, 4, 4, 8), 8)
    x, k = tt(c["x"]), tt(c["k"])
    np.testing.assert_array_equal(nn(tconv.conv3x3_slab(x, k)),
                                  nn(tconv.conv3x3_slab_plain(x, k)))
    np.testing.assert_array_equal(nn(tconv.conv3x3_slab(x, k, upsample=True)),
                                  nn(tconv.conv3x3_slab_plain(x, k, upsample=True)))
    a = tt(rng.normal(size=(1, 8)))
    np.testing.assert_array_equal(nn(tconv.conv3x3_prologue(x, a, a)),
                                  nn(tconv.conv3x3_prologue_plain(x, a, a)))
    ws = tt(rng.normal(size=(2, 1, 4, 4, 8)))
    np.testing.assert_array_equal(nn(tconv.conv3x3_splitk_reduce(ws)),
                                  nn(tconv.splitk_reduce_plain(ws)))
    q = tt(rng.normal(size=(1, 1, 5, 8)))
    np.testing.assert_array_equal(nn(tflash.flash_attention_packed(q, q, q)),
                                  nn(tflash.flash_attention_plain(q, q, q)))
    ws = tt(rng.normal(size=(2 * 3 * (tflash.FLASH_WIDE_DP + 2),)))
    for g, w in zip(tflash.flash_attention_merge(ws, 1, 3, 168, 2, stats=True),
                    tflash.flash_merge_plain(ws, 1, 3, 168, 2)):
        np.testing.assert_array_equal(nn(g.float()), nn(w.float()))
    assert launch_counts == {"conv3x3_slab": 0, "conv3x3_slab_upsample": 0,
                             "conv3x3_slab_prologue": 0, "conv3x3_slab_splitk": 0,
                             "conv3x3_slab_int8": 0, "flash_attention": 0,
                             "flash_attention_stats": 0, "flash_attention_merge": 0,
                             "out_proj_packed": 0,
                             "conv3x3_gemm": 0, "flash_attention_legacy": 0,
                             "flash_attention_nq": 0, "dot_bf16": 0, "dot_bf16_splitk": 0,
                             "dot_int8": 0}


def test_wrappers_raise_on_other_devices():
    x = torch.empty((1, 4, 4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tconv.conv3x3_slab(x, torch.empty((3, 3, 8, 8), device="meta"))
    q = torch.empty((1, 1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tflash.flash_attention_packed(q, q, q)


def test_build_finds_no_nvcc_and_raises(monkeypatch):
    monkeypatch.setattr(os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_sources_and_content_hashed_library_names():
    assert _build.sources() == ["conv3x3_slab", "conv3x3_slab_int8", "dot", "flash_attention",
                                "flash_nq", "out_proj_packed"]
    names = {_build._lib_path(n) for n in _build.sources()}
    assert len(names) == 6
    assert all(os.path.dirname(p) == _build.BUILD_DIR for p in names)


# ------------------------------------------------------------------ card --

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bf16_close(got, want):
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    assert np.abs(g - w).max() <= BF16_REL * np.abs(w).max()


def _cuda_conv_case(rng, x_shape, co, up, dev):
    c = _conv_case(rng, x_shape, co, residual=True, up=up)
    b, ci = x_shape[0], x_shape[-1]
    kw = dict(residual=tt(c["residual"], torch.bfloat16).to(dev), upsample=up,
              emit_stats=True, prologue_scale=tt(rng.uniform(0.5, 1.5, (b, ci))).to(dev),
              prologue_bias=tt(rng.normal(size=(b, ci))).to(dev))
    x = tt(c["x"], torch.bfloat16).to(dev)
    k = tt(c["k"], torch.bfloat16).to(dev)
    return x, k, tt(c["bias"]).to(dev), kw


@pytest.mark.gpu
@pytest.mark.parametrize("x_shape,co,up", [
    ((2, 16, 16, 64), 128, False),
    ((1, 12, 20, 40), 72, False),     # ragged M, Ci and N tiles; split in two
    ((1, 6, 10, 40), 72, True),
    ((2, 16, 16, 2560), 1280, False),  # the UNet's split-K shape, S = 4
    ((1, 136, 130, 40), 72, False),   # ragged, unsplit (139 blocks)
    ((1, 68, 66, 40), 72, True),      # ragged upsample, unsplit (141 blocks)
])
def test_cuda_conv3x3_slab_matches_plain(rng, x_shape, co, up):
    dev = _cuda_or_skip()
    x, k, bias, kw = _cuda_conv_case(rng, x_shape, co, up, dev)
    reset_launch_counts()
    got, got_st = tconv.conv3x3_slab(x, k, bias, **kw)
    torch.cuda.synchronize()
    key = "conv3x3_slab_upsample" if up else "conv3x3_slab"
    assert {n: c for n, c in launch_counts.items() if c} == tconv.conv3x3_launches(
        key, x_shape, co, prologue=True, upsample=up)
    want, want_st = tconv.conv3x3_slab_plain(x, k, bias, **kw)
    _bf16_close(got, want)
    np.testing.assert_allclose(got_st.cpu().numpy(), want_st.cpu().numpy(),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("x_shape,co,up,splits", [
    ((2, 16, 16, 2560), 1280, False, 4),
    ((1, 12, 20, 40), 72, False, 2),
    ((2, 64, 64, 320), 320, False, 1),
    ((2, 16, 16, 1280), 1280, True, 1),
])
def test_cuda_conv3x3_slab_is_deterministic(rng, x_shape, co, up, splits):
    """Repeated calls give bitwise-equal output and moments, split or not
    (a fixed-order reduction, no atomics); the plan gives the S named, and
    each kernel of the call adds one to its own counter."""
    dev = _cuda_or_skip()
    b, hx, wx, ci = x_shape
    h, w = (2 * hx, 2 * wx) if up else (hx, wx)
    assert tconv.plan_conv3x3_split(b, h, w, ci, co) == splits
    x, k, bias, kw = _cuda_conv_case(rng, x_shape, co, up, dev)
    reset_launch_counts()
    runs = [tconv.conv3x3_slab(x, k, bias, **kw) for _ in range(3)]
    torch.cuda.synchronize()
    key = "conv3x3_slab_upsample" if up else "conv3x3_slab"
    want = {n: 3 * c for n, c in tconv.conv3x3_launches(
        key, x_shape, co, prologue=True, upsample=up).items()}
    assert {n: c for n, c in launch_counts.items() if c} == want
    for out, st in runs[1:]:
        assert torch.equal(out, runs[0][0]) and torch.equal(st, runs[0][1])


@pytest.mark.gpu
def test_cuda_prologue_and_splitk_reduce_match_plain(rng):
    """The two sub-kernels alone: the pre-pass within one bf16 rounding of
    its plain version (the exponential differs in its last bits), the
    reduction bitwise (the same float32 additions in the same order) with
    its moments within 1e-5."""
    dev = _cuda_or_skip()
    x = tt(rng.normal(size=(2, 12, 20, 40)) * 2.0, torch.bfloat16).to(dev)
    a = tt(rng.uniform(0.5, 1.5, (2, 40))).to(dev)
    c = tt(rng.normal(size=(2, 40))).to(dev)
    ws = tt(rng.normal(size=(3, 2, 12, 20, 72))).to(dev)
    bias = tt(rng.normal(size=(72,))).to(dev)
    res = tt(rng.normal(size=(2, 12, 20, 72)), torch.bfloat16).to(dev)
    reset_launch_counts()
    y = tconv.conv3x3_prologue(x, a, c)
    out, st = tconv.conv3x3_splitk_reduce(ws, bias, res, emit_stats=True)
    torch.cuda.synchronize()
    assert {n: c for n, c in launch_counts.items() if c} == {
        "conv3x3_slab_prologue": 1, "conv3x3_slab_splitk": 1}
    yp = tconv.conv3x3_prologue_plain(x, a, c)
    assert (y.float() - yp.float()).abs().max() <= 2.0 ** -7 * yp.float().abs().max()
    want, want_st = tconv.splitk_reduce_plain(ws, bias, res, emit_stats=True)
    assert torch.equal(out, want)
    np.testing.assert_allclose(st.cpu().numpy(), want_st.cpu().numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,lk", [((2, 8, 256, 40), 256), ((1, 2, 77, 80), 100),
                                      ((1, 1, 100, 512), 130)])
def test_cuda_flash_attention_matches_plain(rng, shape, lk):
    dev = _cuda_or_skip()
    b, h, lq, d = shape
    q = tt(rng.normal(size=shape), torch.bfloat16).to(dev)
    k, v = (tt(rng.normal(size=(b, h, lk, d)), torch.bfloat16).to(dev) for _ in range(2))
    got = tflash.flash_attention_packed(q, k, v)
    torch.cuda.synchronize()
    _bf16_close(got, tflash.flash_attention_plain(q, k, v))


def _flash_plan_cases():
    """(q shape, Lk) for every padded depth of the D <= 160 plans at each
    query tile it takes (128 rows where the depth is <= 48, and 64; 128-key
    tiles to depth 80, 64-key tiles above), and for the wide plan (split and unsplit): Lq and Lk no
    multiple of their tiles, and Lq under one tile."""
    cases = []
    for d in (8, 32, 40, 48, 64, 72, 80, 88, 96, 104, 128, 136, 160):
        if tflash.flash_depth(d) <= tflash.FLASH_MT2_MAX_DP:
            cases.append(((1, 33, 520, d), 200))   # 128-row tiles, 165 blocks
        cases.append(((1, 33, 200, d), 130))       # 64-row tiles, 132 blocks
        cases.append(((1, 2, 40, d), 70))          # Lq < 64, one key tile to depth 80
    for d in (168, 256, 512):
        cases += [(((1, 1, 100, d)), 130),         # 2 key splits
                  (((1, 2, 40, d)), 70),           # unsplit, Lq < 64
                  (((1, 1, 600, d)), 1000)]        # 14 key splits, ragged
    return cases


@pytest.mark.gpu
@pytest.mark.parametrize("shape,lk", _flash_plan_cases())
def test_cuda_flash_plans_match_plain(rng, shape, lk):
    """C and F (out, m and l) against their plain versions at every plan
    the kernels hold, with the launches plan_flash derives."""
    dev = _cuda_or_skip()
    b, h, lq, d = shape
    q = tt(rng.normal(size=shape), torch.bfloat16).to(dev)
    k, v = (tt(rng.normal(size=(b, h, lk, d)), torch.bfloat16).to(dev) for _ in range(2))
    reset_launch_counts()
    got = tflash.flash_attention_packed(q, k, v)
    out, m, l = tflash.flash_attention_stats_packed(q, k, v)
    torch.cuda.synchronize()
    want = dict(tflash.flash_launches("flash_attention", shape, lk))
    for key, n in tflash.flash_launches("flash_attention_stats", shape, lk).items():
        want[key] = want.get(key, 0) + n
    assert {n: c for n, c in launch_counts.items() if c} == want
    w_out, w_m, w_l = tflash.flash_attention_stats_plain(q, k, v)
    _bf16_close(got, tflash.flash_attention_plain(q, k, v))
    _bf16_close(out, w_out)
    np.testing.assert_allclose(m.cpu().numpy(), w_m.cpu().numpy(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(l.cpu().numpy(), w_l.cpu().numpy(), rtol=1e-2)


@pytest.mark.gpu
def test_cuda_flash_merge_matches_plain(rng):
    """The merge kernel alone on a random workspace (l > 0), against its
    plain version: out within one bf16 rounding, m and l to float32."""
    dev = _cuda_or_skip()
    splits, bh, lq, d = 3, 2, 50, 512
    n = splits * bh * lq
    ws = torch.cat([tt(rng.normal(size=(n * tflash.FLASH_WIDE_DP,))),
                    tt(rng.normal(size=(n,)) * 4.0), tt(rng.uniform(1.0, 50.0, (n,)))]).to(dev)
    reset_launch_counts()
    got = tflash.flash_attention_merge(ws, bh, lq, d, splits, stats=True)
    torch.cuda.synchronize()
    assert launch_counts["flash_attention_merge"] == 1
    want = tflash.flash_merge_plain(ws, bh, lq, d, splits)
    _bf16_close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take():
    dev = _cuda_or_skip()
    x = torch.zeros((1, 4, 4, 12), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        tconv.conv3x3_slab(x, torch.zeros((3, 3, 12, 8), device=dev, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        tconv.conv3x3_slab(x.float()[..., :8], torch.zeros((3, 3, 8, 8), device=dev))
    q = torch.zeros((1, 1, 4, 12), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_attention_packed(q, q, q)
