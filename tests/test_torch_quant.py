"""The port's int8 (W8A8) path (``sdtpu_torch.utils.quant``, the int8 forms
of ``ops/linear.py`` and the flash route, kernel D's plain version, the
quantized resnets, calibration and ``quantize_int8``) against the JAX
package's, on the same numpy inputs made from a seed.

Tolerances, each with its reason:

* quantized trees: int8 leaves equal, float32 leaves bitwise equal -- the
  same numpy algebra on the same float32 host copies;
* int8 linears: 1e-6 scaled -- the same integer product, then the same
  float32 steps in the same order;
* kernel D's plain version against the JAX slab kernel in interpret mode:
  an activation code on a rounding boundary may land one code apart where
  the two frameworks' SiLU or GroupNorm statistics differ by an ulp.  Each
  flip moves the outputs that read it by at most 127 * max(w_scale), so the
  bound is a handful of such steps, and at most 0.5% of the outputs may
  differ from the JAX result by more than 1e-5 scaled;
* models on the dequantized route: 1e-5 scaled, as in
  ``test_torch_models.py``;
* end to end: one uint8 level (``conftest.assert_images_match``).
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import sdtpu.kernels.conv2d as jconv
import sdtpu.models.unet as junet
import sdtpu.models.vae as jvae
import sdtpu.utils.calibrate as jcal
import sdtpu.utils.quant as jquant
import sdtpu_torch.kernels.conv2d as tconv
import sdtpu_torch.models.unet as tunet
import sdtpu_torch.models.vae as tvae
import sdtpu_torch.utils.calibrate as tcal
import sdtpu_torch.utils.quant as tquant
from conftest import assert_images_match
from sdtpu.config import UNetConfig
from sdtpu.pipeline.pipeline import StableDiffusionPipeline as JaxPipeline
from sdtpu.utils.weights import init_pipeline_params as jax_init
from sdtpu_torch import StableDiffusionPipeline
from sdtpu_torch.kernels import launch_counts, reset_launch_counts
from sdtpu_torch.utils.weights import params_from_numpy
from test_pipeline import TINY, TOKENS
from test_torch_models import _leaves, close_scaled
from test_torch_ops import nn, port_config, port_params, tt
from test_torch_pipeline import jax_noise

# importlib: the packages sdtpu.ops and sdtpu_torch.ops re-export functions
# named ``attention`` and ``linear`` that shadow their submodules
jattn = importlib.import_module("sdtpu.ops.attention")
jlinear = importlib.import_module("sdtpu.ops.linear")
tattn = importlib.import_module("sdtpu_torch.ops.attention")
tlinear = importlib.import_module("sdtpu_torch.ops.linear")

torch.set_num_threads(1)

TTINY = port_config(TINY)


@pytest.fixture(scope="module")
def jparams():
    return jax_init(0, TINY)


@pytest.fixture(scope="module")
def jparams_bf16():
    return jax_init(0, TINY.replace(param_dtype=jnp.bfloat16))


def _host_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _act_ranges(unet_params, seed=0):
    rng = np.random.default_rng(seed)
    return {path: rng.uniform(0.5, 4.0, lin["kernel"].shape[0]).astype(np.float32)
            for path, lin in jcal.iter_dynamic_sites(unet_params)}


def _assert_trees_equal(got, want):
    """Same keys; int8 leaves equal; every other leaf bitwise equal, dtype
    kept (bf16 stays bf16), on the CPU."""
    got_l, want_l = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, g), (_, w) in zip(got_l, want_l):
        w = np.asarray(w)
        assert g.device.type == "cpu", path
        if w.dtype == ml_dtypes.bfloat16:
            assert g.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32), err_msg=str(path))
        else:
            assert g.numpy().dtype == w.dtype, path
            np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))


# ------------------------------------------------------------ quantizers --

@pytest.mark.parametrize("dtype,transformer,ranges,skip,vae", [
    ("float32", False, False, False, False),
    ("float32", True, False, False, True),
    ("float32", "full", False, False, False),
    ("float32", "full", True, False, True),
    ("float32", "full", True, True, False),
    ("bfloat16", True, False, True, True),
    ("bfloat16", "full", True, False, True),
])
def test_quantize_pipeline_int8_matches_jax(jparams, jparams_bf16, dtype, transformer,
                                            ranges, skip, vae):
    """Same tree, int8 arrays equal, float32 leaves bitwise equal, for f32
    and bf16 parameter trees (the new leaves are int8/float32 in both)."""
    src = jparams if dtype == "float32" else jparams_bf16
    kw = dict(min_ch=8, transformer=transformer, vae=vae)
    if ranges:
        kw.update(act_ranges=_act_ranges(src["unet"]), act_margin=1.5)
    if skip:
        kw.update(skip_down=(0,), skip_up=(-1,))
    want = _host_tree(jquant.quantize_pipeline_int8(src, **kw))
    got = tquant.quantize_pipeline_int8(port_params(src), **kw)
    _assert_trees_equal(got, want)
    conv1 = got["unet"]["down_blocks"][1]["resnets"][0]["conv1"]
    assert conv1["kernel_q"].dtype == torch.int8 and conv1["w_scale"].dtype == torch.float32
    assert ("kernel_q" in got["vae_decoder"]["mid_block"]["resnets"][0]["conv1"]) == vae


def test_quantize_unet_int8_default_min_ch_keeps_tiny_float(jparams):
    """min_ch=64 leaves every TINY conv float; quantizing is idempotent."""
    tp = port_params(jparams["unet"])
    q64 = tquant.quantize_unet_int8(tp)
    assert "kernel" in q64["down_blocks"][0]["resnets"][0]["conv1"]
    q8 = tquant.quantize_unet_int8(tp, min_ch=8)
    _assert_trees_equal(tquant.quantize_unet_int8(q8, min_ch=8),
                        _host_tree(jquant.quantize_unet_int8(jparams["unet"], min_ch=8)))


@pytest.mark.parametrize("seed", [0, 1])
def test_qparams_and_conv_quantizer_match_jax(seed):
    rng = np.random.default_rng(seed)
    norm = {"scale": rng.normal(size=64).astype(np.float32),
            "bias": rng.normal(size=64).astype(np.float32)}
    for fn in ("act_range_from_norm", "act_qparams_from_norm", "act_qparams_from_ln"):
        for g, w in zip(getattr(tquant, fn)({k: tt(v) for k, v in norm.items()}),
                        getattr(jquant, fn)(norm)):
            np.testing.assert_array_equal(g, w)
    s, z = jquant.act_qparams_from_norm(norm)
    k = (rng.normal(size=(3, 3, 64, 32)) * 0.05).astype(np.float32)
    for g, w in zip(tquant.quantize_conv_w8a8(tt(k), s, z), jquant.quantize_conv_w8a8(k, s, z)):
        np.testing.assert_array_equal(g, w)
    q = {"kernel_q": tt(jquant.quantize_conv_w8a8(k, s)[0], torch.int8),
         "w_scale": tt(jquant.quantize_conv_w8a8(k, s)[1]), "act_scale": tt(s)}
    np.testing.assert_array_equal(
        nn(tquant.dequant_conv_kernel(q)),
        nn(jquant.dequant_conv_kernel({n: jnp.asarray(v.numpy()) for n, v in q.items()})))


def test_params_from_numpy_of_a_jax_quantized_tree(jparams_bf16):
    """A tree quantized by the JAX package converts leaf by leaf and equals
    the port's own quantization of the converted float tree."""
    kw = dict(min_ch=8, transformer="full", vae=True)
    converted = params_from_numpy(_host_tree(jquant.quantize_pipeline_int8(jparams_bf16, **kw)),
                                  device="cpu")
    own = tquant.quantize_pipeline_int8(port_params(jparams_bf16), **kw)
    got_l, own_l = list(_leaves(converted)), list(_leaves(own))
    assert [p for p, _ in got_l] == [p for p, _ in own_l]
    for (path, g), (_, o) in zip(got_l, own_l):
        assert g.dtype == o.dtype and torch.equal(g, o), path


def test_set_by_path_is_copy_on_write():
    tree = {"a": [{"b": 1}, {"b": 2}]}
    new = tquant._set_by_path(tree, "a.1.b", 5)
    assert new == {"a": [{"b": 1}, {"b": 5}]} and tree == {"a": [{"b": 1}, {"b": 2}]}
    assert new["a"][0] is tree["a"][0]


# --------------------------------------------------------------- linears --

def _lin_case(rng, din=32, dout=24, zero_row=False, dtype=torch.float32):
    norm = {"scale": (1 + 0.3 * rng.normal(size=din)).astype(np.float32),
            "bias": (0.2 * rng.normal(size=din)).astype(np.float32)}
    lin = {"kernel": (rng.normal(size=(din, dout)) * din ** -0.5).astype(np.float32),
           "bias": (0.1 * rng.normal(size=dout)).astype(np.float32)}
    x = (rng.normal(size=(2, 20, din)) * 1.3).astype(np.float32)
    if zero_row:
        x[0, 3] = 0.0
    return norm, lin, x


def _port_lin(jlin):
    return {k: torch.from_numpy(np.array(v)) for k, v in jlin.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_q8_and_quantize_act_match_jax(rng, dtype):
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "float32" else (torch.bfloat16,
                                                                          jnp.bfloat16)
    norm, lin, x = _lin_case(rng)
    s, z = jquant.act_qparams_from_ln(norm)
    jlin = jquant._quantize_linear({k: jnp.asarray(v) for k, v in lin.items()}, s, z)
    plin = _port_lin(jlin)
    xj, xt = jnp.asarray(x, jdt), tt(x, tdt)
    np.testing.assert_array_equal(tquant.quantize_act(xt, plin).numpy(),
                                  np.asarray(jquant.quantize_act(xj, jlin)))
    got, want = tlinear.linear(xt, plin), jlinear.linear(xj, jlin)
    assert got.dtype == tdt
    close_scaled(got, want, rtol=1e-6 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("zero_row", [False, True])
def test_linear_q8_dyn_matches_jax(rng, zero_row):
    """Run-time per-row scales; an all-zero row gives zeros, not NaN."""
    _, lin, x = _lin_case(rng, zero_row=zero_row)
    jlin = jquant._quantize_linear_dyn({k: jnp.asarray(v) for k, v in lin.items()})
    got = tlinear.linear(tt(x), _port_lin(jlin))
    want = jlinear.linear(jnp.asarray(x), jlin)
    close_scaled(got, want, rtol=1e-6)
    if zero_row:
        np.testing.assert_array_equal(nn(got)[0, 3], lin["bias"])
        zero = tlinear.linear_q8_dyn(torch.zeros(2, 32), _port_lin(
            jquant._quantize_linear_dyn({"kernel": jnp.ones((32, 4)), "bias": jnp.zeros(4)})))
        assert torch.equal(zero, torch.zeros(2, 4))


def test_int8_matmul_is_exact(rng):
    q = torch.from_numpy(rng.integers(-128, 128, (3, 5, 2560)).astype(np.int8))
    k = torch.from_numpy(rng.integers(-127, 128, (2560, 16)).astype(np.int8))
    want = q.numpy().astype(np.int64) @ k.numpy().astype(np.int64)
    got = tlinear.int8_matmul(q, k)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 5, 16)
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------- kernel D (plain) --

def _int8_slab_case(rng, b, hw, ci, co, g):
    x = (rng.normal(size=(b, hw, hw, ci)) * 1.5 + 0.3).astype(np.float32)
    norm = {"scale": (1 + 0.3 * rng.normal(size=ci)).astype(np.float32),
            "bias": (0.3 * rng.normal(size=ci)).astype(np.float32)}
    k = (rng.normal(size=(3, 3, ci, co)) * (9 * ci) ** -0.5).astype(np.float32)
    s_act, z_act = jquant.act_qparams_from_norm(norm)
    q, w_scale, zp_corr = jquant.quantize_conv_w8a8(k, s_act, z_act)
    bias = (0.1 * rng.normal(size=co)).astype(np.float32)
    return dict(x=x, norm=norm, q=q, w_scale=w_scale, s_act=s_act, z_act=z_act,
                cb=bias - zp_corr)


def _assert_int8_close(got, want, w_scale):
    g, w = nn(got), nn(want)
    assert g.shape == w.shape
    flip = 127.0 * float(np.max(w_scale))
    scale = max(1.0, float(np.abs(w).max()))
    diff = np.abs(g - w)
    assert diff.max() <= 4 * flip + 1e-5 * scale, (diff.max(), flip)
    assert (diff > 1e-5 * scale).mean() <= 5e-3


@pytest.mark.parametrize("b,co,temb,residual,stats,emit", [
    (1, 64, False, False, False, False),
    (2, 64, True, True, False, True),
    (2, 40, True, False, True, True),     # Co not a multiple of 64
    (1, 72, False, True, True, False),
])
def test_int8_slab_plain_matches_pallas_interpret(rng, b, co, temb, residual, stats, emit):
    """Kernel D's plain version against the JAX int8 slab kernel: codes of
    the f32 prologue, the zero-point pad, the exact int32 sum, the per-co
    rescale, bias - zp_corr, residual, and the moments of the cast output."""
    hw, ci, g = 8, 64, 8
    c = _int8_slab_case(rng, b, hw, ci, co, g)
    opt_t, opt_j = {}, {}
    if temb:
        t = rng.normal(size=(b, ci)).astype(np.float32)
        opt_t["temb"], opt_j["temb"] = tt(t), jnp.asarray(t)
    if residual:
        r = rng.normal(size=(b, hw, hw, co)).astype(np.float32)
        opt_t["residual"], opt_j["residual"] = tt(r), jnp.asarray(r)
    if stats:
        x = c["x"]
        st = np.stack([x.mean(axis=(1, 2)), (x * x).mean(axis=(1, 2))], axis=1)
        opt_t["stats"], opt_j["stats"] = tt(st), jnp.asarray(st)
    got = tconv.gn_silu_conv3x3_slab(
        tt(c["x"]), {k: tt(v) for k, v in c["norm"].items()},
        torch.from_numpy(c["q"]), tt(c["cb"]), num_groups=g, emit_stats=emit,
        act_inv_scale=1.0 / tt(c["s_act"]), act_zp=tt(c["z_act"]), w_scale=tt(c["w_scale"]),
        **opt_t)
    want = jconv.gn_silu_conv3x3_slab(
        jnp.asarray(c["x"]), c["norm"], jnp.asarray(c["q"]), jnp.asarray(c["cb"]),
        num_groups=g, emit_stats=emit, act_inv_scale=1.0 / jnp.asarray(c["s_act"]),
        act_zp=jnp.asarray(c["z_act"]), w_scale=jnp.asarray(c["w_scale"]),
        h_tile=8, co_tile=64, interpret=True, **opt_j)
    if emit:
        (got, got_st), (want, want_st) = got, want
        np.testing.assert_allclose(nn(got_st), nn(want_st), rtol=1e-3, atol=1e-3)
    _assert_int8_close(got, want, c["w_scale"])


def test_int8_slab_pads_with_the_zero_point(rng):
    """A pad pixel holds the code z (the real value 0): with a kernel that
    reads only the top-left neighbour, the first row and column see
    (z * w) * w_scale, which ``bias - zp_corr`` cancels to the bias."""
    ci = co = 32
    k = np.zeros((3, 3, ci, co), np.int8)
    k[0, 0] = np.eye(ci, dtype=np.int8) * 100
    z = rng.integers(-100, -20, ci).astype(np.float32)
    ws = np.full(co, 0.01, np.float32)
    zp_corr = (ws.astype(np.float64) * (z.astype(np.int64) * 100)).astype(np.float32)
    bias = np.full(co, 0.5, np.float32)
    x = np.abs(rng.normal(size=(1, 4, 4, ci))).astype(np.float32)  # y >= SiLU(3)
    out = tconv.conv3x3_slab(
        tt(x), torch.from_numpy(k), tt(bias - zp_corr), prologue_scale=tt(np.ones((1, ci))),
        prologue_bias=tt(np.full((1, ci), 3.0)), act_inv_scale=tt(np.full(ci, 20.0)),
        act_zp=tt(z), w_scale=tt(ws))
    np.testing.assert_allclose(nn(out)[0, 0], 0.5, atol=1e-5)
    np.testing.assert_allclose(nn(out)[0, :, 0], 0.5, atol=1e-5)
    assert float(out[0, 1:, 1:].min()) > 1.0


def test_int8_slab_rejects_what_it_does_not_take():
    x = torch.zeros((1, 4, 4, 32))
    k = torch.zeros((3, 3, 32, 32), dtype=torch.int8)
    v = torch.ones(32)
    with pytest.raises(ValueError, match="prologue"):
        tconv.conv3x3_slab(x, k, act_inv_scale=v, w_scale=v)
    with pytest.raises(ValueError, match="upsample"):
        tconv.conv3x3_slab(x, k, prologue_scale=v[None], prologue_bias=v[None],
                           upsample=True, act_inv_scale=v, w_scale=v)
    with pytest.raises(ValueError, match="act_inv_scale"):
        tconv.conv3x3_slab(x, k, prologue_scale=v[None], prologue_bias=v[None])


# ------------------------------------------- kernel D's pieces (plain) --

def _int8_pieces(x, kernel, conv_bias=None, *, prologue_scale, prologue_bias, residual=None,
                 emit_stats=False, act_inv_scale, act_zp=None, w_scale, splits, **_):
    """Kernel D as the card runs it, from the plain versions of its pieces:
    the padded codes, the int32 split partials of the flattened K loop on
    the K-major weights, and the reduction's exact sum and epilogue."""
    codes = tconv.conv3x3_int8_codes_plain(x, prologue_scale, prologue_bias, act_inv_scale,
                                           act_zp)
    ws = tconv.conv3x3_int8_split_plain(codes, tconv.conv3x3_kmajor_plain(kernel), splits)
    return tconv.conv3x3_int8_reduce_plain(ws, w_scale, conv_bias, residual,
                                           emit_stats=emit_stats, dtype=x.dtype)


@pytest.mark.parametrize("b,h,w,ci,co,splits,residual,stats", [
    (1, 8, 8, 64, 64, 1, False, False),
    (2, 12, 20, 96, 72, 2, True, True),    # 240 pixels: a ragged M tile; a ragged Ci chunk
    (1, 5, 7, 32, 40, 3, True, False),     # Co not a multiple of 64
    (2, 16, 9, 128, 16, 5, False, True),
    (1, 3, 3, 64, 8, 9, True, True),       # one K step a split
])
def test_int8_pieces_compose_to_the_plain_conv_bitwise(rng, b, h, w, ci, co, splits, residual,
                                                       stats):
    """The padded code map, the int32 split partials and the reduction,
    composed, equal ``_conv3x3_int8_plain`` (the float64 conv with the
    zero-point pad) bitwise, output and moments, for any split: integer
    partial sums are exact in any order and the epilogue rounds at the
    same points.  Zero points are nonzero, so the border taps read z."""
    x = tt(rng.normal(size=(b, h, w, ci)) * 1.5, torch.bfloat16)
    kw = dict(prologue_scale=tt(rng.uniform(0.5, 1.5, (b, ci))),
              prologue_bias=tt(rng.normal(size=(b, ci))),
              act_inv_scale=tt(rng.uniform(5.0, 40.0, ci)),
              act_zp=tt(rng.integers(-110, 60, ci)), w_scale=tt(rng.uniform(1e-4, 1e-3, co)),
              emit_stats=stats)
    if residual:
        kw["residual"] = tt(rng.normal(size=(b, h, w, co)), torch.bfloat16)
    k = torch.from_numpy(rng.integers(-127, 128, (3, 3, ci, co)).astype(np.int8))
    bias = tt(rng.normal(size=co))
    want = tconv.conv3x3_slab_plain(x, k, bias, **kw)
    got = _int8_pieces(x, k, bias, splits=splits, **kw)
    ws = tconv.conv3x3_int8_split_plain(
        tconv.conv3x3_int8_codes_plain(x, kw["prologue_scale"], kw["prologue_bias"],
                                       kw["act_inv_scale"], kw["act_zp"]),
        tconv.conv3x3_kmajor_plain(k), splits)
    assert ws.dtype == torch.int32 and tuple(ws.shape) == (splits, b, h, w, co)
    if stats:
        (got, got_st), (want, want_st) = got, want
        assert torch.equal(got_st, want_st)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("b,co,temb,residual,emit,splits", [
    (1, 64, False, False, False, 1),
    (2, 64, True, True, True, 3),
    (2, 40, True, False, True, 2),     # Co not a multiple of 64
])
def test_int8_pieces_match_pallas_interpret(rng, monkeypatch, b, co, temb, residual, emit,
                                            splits):
    """The composition of D's pieces under ``gn_silu_conv3x3_slab`` against
    the JAX int8 slab kernel in interpret mode, with the tolerance of
    ``test_int8_slab_plain_matches_pallas_interpret``."""
    hw, ci, g = 8, 64, 8
    c = _int8_slab_case(rng, b, hw, ci, co, g)
    opt_t, opt_j = {}, {}
    if temb:
        t = rng.normal(size=(b, ci)).astype(np.float32)
        opt_t["temb"], opt_j["temb"] = tt(t), jnp.asarray(t)
    if residual:
        r = rng.normal(size=(b, hw, hw, co)).astype(np.float32)
        opt_t["residual"], opt_j["residual"] = tt(r), jnp.asarray(r)
    monkeypatch.setattr(tconv, "conv3x3_slab", functools.partial(_int8_pieces, splits=splits))
    got = tconv.gn_silu_conv3x3_slab(
        tt(c["x"]), {k: tt(v) for k, v in c["norm"].items()},
        torch.from_numpy(c["q"]), tt(c["cb"]), num_groups=g, emit_stats=emit,
        act_inv_scale=1.0 / tt(c["s_act"]), act_zp=tt(c["z_act"]), w_scale=tt(c["w_scale"]),
        **opt_t)
    want = jconv.gn_silu_conv3x3_slab(
        jnp.asarray(c["x"]), c["norm"], jnp.asarray(c["q"]), jnp.asarray(c["cb"]),
        num_groups=g, emit_stats=emit, act_inv_scale=1.0 / jnp.asarray(c["s_act"]),
        act_zp=jnp.asarray(c["z_act"]), w_scale=jnp.asarray(c["w_scale"]),
        h_tile=8, co_tile=64, interpret=True, **opt_j)
    if emit:
        (got, got_st), (want, want_st) = got, want
        np.testing.assert_allclose(nn(got_st), nn(want_st), rtol=1e-3, atol=1e-3)
    _assert_int8_close(got, want, c["w_scale"])


def test_int8_codes_ring_holds_the_zero_point(rng):
    """The pre-pass's padded map: the one-pixel ring is z (the real value
    0), the inside the codes of the quantized prologue, half to even."""
    b, h, w, ci = 2, 3, 5, 32
    x = tt(rng.normal(size=(b, h, w, ci)), torch.bfloat16)
    a, c = tt(rng.uniform(0.5, 1.5, (b, ci))), tt(rng.normal(size=(b, ci)))
    s, z = tt(rng.uniform(5.0, 40.0, ci)), tt(rng.integers(-110, 60, ci))
    codes = tconv.conv3x3_int8_prologue(x, a, c, s, z)
    assert codes.dtype == torch.int8 and tuple(codes.shape) == (b, h + 2, w + 2, ci)
    ring = torch.ones((h + 2, w + 2), dtype=torch.bool)
    ring[1:-1, 1:-1] = False
    assert torch.equal(codes[:, ring].float(), z.expand(b, int(ring.sum()), ci))
    y = x.float() * a[:, None, None] + c[:, None, None]
    want = torch.clamp(torch.round(y * torch.sigmoid(y) * s) + z, -128, 127)
    assert torch.equal(codes[:, 1:-1, 1:-1].float(), want)
    zero = tconv.conv3x3_int8_prologue(x, a, c, s)  # no zero point: the ring is 0
    assert not zero[:, ring].any()


def test_int8_kmajor_copy_is_made_once_per_weight(rng):
    """D's K-major weights, (3, 3, Co, Ci): the permuted copy, made on
    first use, kept on the weight tensor (the parameter tree is untouched),
    and made again after the weight is written in place."""
    k = torch.from_numpy(rng.integers(-127, 128, (3, 3, 32, 24)).astype(np.int8))
    wk = tconv._kmajor(k)
    assert tuple(wk.shape) == (3, 3, 24, 32) and wk.is_contiguous()
    assert torch.equal(wk, tconv.conv3x3_kmajor_plain(k))
    assert torch.equal(wk[1, 2], k[1, 2].T)
    assert tconv._kmajor(k) is wk
    k[0, 0, 0, 0] = 5
    again = tconv._kmajor(k)
    assert again is not wk and int(again[0, 0, 0, 0]) == 5


# ----------------------------------------------------- quantized resnets --

@pytest.fixture
def jax_slab_interpret(monkeypatch):
    """The JAX package's conv kernels in interpret mode (its TPU route on
    the CPU), as tests/test_quant.py runs flash; nothing in sdtpu changes."""
    def interpreted(fn):
        return lambda *a, **kw: fn(*a, **{**kw, "interpret": True})

    for name in ("conv3x3_gemm_slab", "conv3x3_gemm"):
        monkeypatch.setattr(jconv, name, interpreted(getattr(jconv, name)))


def _resnet_params(init, ci, co, *extra):
    p = init(jax.random.key(3), ci, co, *extra, dtype=jnp.float32)
    return jquant._quantize_resnet(p, min_ch=8)


@pytest.mark.parametrize("co", [64, 128])
def test_quantized_resnet_block_int8_route_matches_jax_slab(rng, jax_slab_interpret, co):
    """At a slab-eligible shape both packages take the int8 slab route."""
    jp = _resnet_params(junet._init_resnet, 64, co, 16)
    tp = port_params(jp)
    routes = tquant.resnet_conv_args((2, 8, 8, 64), tp, 32, torch.float32)
    assert [k.dtype for k, _, _ in routes] == [torch.int8, torch.int8]
    x = (rng.normal(size=(2, 8, 8, 64)) + 0.2).astype(np.float32)
    temb = rng.normal(size=(2, 16)).astype(np.float32)
    got = tunet.resnet_block(tt(x), tt(temb), tp, num_groups=32)
    want = junet.resnet_block(jnp.asarray(x), jnp.asarray(temb), jp, num_groups=32,
                              conv_impl="gemm")
    _assert_int8_close(got, want, np.maximum(np.asarray(jp["conv1"]["w_scale"]).max(),
                                             np.asarray(jp["conv2"]["w_scale"]).max()))


@pytest.mark.parametrize("co", [64, 128])
def test_quantized_vae_resnet_int8_route_matches_jax_slab(rng, jax_slab_interpret, co):
    jp = _resnet_params(jvae._init_vae_resnet, 64, co)
    tp = port_params(jp)
    x = (rng.normal(size=(2, 8, 8, 64)) - 0.1).astype(np.float32)
    got, got_st = tvae.vae_resnet(tt(x), tp, num_groups=32, emit_stats=True)
    want, want_st = jvae.vae_resnet(jnp.asarray(x), jp, num_groups=32, conv_impl="gemm",
                                    emit_stats=True)
    ws = np.maximum(np.asarray(jp["conv1"]["w_scale"]).max(),
                    np.asarray(jp["conv2"]["w_scale"]).max())
    _assert_int8_close(got, want, ws)
    np.testing.assert_allclose(nn(got_st), nn(want_st), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("which", ["unet", "vae"])
def test_quantized_resnet_below_the_slab_shapes_dequantizes(rng, which):
    """At the TINY shapes no slab plan exists (Ci, Co < 64), so a quantized
    resnet takes the dequantized float route with the original bias, and
    equals the JAX package's CPU program."""
    if which == "unet":
        jp = _resnet_params(junet._init_resnet, 16, 24, 16)
    else:
        jp = _resnet_params(jvae._init_vae_resnet, 16, 24)
    tp = port_params(jp)
    routes = tquant.resnet_conv_args((2, 8, 8, 16), tp, 8, torch.float32)
    assert [k.dtype for k, _, _ in routes] == [torch.float32, torch.float32]
    assert routes[0][1] is tp["conv1"]["bias"]
    x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    if which == "unet":
        temb = rng.normal(size=(2, 16)).astype(np.float32)
        got = tunet.resnet_block(tt(x), tt(temb), tp, num_groups=8)
        want = junet.resnet_block(jnp.asarray(x), jnp.asarray(temb), jp, num_groups=8)
    else:
        got = tvae.vae_resnet(tt(x), tp, num_groups=8)
        want = jvae.vae_resnet(jnp.asarray(x), jp, num_groups=8)
    close_scaled(got, want)


def test_resnet_routing_rule():
    """The JAX package's shape rule without its VMEM budget: both convs
    need a 3x3 kernel, H and W multiples of 8 and Ci, Co >= 64, and both
    channel counts must divide by the group count."""
    ok = tquant.slab_plan_ok
    assert ok((2, 64, 64, 320), (3, 3, 320, 320))
    assert ok((1, 512, 512, 128), (3, 3, 128, 128))
    assert not ok((2, 12, 16, 64), (3, 3, 64, 64))
    assert not ok((2, 16, 16, 32), (3, 3, 32, 64))
    assert not ok((2, 16, 16, 64), (1, 1, 64, 64))
    tp = port_params(_resnet_params(junet._init_resnet, 64, 96, 16))

    def kinds(x_shape, groups):
        return [k.dtype for k, _, _ in tquant.resnet_conv_args(x_shape, tp, groups,
                                                               torch.float32)]

    assert kinds((1, 8, 8, 64), 32) == [torch.int8, torch.int8]
    assert kinds((1, 8, 8, 64), 64) == [torch.float32, torch.float32]  # 96 % 64
    assert kinds((1, 12, 12, 64), 32) == [torch.float32, torch.float32]


# --------------------------------------------------------------- models --

@pytest.fixture(scope="module")
def q_trees(jparams):
    jq = jquant.quantize_pipeline_int8(jparams, min_ch=8, transformer="full", vae=True)
    return jq, port_params(jq)


def test_unet_forward_int8_tiny_matches_jax(q_trees):
    """TINY int8 tree: resnets dequantized (no slab plan), every transformer
    matmul int8 (post-LN static, out-projections dynamic); the port's flash
    route against the JAX CPU program's dense route."""
    jq, tq = q_trees
    rng = np.random.default_rng(3)
    lat = rng.normal(size=(2, 4, 4, 4)).astype(np.float32)
    ts = np.array([981.0, 21.0], np.float32)
    ctx = rng.normal(size=(2, 16, TINY.unet.cross_attention_dim)).astype(np.float32)
    got = tunet.unet_forward(tt(lat), tt(ts), tt(ctx), tq["unet"], TTINY.unet)
    # one jitted program: the same function as the eager ops, compiled once
    want = jax.jit(lambda p: junet.unet_forward(jnp.asarray(lat), jnp.asarray(ts),
                                                jnp.asarray(ctx), p, TINY.unet))(jq["unet"])
    close_scaled(got, want)


def test_vae_decode_int8_tiny_matches_jax(q_trees):
    jq, tq = q_trees
    lat = np.random.default_rng(6).normal(size=(1, 4, 4, 4)).astype(np.float32)
    got = tvae.vae_decode(tt(lat), tq["vae_decoder"], TTINY.vae)
    want = jax.jit(lambda p: jvae.vae_decode(jnp.asarray(lat), p, TINY.vae))(jq["vae_decoder"])
    close_scaled(got, want)


SLAB_UNET = UNetConfig(block_out_channels=(64, 64), layers_per_block=1,
                       attention_levels=(False, True), num_attention_heads=2,
                       cross_attention_dim=32, norm_num_groups=32)


def test_unet_forward_all_resnets_on_kernel_d(rng, jax_slab_interpret):
    """A small UNet whose every resnet passes the slab rule (64 channels,
    8x8 and 16x16... maps): all of them run kernel D's plain version here and
    the JAX slab kernel in interpret mode there."""
    jp = jquant.quantize_unet_int8(junet.init_unet(5, SLAB_UNET), min_ch=8, transformer=True)
    tp = port_params(jp)
    lat = rng.normal(size=(1, 16, 16, 4)).astype(np.float32)
    ts = np.array([601.0], np.float32)
    ctx = rng.normal(size=(1, 5, 32)).astype(np.float32)
    calls = []
    orig = tconv.conv3x3_slab_plain

    def spy(x, kernel, *a, **kw):
        calls.append(kernel.dtype)
        return orig(x, kernel, *a, **kw)

    tconv.conv3x3_slab_plain = spy
    try:
        got = tunet.unet_forward(tt(lat), tt(ts), tt(ctx), tp, port_config(SLAB_UNET))
    finally:
        tconv.conv3x3_slab_plain = orig
    n_res = 2 * (len(jp["down_blocks"]) * 1 + len(jp["up_blocks"]) * 2)
    assert calls.count(torch.int8) == n_res
    want = jax.jit(lambda p: junet.unet_forward(jnp.asarray(lat), jnp.asarray(ts),
                                                jnp.asarray(ctx), p, SLAB_UNET,
                                                conv_impl="gemm"))(jp)
    ws = max(float(np.asarray(leaf).max()) for path, leaf in _leaves(_host_tree(jp))
             if path[-1] == "w_scale" and ("conv1" in path or "conv2" in path))
    _assert_int8_close(got, want, ws)


# ------------------------------------------------------------ end to end --

def test_txt2img_int8_tiny_within_one_level(tiny_pipe):
    """The quantized TINY pipeline (min_ch=8, transformer="full",
    vae=True), with the JAX package's own latents and noise injected."""
    steps, seed = 3, 40
    kw = dict(min_ch=8, transformer="full", vae=True)
    jpipe = JaxPipeline(TINY, jquant.quantize_pipeline_int8(tiny_pipe.params, **kw))
    want = jpipe.generate("x", token_ids=TOKENS, num_inference_steps=steps, seed=seed)
    pipe = StableDiffusionPipeline.from_params(TTINY, _host_tree(tiny_pipe.params), device="cpu")
    assert pipe.quantize_int8(**kw) is pipe
    lat = TINY.default_image_size // TINY.vae.downscale_factor
    lat0, noise = jax_noise(seed, steps, (1, lat, lat, TINY.vae.latent_channels))
    reset_launch_counts()
    got = pipe.txt2img(pipe._tokenize("", "", True, TOKENS), lat0, noise, cfg=True,
                       cfg_scale=TINY.default_cfg_scale)
    assert all(n == 0 for n in launch_counts.values())
    assert_images_match(got, want)


def test_quantize_int8_autopairs_vae_on_few_step_presets(caplog):
    """``vae=None`` turns the VAE path on when default_steps <= 8, and says
    so; an explicit ``vae=False`` wins; many-step presets keep it off."""
    def vae_conv1(pipe):
        return pipe.params["vae_decoder"]["up_blocks"][0]["resnets"][0]["conv1"]

    few = TTINY.replace(default_steps=4)
    with caplog.at_level("INFO", logger="sdtpu_torch.pipeline"):
        auto = StableDiffusionPipeline.from_random(few, device="cpu").quantize_int8(min_ch=8)
    assert "kernel_q" in vae_conv1(auto) and "int8 VAE" in caplog.text
    off = StableDiffusionPipeline.from_random(few, device="cpu").quantize_int8(min_ch=8,
                                                                              vae=False)
    assert "kernel_q" not in vae_conv1(off)
    many = StableDiffusionPipeline.from_random(TTINY, device="cpu").quantize_int8(min_ch=8)
    assert "kernel_q" not in vae_conv1(many)
    for p in (auto, off, many):
        assert "kernel_q" in p.params["unet"]["down_blocks"][1]["resnets"][0]["conv1"]


# ----------------------------------------------------------- calibration --

CAL = UNetConfig(block_out_channels=(64, 96), layers_per_block=1,
                 attention_levels=(True, True), num_attention_heads=2,
                 cross_attention_dim=64, norm_num_groups=8)


def _cal_samples(seed=0, n=2):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((1, 8, 8, 4)).astype(np.float32),
             np.asarray([500.0 - 100.0 * i], np.float32),
             rng.standard_normal((1, 5, 64)).astype(np.float32)) for i in range(n)]


def test_iter_dynamic_sites_paths_match_jax(jparams):
    jp = junet.init_unet(0, CAL)
    for params in (jp, jparams["unet"]):
        want = [p for p, _ in jcal.iter_dynamic_sites(params)]
        got = [p for p, _ in tcal.iter_dynamic_sites(port_params(params))]
        assert got == want and len(got) > 0


def test_calibrate_unet_act_ranges_matches_jax():
    jp = junet.init_unet(0, CAL)
    samples = _cal_samples()
    want = jcal.calibrate_unet_act_ranges(
        jp, CAL, [tuple(jnp.asarray(a) for a in s) for s in samples])
    got = tcal.calibrate_unet_act_ranges(
        port_params(jp), port_config(CAL), [tuple(tt(a) for a in s) for s in samples])
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-5, atol=1e-6, err_msg=path)


def test_activation_capture_accumulates_and_refuses_tracing():
    lin = {"kernel": torch.ones((4, 4))}
    store = {}
    with tlinear.activation_capture(store, {id(lin["kernel"]): "site"}):
        tlinear.linear(torch.tensor([[1.0, -2.0, 0.5, 0.0]]), lin)
        tlinear.linear(torch.tensor([[0.5, 1.0, -3.0, 0.1]]), lin)
        with pytest.raises(RuntimeError, match="eagerly"):
            torch.jit.trace(lambda x: tlinear.linear(x, lin), (torch.ones(1, 4),))
    np.testing.assert_allclose(store["site"], [1.0, 2.0, 3.0, 0.1])
    tlinear.linear(torch.ones((1, 4)), lin)
    assert set(store) == {"site"}


def test_calibrate_pipeline_then_quantize_generates():
    """Calibrate -> quantize(transformer="full", act_ranges) -> generate on
    the TINY port pipeline: every site gets a range, calibrated sites get a
    static scale (act_scale present, zero zero point)."""
    pipe = StableDiffusionPipeline.from_random(TTINY, device="cpu")
    ranges = tcal.calibrate_pipeline_act_ranges(pipe, TOKENS, num_steps=2)
    sites = dict(tcal.iter_dynamic_sites(pipe.params["unet"]))
    assert set(ranges) == set(sites)
    pipe.quantize_int8(min_ch=8, transformer="full", act_ranges=ranges)
    out = pipe.params["unet"]["down_blocks"][0]["attentions"][0]["blocks"][0]["ff"]["out"]
    assert "act_scale" in out and not out["act_zp"].any()
    img = pipe.generate(token_ids=TOKENS, num_inference_steps=2, seed=1)
    assert img.shape == (1, 32, 32, 3) and img.dtype == np.uint8


def test_flash_route_ignores_calibrated_out_proj_scale_as_jax_does(rng, monkeypatch):
    """A fault of the JAX package that the port reproduces on purpose: its
    flash route quantizes the self-attention out-projection with run-time
    row scales whenever the weight is int8, so a calibrated static scale is
    ignored there (``sdtpu/ops/attention.py:170-187``), while its dense
    route (the CPU program) honours it.  The port's flash route equals the
    JAX flash route, not the JAX dense route."""
    monkeypatch.setattr(jattn, "_PACKED_OUT_PROJ", False)
    import sdtpu.kernels.flash_attention as jflash

    monkeypatch.setattr(jflash, "flash_attention_packed",
                        functools.partial(jflash.flash_attention_packed, interpret=True))
    params = jattn.init_attention(jax.random.key(0), 32, qkv_bias=False)
    s, z = jquant.act_qparams_from_ln({"scale": jnp.ones(32), "bias": jnp.zeros(32)})
    qp = {k: jquant._quantize_linear(params[k], s, z) for k in ("q", "k", "v")}
    amax = np.full(32, 0.05, np.float32)  # calibrated far below the real range
    qp["out"] = jquant._quantize_linear(params["out"], amax / 127.0, np.zeros(32, np.float32))
    x = rng.normal(size=(1, 64, 32)).astype(np.float32)
    jflash_out = jattn.attention(jnp.asarray(x), qp, num_heads=2, implementation="flash")
    jdense_out = jattn.attention(jnp.asarray(x), qp, num_heads=2, implementation="xla")
    got = tattn.attention(tt(x), port_params(qp), num_heads=2, implementation="flash")
    close_scaled(got, jflash_out, rtol=1e-5)
    assert np.abs(nn(jflash_out) - nn(jdense_out)).max() > 1e-2


# ------------------------------------------------------------------ card --

@pytest.mark.gpu
@pytest.mark.parametrize("x_shape,co,res,stats", [
    ((2, 16, 16, 64), 128, True, True),
    ((1, 12, 20, 96), 72, False, True),   # ragged M and N tiles
    ((2, 8, 8, 320), 320, True, False),
])
def test_cuda_int8_slab_matches_plain(rng, x_shape, co, res, stats):
    """Kernel D on the card against its plain version: a few activation
    codes may flip where the card's expf differs by an ulp; tolerance 2% of
    max |plain| and at most 1% of the outputs off by more than 1e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    b, h, w, ci = x_shape
    c = _int8_slab_case(rng, b, h, ci, co, 32)
    kw = dict(prologue_scale=tt(rng.uniform(0.5, 1.5, (b, ci))).to(dev),
              prologue_bias=tt(rng.normal(size=(b, ci))).to(dev),
              act_inv_scale=(1.0 / tt(c["s_act"])).to(dev), act_zp=tt(c["z_act"]).to(dev),
              w_scale=tt(c["w_scale"]).to(dev), emit_stats=stats)
    if res:
        kw["residual"] = tt(rng.normal(size=(b, h, w, co)), torch.bfloat16).to(dev)
    x = tt(rng.normal(size=x_shape), torch.bfloat16).to(dev)
    k, bias = torch.from_numpy(c["q"]).to(dev), tt(c["cb"]).to(dev)
    reset_launch_counts()
    got = tconv.conv3x3_slab(x, k, bias, **kw)
    torch.cuda.synchronize()
    assert launch_counts["conv3x3_slab_int8"] == 1
    want = tconv.conv3x3_slab_plain(x, k, bias, **kw)
    if stats:
        (got, got_st), (want, want_st) = got, want
        np.testing.assert_allclose(got_st.cpu().numpy(), want_st.cpu().numpy(),
                                   rtol=1e-2, atol=1e-2)
    g, wn = got.float().cpu().numpy(), want.float().cpu().numpy()
    assert np.abs(g - wn).max() <= 2e-2 * np.abs(wn).max()
    assert (np.abs(g - wn) > 1e-2 * np.abs(wn).max()).mean() <= 1e-2


@pytest.mark.gpu
def test_cuda_int8_txt2img_runs_through_kernel_d():
    """A small bf16 config on the card, quantized with the VAE: the resnets
    that pass the slab rule (64 channels, 8x8 latent maps) launch kernel D."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    unet = TTINY.unet.__class__(**{**TTINY.unet.__dict__, "block_out_channels": (64, 64, 64)})
    cfg = TTINY.replace(unet=unet, compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    pipe = StableDiffusionPipeline.from_random(cfg, seed=0, device="cuda")
    pipe.quantize_int8(min_ch=8, transformer="full", vae=True)
    reset_launch_counts()
    img = pipe.generate(token_ids=TOKENS, num_inference_steps=2, seed=1, image_size=64)
    assert img.shape == (1, 64, 64, 3) and img.dtype == np.uint8
    assert launch_counts["conv3x3_slab_int8"] > 0, launch_counts


@pytest.mark.gpu
@pytest.mark.parametrize("x_shape,co,res,stats", [
    ((2, 16, 16, 1280), 1280, True, True),  # S = 4: the int32 reduction
    ((1, 12, 20, 96), 72, False, True),     # unsplit; ragged M, Ci chunk and N tile
    ((2, 32, 32, 640), 640, True, False),   # S = 2
])
def test_cuda_int8_pieces_match_plain(rng, x_shape, co, res, stats):
    """Kernel D's pieces on the card: the pre-pass's codes within one code
    of the plain version's (an ulp of the card's expf may flip a rounding),
    the ring exactly z; the split GEMM's int32 partials and the reduction
    bitwise against their plain versions on the same inputs; the whole
    call bitwise equal to the plain reduction of the plain GEMM on the
    card's own codes; launches as ``conv3x3_int8_launches`` says."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    b, h, w, ci = x_shape
    c = _int8_slab_case(rng, b, h, ci, co, 32)
    a = tt(rng.uniform(0.5, 1.5, (b, ci))).to(dev)
    pc = tt(rng.normal(size=(b, ci))).to(dev)
    s, z = (1.0 / tt(c["s_act"])).to(dev), tt(c["z_act"]).to(dev)
    wsc, bias = tt(c["w_scale"]).to(dev), tt(c["cb"]).to(dev)
    x = tt(rng.normal(size=x_shape), torch.bfloat16).to(dev)
    k = torch.from_numpy(c["q"]).to(dev)
    r = tt(rng.normal(size=(b, h, w, co)), torch.bfloat16).to(dev) if res else None
    reset_launch_counts()
    codes = tconv.conv3x3_int8_prologue(x, a, pc, s, z)
    torch.cuda.synchronize()
    assert launch_counts["conv3x3_slab_int8_prologue"] == 1
    want_codes = tconv.conv3x3_int8_codes_plain(x, a, pc, s, z)
    diff = (codes.int() - want_codes.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3
    assert torch.equal(codes[:, 0], want_codes[:, 0]) and torch.equal(codes[:, :, -1],
                                                                      want_codes[:, :, -1])
    splits = tconv.plan_conv3x3_int8_split(b, h, w, ci, co)
    wk = tconv.conv3x3_kmajor_plain(k)
    for sp in {2, max(2, splits)}:
        assert torch.equal(tconv.conv3x3_int8_split(codes, k, sp),
                           tconv.conv3x3_int8_split_plain(codes, wk, sp))
    ws = tconv.conv3x3_int8_split_plain(codes, wk, max(2, splits))
    got, got_st = tconv.conv3x3_int8_splitk_reduce(ws, wsc, bias, r, emit_stats=True)
    want, want_st = tconv.conv3x3_int8_reduce_plain(ws, wsc, bias, r, emit_stats=True)
    assert torch.equal(got, want)
    torch.testing.assert_close(got_st, want_st, rtol=1e-4, atol=1e-4)
    kw = dict(prologue_scale=a, prologue_bias=pc, act_inv_scale=s, act_zp=z, w_scale=wsc,
              residual=r, emit_stats=stats)
    reset_launch_counts()
    out = tconv.conv3x3_slab(x, k, bias, **kw)
    torch.cuda.synchronize()
    assert {n: v for n, v in launch_counts.items() if v} == tconv.conv3x3_int8_launches(x_shape,
                                                                                         co)
    ref = tconv.conv3x3_int8_reduce_plain(tconv.conv3x3_int8_split_plain(codes, wk, 1), wsc,
                                          bias, r, emit_stats=stats)
    if stats:
        (out, out_st), (ref, ref_st) = out, ref
        torch.testing.assert_close(out_st, ref_st, rtol=1e-4, atol=1e-4)
    assert torch.equal(out, ref)
