"""The port's measurement entry points and their kernels against the JAX
package on the CPU: kernel E (``conv3x3_gemm``) and the ``conv2d(impl="gemm")``
route to it, and the probe kernels H (``legacy_flash``), I (``flash_2q``)
and J (``make``) of ``sdtpu_torch/tools``.

Inputs are made with numpy from a seed and handed to both packages.  The
Pallas kernels run as the JAX package's own tests run them on the CPU:
``interpret=True`` for E, and ``pltpu.force_tpu_interpret_mode()`` for the
tools' kernels and the ops route, which take no ``interpret`` argument.
The JAX flash probes pad the head dim to 128 lanes; the port keeps the
real head dim, so the JAX output is compared on ``[..., :d]``.
Tolerances:

* float32: about 1e-5 -- the same function in float32, differing in
  summation order (and the online softmax's running max) only;
* bfloat16 flash: max |port - jax| <= 2e-2 * max |jax|, one bf16 rounding
  step of P where an accumulation-order difference lands on a boundary;
* bfloat16 conv (E): within one bf16 ulp per element at each of E's two
  roundings (the f32 accumulator to bf16, then accumulator + bias), i.e.
  ulp(conv) + ulp(out) -- both accumulate the exact products in float32,
  in another order, and round at the same points;
* bfloat16 dot (J): within one bf16 ulp per element (one rounding); the
  card kernel's split-K order (float32 partial sums added in split order,
  rounded once) within one bf16 ulp plus the float32 bound of a sum taken
  in another order, ``2 * k * 2^-24 * (|x| @ |w|)`` (an output near zero
  after cancellation has an ulp far below its sum's rounding error), and
  bitwise with one split;
* int8 dot: exactly equal.

Tests marked ``gpu`` hold the CUDA kernels against their plain versions on
the card; they skip on a machine without one.
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import sdtpu.kernels.conv2d as jconv
import sdtpu.ops as jops
import sdtpu_torch.ops.conv as tops_conv
from sdtpu_torch.kernels import _build, launch_counts, reset_launch_counts
from sdtpu_torch.kernels import conv2d as tconv
from sdtpu_torch.kernels.flash_attention import plan_flash
from sdtpu_torch.ops import conv2d as tconv2d
from sdtpu_torch.tools import probe_flash_2stream as t2q
from sdtpu_torch.tools import probe_flash_vpu as tvpu
from sdtpu_torch.tools import probe_int8_dot as tdot
from test_torch_ops import nn, tt

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
BF16_REL = 2e-2
_DT = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _jax_tool(name):
    """The JAX package's tool ``tools/<name>.py`` as a module (``tools`` is
    not a package)."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jvpu = _jax_tool("probe_flash_vpu")
j2q = _jax_tool("probe_flash_2stream")
jdot = _jax_tool("probe_int8_dot")


def bf16_ulp(a):
    """One bf16 ulp at |a| (8 significant bits)."""
    a = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _flash_inputs(rng, shape, lk=None):
    """q (B,H,Lq,D), k/v (B,H,Lk,D) float32, and the JAX probes' 128-lane
    zero-padded copies."""
    b, h, lq, d = shape
    lk = lq if lk is None else lk
    real = [rng.normal(size=s).astype(np.float32) for s in
            ((b, h, lq, d), (b, h, lk, d), (b, h, lk, d))]
    padded = [np.pad(a, ((0, 0), (0, 0), (0, 0), (0, 128 - d))) for a in real]
    return real, padded


def _flash_close(got, want, dtype):
    g, w = nn(got), nn(want)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=2e-5)
    else:
        assert np.abs(g - w).max() <= BF16_REL * np.abs(w).max()


# ----------------------------------------------------------------- kernel E --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,ci,co", [
    (1, 8, 8, 16, 32),
    (2, 16, 16, 128, 128),
    (1, 8, 8, 24, 40),   # non-aligned channels
    (1, 8, 8, 16, 300),  # co > co_tile with padding in the JAX kernel
])
def test_conv3x3_gemm_matches_pallas(rng, dtype, b, h, w, ci, co):
    """Kernel E: f32 accumulation, one cast to x's dtype, then the bias
    added in x's dtype (the JAX kernel's two roundings)."""
    tdt, jdt = _DT[dtype]
    x = rng.standard_normal((b, h, w, ci), dtype=np.float32)
    k = (rng.standard_normal((3, 3, ci, co), dtype=np.float32) * 0.1).astype(np.float32)
    bias = rng.standard_normal(co, dtype=np.float32)
    xj, kj = jnp.asarray(x, jdt), jnp.asarray(k, jdt)
    want = jconv.conv3x3_gemm(xj, kj, jnp.asarray(bias), co_tile=128, interpret=True)
    got = tconv.conv3x3_gemm(tt(x, tdt), tt(k, tdt), tt(bias), co_tile=128)
    assert got.dtype == tdt and tuple(got.shape) == (b, h, w, co)
    if dtype == "float32":
        np.testing.assert_allclose(nn(got), nn(want), rtol=1e-5, atol=1e-5)
    else:
        pre = nn(jconv.conv3x3_gemm(xj, kj, None, co_tile=128, interpret=True))
        assert (np.abs(nn(got) - nn(want)) <= bf16_ulp(pre) + bf16_ulp(nn(want))).all()


def test_conv3x3_gemm_adds_its_bias_after_the_cast(rng):
    """E rounds the accumulator and the bias to bf16 and then their sum,
    where the slab kernel A adds the f32 bias to the f32 accumulator and
    rounds once; the two differ by up to one ulp at each of E's roundings,
    and E's result is exactly the bf16 sum of the bf16-rounded conv and the
    bf16 bias."""
    x = tt(rng.standard_normal((1, 8, 8, 64)), torch.bfloat16)
    k = tt(rng.standard_normal((3, 3, 64, 64)) * 0.05, torch.bfloat16)
    bias = tt(rng.standard_normal(64) * 3.3)
    e, pre = tconv.conv3x3_gemm(x, k, bias), tconv.conv3x3_gemm(x, k)
    assert torch.equal(e, pre + bias.to(torch.bfloat16))
    a = tconv.conv3x3_slab(x, k, bias)
    assert not torch.equal(e, a)
    tol = bf16_ulp(nn(pre)) + bf16_ulp(nn(bias))[None, None, None] + bf16_ulp(nn(a))
    assert (np.abs(nn(e) - nn(a)) <= tol).all()


@pytest.mark.parametrize("co", [4, 32, 64, 320, 640, 1280, 2560])
def test_plan_co_tile_and_fits_fused_match_jax(co):
    """The routing rule is the JAX package's, shape for shape."""
    for b in (1, 2):
        for h, w in ((8, 8), (12, 16), (16, 16), (64, 64), (72, 64), (96, 96), (128, 128),
                     (24, 40), (64, 72)):
            for ci in (4, 32, 64, 320, 640, 1280, 2560):
                for kh in (1, 3):
                    xs, ks = (b, h, w, ci), (kh, kh, ci, co)
                    assert tconv.plan_co_tile(xs, ks) == jconv.plan_co_tile(xs, ks), (xs, ks)
                    assert tconv.fits_fused(xs, ks) == jconv.fits_fused(xs, ks), (xs, ks)


def test_co_tile_candidates_and_vmem_estimate_match_jax():
    for co in (64, 128, 300, 320, 640, 960, 1280, 2560):
        assert tconv._co_tile_candidates(co) == jconv._co_tile_candidates(co)
    for args in ((64, 64, 320, 320), (32, 32, 640, 640), (96, 96, 960, 256)):
        assert tconv._vmem_estimate(*args) == jconv._vmem_estimate(*args)
    assert tconv._VMEM_BUDGET == jconv._VMEM_BUDGET


# -------------------------------------------------------- conv2d(impl=gemm) --

@pytest.mark.parametrize("case,x_shape,co,route", [
    ("whole-map", (1, 16, 16, 64), 64, "conv3x3_gemm"),
    ("slab only, H*W > 4096", (1, 72, 64, 64), 64, "conv3x3_slab"),
    ("neither, Ci < 64", (1, 16, 16, 32), 64, None),
])
def test_conv2d_gemm_route_matches_jax(rng, monkeypatch, case, x_shape, co, route):
    """``conv2d(impl="gemm")`` routes as ``sdtpu/ops/conv.py:44-63``: to E
    where plan_co_tile accepts, else to the slab kernel without prologue
    where the slab plan accepts, else to the plain conv; a recording shim
    shows which port wrapper ran."""
    ci = x_shape[-1]
    x = rng.standard_normal(x_shape, dtype=np.float32)
    k = (rng.standard_normal((3, 3, ci, co)) * (9 * ci) ** -0.5).astype(np.float32)
    bias = rng.standard_normal(co, dtype=np.float32)
    ran = []
    for name in ("conv3x3_gemm", "conv3x3_slab"):
        real = getattr(tops_conv, name)

        def shim(*a, _name=name, _real=real, **kw):
            ran.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(tops_conv, name, shim)
    got = tconv2d(tt(x), tt(k), tt(bias), padding=1, impl="gemm")
    with pltpu.force_tpu_interpret_mode():
        want = jops.conv2d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), padding=1,
                           impl="gemm")
    assert ran == ([] if route is None else [route])
    np.testing.assert_allclose(nn(got), nn(want), rtol=1e-5, atol=1e-5)
    ran.clear()
    np.testing.assert_allclose(nn(tconv2d(tt(x), tt(k), tt(bias), padding=1)), nn(got),
                               rtol=1e-5, atol=1e-5)
    assert ran == []  # the default impl takes no kernel


def test_conv2d_gemm_route_keeps_other_convs_plain(rng, monkeypatch):
    """Stride 2, a 1x1 kernel or another padding stay on the plain conv
    under impl="gemm", as in the JAX package; an unknown impl raises."""
    monkeypatch.setattr(tops_conv, "conv3x3_gemm", None)
    monkeypatch.setattr(tops_conv, "conv3x3_slab", None)
    x = tt(rng.standard_normal((1, 16, 16, 64)))
    k3, k1 = tt(rng.standard_normal((3, 3, 64, 64))), tt(rng.standard_normal((1, 1, 64, 64)))
    for kernel, kw in ((k3, {"stride": 2, "padding": 1}), (k1, {}), (k3, {"padding": 0}),
                       (k3, {"padding": ((0, 1), (0, 1))})):
        want = tconv2d(x, kernel, **kw)
        np.testing.assert_array_equal(nn(tconv2d(x, kernel, impl="gemm", **kw)), nn(want))
    with pytest.raises(ValueError, match="unknown impl"):
        tconv2d(x, k3, padding=1, impl="slab")


# ----------------------------------------------------------------- kernel H --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 2, 256, 40), (1, 2, 2048, 64)])
def test_legacy_flash_matches_the_jax_probe(rng, dtype, shape):
    """Kernel H against ``tools/probe_flash_vpu.py:legacy_flash``; at 2048
    keys the JAX kernel runs two key tiles."""
    tdt, jdt = _DT[dtype]
    real, padded = _flash_inputs(rng, shape)
    with pltpu.force_tpu_interpret_mode():
        want = jvpu.legacy_flash(*(jnp.asarray(a, jdt) for a in padded), d_real=shape[3])
    got = tvpu.legacy_flash(*(tt(a, tdt) for a in real))
    assert got.dtype == tdt and tuple(got.shape) == shape
    _flash_close(got, want[..., :shape[3]], dtype)


# ----------------------------------------------------------------- kernel I --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq", [1, 2, 3, 4])
def test_flash_2q_matches_the_jax_body_as_in_the_jax_probe(rng, monkeypatch, dtype, nq):
    """Kernel I against ``tools/probe_flash_2stream.py:flash_2q``.  The JAX
    kernel reads its padded head dim from ``a0_scr``, a name it never
    defines, so it raises NameError while it traces; supplying that name
    from outside (the shape of an accumulator, (bq, 128)) runs the unchanged
    body, which then equals the port.  Two q tiles of nq chains and, with
    block_k=128, two key tiles.  A Lq that is not a multiple of nq * bq is
    refused by both."""
    tdt, jdt = _DT[dtype]
    bq, d = 128, 40
    real, padded = _flash_inputs(rng, (1, 2, 2 * nq * bq, d), lk=256)
    qj, kj, vj = (jnp.asarray(a, jdt) for a in padded)
    with pltpu.force_tpu_interpret_mode():
        with pytest.raises(NameError, match="a0_scr"):
            j2q.flash_2q(qj, kj, vj, d_real=d, bq=bq, nq=nq, block_k=128)
        monkeypatch.setattr(j2q, "a0_scr", SimpleNamespace(shape=(bq, 128)), raising=False)
        want = j2q.flash_2q(qj, kj, vj, d_real=d, bq=bq, nq=nq, block_k=128)
        with pytest.raises(AssertionError):
            j2q.flash_2q(qj[:, :, :-8], kj, vj, d_real=d, bq=bq, nq=nq, block_k=128)
    q, k, v = (tt(a, tdt) for a in real)
    got = t2q.flash_2q(q, k, v, bq=bq, nq=nq, block_k=128)
    _flash_close(got, want[..., :d], dtype)
    with pytest.raises(ValueError, match="multiple of nq"):
        t2q.flash_2q(q[:, :, :-8], k, v, bq=bq, nq=nq)
    with pytest.raises(ValueError, match="multiple of nq"):
        t2q.flash_2q_plain(q[:, :, :-8], k, v, bq=bq, nq=nq)


def test_flash_probes_compute_kernel_cs_function(rng):
    """H, I and C are one function (natural exp or exp2, the mask on every
    tile or only where there is padding): in float32 their plain versions
    agree to rounding, at a key count that is no multiple of any tile."""
    from sdtpu_torch.kernels.flash_attention import flash_attention_plain

    real, _ = _flash_inputs(rng, (1, 2, 128, 40), lk=100)
    q, k, v = (tt(a) for a in real)
    c = flash_attention_plain(q, k, v)
    np.testing.assert_allclose(nn(tvpu.legacy_flash(q, k, v)), nn(c), rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(nn(t2q.flash_2q(q, k, v, bq=64, nq=2)), nn(c), rtol=1e-5,
                               atol=2e-6)


# ----------------------------------------------------------------- kernel J --

@pytest.mark.parametrize("form", ["bf16", "int8"])
@pytest.mark.parametrize("m,k,n", [(64, 128, 32), (256, 640, 64)])
def test_dot_matches_the_jax_probe(rng, form, m, k, n):
    """Kernel J against ``tools/probe_int8_dot.py:make``: int8 -> int32
    exactly, bf16 -> f32 -> bf16 within one bf16 ulp."""
    if form == "int8":
        x = rng.integers(-128, 128, (m, k), dtype=np.int8)
        w = rng.integers(-128, 128, (k, n), dtype=np.int8)
        dts = (jnp.int8, jnp.int32, jnp.int32), (torch.int8, torch.int32, torch.int32)
        xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    else:
        x = rng.standard_normal((m, k), dtype=np.float32)
        w = rng.standard_normal((k, n), dtype=np.float32)
        dts = (jnp.bfloat16, jnp.float32, jnp.bfloat16), (torch.bfloat16, torch.float32,
                                                          torch.bfloat16)
        xt, wt = tt(x, torch.bfloat16), tt(w, torch.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jdot.make(m, k, n, *dts[0])(jnp.asarray(x, dts[0][0]),
                                                      jnp.asarray(w, dts[0][0])))
    got = tdot.make(m, k, n, *dts[1])(xt, wt)
    assert got.dtype == dts[1][2] and tuple(got.shape) == (m, n)
    if form == "int8":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        want = want.astype(np.float32)
        assert (np.abs(nn(got) - want) <= bf16_ulp(want)).all()


@pytest.mark.parametrize("shape,plan", [((1024, 2560, 512), (128, 4)),
                                        ((4096, 640, 640), (160, 1))])
def test_plan_dot_fills_the_card_at_the_probe_shapes(shape, plan):
    """At the probe's shapes the bf16 plan is one wave over 128 of the 132
    SMs (128 x 128 tiles x 4 K-splits; 128 x 160 tiles unsplit): a fifth
    split or the other tile would need a second wave.  Each split keeps at
    least DOT_MIN_SPLIT K steps."""
    assert shape in tdot.SHAPES
    m, k, n = shape
    bn, splits = tdot.plan_dot(m, k, n)
    assert (bn, splits) == plan
    blocks = -(-m // tdot.DOT_BM) * -(-n // bn) * splits
    assert 0.95 * tdot.SMS <= blocks <= tdot.SMS
    assert k // tdot.DOT_BK // splits >= tdot.DOT_MIN_SPLIT
    assert tdot.dot_launches(m, k, n, torch.bfloat16) == (
        {"dot_bf16": 1, "dot_bf16_splitk": 1} if splits > 1 else {"dot_bf16": 1})
    i8_splits = tdot.plan_dot(m, k, n, True)[1]
    assert tdot.dot_launches(m, k, n, torch.int8) == {
        "dot_int8": 1, "dot_int8_transpose": 1, **({"dot_int8_splitk": 1} if i8_splits > 1 else {})}


@pytest.mark.parametrize("shape,plan", [((1024, 2560, 512), (128, 4)),
                                        ((4096, 640, 640), (160, 1))])
def test_plan_dot_int8_fills_the_card_at_the_probe_shapes(shape, plan):
    """J int8's plan on 128-value K steps: the same tiles as bf16 and one
    wave over 128 of the 132 SMs; each split keeps at least
    DOT_I8_MIN_SPLIT steps (512 K values, bf16's depth), so (4096, 640,
    640), 5 steps, does not split."""
    m, k, n = shape
    bn, splits = tdot.plan_dot(m, k, n, True)
    assert (bn, splits) == plan
    blocks = -(-m // tdot.DOT_BM) * -(-n // bn) * splits
    assert 0.95 * tdot.SMS <= blocks <= tdot.SMS
    assert -(-k // tdot.DOT_I8_BK) // splits >= tdot.DOT_I8_MIN_SPLIT or splits == 1
    assert tdot.DOT_I8_MIN_SPLIT * tdot.DOT_I8_BK == tdot.DOT_MIN_SPLIT * tdot.DOT_BK


@pytest.mark.parametrize("m,k,n,splits", [(1024, 2560, 512, 4), (100, 640, 48, 3),
                                          (64, 192, 16, 2)])
def test_dot_int8_split_partials_sum_to_dot_plain(rng, m, k, n, splits):
    """J int8's split partials (128-value K steps, ragged last split) and
    the exact reduction equal ``dot_plain`` bitwise; the K-major route
    (w transposed once) equals ``make``'s."""
    x = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8))
    want = tdot.dot_plain(x, w, torch.int32, torch.int32)
    ws = tdot.dot_int8_split_plain(x, w, splits)
    assert ws.dtype == torch.int32 and tuple(ws.shape) == (splits, m, n)
    assert torch.equal(tdot.dot_int8_reduce_plain(ws), want)
    assert torch.equal(tdot.dot_splitk_reduce(ws), want)
    wt = tdot.dot_int8_transpose(w)
    assert tuple(wt.shape) == (n, k) and wt.is_contiguous() and torch.equal(wt, w.T)
    assert torch.equal(tdot.dot_transpose_plain(w), wt)
    assert torch.equal(tdot.dot_int8_kmajor(x, wt), want)


@pytest.mark.parametrize("m,k,n", [(64, 48, 64), (64, 64, 60), (0, 64, 64), (64, 64, 0)])
def test_plan_dot_raises_on_shapes_the_kernel_does_not_take(m, k, n):
    with pytest.raises(ValueError, match="no plan"):
        tdot.plan_dot(m, k, n)


@pytest.mark.parametrize("m,k,n", tdot.SHAPES)
def test_dot_splitk_order_matches_dot_plain(rng, m, k, n):
    """The card kernel's order of sums, emulated on the CPU at the plan's
    splits: within the stated tolerance of ``dot_plain`` (float32 sums in
    another order, one rounding); with one split bitwise."""
    x = tt(rng.standard_normal((m, k), dtype=np.float32), torch.bfloat16)
    w = tt(rng.standard_normal((k, n), dtype=np.float32), torch.bfloat16)
    want = tdot.dot_plain(x, w, torch.float32, torch.bfloat16)
    got = tdot.dot_splitk_plain(x, w, tdot.plan_dot(m, k, n)[1])
    reorder = 2 * k * 2.0 ** -24 * nn(x.float().abs() @ w.float().abs())
    assert (np.abs(nn(got) - nn(want)) <= bf16_ulp(nn(want)) + reorder).all()
    assert torch.equal(tdot.dot_splitk_plain(x, w, 1), want)
    ws = tt(rng.standard_normal((3, 4, 8), dtype=np.float32))
    assert torch.equal(tdot.splitk_reduce_plain(ws), ((ws[0] + ws[1]) + ws[2]).to(torch.bfloat16))


def test_dot_make_refuses_other_forms_and_shapes():
    with pytest.raises(ValueError, match="is not one of"):
        tdot.make(8, 8, 8, torch.int8, torch.float32, torch.int32)
    f = tdot.make(8, 16, 8, torch.int8, torch.int32, torch.int32)
    with pytest.raises(ValueError, match=r"w must be"):
        f(torch.zeros((8, 16), dtype=torch.int8), torch.zeros((16, 4), dtype=torch.int8))


# ------------------------------------------------------------------- tools --

CARD_TOOLS = ["ab_conv", "probe_flash_vpu", "probe_flash_2stream", "probe_int8_dot", "ab_flash",
              "ab_probes"]

# Runs each tool as ``python -m sdtpu_torch.tools.<tool> 1`` runs it (runpy
# with run_name "__main__"), one after the other in one fresh process, and
# prints each one's exit code, stdout and stderr as JSON.
_RUN_AS_MAIN = r"""
import contextlib, io, json, runpy, sys, traceback
res = {}
for tool in sys.argv[1:]:
    out, err = io.StringIO(), io.StringIO()
    code = 0
    sys.argv = [tool, "1"]
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            runpy.run_module(f"sdtpu_torch.tools.{tool}", run_name="__main__", alter_sys=True)
        except SystemExit as exc:
            code = exc.code if isinstance(exc.code, int) else (0 if exc.code is None else 1)
        except BaseException:
            traceback.print_exc(file=err)
            code = 1
    res[tool] = [code, out.getvalue(), err.getvalue()]
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def tools_as_main():
    """Every card tool's ``python -m`` run without a card, in one process
    (its start and the imports once, not once a tool)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _RUN_AS_MAIN, *CARD_TOOLS], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("tool", CARD_TOOLS)
def test_tool_exits_non_zero_without_a_card(tool, tools_as_main):
    """``python -m sdtpu_torch.tools.<tool>`` has no CPU mode: without a
    card it exits non-zero and prints no measurement."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    code, stdout, stderr = tools_as_main[tool]
    assert code != 0
    assert "needs an NVIDIA card" in stderr
    assert "ms/call" not in stdout


def test_ab_slab_splits_kernel_d_by_kernel_name():
    """``ab_slab`` (and ``chip_smoke.py`` phase 8) split D's device time by
    the names of its CUDA kernels; a one-kernel D counts as the GEMM and the
    wrapper's torch work as ``other``."""
    from sdtpu_torch.tools.ab_slab import int8_pieces

    names = {"void (anonymous namespace)::quantize_kernel(...)": 1.0,
             "void (anonymous namespace)::conv3x3_int8_kernel<true, false, false>(...)": 2.0,
             "void (anonymous namespace)::int8_splitk_reduce_kernel<false, true>(...)": 0.5,
             "void at::native::reduce_kernel<...>(...)": 0.25}
    assert int8_pieces(names) == {"prologue": 1.0, "gemm": 2.0, "reduction": 0.5,
                                  "other": 0.25}
    assert int8_pieces({"conv3x3_int8_kernel<true, true>": 3.0})["gemm"] == 3.0


def test_probe_wrappers_run_plain_versions_on_the_cpu_and_count_nothing(rng):
    reset_launch_counts()
    x = tt(rng.standard_normal((1, 8, 8, 64)))
    k = tt(rng.standard_normal((3, 3, 64, 64)))
    np.testing.assert_array_equal(nn(tconv.conv3x3_gemm(x, k)), nn(tconv.conv3x3_gemm_plain(x, k)))
    q = tt(rng.standard_normal((1, 1, 128, 16)))
    np.testing.assert_array_equal(nn(tvpu.legacy_flash(q, q, q)), nn(tvpu.legacy_flash_plain(q, q, q)))
    np.testing.assert_array_equal(nn(t2q.flash_2q(q, q, q, bq=64)),
                                  nn(t2q.flash_2q_plain(q, q, q, bq=64)))
    xi = torch.ones((8, 64), dtype=torch.int8)
    got = tdot.make(8, 64, 8, torch.int8, torch.int32, torch.int32)(xi, xi.T)
    assert torch.equal(got, torch.full((8, 8), 64, dtype=torch.int32))
    xb = xi.to(torch.bfloat16)
    got = tdot.make(8, 64, 8, torch.bfloat16, torch.float32, torch.bfloat16)(xb, xb.T)
    assert torch.equal(got, torch.full((8, 8), 64, dtype=torch.bfloat16))
    ws = tt(rng.standard_normal((4, 8, 8)))
    assert torch.equal(tdot.dot_splitk_reduce(ws), tdot.splitk_reduce_plain(ws))
    wi = torch.from_numpy(rng.integers(-128, 128, (64, 16), dtype=np.int8))
    assert torch.equal(tdot.dot_int8_transpose(wi), tdot.dot_transpose_plain(wi))
    assert torch.equal(tdot.dot_int8_kmajor(xi, wi.T.contiguous()),
                       tdot.dot_plain(xi, wi, torch.int32, torch.int32))
    assert all(n == 0 for n in launch_counts.values()), launch_counts


def test_probe_wrappers_raise_on_other_devices():
    x = torch.empty((1, 8, 8, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tconv.conv3x3_gemm(x, torch.empty((3, 3, 64, 64), device="meta"))
    q = torch.empty((1, 1, 128, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tvpu.legacy_flash(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        t2q.flash_2q(q, q, q, bq=64)
    xi, wi = (torch.empty(s, dtype=torch.int8, device="meta") for s in ((8, 64), (64, 8)))
    with pytest.raises(ValueError, match="unsupported device"):
        tdot.make(8, 64, 8, torch.int8, torch.int32, torch.int32)(xi, wi)
    with pytest.raises(ValueError, match="unsupported device"):
        tdot.dot_splitk_reduce(torch.empty((2, 8, 8), device="meta"))


def test_library_names_hash_the_headers_too(tmp_path, monkeypatch):
    """A source's library name changes when a header it may include
    changes, so an edited header is never served from a stale build."""
    for name in os.listdir(_build.CSRC_DIR):
        (tmp_path / name).write_bytes((pathlib.Path(_build.CSRC_DIR) / name).read_bytes())
    (tmp_path / "helpers.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    before = _build._lib_path("flash_attention")
    assert before == _build._lib_path("flash_attention")
    with open(tmp_path / "helpers.cuh", "a") as f:
        f.write("\n// edited\n")
    assert _build._lib_path("flash_attention") != before


# -------------------------------------------------------------------- card --

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bf16_close(got, want):
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    assert np.abs(g - w).max() <= BF16_REL * np.abs(w).max()


@pytest.mark.gpu
@pytest.mark.parametrize("x_shape,co", [((2, 16, 16, 64), 128), ((1, 12, 20, 40), 72)])
def test_cuda_conv3x3_gemm_matches_plain(rng, x_shape, co):
    dev = _cuda_or_skip()
    ci = x_shape[-1]
    x = tt(rng.standard_normal(x_shape), torch.bfloat16).to(dev)
    k = tt(rng.standard_normal((3, 3, ci, co)) * (9 * ci) ** -0.5, torch.bfloat16).to(dev)
    bias = tt(rng.standard_normal(co)).to(dev)
    reset_launch_counts()
    got = tconv.conv3x3_gemm(x, k, bias)
    torch.cuda.synchronize()
    assert launch_counts["conv3x3_gemm"] == 1
    _bf16_close(got, tconv.conv3x3_gemm_plain(x, k, bias))


@pytest.mark.gpu
def test_cuda_conv2d_gemm_route_launches_kernel_e(rng):
    dev = _cuda_or_skip()
    x = tt(rng.standard_normal((1, 16, 16, 64)), torch.bfloat16).to(dev)
    k = tt(rng.standard_normal((3, 3, 64, 64)) * 0.04, torch.bfloat16).to(dev)
    reset_launch_counts()
    tconv2d(x, k, None, padding=1, impl="gemm")
    tconv2d(x, k, None, padding=1)
    torch.cuda.synchronize()
    assert {n: c for n, c in launch_counts.items() if c} == tconv.conv3x3_launches(
        "conv3x3_gemm", x.shape, 64)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,lk", [
    ((2, 8, 256, 40), 256), ((2, 4, 512, 64), 512), ((1, 2, 100, 64), 300),
    ((1, 2, 77, 80), 100), ((1, 2, 192, 160), 1000),
    # every padded depth 32..160 at a ragged Lk (the every-tile mask selects
    # columns in the last key tile), and Lq under one query tile
    ((1, 2, 10, 32), 77), ((1, 3, 200, 48), 129), ((1, 2, 70, 96), 257),
    ((1, 2, 130, 128), 65), ((2, 2, 33, 24), 1),
    # the 128-row plan (two row tiles per warp), ragged Lq and Lk
    ((2, 8, 2100, 48), 2047), ((2, 8, 4096, 40), 4000),
])
def test_cuda_legacy_flash_matches_plain(rng, shape, lk):
    dev = _cuda_or_skip()
    b, h, lq, d = shape
    q = tt(rng.normal(size=shape), torch.bfloat16).to(dev)
    k, v = (tt(rng.normal(size=(b, h, lk, d)), torch.bfloat16).to(dev) for _ in range(2))
    reset_launch_counts()
    got = tvpu.legacy_flash(q, k, v)
    torch.cuda.synchronize()
    assert launch_counts["flash_attention_legacy"] == 1
    assert sum(launch_counts.values()) == 1
    _bf16_close(got, tvpu.legacy_flash_plain(q, k, v))
    if lq >= 2048:
        assert plan_flash(b * h, lq, lk, d)[0] == 128


@pytest.mark.gpu
@pytest.mark.parametrize("nq,bq", t2q.CARD_VARIANTS)
@pytest.mark.parametrize("d,lk", [(40, 1000), (64, 256), (160, 100)])
def test_cuda_flash_2q_matches_plain(rng, nq, bq, d, lk):
    dev = _cuda_or_skip()
    lq = 2 * nq * bq
    q = tt(rng.normal(size=(2, 2, lq, d)), torch.bfloat16).to(dev)
    k, v = (tt(rng.normal(size=(2, 2, lk, d)), torch.bfloat16).to(dev) for _ in range(2))
    reset_launch_counts()
    got = t2q.flash_2q(q, k, v, bq=bq, nq=nq)
    torch.cuda.synchronize()
    assert {key: n for key, n in launch_counts.items() if n} == {"flash_attention_nq": 1}
    _bf16_close(got, t2q.flash_2q_plain(q, k, v, bq=bq, nq=nq))


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [
    (1024, 2560, 512), (4096, 640, 640),  # the probe's shapes: 4 K-splits; 160-wide tiles
    (100, 128, 48), (130, 192, 80),       # ragged M and N, one split
    (40, 96, 8),                          # a ragged last K step, one consumer's rows
    (130, 2560, 200), (333, 1024, 72),    # ragged M and N with K-splits
])
def test_cuda_dot_matches_plain(m, k, n):
    """J bf16 against its plain version, two calls bitwise equal (the
    split-K reduction adds in a fixed order), launches as ``dot_launches``
    says; J int8 bitwise."""
    _cuda_or_skip()
    x8, w8, x16, w16 = tdot.dot_inputs(m, k, n)
    f16 = tdot.make(m, k, n, torch.bfloat16, torch.float32, torch.bfloat16)
    reset_launch_counts()
    got = f16(x16, w16)
    torch.cuda.synchronize()
    assert {key: c for key, c in launch_counts.items() if c} == tdot.dot_launches(
        m, k, n, torch.bfloat16)
    _bf16_close(got, tdot.dot_plain(x16, w16, torch.float32, torch.bfloat16))
    assert torch.equal(f16(x16, w16), got)
    if tdot.plan_dot(m, k, n)[1] > 1:
        ws = torch.randn((tdot.plan_dot(m, k, n)[1], m, n), device="cuda")
        assert torch.equal(tdot.dot_splitk_reduce(ws), tdot.splitk_reduce_plain(ws))
    if k % 64 == 0 and n % 16 == 0:
        f8 = tdot.make(m, k, n, torch.int8, torch.int32, torch.int32)
        reset_launch_counts()
        assert torch.equal(f8(x8, w8), tdot.dot_plain(x8, w8, torch.int32, torch.int32))
        assert {key: c for key, c in launch_counts.items() if c} == tdot.dot_launches(
            m, k, n, torch.int8)


@pytest.mark.gpu
def test_cuda_probe_wrappers_raise_on_what_the_kernels_do_not_take():
    dev = _cuda_or_skip()
    x = torch.zeros((1, 8, 8, 12), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        tconv.conv3x3_gemm(x, torch.zeros((3, 3, 12, 8), device=dev, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        tconv.conv3x3_gemm(x.float()[..., :8], torch.zeros((3, 3, 8, 8), device=dev))
    q = torch.zeros((1, 1, 128, 256), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at most 160"):
        tvpu.legacy_flash(q, q, q)
    q = torch.zeros((1, 1, 384, 40), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="is not one of"):
        t2q.flash_2q(q, q, q, bq=128, nq=3)
    with pytest.raises(ValueError, match="multiple of 64"):
        tdot.make(64, 96, 64, torch.int8, torch.int32, torch.int32)(
            torch.zeros((64, 96), dtype=torch.int8, device=dev),
            torch.zeros((96, 64), dtype=torch.int8, device=dev))


@pytest.mark.gpu
def test_cuda_tool_launches_its_kernels_once_per_call():
    """A tool's main() on the card: the launch counters equal the calls it
    made of each wrapper."""
    _cuda_or_skip()
    reset_launch_counts()
    calls = tdot.main(["2"])
    torch.cuda.synchronize()
    assert {n: c for n, c in launch_counts.items() if c} == dict(calls)
    assert set(calls) == {"dot_bf16", "dot_bf16_splitk", "dot_int8", "dot_int8_transpose",
                          "dot_int8_splitk"}


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(1024, 2560, 512), (4096, 640, 640), (100, 640, 48),
                                   (130, 2560, 208)])
def test_cuda_dot_int8_pieces_match_plain(m, k, n):
    """J int8's pieces on the card, each bitwise against its plain version:
    the transpose (``dot_int8_transpose``), the GEMM on the K-major w
    (``dot_int8`` and, where the plan splits, ``dot_int8_splitk``), and the
    reduction alone on int32 partials."""
    _cuda_or_skip()
    x8, w8, _, _ = tdot.dot_inputs(m, k, n)
    reset_launch_counts()
    wt = tdot.dot_int8_transpose(w8)
    torch.cuda.synchronize()
    assert launch_counts["dot_int8_transpose"] == 1
    assert torch.equal(wt, tdot.dot_transpose_plain(w8))
    reset_launch_counts()
    got = tdot.dot_int8_kmajor(x8, wt)
    torch.cuda.synchronize()
    splits = tdot.plan_dot(m, k, n, True)[1]
    assert {key: c for key, c in launch_counts.items() if c} == (
        {"dot_int8": 1, "dot_int8_splitk": 1} if splits > 1 else {"dot_int8": 1})
    assert torch.equal(got, tdot.dot_plain(x8, w8, torch.int32, torch.int32))
    ws = tdot.dot_int8_split_plain(x8, w8, 3)
    assert torch.equal(tdot.dot_splitk_reduce(ws), tdot.dot_int8_reduce_plain(ws))
