"""The transformer block's row passes (``sdtpu_torch/kernels/rowwise.py``):
LayerNorm and the feed-forward's bias + GeGLU.

On the CPU the wrappers run their plain versions, which must be the eager
code they replaced: ``layer_norm`` and ``geglu(linear(...))`` as they were
are written out below, and everything that now calls the wrappers
(``layer_norm``, ``transformer_block``, ``unet_forward``) is held to them
bitwise.  The ``gpu`` cases hold the CUDA kernels to the plain versions on
the card at the main paths' shapes; they skip on a machine without one.
"""

import importlib

import numpy as np
import pytest
import torch

import sdtpu_torch.models.unet as tunet
from sdtpu_torch.config import UNetConfig
from sdtpu_torch.kernels import launch_counts, reset_launch_counts
from sdtpu_torch.kernels import rowwise
from sdtpu_torch.ops.activations import geglu, gelu_erf
from sdtpu_torch.ops.linear import init_linear, linear, linear_parts, linear_q8, linear_q8_dyn
from sdtpu_torch.ops.norm import layer_norm
from sdtpu_torch.utils import hostrng
from sdtpu_torch.utils.quant import _quantize_linear, _quantize_linear_dyn, act_qparams_from_ln

# the package re-exports a function named ``attention`` over its submodule
tattn = importlib.import_module("sdtpu_torch.ops.attention")
torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16]


# -------------------------------------------- the eager code, as it was --

def eager_layer_norm(x, params, *, eps=1e-5):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    out = xf * params["scale"].float() + params["bias"].float()
    return out.to(x.dtype)


def eager_geglu(x):
    value, gate = torch.chunk(x, 2, dim=-1)
    return value * gelu_erf(gate)


def eager_linear(x, params):
    if "kernel_q" in params:
        return linear_q8(x, params) if "act_scale" in params else linear_q8_dyn(x, params)
    out = torch.matmul(x, params["kernel"].to(x.dtype))
    bias = params.get("bias")
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def eager_transformer_block(x, params, *, num_heads, context, implementation="dense",
                            cross_kv=None, pag_tail=0):
    h = eager_layer_norm(x, params["norm1"])
    if pag_tail:
        ident = linear(linear(h[-pag_tail:], params["attn1"]["v"]), params["attn1"]["out"])
        head = tattn.attention(h[:-pag_tail], params["attn1"], num_heads=num_heads,
                               implementation=implementation, residual=x[:-pag_tail])
        x = torch.cat([head, x[-pag_tail:] + ident])
    else:
        x = tattn.attention(h, params["attn1"], num_heads=num_heads,
                            implementation=implementation, residual=x)
    h = eager_layer_norm(x, params["norm2"])
    x = tattn.attention(h, params["attn2"], num_heads=num_heads, context=context,
                        implementation=implementation, kv_cache=cross_kv, residual=x)
    h = eager_layer_norm(x, params["norm3"])
    h = eager_geglu(eager_linear(h, params["ff"]["proj"]))
    return x + linear(h, params["ff"]["out"])


# ------------------------------------------------------------- helpers --

def _t(rng, shape, dtype, scale=1.0, shift=0.0):
    return torch.from_numpy((rng.normal(size=shape) * scale + shift).astype(np.float32)).to(dtype)


def _norm(rng, c, dtype):
    return {"scale": _t(rng, (c,), dtype, 0.2, 1.0), "bias": _t(rng, (c,), dtype, 0.2)}


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b), float((a.float() - b.float()).abs().max())


def _block(rng, c, ctx_dim, dtype):
    key = hostrng.ensure_key(int(rng.integers(1 << 30)))
    params = tattn.init_transformer_block(key, c, context_dim=ctx_dim)
    params = {k: {kk: {n: t.to(dtype) for n, t in vv.items()} if isinstance(vv, dict)
                  else vv.to(dtype) for kk, vv in v.items()} for k, v in params.items()}
    for name in ("norm1", "norm2", "norm3"):  # a non-trivial affine
        params[name] = _norm(rng, c, dtype)
    return params


# --------------------------------------------------------------- tests --

@pytest.mark.parametrize("pdtype", DTYPES, ids=["p32", "pbf16"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_layer_norm_is_the_eager_code(rng, dtype, pdtype):
    x = _t(rng, (2, 7, 24), dtype, 2.0, 0.5)
    p = _norm(rng, 24, pdtype)
    for eps in (1e-5, 1e-6):
        _same(layer_norm(x, p, eps=eps), eager_layer_norm(x, p, eps=eps))
        _same(rowwise.layer_norm_rows(x, p["scale"], p["bias"], eps),
              eager_layer_norm(x, p, eps=eps))


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_geglu_is_the_eager_code(rng, dtype, bias):
    proj = init_linear(hostrng.ensure_key(3), 16, 64, use_bias=bias)
    proj = {k: v.to(dtype) for k, v in proj.items()}
    h = _t(rng, (2, 5, 16), dtype, 1.5)
    want = eager_geglu(eager_linear(h, proj))
    _same(rowwise.geglu_rows(*linear_parts(h, proj)), want)
    _same(geglu(linear(h, proj)), want)
    _same(rowwise.geglu_rows_plain(torch.matmul(h, proj["kernel"]), proj.get("bias")), want)


@pytest.mark.parametrize("form", ["static", "dynamic"])
def test_geglu_on_the_int8_projection(rng, form):
    """``linear_q8`` and ``linear_q8_dyn`` add their own bias:
    ``linear_parts`` hands back their output and no bias, and the gate is
    the eager one on it."""
    proj = init_linear(hostrng.ensure_key(4), 16, 64)
    if form == "static":
        proj_q = _quantize_linear(proj, *act_qparams_from_ln(_norm(rng, 16, torch.float32)))
    else:
        proj_q = _quantize_linear_dyn(proj)
    h = _t(rng, (3, 16), torch.bfloat16, 1.5)
    out, bias = linear_parts(h, proj_q)
    assert bias is None
    _same(rowwise.geglu_rows(out, bias), eager_geglu(eager_linear(h, proj_q)))


@pytest.mark.parametrize("pag_tail", [0, 1])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_transformer_block_is_unchanged(rng, dtype, pag_tail):
    params = _block(rng, 16, 12, dtype)
    x = _t(rng, (3, 10, 16), dtype)
    ctx = _t(rng, (3, 6, 12), dtype)
    for impl in ("dense", "flash"):
        _same(tattn.transformer_block(x, params, num_heads=2, context=ctx, implementation=impl,
                                      pag_tail=pag_tail),
              eager_transformer_block(x, params, num_heads=2, context=ctx,
                                      implementation=impl, pag_tail=pag_tail))


def test_unet_forward_is_unchanged(rng, monkeypatch):
    cfg = UNetConfig(block_out_channels=(16, 24), layers_per_block=1,
                     attention_levels=(True, True), num_attention_heads=2,
                     cross_attention_dim=24, norm_num_groups=8)
    params = tunet.init_unet(0, cfg)
    params = {k: v for k, v in params.items()}
    x = _t(rng, (2, 8, 8, 4), torch.float32)
    ctx = _t(rng, (2, 6, 24), torch.float32)
    t = torch.tensor([3.0, 500.0])
    got = tunet.unet_forward(x, t, ctx, params, cfg)
    monkeypatch.setattr(tunet, "transformer_block", eager_transformer_block)
    _same(got, tunet.unet_forward(x, t, ctx, params, cfg))


def test_cpu_calls_launch_nothing(rng):
    reset_launch_counts()
    x = _t(rng, (4, 16), torch.bfloat16)
    rowwise.layer_norm_rows(x, torch.ones(16), torch.zeros(16))
    rowwise.geglu_rows(x, torch.zeros(16))
    rowwise.geglu_rows(x)
    layer_norm(x, _norm(rng, 16, torch.float32))
    assert launch_counts["layer_norm_rows"] == 0 and launch_counts["geglu_rows"] == 0
    assert not any(launch_counts.values())


def test_wrappers_raise_on_other_devices():
    x = torch.empty((2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rowwise.layer_norm_rows(x, x[0], x[0])
    with pytest.raises(ValueError, match="unsupported device"):
        rowwise.geglu_rows(x)


# ----------------------------------------------------------- the card --

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _row_ulps(got, want):
    """max |got - want| in ulps of their dtype at the largest |want| of
    its row"""
    bits = 7 if got.dtype == torch.bfloat16 else 23
    top = want.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
    return float(((got.float() - want.float()).abs()
                  / torch.exp2(torch.floor(torch.log2(top)) - bits)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,pdtype", [
    ((65536, 320), torch.bfloat16, torch.bfloat16),   # tiny-sd's 64x64 level, 16 rows
    ((4096, 1280), torch.bfloat16, torch.bfloat16),
    ((2048, 1280), torch.bfloat16, torch.float32),
    ((2048, 1536), torch.bfloat16, torch.bfloat16),   # the SDXL refiner's deepest level
    ((154, 768), torch.bfloat16, torch.bfloat16),     # CLIP-L, cond + uncond
    ((154, 1280), torch.float32, torch.float32),      # bigG in float32
    ((5, 8), torch.float32, torch.bfloat16),
])
def test_cuda_layer_norm_rows_matches_plain(rng, shape, dtype, pdtype):
    """Within 1 bf16 (8 float32) ulps at the row's largest value: the row
    sums behind the mean and the variance run in another order than
    PyTorch's reductions, which moves the normalised row by a float32
    rounding, and an output that cancels against the bias cannot be held
    to its own ulp; every later step rounds as the eager ops round."""
    dev = _cuda_or_skip()
    x = _t(rng, shape, dtype, 2.0, 0.5).to(dev)
    p = {k: v.to(dev) for k, v in _norm(rng, shape[1], pdtype).items()}
    reset_launch_counts()
    got = rowwise.layer_norm_rows(x, p["scale"], p["bias"], 1e-5)
    torch.cuda.synchronize()
    assert launch_counts["layer_norm_rows"] == 1
    want = rowwise.layer_norm_rows_plain(x, p["scale"], p["bias"], 1e-5)
    assert _row_ulps(got, want) <= (1 if dtype == torch.bfloat16 else 8)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,bdtype", [
    ((65536, 2560), torch.bfloat16, torch.bfloat16),  # tiny-sd's 64x64 level, 16 rows
    ((2048, 10240), torch.bfloat16, torch.bfloat16),  # SDXL's 32x32 level, 2 rows
    ((4096, 10240), torch.bfloat16, None),            # an int8 projection's output
    ((300, 5120), torch.float32, torch.bfloat16),
])
def test_cuda_geglu_rows_matches_plain(rng, shape, dtype, bdtype):
    """Bitwise: every rounding of the eager chain is repeated, the erf is
    the same ``erff``."""
    dev = _cuda_or_skip()
    h = _t(rng, shape, dtype, 1.5).to(dev)
    b = None if bdtype is None else _t(rng, (shape[1],), bdtype, 0.3).to(dev)
    reset_launch_counts()
    got = rowwise.geglu_rows(h, b)
    torch.cuda.synchronize()
    assert launch_counts["geglu_rows"] == 1
    assert torch.equal(got, rowwise.geglu_rows_plain(h, b))
