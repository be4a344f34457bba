"""The PyTorch port's ops (``sdtpu_torch.ops``) against their ``sdtpu.ops``
counterparts on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  In
float32 the two must agree to about 1e-5: they compute the same function
with the same float32 islands, and differ only in summation order.  The
helpers here (numpy/torch conversion, config and parameter mapping) are
shared with the other ``test_torch_*`` files.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdtpu.config as jcfg
import sdtpu.ops as jops
import sdtpu_torch.config as tcfg
import sdtpu_torch.ops as tops
from sdtpu.ops.attention import precompute_transformer_cross_kv
from sdtpu_torch.utils.weights import params_from_numpy

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-5)

_DTYPES = {
    jnp.dtype(jnp.float32): torch.float32,
    jnp.dtype(jnp.bfloat16): torch.bfloat16,
    jnp.dtype(jnp.float16): torch.float16,
}


def tt(a, dtype=torch.float32):
    """numpy -> CPU tensor."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def nn(x):
    """torch or jax array -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want, **tol):
    np.testing.assert_allclose(nn(got), nn(want), **(tol or F32_TOL))


def port_value(v):
    if dataclasses.is_dataclass(v):
        return port_config(v)
    if isinstance(v, (type, np.dtype)) or type(v).__name__ == "_ScalarMeta":
        return _DTYPES[jnp.dtype(v)]
    return v


def port_config(cfg):
    """A ``sdtpu.config`` dataclass -> the same ``sdtpu_torch.config`` one,
    field by field, with torch dtypes."""
    cls = getattr(tcfg, type(cfg).__name__)
    return cls(**{f.name: port_value(getattr(cfg, f.name))
                  for f in dataclasses.fields(cfg)})


def port_params(tree):
    """A JAX parameter tree -> the port's tree on the CPU."""
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


# ---------------------------------------------------------------- config --

@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_presets_match_field_by_field(name):
    want = port_config(jcfg.get_preset(name))
    got = tcfg.get_preset(name)
    assert got == want
    assert got.unet.time_embed_dim == want.unet.time_embed_dim
    assert got.vae.downscale_factor == want.vae.downscale_factor


@pytest.mark.parametrize("get_preset", [jcfg.get_preset, tcfg.get_preset])
def test_unknown_preset_raises(get_preset):
    with pytest.raises(ValueError, match="unknown preset"):
        get_preset("no-such-model")


# ----------------------------------------------------------- elementwise --

@pytest.mark.parametrize("name", ["silu", "gelu_tanh", "gelu_erf", "quick_gelu", "geglu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_activations(rng, name, dtype):
    x = rng.normal(size=(2, 5, 16)).astype(np.float32) * 3
    got = getattr(tops, name)(tt(x, dtype))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = getattr(jops, name)(jnp.asarray(x, jdt))
    assert got.dtype == dtype
    if dtype == torch.float32:
        close(got, want)
    else:  # one bf16 rounding step apart at most
        close(got, want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("bias", [True, False])
def test_linear(rng, bias):
    x = rng.normal(size=(2, 7, 12)).astype(np.float32)
    p = {"kernel": rng.normal(size=(12, 20)).astype(np.float32)}
    if bias:
        p["bias"] = rng.normal(size=(20,)).astype(np.float32)
    close(tops.linear(tt(x), port_params(p)), jops.linear(jnp.asarray(x), p))


def test_embedding_lookup(rng):
    table = {"weight": rng.normal(size=(50, 8)).astype(np.float32)}
    ids = rng.integers(0, 50, (3, 9)).astype(np.int32)
    got = tops.embedding_lookup(torch.from_numpy(ids), port_params(table))
    close(got, jops.embedding_lookup(jnp.asarray(ids), table))


@pytest.mark.parametrize("flip,shift", [(True, 0.0), (False, 1.0)])
def test_timestep_embedding(flip, shift):
    ts = np.array([0.0, 1.0, 501.0, 999.0], np.float32)
    got = tops.timestep_embedding(torch.from_numpy(ts), 32, flip_sin_to_cos=flip,
                                  freq_shift=shift)
    want = jops.timestep_embedding(jnp.asarray(ts), 32, flip_sin_to_cos=flip,
                                   freq_shift=shift)
    close(got, want, rtol=1e-5, atol=1e-4)  # sin/cos of args up to ~1e3


def test_nearest_upsample(rng):
    from sdtpu.ops.resize import nearest_upsample

    x = rng.normal(size=(2, 3, 5, 4)).astype(np.float32)
    got = tops.nearest_upsample(tt(x))
    np.testing.assert_array_equal(nn(got), np.asarray(nearest_upsample(jnp.asarray(x))))


# ----------------------------------------------------------------- norms --

@pytest.mark.parametrize("shape", [(2, 6, 5, 16), (2, 11, 16)])
@pytest.mark.parametrize("with_stats", [False, True])
def test_group_norm(rng, shape, with_stats):
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    p = {"scale": rng.normal(size=(16,)).astype(np.float32),
         "bias": rng.normal(size=(16,)).astype(np.float32)}
    stats = None
    if with_stats:
        axes = tuple(range(1, x.ndim - 1))
        stats = np.stack([x.mean(axis=axes), (x * x).mean(axis=axes)], axis=1)
    got = tops.group_norm(tt(x), port_params(p), num_groups=4, eps=1e-6,
                          stats=None if stats is None else tt(stats))
    want = jops.group_norm(jnp.asarray(x), p, num_groups=4, eps=1e-6,
                           stats=None if stats is None else jnp.asarray(stats))
    close(got, want, rtol=1e-5, atol=2e-5)


def test_group_norm_stats_variance_clamp():
    """Producer moments whose E[x^2] - mean^2 is negative (rounding in the
    producer) give variance 0, not NaN, in both packages."""
    x = np.full((1, 2, 2, 4), 3.0, np.float32)
    stats = np.stack([np.full((1, 4), 3.0), np.full((1, 4), 8.99)], axis=1).astype(np.float32)
    p = {"scale": np.ones(4, np.float32), "bias": np.zeros(4, np.float32)}
    got = tops.group_norm(tt(x), port_params(p), num_groups=2, stats=tt(stats))
    want = jops.group_norm(jnp.asarray(x), p, num_groups=2, stats=jnp.asarray(stats))
    assert np.isfinite(nn(got)).all()
    close(got, want)


def test_layer_norm(rng):
    x = (rng.normal(size=(2, 9, 24)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.normal(size=(24,)).astype(np.float32),
         "bias": rng.normal(size=(24,)).astype(np.float32)}
    got = tops.layer_norm(tt(x), port_params(p), eps=1e-5)
    close(got, jops.layer_norm(jnp.asarray(x), p, eps=1e-5, stats="reduce"))


# ----------------------------------------------------------------- convs --

@pytest.mark.parametrize("k,stride,padding", [
    (3, 1, 1),
    (3, 2, 1),                  # the UNet's downsample
    (3, 2, ((0, 1), (0, 1))),   # the VAE encoder's asymmetric downsample pad
    (1, 1, 0),                  # the VAE's post-quant conv
])
def test_conv2d(rng, k, stride, padding):
    x = rng.normal(size=(2, 9, 8, 6)).astype(np.float32)
    w = (rng.normal(size=(k, k, 6, 10)) * 0.3).astype(np.float32)
    b = rng.normal(size=(10,)).astype(np.float32)
    got = tops.conv2d(tt(x), tt(w), tt(b), stride=stride, padding=padding)
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                       stride=stride, padding=padding)
    assert tuple(got.shape) == want.shape
    close(got, want)


def test_conv1x1_tokens(rng):
    x = rng.normal(size=(2, 4, 5, 6)).astype(np.float32)
    p = {"kernel": rng.normal(size=(1, 1, 6, 3)).astype(np.float32),
         "bias": rng.normal(size=(3,)).astype(np.float32)}
    close(tops.conv1x1_tokens(tt(x), port_params(p)),
          jops.conv.conv1x1_tokens(jnp.asarray(x), p))


@pytest.mark.parametrize("emit_stats", [False, True])
def test_nearest_up_conv2d(rng, emit_stats):
    """A shape the slab rule refuses (Ci < 64): upsample then conv2d, as the
    JAX package routes it, with no moments under ``emit_stats``."""
    x = rng.normal(size=(2, 4, 6, 16)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 16, 8)) * 0.2).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    got = tops.nearest_up_conv2d(tt(x), tt(w), tt(b), emit_stats=emit_stats)
    want = jops.conv.nearest_up_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                       impl="gemm", emit_stats=emit_stats)
    if emit_stats:
        (got, st), (want, want_st) = got, want
        assert st is None and want_st is None
    close(got, want)


@pytest.mark.parametrize("emit_stats", [False, True])
def test_nearest_up_conv2d_fused(rng, emit_stats):
    """A shape the slab rule accepts: the fused upsample + conv (the slab
    kernel's plain version on the CPU) against the JAX package's XLA route,
    upsample then conv, and its moments against the output's."""
    x = rng.normal(size=(1, 4, 4, 64)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 64, 64)) * 0.05).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    got = tops.nearest_up_conv2d(tt(x), tt(w), tt(b), emit_stats=emit_stats)
    want = jops.conv.nearest_up_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    if emit_stats:
        got, st = got
        o = nn(want)
        close(st, np.stack([o.mean(axis=(1, 2)), (o * o).mean(axis=(1, 2))], axis=1))
    close(got, want)


# ------------------------------------------------------------- attention --

def _attn_params(rng, dim, ctx_dim, bias):
    def lin(i, o):
        p = {"kernel": (rng.normal(size=(i, o)) * i ** -0.5).astype(np.float32)}
        if bias:
            p["bias"] = (rng.normal(size=(o,)) * 0.1).astype(np.float32)
        return p
    return {"q": lin(dim, dim), "k": lin(ctx_dim, dim), "v": lin(ctx_dim, dim),
            "out": lin(dim, dim)}


@pytest.mark.parametrize("case", ["self", "cross", "causal", "kv_cache", "flash"])
@pytest.mark.parametrize("residual", [False, True])
def test_attention(rng, case, residual):
    """Dense attention in every form the slice uses, and the flash route
    (the flash kernel's plain version on the CPU) against the JAX package's
    dense attention, which computes the same function."""
    b, lq, lk, dim, heads = 2, 12, 7, 16, 2
    ctx_dim = 24 if case in ("cross", "kv_cache") else dim
    p = _attn_params(rng, dim, ctx_dim, bias=case != "kv_cache")
    x = rng.normal(size=(b, lq, dim)).astype(np.float32)
    ctx = rng.normal(size=(b, lk, ctx_dim)).astype(np.float32)
    res = rng.normal(size=(b, lq, dim)).astype(np.float32) if residual else None
    tp = port_params(p)
    kw_t, kw_j = {}, {}
    if case in ("cross", "kv_cache"):
        kw_t["context"], kw_j["context"] = tt(ctx), jnp.asarray(ctx)
    if case == "kv_cache":
        kv = {"k": ctx @ p["k"]["kernel"], "v": ctx @ p["v"]["kernel"]}
        kw_t["kv_cache"], kw_j["kv_cache"] = port_params(kv), kv
    if case == "causal":
        kw_t["causal"] = kw_j["causal"] = True
    if case == "flash":
        kw_t["implementation"] = "flash"
    got = tops.attention(tt(x), tp, num_heads=heads,
                         residual=None if res is None else tt(res), **kw_t)
    want = jops.attention(jnp.asarray(x), p, num_heads=heads,
                          residual=None if res is None else jnp.asarray(res), **kw_j)
    close(got, want)


def test_attention_rejects_unknown_implementation(rng):
    """("xla" became the dense route, ``test_attention_xla_route_is_dense``.)"""
    p = port_params(_attn_params(rng, 8, 8, bias=True))
    with pytest.raises(ValueError):
        tops.attention(torch.zeros(1, 3, 8), p, num_heads=2, implementation="pallas")


@pytest.mark.parametrize("cross", [False, True])
def test_attention_xla_route_is_dense(rng, cross):
    """On the CPU ``implementation="xla"`` computes what the JAX package's
    ``xla`` route does: dense attention, self or cross."""
    jp = _attn_params(rng, 16, 8 if cross else 16, bias=True)
    x = rng.normal(size=(2, 12, 16)).astype(np.float32)
    ctx = rng.normal(size=(2, 5, 8)).astype(np.float32) if cross else None
    got = tops.attention(tt(x), port_params(jp), num_heads=2, implementation="xla",
                         context=None if ctx is None else tt(ctx))
    want = jops.attention(jnp.asarray(x), jp, num_heads=2, implementation="xla",
                          context=None if ctx is None else jnp.asarray(ctx))
    close(got, want)


def _block_params(rng, dim, ctx_dim):
    def lin(i, o, bias=True):
        p = {"kernel": (rng.normal(size=(i, o)) * i ** -0.5).astype(np.float32)}
        if bias:
            p["bias"] = (rng.normal(size=(o,)) * 0.1).astype(np.float32)
        return p

    def ln():
        return {"scale": (1 + 0.1 * rng.normal(size=(dim,))).astype(np.float32),
                "bias": (0.1 * rng.normal(size=(dim,))).astype(np.float32)}

    def attn(c):
        return {"q": lin(dim, dim, False), "k": lin(c, dim, False),
                "v": lin(c, dim, False), "out": lin(dim, dim)}

    return {"norm1": ln(), "attn1": attn(dim), "norm2": ln(), "attn2": attn(ctx_dim),
            "norm3": ln(), "ff": {"proj": lin(dim, 8 * dim), "out": lin(4 * dim, dim)}}


@pytest.mark.parametrize("implementation", ["dense", "flash"])
@pytest.mark.parametrize("hoisted_kv", [False, True])
def test_transformer_block(rng, implementation, hoisted_kv):
    dim, ctx_dim = 16, 12
    p = _block_params(rng, dim, ctx_dim)
    x = rng.normal(size=(2, 10, dim)).astype(np.float32)
    ctx = rng.normal(size=(2, 5, ctx_dim)).astype(np.float32)
    tp = port_params(p)
    cross_kv = tops.precompute_transformer_cross_kv(tt(ctx), tp) if hoisted_kv else None
    got = tops.transformer_block(tt(x), tp, num_heads=2, context=tt(ctx),
                                 implementation=implementation, cross_kv=cross_kv)
    want = jops.transformer_block(jnp.asarray(x), p, num_heads=2, context=jnp.asarray(ctx))
    close(got, want)


def test_precompute_transformer_cross_kv(rng):
    p = _block_params(rng, 16, 12)
    ctx = rng.normal(size=(2, 5, 12)).astype(np.float32)
    got = tops.precompute_transformer_cross_kv(tt(ctx), port_params(p))
    want = precompute_transformer_cross_kv(jnp.asarray(ctx), p)
    for name in ("k", "v"):
        close(got[name], want[name])


# ----------------------------------------------------------------- image --

@pytest.mark.parametrize("as_tensor", [False, True])
def test_to_uint8_and_back(rng, as_tensor):
    from sdtpu.utils.image import from_uint8, to_uint8
    from sdtpu_torch.utils import image as timage

    img = np.concatenate([rng.uniform(-1.2, 1.2, (1, 4, 4, 3)),
                          np.full((1, 1, 4, 3), 0.5 / 127.5 - 1.0)], axis=1).astype(np.float32)
    got = timage.to_uint8(tt(img) if as_tensor else img)
    assert isinstance(got, torch.Tensor) == as_tensor
    got = got.numpy() if as_tensor else got
    np.testing.assert_array_equal(got, to_uint8(img))
    np.testing.assert_array_equal(timage.from_uint8(got), from_uint8(got))
