"""The port's copy of ``jax.random`` (``sdtpu_torch/utils/prng.py``) and of
the JAX package's host-side init RNG (``sdtpu_torch/utils/hostrng.py``),
against the originals on the CPU.

Keys, splits, ``fold_in``, 32-bit bits and uniforms must be bitwise
``jax.random``'s.  Normals may differ where ``log1p`` rounds differently
from XLA's: tolerance 4 float32 ulp, which for |x| < 8 is at most 4e-6 and
in practice 4.8e-7 (abs <= 1e-6 is asserted besides).  The torch form of
the draws (run here on CPU tensors; on the card in ``chip_smoke.py`` and
the ``gpu`` test) must give the numpy form's bits and uniforms bitwise and
its normals within 4 ulp.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import sdtpu.utils.hostrng as jhostrng
from sdtpu_torch.utils import hostrng, prng

SEEDS = [0, 1, 40, 2**32 - 1]
SHAPES = [(3,), (7, 5), (1, 8, 8, 4), (2, 3, 5, 7)]
ULP = 4


def jkey(seed):
    return jax.random.key(np.uint32(seed))


def kdata(k):
    return np.asarray(jax.random.key_data(k))


def ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape and np.all(np.sign(a) == np.sign(b))
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_threefry_partitionable_is_the_mirrored_setting():
    assert jax.config.jax_threefry_partitionable is prng.THREEFRY_PARTITIONABLE


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bitwise(seed):
    k = prng.key(seed)
    np.testing.assert_array_equal(k, kdata(jkey(seed)))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(prng.split(k, num), kdata(jax.random.split(jkey(seed), num)))
    for data in (0, 1, 7, 2**32 - 1):
        np.testing.assert_array_equal(prng.fold_in(k, data),
                                      kdata(jax.random.fold_in(jkey(seed), data)))


def test_a_25_split_chain_bitwise():
    """The key chain of a 25-step request: ``key, sub = split(key)``."""
    k, jk = prng.key(40), jkey(40)
    for _ in range(25):
        k, sub = prng.split(k)
        jk, jsub = jax.random.split(jk)
        np.testing.assert_array_equal(sub, kdata(jsub))
    np.testing.assert_array_equal(k, kdata(jk))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_bitwise(seed, shape):
    k, jk = prng.key(seed), jkey(seed)
    np.testing.assert_array_equal(prng.random_bits(k, shape),
                                  np.asarray(jax.random.bits(jk, shape, jnp.uint32)))
    for lo, hi in ((0.0, 1.0), (-0.3, 2.5)):
        got = prng.uniform(k, shape, lo, hi)
        want = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, hi))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_normal_within_4_ulp(seed, shape):
    got = prng.normal(prng.key(seed), shape)
    want = np.asarray(jax.random.normal(jkey(seed), shape, jnp.float32))
    assert got.dtype == np.float32
    assert ulps(got, want).max() <= ULP
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_normal_within_4_ulp_at_the_image_shape():
    """A 512-px image's draw, split from seed 40 as the pipeline does."""
    k = prng.split(prng.key(40))[1]
    jk = jax.random.split(jkey(40))[1]
    got = prng.normal(k, (1, 64, 64, 4))
    want = np.asarray(jax.random.normal(jk, (1, 64, 64, 4), jnp.float32))
    assert ulps(got, want).max() <= ULP


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_draws_match_numpy(seed):
    """The batched torch form, on CPU tensors, against the numpy form."""
    keys = prng.split(prng.key(seed), 3)
    shape = (1, 8, 8, 4)
    bits = prng.bits_torch(keys, shape, "cpu")
    u = prng.uniform_torch(keys, shape, "cpu")
    n = prng.normal_torch(keys, shape, "cpu")
    assert bits.shape == u.shape == n.shape == (3, *shape) and n.dtype == torch.float32
    for i, k in enumerate(keys):
        np.testing.assert_array_equal(bits[i].numpy(), prng.random_bits(k, shape))
        np.testing.assert_array_equal(u[i].numpy().view(np.uint32),
                                      prng.uniform(k, shape).view(np.uint32))
        assert ulps(n[i].numpy(), prng.normal(k, shape)).max() <= ULP


@pytest.mark.parametrize("seed", [-1, 2**32, 2**40])
def test_seed_outside_uint32_raises(seed):
    with pytest.raises(OverflowError, match="uint32"):
        prng.key(seed)


def test_erf_inv_is_the_inverse_of_erf():
    x = np.linspace(-0.999, 0.999, 2001, dtype=np.float32)
    from math import erf

    back = np.array([erf(float(v)) for v in prng.erf_inv(x)])
    np.testing.assert_allclose(back, x, rtol=0, atol=2e-6)


# --------------------------------------------------------------- hostrng --

@pytest.mark.parametrize("seed", [0, 3])
def test_hostrng_draws_equal_the_jax_packages(seed):
    """The port's hostrng (numpy branch) against ``sdtpu/utils/hostrng.py``:
    the same children and the same float64 draws, bitwise."""
    k, jk = hostrng.key(seed), jhostrng.key(seed)
    for (a, b) in zip(hostrng.split(k, 4), jhostrng.split(jk, 4)):
        assert a.ss.spawn_key == b.ss.spawn_key and a.ss.entropy == b.ss.entropy
        np.testing.assert_array_equal(hostrng.uniform(a, (5, 3), -0.2, 0.2),
                                      jhostrng.uniform(b, (5, 3), np.float64, -0.2, 0.2))
        np.testing.assert_array_equal(hostrng.normal(a, (4,)),
                                      jhostrng.normal(b, (4,), np.float64))


def test_hostrng_leaf_rounds_as_the_jax_package():
    """float64 -> float32 -> bf16 equals ml_dtypes' cast of the draws, and
    float32 equals numpy's astype."""
    k = hostrng.key(1)
    draws = hostrng.normal(k, (100_000,))
    np.testing.assert_array_equal(hostrng.leaf(draws, torch.bfloat16).view(torch.int16).numpy(),
                                  draws.astype(ml_dtypes.bfloat16).view(np.int16))
    np.testing.assert_array_equal(hostrng.leaf(draws).numpy(), draws.astype(np.float32))


def test_hostrng_shapes_only_draws_nothing():
    with hostrng.shapes_only():
        t = hostrng.leaf(hostrng.uniform(hostrng.key(0), (1000, 1000)), torch.bfloat16)
    assert t.device.type == "meta" and t.shape == (1000, 1000) and t.dtype == torch.bfloat16
    assert hostrng.leaf(hostrng.uniform(hostrng.key(0), (2,))).device.type == "cpu"


# ------------------------------------------------------------------ card --

@pytest.mark.gpu
def test_cuda_draws_match_numpy():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for seed in (0, 40, 2**32 - 1):
        keys = prng.split(prng.key(seed), 26)
        shape = (1, 64, 64, 4)
        bits = prng.bits_torch(keys, shape, "cuda").cpu()
        u = prng.uniform_torch(keys, shape, "cuda").cpu()
        n = prng.normal_torch(keys, shape, "cuda").cpu()
        for i, k in enumerate(keys):
            np.testing.assert_array_equal(bits[i].numpy(), prng.random_bits(k, shape))
            np.testing.assert_array_equal(u[i].numpy(), prng.uniform(k, shape))
            assert ulps(n[i].numpy(), prng.normal(k, shape)).max() <= ULP


def test_normal_graphs_refuse_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        prng.NormalGraphs()(prng.split(prng.key(0), 2), (4,), "cpu")


@pytest.mark.gpu
def test_cuda_graph_replay_equals_the_eager_draw():
    """The replayed draw equals ``normal_torch`` bitwise, and a later call
    does not overwrite an earlier result."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    graphs = prng.NormalGraphs()
    shape = (1, 64, 64, 4)
    k1, k2 = prng.split(prng.key(1), 26), prng.split(prng.key(2), 26)
    a = graphs(k1, shape, "cuda")
    b = graphs(k2, shape, "cuda")
    assert torch.equal(a, prng.normal_torch(k1, shape, "cuda"))
    assert torch.equal(b, prng.normal_torch(k2, shape, "cuda"))
    assert not torch.equal(a, b)
