"""The part of ``jax.random`` that the pipeline draws from, without jax.

The JAX package derives a request's initial latents and its per-step noise
from ``jax.random.key(seed)`` (``sdtpu/pipeline/pipeline.py:1902-1915,
2062-2066, 1777-1778``).  This module reproduces those bits: threefry-2x32
(20 rounds) keys, ``split`` and ``fold_in``, 32-bit ``random_bits`` over
counters laid out as jax lays them out with ``jax_threefry_partitionable``
on (its default since jax 0.5), and the float32 ``uniform`` and ``normal``
transforms (``jax/_src/prng.py``, ``jax/_src/random.py``).

A key is a (2,) uint32 numpy array, as jax's raw keys are.  Key
derivation runs on the host in Python integers (a few microseconds a
split).  The draws have two forms:

- numpy (``random_bits``, ``uniform``, ``normal``): the CPU path and the
  reference;
- torch (``bits_torch``, ``uniform_torch``, ``normal_torch``): the same
  integer and float operations on the tensors of any device, for many keys
  in one batched call, so that a request's draws run on the card with no
  host round trip.  Integers are int64 tensors holding 32-bit words.
  ``NormalGraphs`` replays ``normal_torch`` as a CUDA graph, so that its
  ~220 ops cost the host one launch.

Bits and uniforms are bitwise jax's.  ``normal`` uses the single-precision
inverse-error-function polynomial of M. Giles ("Approximating the erfinv
function", GPU Computing Gems, 2011), the one XLA expands ``erf_inv`` to
in float32; its values are within a few float32 ulp of jax's (``log1p``
and ``sqrt`` may round differently on another device or library).
"""

from __future__ import annotations

import math
import operator

import numpy as np

# the ``jax_threefry_partitionable`` setting whose bit layout this module
# reproduces: counters are the flattened index as (hi, lo) 32-bit words and
# 32-bit bits are the xor of threefry's two outputs
THREEFRY_PARTITIONABLE = True

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# erf_inv's polynomial in w = -log1p(-x^2), split at w = 5 (Giles 2011)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))  # uniform's low end
_SQRT2 = float(np.float32(math.sqrt(2.0)))


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32, 20 rounds, on 32-bit words held as Python ints,
    numpy uint32 arrays or torch int64 tensors (values in [0, 2^32));
    every sum is reduced mod 2^32, so a shift right is logical."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.key(np.uint32(seed))``'s data: ``[0, seed]``.  A seed
    outside [0, 2^32) raises, as ``jnp.asarray(seed, jnp.uint32)`` does."""
    seed = operator.index(seed)
    if not 0 <= seed <= _M32:
        raise OverflowError(f"seed {seed} is outside the uint32 range [0, 2**32)")
    return np.array([0, seed], np.uint32)


def _words(k) -> tuple:
    k = np.asarray(k)
    if k.shape != (2,) or k.dtype != np.uint32:
        raise TypeError(f"a key is a (2,) uint32 array, got {k.shape} {k.dtype}")
    return int(k[0]), int(k[1])


def split(k, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)``: (num, 2) uint32, child i hashing the
    counter (0, i)."""
    k1, k2 = _words(k)
    return np.array([threefry2x32(k1, k2, 0, i) for i in range(num)], np.uint32).reshape(num, 2)


def fold_in(k, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)``: the hash of the counter (0, data)."""
    k1, k2 = _words(k)
    data = operator.index(data) & _M32
    return np.array(threefry2x32(k1, k2, 0, data), np.uint32)


def random_bits(k, shape) -> np.ndarray:
    """``jax.random.bits(k, shape, jnp.uint32)``: uint32 of ``shape``."""
    k1, k2 = _words(k)
    shape = tuple(shape)
    n = math.prod(shape)
    counts = np.arange(n, dtype=np.uint64)
    hi = (counts >> np.uint64(32)).astype(np.uint32)
    lo = (counts & np.uint64(_M32)).astype(np.uint32)
    b1, b2 = threefry2x32(np.uint32(k1), np.uint32(k2), hi, lo)
    return (b1 ^ b2).reshape(shape)


def _unit_float(bits):
    """23 mantissa bits under exponent 0, minus 1: floats in [0, 1)."""
    return ((bits >> 9) | 0x3F800000).view(np.float32) - np.float32(1.0)


def uniform(k, shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(k, shape, jnp.float32, minval, maxval)``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    floats = _unit_float(random_bits(k, shape))
    return np.maximum(lo, floats * (hi - lo) + lo)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """float32 inverse error function on (-1, 1), Giles' polynomial."""
    x = np.asarray(x, np.float32)
    w = -np.log1p(x * -x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = np.where(lt, np.float32(a), np.float32(b)) + p * w
    return p * x


def normal(k, shape) -> np.ndarray:
    """``jax.random.normal(k, shape, jnp.float32)``: sqrt(2) erf_inv(u),
    u uniform on [nextafter(-1, 0), 1)."""
    u = uniform(k, shape, _NORMAL_LO, 1.0)
    return np.float32(_SQRT2) * erf_inv(u)


def _bits_words(kw, shape):
    """32-bit bits for each row of ``kw`` ((n, 2) int64 key words on one
    device): (n, *shape) int64."""
    import torch

    counts = torch.arange(math.prod(shape), dtype=torch.int64, device=kw.device)[None]
    b1, b2 = threefry2x32(kw[:, :1], kw[:, 1:], counts >> 32, counts & _M32)
    return (b1 ^ b2).reshape(kw.shape[0], *shape)


def _uniform_words(kw, shape, minval: float = 0.0, maxval: float = 1.0):
    import torch

    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))  # rounded as jax rounds it
    bits = _bits_words(kw, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats * span + lo, lo)


def _normal_words(kw, shape):
    import torch

    u = _uniform_words(kw, shape, _NORMAL_LO, 1.0)
    w = -torch.log1p(u * -u)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    return _SQRT2 * (p * u)


def _key_words(keys, device):
    """(n, 2) uint32 keys -> int64 words on ``device``, copied without a
    host sync (``runtime.to_device``)."""
    from sdtpu_torch.utils.runtime import to_device

    return to_device(np.asarray(keys, np.uint32).reshape(-1, 2).astype(np.int64), device)


def bits_torch(keys, shape, device):
    """``random_bits`` for each of ``keys`` ((n, 2) uint32) at once, computed
    by torch on ``device``: (n, *shape) int64 holding the uint32 values."""
    return _bits_words(_key_words(keys, device), tuple(shape))


def uniform_torch(keys, shape, device, minval: float = 0.0, maxval: float = 1.0):
    """``uniform`` for each of ``keys`` at once, on ``device``: float32."""
    return _uniform_words(_key_words(keys, device), tuple(shape), minval, maxval)


def normal_torch(keys, shape, device):
    """``normal`` for each of ``keys`` at once, on ``device``: float32."""
    return _normal_words(_key_words(keys, device), tuple(shape))


class NormalGraphs:
    """``normal_torch`` on a card, captured once per (number of keys, shape,
    device) as a CUDA graph and replayed: the ~220 torch ops of one draw
    then cost the host one copy and one replay.  Each call copies the keys
    into the graph's input on the current stream and returns a copy of the
    graph's output, so a later call does not overwrite an earlier result.
    The first call of a shape synchronises the card (the capture)."""

    def __init__(self):
        self._graphs = {}

    def __call__(self, keys, shape, device):
        import torch

        keys = np.asarray(keys, np.uint32).reshape(-1, 2)
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"NormalGraphs replays CUDA graphs; got device {device}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        slot = (keys.shape[0], tuple(shape), device)
        if slot not in self._graphs:
            self._graphs[slot] = self._capture(*slot)
        words, graph, out = self._graphs[slot]
        words.copy_(torch.from_numpy(keys.astype(np.int64)).pin_memory(), non_blocking=True)
        graph.replay()
        return out.clone()

    @staticmethod
    def _capture(n, shape, device):
        import torch

        words = torch.zeros((n, 2), dtype=torch.int64, device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            _normal_words(words, shape)  # warm-up outside the capture
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = _normal_words(words, shape)
        return words, graph, out
