"""Host-side parameter-init RNG: the JAX package's ``sdtpu/utils/hostrng.py``
(its numpy branch), so that ``from_random(seed)`` draws the same weights.

A ``jax.random``-shaped surface (``key``/``split``/``uniform``/``normal``)
backed by numpy's Philox counter-based generator:

- ``split`` is pure: splitting the same key twice yields the same children
  (child ``SeedSequence``s extend ``spawn_key`` explicitly instead of
  calling the stateful ``SeedSequence.spawn``);
- draws are pure: every ``uniform``/``normal`` call builds a fresh
  ``Generator`` from the key, so the same key always yields the same array;
- numpy guarantees Philox / ``SeedSequence`` stream stability across
  platforms and versions.

The draws are float64, as numpy makes them.  ``leaf`` rounds one to a
parameter dtype the way the JAX package's ``astype`` does: float64 ->
float32 -> the dtype.

Inside ``shapes_only()`` a draw costs nothing and ``leaf`` returns a meta
tensor (shape and dtype, no values): the counterpart of ``jax.eval_shape``
over an init, for trees of zeros (``utils/weights.py:zero_pipeline_params``).
"""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch

_shapes_only = contextvars.ContextVar("hostrng_shapes_only", default=False)


@contextlib.contextmanager
def shapes_only():
    """Draws inside the block are zero-cost placeholders and every ``leaf``
    a tensor on the meta device."""
    token = _shapes_only.set(True)
    try:
        yield
    finally:
        _shapes_only.reset(token)


class HostKey:
    """A functional PRNG key backed by ``np.random.SeedSequence``."""

    __slots__ = ("ss",)

    def __init__(self, ss: np.random.SeedSequence):
        self.ss = ss

    def __repr__(self):  # pragma: no cover - debug aid
        return f"HostKey(entropy={self.ss.entropy}, spawn_key={self.ss.spawn_key})"


def key(seed: int) -> HostKey:
    return HostKey(np.random.SeedSequence(int(seed)))


def ensure_key(k) -> HostKey:
    """An int seed -> its HostKey; a HostKey passes through."""
    return key(k) if isinstance(k, (int, np.integer)) else k


def split(k: HostKey, num: int = 2) -> list:
    # pure analogue of ss.spawn(num): child i = same entropy, spawn_key + (i,)
    return [
        HostKey(np.random.SeedSequence(entropy=k.ss.entropy,
                                       spawn_key=tuple(k.ss.spawn_key) + (i,)))
        for i in range(num)
    ]


def _gen(k: HostKey) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=k.ss.generate_state(2, np.uint64)))


def uniform(k: HostKey, shape=(), minval=0.0, maxval=1.0) -> np.ndarray:
    """U(minval, maxval) in float64."""
    if _shapes_only.get():
        return np.broadcast_to(np.float64(0.0), shape)
    u = np.asarray(_gen(k).random(size=shape, dtype=np.float64))
    return u * (float(maxval) - float(minval)) + float(minval)


def normal(k: HostKey, shape=()) -> np.ndarray:
    """N(0, 1) in float64."""
    if _shapes_only.get():
        return np.broadcast_to(np.float64(0.0), shape)
    return np.asarray(_gen(k).standard_normal(size=shape, dtype=np.float64))


def leaf(values: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """float64 draws -> a CPU tensor of ``dtype``, rounded float64 ->
    float32 -> ``dtype`` (round to nearest even at each step)."""
    if _shapes_only.get():
        return torch.empty(np.shape(values), dtype=dtype, device="meta")
    return torch.from_numpy(np.asarray(values, np.float64).astype(np.float32)).to(dtype)
