"""The draws of a request, worked out again: ``jax.random``'s threefry-2x32
keys (``key``, ``split``, ``fold_in``) and its float32 ``normal`` (counter
layout of ``jax_threefry_partitionable``, Giles' single-precision inverse
error function), as the served pipeline documents them.  Key derivation
runs on the host in Python integers; the normals run in torch on any
device."""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
        -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
        -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(math.sqrt(2.0)))


def threefry(k1, k2, x0, x1):
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def key(seed: int) -> tuple:
    if not 0 <= seed <= _M32:
        raise OverflowError(f"seed {seed} outside [0, 2**32)")
    return (0, int(seed))


def split(k: tuple, num: int = 2) -> list:
    return [threefry(k[0], k[1], 0, i) for i in range(num)]


def fold_in(k: tuple, data: int) -> tuple:
    return threefry(k[0], k[1], 0, data & _M32)


def request_keys(seed: int, steps: int, *, heads: int, per_row: bool) -> list:
    """The keys of one request's draws: ``heads`` draws before the steps'
    (1 for text-to-image: the initial latents; 2 for image-to-image: the
    encoder's posterior noise and the forward noise), then one a step.
    A row of a batch with its own seed folds in salts 0 (and 1) and 2 + i;
    a lone request's scalar key splits once per draw."""
    k = key(seed)
    if per_row:
        return [fold_in(k, s) for s in list(range(heads)) + [2 + i for i in range(steps)]]
    out = []
    if heads == 1:
        k, init = split(k)
        out.append(init)
    elif heads == 2:
        k, enc, fwd = split(k, 3)
        out += [enc, fwd]
    for _ in range(steps):
        k, sub = split(k)
        out.append(sub)
    return out


def normals(keys: list, shape, device) -> torch.Tensor:
    """float32 normals, one draw of ``shape`` per key: (len(keys), *shape)."""
    kw = torch.tensor(keys, dtype=torch.int64, device=device)
    n = math.prod(shape)
    counts = torch.arange(n, dtype=torch.int64, device=device)[None]
    b1, b2 = threefry(kw[:, :1], kw[:, 1:], counts >> 32, counts & _M32)
    bits = b1 ^ b2
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    span = float(np.float32(1.0) - np.float32(_LO))
    u = torch.clamp_min(u * span + _LO, _LO)
    w = -torch.log1p(u * -u)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _LT5[0], _GE5[0])
    for a, b in zip(_LT5[1:], _GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    return (_SQRT2 * (p * u)).reshape(len(keys), *shape)
