"""The traffic: one generator of requests (this module), which reads a
traffic mix's parameters (``sdbench/traffic/<mix>.json``) and ``--seed``,
and one driver per kind of traffic (``sdbench/traffic/<kind>.py``), found
by the mix's ``kind``.  The same seed gives the same requests; every seed
gives the same sizes, which the mix fixes.

Parameters every mix may have:

- ``kind``: the driver's module: ``batched`` (``generate_batch`` of
  ``batch`` requests, each row with its own seed), ``single``
  (``generate``, one request each), ``open_loop``
  (``ServingEngine.submit`` at arrival times); each documents its own
  parameters;
- ``prompt_tokens``: [least, most] prompt tokens between BOS and EOS;
- ``init_image``: ``{"pool": n}`` gives each request one of n seeded
  smooth uint8 images at the configuration's size, with ``strength``.

A kind's module supplies:

- ``PER_ROW``: whether the entry it calls draws each request's noise from
  the request's own seed in a batch (``generate_batch``) or from a lone
  request's key (``generate``); the reference draws alike;
- ``call(pipe, cfg, mix, reqs)``: the requests' uint8 images through the
  kind's entry, on the device (the control sends a sample through it
  again);
- ``warm(pipe, cfg, mix, inputs)``: every shape the window uses, once;
- ``run(pipe, cfg, mix, inputs, seconds, tracer)``: the window
  (``drive.Window``), and with an enabled tracer its traced slice.
"""

from __future__ import annotations

import importlib

import numpy as np


def request(seed: int, index: int, mix: dict, text: dict) -> dict:
    """Request ``index`` of the run seeded ``seed``: (77,) token ids
    (BOS, random tokens, EOS to the end) and the 32-bit seed of its
    draws."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, int(index)])
    vocab, length = text["vocab_size"], text["max_length"]
    lo, hi = mix.get("prompt_tokens", [5, 60])
    n = int(rng.integers(lo, hi + 1))
    ids = np.full((length,), vocab - 1, np.int64)
    ids[0] = vocab - 2
    ids[1:n + 1] = rng.integers(0, vocab - 2, n)
    out = {"index": index, "ids": ids, "seed": int(rng.integers(0, 2**32))}
    if "init_image" in mix:
        out["image_index"] = int(rng.integers(0, mix["init_image"]["pool"]))
        out["strength"] = mix["strength"]
    return out


def image_pool(seed: int, mix: dict, size: int) -> list:
    """``pool`` smooth uint8 (size, size, 3) images: seeded 8x8 colour
    fields, upsampled bilinearly, plus fine noise."""
    n = mix["init_image"]["pool"]
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 0x1A6E])
    axis = np.linspace(0.0, 7.0, size)
    i0 = np.floor(axis).astype(int).clip(0, 6)
    w = (axis - i0)[:, None]
    images = []
    for _ in range(n):
        coarse = rng.uniform(0.0, 255.0, (8, 8, 3))
        rows = coarse[i0] * (1 - w[..., None]) + coarse[i0 + 1] * w[..., None]
        full = rows[:, i0] * (1 - w[None, :, :]) + rows[:, i0 + 1] * w[None, :, :]
        full = full + rng.normal(0.0, 6.0, full.shape)
        images.append(np.clip(np.round(full), 0, 255).astype(np.uint8))
    return images


def kind(mix: dict):
    """The driver of the mix's kind: ``sdbench.traffic.<kind>``."""
    return importlib.import_module(f"{__name__}.{mix['kind']}")
