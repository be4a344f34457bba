"""Runtime helpers: synchronisation for timing, and host-to-device copies
that do not stall the host.

Counterpart of ``sdtpu/utils/runtime.py``.  Its ``enable_compilation_cache``
has no counterpart here: eager PyTorch compiles no program, and the
hand-written kernels are compiled once per source and cached under
``build/`` (``kernels/_build.py``).
"""

from __future__ import annotations

import numpy as np
import torch


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def device_sync(x=None) -> None:
    """Wait until the card has finished the work queued so far: the
    ``torch.cuda.synchronize`` of the device that ``x`` (a tensor, or a
    tree of them; None: the current device) lies on.  A no-op for the CPU,
    where every op has finished when it returns."""
    t = _first_tensor(x)
    device = None if t is None else t.device
    if device is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    elif device.type == "cuda":
        torch.cuda.synchronize(device)


def to_device(array, device, dtype=None) -> torch.Tensor:
    """A numpy array -> a tensor on ``device`` (cast to ``dtype`` there).
    To a card the copy goes from pinned memory with ``non_blocking``, so the
    host does not wait for the work already queued; a copy from pageable
    memory would synchronise the stream."""
    t = torch.from_numpy(np.array(array))  # a copy: the caller's array may be read-only
    device = torch.device(device)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    else:
        t = t.to(device)
    return t if dtype is None else t.to(dtype)
