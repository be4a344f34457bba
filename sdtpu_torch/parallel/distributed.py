"""Process-group set-up and a health probe.

Counterpart of ``sdtpu/parallel/distributed.py`` (``initialize``,
``health_check``, ``global_mesh``).  Nothing on a machine names its cluster to the program,
so ``initialize`` takes the rendezvous address, the number of processes and
this process's rank (or, with none given, reads them from the environment
as ``torchrun`` sets it).  NCCL is the backend on the card and gloo on the
CPU; gloo also takes CUDA tensors, so several processes can drive one
card.  ``global_mesh`` lays the world's ranks out as a dp/tp mesh
(``mesh.py``).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
) -> None:
    """Join this process to a ``torch.distributed`` group.  A no-op for one
    process.  ``coordinator_address``: ``"host:port"`` (TCP rendezvous) or
    a full ``tcp://`` or ``file://`` URL; None reads ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` from the environment.
    ``backend`` defaults to NCCL when a card is present, else gloo (gloo on
    a card lets several processes share it); with NCCL each
    process drives card ``process_id % device_count`` (``LOCAL_RANK``, as
    ``torchrun`` sets it, when no ``process_id`` is given)."""
    if num_processes is not None and num_processes <= 1:
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if backend == "nccl":
        local = process_id if process_id is not None else int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes or -1,
                            rank=-1 if process_id is None else process_id)


def health_check(mesh=None) -> dict:
    """Heartbeat over the devices: a round trip to each device, then one
    collective, so that a wedged card or a broken link shows as a report,
    not as a hang deep inside a generation.  With ``mesh``: this rank's
    device, and an ``all_reduce`` of a 1 from each of the mesh's ranks
    (``"devices"`` counts them).  Without one: under a process group this
    rank's device and the world's ``all_reduce``; with none, every local
    device and a sum of a 1 from each.

    Returns ``{"ok", "devices": n, "device_errors": {idx: msg},
    "collective_ok"}`` (plus ``"world_size"`` under a group, and
    ``"collective_error"`` when the collective raised)."""
    grouped = dist.is_initialized() and (mesh is None or mesh.device_mesh is not None)
    if mesh is not None:
        devices = [mesh.device]
    elif grouped and dist.get_backend() == "nccl":
        devices = [torch.device("cuda", torch.cuda.current_device())]
    elif torch.cuda.is_available():
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device("cpu")]
    report = {"devices": mesh.size if mesh is not None else len(devices),
              "device_errors": {}, "collective_ok": False}
    for i, d in enumerate(devices):
        try:
            x = torch.tensor(float(i), device=d)
            if float(x.cpu()) != float(i):
                report["device_errors"][i] = "round-trip value mismatch"
        except Exception as exc:  # surface, don't raise: this is the probe
            report["device_errors"][i] = repr(exc)
    try:
        if grouped:
            n = dist.get_world_size()
            one = torch.ones(1, device=devices[0] if mesh is not None or
                             dist.get_backend() == "nccl" else "cpu")
            dist.all_reduce(one)
            report["world_size"] = n
            report["collective_ok"] = float(one.cpu()) == n
        else:
            total = sum(torch.ones(1, device=d).to(devices[0]) for d in devices)
            report["collective_ok"] = float(total.cpu()) == len(devices)
    except Exception as exc:  # surface, don't raise: this is the probe
        report["collective_error"] = repr(exc)
    report["ok"] = not report["device_errors"] and report["collective_ok"]
    return report


def global_mesh(dp: Optional[int] = None, tp: int = 1):
    """A (dp, tp) mesh over all the world's ranks.  tp must not exceed the
    ranks of one host (``LOCAL_WORLD_SIZE`` as ``torchrun`` sets it, else
    the cards of this machine, else the world), so that the tensor-parallel
    collectives stay inside a host, as the JAX package keeps them on ICI;
    dp spans hosts.  Defaults to dp = ranks // tp."""
    from sdtpu_torch.parallel.mesh import make_mesh

    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % tp != 0:
        raise ValueError(f"tp={tp} does not divide device count {n}")
    dp = dp or n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp * tp} != device count {n}")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", 0)) or (
        torch.cuda.device_count() if torch.cuda.is_available() else n)
    if tp > local:
        raise ValueError(
            f"tp={tp} exceeds local device count {local}; tensor-parallel "
            "collectives must stay on ICI (within one host)"
        )
    return make_mesh(dp, tp)
