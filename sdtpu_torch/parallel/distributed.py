"""Process-group set-up and a health probe.

Counterpart of ``sdtpu/parallel/distributed.py`` (``initialize``,
``health_check``).  Nothing on a machine names its cluster to the program,
so ``initialize`` takes the rendezvous address, the number of processes and
this process's rank (or, with none given, reads them from the environment
as ``torchrun`` sets it).  NCCL is the backend on the card and gloo on the
CPU.  ``global_mesh`` and the dp/tp layouts belong to the serving slice
(they ride on ``generate_batch``) and are not here.
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
) -> None:
    """Join this process to a ``torch.distributed`` group.  A no-op for one
    process.  ``coordinator_address``: ``"host:port"`` (TCP rendezvous) or
    a full ``tcp://`` or ``file://`` URL; None reads ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` from the environment.  The
    backend is NCCL when a card is present, else gloo; with NCCL each
    process drives card ``process_id % device_count`` (``LOCAL_RANK``, as
    ``torchrun`` sets it, when no ``process_id`` is given)."""
    if num_processes is not None and num_processes <= 1:
        return
    backend = "nccl" if torch.cuda.is_available() else "gloo"
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


def _devices(group) -> list:
    """The devices this process drives: its card under NCCL, every card
    without a group, the CPU on a machine without one."""
    if dist.is_initialized() and dist.get_backend(group) == "nccl":
        return [torch.device("cuda", torch.cuda.current_device())]
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def health_check(group=None) -> dict:
    """Heartbeat over the devices: a round trip to each device this process
    drives, then one collective -- an ``all_reduce`` of a 1 from every rank
    of ``group`` (the default group) when one is initialized, else a sum of
    a 1 from every local device -- so a wedged card or a broken link shows
    as a report, not as a hang deep inside a generation.

    Returns ``{"ok", "devices": n, "device_errors": {idx: msg},
    "collective_ok"}`` (plus ``"world_size"`` under a group, and
    ``"collective_error"`` when the collective raised)."""
    devices = _devices(group)
    report = {"devices": len(devices), "device_errors": {}, "collective_ok": False}
    for i, d in enumerate(devices):
        try:
            x = torch.tensor(float(i), device=d)
            if float(x.cpu()) != float(i):
                report["device_errors"][i] = "round-trip value mismatch"
        except Exception as exc:  # surface, don't raise: this is the probe
            report["device_errors"][i] = repr(exc)
    try:
        if dist.is_initialized():
            n = dist.get_world_size(group)
            one = torch.ones(1, device=devices[0] if dist.get_backend(group) == "nccl"
                             else "cpu")
            dist.all_reduce(one, group=group)
            report["world_size"] = n
            report["collective_ok"] = float(one.cpu()) == n
        else:
            total = sum(torch.ones(1, device=d).to(devices[0]) for d in devices)
            report["collective_ok"] = float(total.cpu()) == len(devices)
    except Exception as exc:  # surface, don't raise: this is the probe
        report["collective_error"] = repr(exc)
    report["ok"] = not report["device_errors"] and report["collective_ok"]
    return report
