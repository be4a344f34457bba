"""Sequence-parallel ring attention and process-group set-up; counterpart
of ``sdtpu/parallel`` without the dp/tp mesh layer (``mesh.py``,
``global_mesh``), which belongs to the serving slice."""

from sdtpu_torch.parallel.distributed import health_check, initialize
from sdtpu_torch.parallel.ring_attention import (
    LocalRing,
    ProcessGroupRing,
    get_ring_context,
    maybe_ring_attention,
    ring_attention,
    ring_context,
)

__all__ = [
    "LocalRing",
    "ProcessGroupRing",
    "get_ring_context",
    "health_check",
    "initialize",
    "maybe_ring_attention",
    "ring_attention",
    "ring_context",
]
