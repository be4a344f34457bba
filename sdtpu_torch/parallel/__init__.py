"""Scale-out: the dp/tp mesh and its layouts (``mesh.py``), process-group
set-up, ``global_mesh`` and the health probe (``distributed.py``), and
sequence-parallel ring attention (``ring_attention.py``); the counterpart
of ``sdtpu/parallel``."""

from sdtpu_torch.parallel.distributed import global_mesh, health_check, initialize
from sdtpu_torch.parallel.mesh import (
    batch_spec,
    make_mesh,
    replicate,
    shard_batch,
    shard_params_tp,
    tp_context,
    tp_spec_for,
)
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
    "batch_spec",
    "get_ring_context",
    "global_mesh",
    "health_check",
    "initialize",
    "make_mesh",
    "maybe_ring_attention",
    "replicate",
    "ring_attention",
    "ring_context",
    "shard_batch",
    "shard_params_tp",
    "tp_context",
    "tp_spec_for",
]
