"""The dp/tp mesh and the tensor-parallel layouts: the counterpart of
``sdtpu/parallel/mesh.py``.

The JAX package's mesh is single-controller GSPMD: one process sees every
device, ``NamedSharding`` annotations place inputs and parameters, and XLA
inserts the collectives.  PyTorch has no compiler that partitions a
program, so the port runs one process per rank (SPMD over
``torch.distributed``, as ``ProcessGroupRing`` does): each process holds
its own rows and its own parameter slices and issues the collectives
itself.  The two axes compute what the JAX package's compute:

* **dp**: ``generate_batch(mesh=)`` serves this rank's block of requests,
  all of their rows, and ``all_gather``s the images over dp, so that every
  rank returns the whole batch, as a JAX global array holds it.
* **tp**: Megatron-style.  :func:`shard_params_tp` keeps this rank's slice
  of the column-parallel in-projections (attention q/k/v, ``mlp/fc1``,
  ``ff/proj``) and of the row-parallel out-projections (attention ``out``,
  ``mlp/fc2``, ``ff/out``); every other leaf is shared.  Under
  :func:`tp_context`, attention runs on this rank's heads, and a
  row-parallel projection is a local matmul, an ``all_reduce`` over tp,
  then the bias once (the JAX program's psum per projection).

:func:`tp_spec_for` and :func:`batch_spec` return the JAX
``PartitionSpec``'s entries as a tuple.  One layout differs by design:
``ff/proj``'s output is GEGLU's ``value | gate`` halves, and a rank keeps
its slice of each half, so that GEGLU runs on the rank's own columns.
"""

from __future__ import annotations

import contextlib
import re
import threading
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """A (dp, tp) grid of the world's ranks, tp the minor axis as in the
    JAX package's ``make_mesh``: rank ``i * tp + j`` sits at (i, j).
    ``devices`` holds the ranks (a process drives one device) in that
    shape.  A mesh of one process with no group has no groups, and its
    collectives are identities."""

    axis_names = ("dp", "tp")

    def __init__(self, dp: int, tp: int, device_mesh=None):
        self.dp, self.tp = dp, tp
        self.devices = np.arange(dp * tp).reshape(dp, tp)
        self.device_mesh = device_mesh
        self.rank = dist.get_rank() if device_mesh is not None else 0
        self.dp_index, self.tp_index = divmod(self.rank, tp)
        self.dp_group = device_mesh.get_group("dp") if device_mesh is not None else None
        self.tp_group = device_mesh.get_group("tp") if device_mesh is not None else None
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if torch.cuda.is_available() else torch.device("cpu"))

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def size(self) -> int:
        return self.dp * self.tp

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and (self.dp, self.tp) == (other.dp, other.tp)

    def __hash__(self) -> int:
        return hash((self.dp, self.tp))

    def __repr__(self) -> str:
        return f"Mesh(dp={self.dp}, tp={self.tp}, rank={self.rank})"

    # -- collectives; the world's group is the mesh's (make_mesh) ----------

    def tp_all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over tp, in place."""
        if self.tp > 1:
            dist.all_reduce(t, group=self.tp_group)
        return t

    def tp_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The tp ranks' blocks concatenated along the last axis, in rank
        order."""
        return _all_gather(t, self.tp, self.tp_group, -1)

    def tp_local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the last axis (of tp equal blocks)."""
        w = t.shape[-1] // self.tp
        return t[..., self.tp_index * w:(self.tp_index + 1) * w]

    def dp_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The dp ranks' rows concatenated, in rank order."""
        return _all_gather(t, self.dp, self.dp_group, 0)

    def dp_rows(self, n: int) -> slice:
        """This rank's block of ``n`` rows (requests); n must divide by dp."""
        if n % self.dp:
            raise ValueError(f"a batch of {n} does not divide over dp={self.dp}")
        b = n // self.dp
        return slice(self.dp_index * b, (self.dp_index + 1) * b)


def _all_gather(t: torch.Tensor, n: int, group, dim: int) -> torch.Tensor:
    if n == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def make_mesh(dp: int = 1, tp: int = 1, *, devices: Optional[Sequence] = None) -> Mesh:
    """A (dp, tp) mesh over the default process group's ranks (every
    process calls it: the sub-groups are made collectively), from
    ``init_device_mesh`` with ``mesh_dim_names=("dp", "tp")``.  With no
    group this process is the one device.  ``devices``: the ranks to use
    (the JAX package's device list); a mesh must hold every rank of the
    world, since each process of an SPMD program runs its part."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(devices) if devices is not None else list(range(world))
    n = dp * tp
    if len(ranks) < n:
        raise ValueError(f"need {n} devices, have {len(ranks)}")
    if n != world or ranks[:n] != list(range(world)):
        raise ValueError(f"a mesh of {n} ranks in a world of {world}: every rank of the "
                         "world must be in the mesh, in rank order")
    if not dist.is_initialized():
        return Mesh(dp, tp)
    from torch.distributed.device_mesh import init_device_mesh

    kind = "cuda" if torch.cuda.is_available() else "cpu"
    return Mesh(dp, tp, init_device_mesh(kind, (dp, tp), mesh_dim_names=("dp", "tp")))


def replicate(tree, mesh: Mesh):
    """Every leaf on this rank's device, holding the values of the mesh's
    rank 0 (a broadcast over the mesh), so that every rank holds the same
    tree."""
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [replicate(v, mesh) for v in tree]
    t = torch.as_tensor(tree).to(mesh.device, copy=mesh.size > 1)
    if mesh.size > 1:
        dist.broadcast(t, src=0)
    return t


def batch_spec(x) -> tuple:
    return ("dp", *([None] * (np.ndim(x) - 1)))


def shard_batch(x, mesh: Mesh):
    """This rank's dp block of the leading (batch) axis."""
    return x[mesh.dp_rows(x.shape[0])]


# ---------------------------------------------------------------------------
# Tensor-parallel parameter shardings
# ---------------------------------------------------------------------------

# Path-suffix rules, applied to the '/'-joined pytree path.  Column-parallel
# (output-dim sharded) in-projections; row-parallel (input-dim sharded)
# out-projections; everything else replicated.
_COL_KERNEL = re.compile(
    r"(attn1?|attn2|attn)/(q|k|v)/kernel$|mlp/fc1/kernel$|ff/proj/kernel$"
)
_COL_BIAS = re.compile(
    r"(attn1?|attn2|attn)/(q|k|v)/bias$|mlp/fc1/bias$|ff/proj/bias$"
)
_ROW_KERNEL = re.compile(
    r"(attn1?|attn2|attn)/out/kernel$|mlp/fc2/kernel$|ff/out/kernel$"
)


def _path_str(path) -> str:
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return "/".join(parts)


def tp_spec_for(path, leaf) -> tuple:
    """PartitionSpec for one parameter under tp sharding, as a tuple;
    ``path`` a sequence of dict keys and list indices."""
    s = _path_str(path)
    ndim = np.ndim(leaf)
    if _COL_KERNEL.search(s) and ndim >= 2:
        # stacked CLIP layers have a leading layer axis: (L, in, out)
        return (*([None] * (ndim - 1)), "tp")
    if _COL_BIAS.search(s) and ndim >= 1:
        return (*([None] * (ndim - 1)), "tp")
    if _ROW_KERNEL.search(s) and ndim >= 2:
        return (*([None] * (ndim - 2)), "tp", None)
    return ()


class ShardedTree(dict):
    """A dict of a tree that :func:`shard_params_tp` made.  ``mesh``: the
    mesh it was sharded for.  ``split``: ``"col"`` or ``"row"`` on a
    projection whose leaves hold this rank's slice (tp > 1), else None."""

    def __init__(self, items, mesh: Mesh, split: Optional[str] = None):
        super().__init__(items)
        self.mesh, self.split = mesh, split


def like(src, items: dict) -> dict:
    """``items`` as a dict of ``src``'s kind: a :class:`ShardedTree` keeps
    its mesh and split (a forward that rebuilds a projection's dict, as
    CLIP's stacked layers do, must not lose them)."""
    if isinstance(src, ShardedTree):
        return ShardedTree(items, src.mesh, src.split)
    return items


def shard_leaf(path, leaf: torch.Tensor, tp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s slice of one parameter (of ``tp``) along the axis its
    spec names; the leaf itself where the spec names none.  ``ff/proj``'s
    output axis holds GEGLU's ``value | gate`` halves: the rank takes its
    slice of each and concatenates them."""
    spec = tp_spec_for(path, leaf)
    if "tp" not in spec:
        return leaf
    axis = spec.index("tp")
    halves = 2 if re.search(r"ff/proj/(kernel|bias)$", _path_str(path)) else 1
    size = leaf.shape[axis]
    if size % (tp * halves):
        raise ValueError(f"{_path_str(path)}: {size} does not divide over tp={tp}"
                         + (" in each GEGLU half" if halves == 2 else ""))
    half, w = size // halves, size // halves // tp
    return torch.cat([leaf.narrow(axis, h * half + rank * w, w) for h in range(halves)],
                     dim=axis)


def shard_params_tp(params, mesh: Mesh):
    """This rank's Megatron-style slices: every leaf :func:`tp_spec_for`
    shards holds this rank's slice (a copy), every other leaf is the
    caller's (shared).  An int8 projection (``kernel_q``, no ``kernel``)
    stays whole, its bias too, as the JAX package runs its int8 tree
    replicated.  Every dict of the result is a :class:`ShardedTree` that
    knows the mesh; a forward that meets one of its projections outside
    ``tp_context(mesh)`` raises ValueError."""

    def walk(node, path):
        if isinstance(node, (list, tuple)):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        if not isinstance(node, dict):
            return node
        split = None
        if mesh.tp > 1 and isinstance(node.get("kernel"), torch.Tensor):
            kernel_path = _path_str(path + ("kernel",))
            split = ("col" if _COL_KERNEL.search(kernel_path)
                     else "row" if _ROW_KERNEL.search(kernel_path) else None)
        items = {}
        for k, v in node.items():
            if split is not None and isinstance(v, torch.Tensor):
                items[k] = shard_leaf(path + (k,), v, mesh.tp, mesh.tp_index)
            else:
                items[k] = walk(v, path + (k,))
        return ShardedTree(items, mesh, split)

    return walk(params, ())


def sharded_mesh(tree) -> Optional[Mesh]:
    """The mesh :func:`shard_params_tp` sharded ``tree`` for, or None."""
    return tree.mesh if isinstance(tree, ShardedTree) else None


# ---------------------------------------------------------------------------
# The tp context: ``generate_batch(mesh=)`` enters it; ``ops/linear.py`` and
# ``ops/attention.py`` read it at every projection that holds a slice.
# ---------------------------------------------------------------------------

_tp_ctx = threading.local()


@contextlib.contextmanager
def tp_context(mesh: Mesh):
    """Run the forwards inside this block with ``mesh``'s tp group."""
    prev = getattr(_tp_ctx, "value", None)
    _tp_ctx.value = mesh
    try:
        yield
    finally:
        _tp_ctx.value = prev


def get_tp_context() -> Optional[Mesh]:
    return getattr(_tp_ctx, "value", None)


def tp_of(params) -> Optional[Mesh]:
    """The active mesh when projection ``params`` holds a tp slice, else
    None.  Raises ValueError when a slice meets no ``tp_context`` of the
    mesh it was sharded for: computing on a slice alone is no result."""
    if getattr(params, "split", None) is None:
        return None
    mesh = get_tp_context()
    if mesh != params.mesh:
        raise ValueError(f"these parameters hold the tp slices of {params.mesh}: run them "
                         f"under tp_context of that mesh (generate_batch(mesh=...)), not "
                         f"{'no mesh' if mesh is None else mesh}")
    return mesh
