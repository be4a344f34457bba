"""The denoise step's UNet forward as a CUDA graph, captured once per shape
and replayed.

An eager UNet forward is ~1000-3800 kernel launches driven from Python, at
~25 us of host time each: at a few UNet rows the host, not the card, sets
the pace.  A replay is one ``cudaGraphLaunch`` of the same kernels at the
same shapes in the same order, so its output is bitwise the eager one.

:class:`UNetGraphs` holds one graph per :func:`graph_key` (everything that
fixes the captured work: the shapes and dtypes of the inputs, PAG's rows,
FreeU, the add-embedding and guidance-embedding flags, the attention and
conv routes, the run-time kernel switches and the device).  Each graph
reads static buffers: the UNet input, one step's time projections, the
text context and the cross-attention K/V.  A replay copies the step's input
and time slice into them (one ``torch._foreach_copy_``), and the context
and K/V too when the request is not the one whose values they hold (once
per request).  A graph's output is copied out (a float32 copy, which the
loop makes eagerly too) before the lock is released, so the next replay
may overwrite it.

Requests several deep in flight (the next request's steps queued while the
card still runs this one's) stay correct by stream order alone: every copy
into a static buffer, every replay and every read of an output is queued on
the one current stream, so a copy for request N + 1 runs after request N's
last replay has read the buffers.  All graphs of one runner share one
memory pool and replay one at a time on that stream.

:func:`graph_route` says where the route applies; it reads only what the
denoise loop can see.  The pipeline drops every graph whenever its
parameter tree is replaced (``load_lora``, ``unload_loras``,
``quantize_int8``, any assignment of ``params``): a graph holds pointers to
the weights it was captured with.
"""

from __future__ import annotations

import contextlib
import importlib
import threading
from typing import Optional

import torch

from sdtpu_torch.kernels import conv2d as conv_kernels
from sdtpu_torch.kernels import launch_counts
from sdtpu_torch.ops.linear import capturing_activations
from sdtpu_torch.parallel.mesh import get_tp_context, sharded_mesh
from sdtpu_torch.utils.profiling import untimed

# the attention routes a graph can hold; "ring" may run collectives
GRAPH_ATTENTION = ("flash", "xla")
# the package re-exports a function named ``attention`` over its submodule
_attention_ops = importlib.import_module("sdtpu_torch.ops.attention")


def leaves(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples, in traversal
    order (None leaves skipped)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in leaves(sub)]
    return []


def _clone(tree):
    """A tree of contiguous copies of ``tree``'s tensors, same structure."""
    if isinstance(tree, torch.Tensor):
        return tree.clone(memory_format=torch.contiguous_format)
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def _signature(tree, skip: int = 0) -> tuple:
    """The shapes (less the first ``skip`` axes) and dtypes of a tree's
    tensors, in traversal order."""
    return tuple((tuple(t.shape[skip:]), t.dtype) for t in leaves(tree))


def graph_route(device, *, attention_impl: str, unet, control=None,
                grouped: bool = False) -> bool:
    """Whether a denoise step's UNet forward runs as a graph: on a CUDA
    device, on the kernel or library route, for the plain forward.  These
    stay eager: ControlNet steps (``control``), the encoder cache's grouped
    steps (``grouped``), a tp mesh (an active ``tp_context`` or a sharded
    tree: collectives must not be captured), ``attention_impl="ring"``,
    and int8 calibration (``activation_capture`` reads values on the
    host)."""
    return (torch.device(device).type == "cuda" and attention_impl in GRAPH_ATTENTION
            and not control and not grouped and get_tp_context() is None
            and sharded_mesh(unet) is None and not capturing_activations())


def graph_key(lat_shape, dtype, device, context, cross_kv, time_cache, *, pag_tail: int,
              freeu, added_cond: bool, timestep_cond: bool, attention_impl: str,
              conv_impl: str) -> tuple:
    """Everything that fixes a captured forward: the UNet input's shape
    (rows, h, w, channels with the extra ones) and dtype, the context's and
    the cross K/V's shapes, one step's time projections (``time_cache``'s
    leaves less their step axis), PAG's tail rows, FreeU, whether the
    add-embedding or the guidance embedding is folded in, the routes, the
    module switches that pick kernels at run time (conv-stats chaining, the
    packed out-projection) and the device."""
    return (tuple(lat_shape), dtype, _signature(context), _signature(cross_kv),
            _signature(time_cache, 1), int(pag_tail), None if freeu is None else tuple(freeu),
            bool(added_cond), bool(timestep_cond), attention_impl, conv_impl,
            bool(conv_kernels.CONV_STATS_CHAIN), bool(_attention_ops._PACKED_OUT_PROJ),
            torch.device(device))


@contextlib.contextmanager
def held_launches():
    """Yields a dict that, when the block ends, holds the kernel launches
    the block counted (``kernels.launch_counts``' increments, nonzero
    ones); the counts are then put back as they were."""
    before = dict(launch_counts)
    made = {}
    try:
        yield made
    finally:
        made.update({k: n - before.get(k, 0) for k, n in launch_counts.items()
                     if n != before.get(k, 0)})
        launch_counts.update(before)


def _drop_cublas_workspaces(device) -> None:
    """Free cuBLAS's per-stream workspaces once the card is idle; the next
    call on a stream allocates its own again."""
    torch.cuda.synchronize(device)
    torch._C._cuda_clearCublasWorkspaces()


class _Graph:
    __slots__ = ("graph", "step_in", "request_in", "out", "launches", "owner")

    def __init__(self, graph, step_in, request_in, out, launches):
        self.graph = graph
        self.step_in = step_in  # the static buffers, flat
        self.request_in = request_in
        self.out = out
        self.launches = launches  # the kernel launches one replay makes
        self.owner = None  # the request whose context and K/V the buffers hold


class _Request:
    """A request's handle: the runner's generation when it started (the
    tree its forward closes over), and its identity for the buffers."""

    __slots__ = ("generation",)

    def __init__(self, generation: int):
        self.generation = generation


class UNetGraphs:
    """One pipeline's captured UNet forwards, one per :func:`graph_key`.

    ``captures``, ``replays`` and ``eager_steps`` count the graphs
    captured, the steps replayed and the steps that ran eagerly (on or off
    the route; the pipeline counts them).  ``generation`` counts the
    :meth:`clear` calls: a request that started before the last one (its
    forward closes over the old tree) neither captures nor replays."""

    def __init__(self):
        self._graphs = {}
        self._lock = threading.Lock()
        self._pool = None
        self._side = None
        self.generation = 0
        self.captures = self.replays = self.eager_steps = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def __contains__(self, key) -> bool:
        return key in self._graphs

    def clear(self) -> None:
        """Drop every graph and the pool they share."""
        with self._lock:
            self._graphs.clear()
            self._pool = None
            self.generation += 1

    def request(self) -> _Request:
        """A handle for one request's :meth:`capture` and :meth:`replay`
        calls."""
        return _Request(self.generation)

    def count_eager(self) -> None:
        with self._lock:
            self.eager_steps += 1

    def capture(self, key, forward, step_inputs: tuple, request_inputs: tuple,
                request: _Request) -> None:
        """Capture ``forward(*step_inputs, *request_inputs)`` under ``key``
        (nothing if another thread got there first, or if the tree changed
        since ``request`` started).  The inputs are copied
        into new static buffers; the forward runs once on a side stream
        (outside the capture), then is captured there.  The launches the
        capture counts are kept for each replay and taken back out of
        ``launch_counts``, as are the warm-up's.  The capture synchronises
        the card."""
        device = leaves(step_inputs)[0].device
        with self._lock:
            if key in self._graphs or request.generation != self.generation:
                return
            step_in, request_in = _clone(step_inputs), _clone(request_inputs)
            if self._side is None:
                self._side = torch.cuda.Stream(device)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            side, current = self._side, torch.cuda.current_stream(device)
            side.wait_stream(current)
            graph = torch.cuda.CUDAGraph()
            # the serving engine's worker may capture while another thread
            # works the card: only this thread's calls must be capturable
            with held_launches(), untimed():
                with torch.cuda.stream(side):
                    forward(*step_in, *request_in)  # warm-up outside the capture
                # cuBLAS holds a workspace per stream from its first call
                # there: dropped before the capture, the capture takes its
                # own from the graph's pool; dropped after, it is the
                # graph's scratch there, not memory held beside it
                _drop_cublas_workspaces(device)
                with held_launches() as launches, torch.cuda.graph(
                        graph, pool=self._pool, stream=side, capture_error_mode="thread_local"):
                    out = forward(*step_in, *request_in)
                _drop_cublas_workspaces(device)
            current.wait_stream(side)
            self._graphs[key] = _Graph(graph, leaves(step_in), leaves(request_in), out,
                                       launches)
            self.captures += 1

    def replay(self, key, step_inputs: tuple, request_inputs: tuple,
               request: _Request) -> Optional[torch.Tensor]:
        """The captured forward on these inputs: a float32 copy of its
        output; None, with nothing run, where the tree changed since
        ``request`` started.  The request's context and K/V are copied in
        only when the buffers hold another request's.  ``launch_counts``
        gains the launches of one forward."""
        with self._lock:
            g = self._graphs.get(key)
            if g is None or request.generation != self.generation:
                return None
            dst, src = g.step_in, leaves(step_inputs)
            if g.owner is not request:
                dst, src = dst + g.request_in, src + leaves(request_inputs)
                g.owner = request
            torch._foreach_copy_(dst, src)
            g.graph.replay()
            for k, n in g.launches.items():
                launch_counts[k] += n
            self.replays += 1
            return g.out.float() if g.out.dtype != torch.float32 else g.out.clone()
