"""Ring attention: sequence-parallel exact attention over a ring of shards.

Counterpart of ``sdtpu/parallel/ring_attention.py``.  The sequence axis of
q/k/v is cut into n shards; each shard keeps its queries while the KV
blocks rotate around the ring, and each shard folds every visiting block
into its running online-softmax state.  At step s shard r holds KV block
(r - s) mod n, as the JAX package's ``ppermute`` to i + 1 gives, so every
transport computes the same sums in the same order.

Two per-shard bodies, as in the JAX package:

* ``"dense"``: one f32 score matrix per rotation (``_block_attention``);
* ``"flash"``: kernel F (``flash_attention_stats_packed``) per rotation,
  and the blocks' results merged through their softmax statistics:
  ``out = sum_i o_i l_i e^{m_i - M} / sum_i l_i e^{m_i - M}``.  The merge
  takes ``o_i`` as F returns it, already rounded to q's dtype, as the JAX
  body does (``astype(float32)`` of the kernel's output).

``"auto"`` is dense on the CPU and flash on the card.  The rotation is the
only thing that differs between transports; a body takes it from a small
ring object:

* ``LocalRing(n)``: all n shards in this process, on one device (the
  counterpart of a mesh over virtual devices);
* ``ProcessGroupRing(group)``: one shard per rank of a
  ``torch.distributed`` group; point-to-point sends to rank + 1 and
  receives from rank - 1, and an ``all_gather`` of the shards' outputs at
  the end (the JAX ``shard_map`` has ``out_specs P(None, sp)`` and the rest
  of the program stays replicated).

Both hold the shards head-major, (B, H, L/n, D), as kernel F takes them;
the public entry takes and returns (B, L, H, D).
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional

import torch
import torch.distributed as dist

from sdtpu_torch.kernels.flash_attention import flash_attention_stats_packed


class LocalRing:
    """All ``n`` shards of the ring in this process, on one device.  It
    holds shards ``rank() .. rank() + held() - 1``, i.e. every one."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"ring size must be >= 1, got {n}")
        self.n = n

    def size(self) -> int:
        return self.n

    def rank(self) -> int:
        return 0

    def held(self) -> int:
        return self.n

    def rotate(self, k: List[torch.Tensor], v: List[torch.Tensor]):
        """Shard r receives shard r - 1's block."""
        return k[-1:] + k[:-1], v[-1:] + v[:-1]

    def gather(self, shards: List[torch.Tensor], dim: int) -> torch.Tensor:
        return torch.cat(shards, dim=dim)


class ProcessGroupRing:
    """One shard per rank of a ``torch.distributed`` process group (the
    default group when ``group`` is None)."""

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupRing needs torch.distributed to be "
                               "initialized (sdtpu_torch.parallel.initialize)")
        self.group = group

    def size(self) -> int:
        return dist.get_world_size(self.group)

    def rank(self) -> int:
        return dist.get_rank(self.group)

    def held(self) -> int:
        return 1

    def _global(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def rotate(self, k: List[torch.Tensor], v: List[torch.Tensor]):
        """Send this rank's block to rank + 1, receive rank - 1's."""
        n, r = self.size(), self.rank()
        nxt, prv = self._global((r + 1) % n), self._global((r - 1) % n)
        k_in, v_in = torch.empty_like(k[0]), torch.empty_like(v[0])
        ops = [dist.P2POp(dist.isend, k[0], nxt, self.group),
               dist.P2POp(dist.irecv, k_in, prv, self.group),
               dist.P2POp(dist.isend, v[0], nxt, self.group),
               dist.P2POp(dist.irecv, v_in, prv, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [k_in], [v_in]

    def gather(self, shards: List[torch.Tensor], dim: int) -> torch.Tensor:
        out = [torch.empty_like(shards[0]) for _ in range(self.size())]
        dist.all_gather(out, shards[0].contiguous(), group=self.group)
        return torch.cat(out, dim=dim)


def _block_attention(q, k, v, m_prev, l_prev, acc_prev, *, scale):
    """One online-softmax update of the running (m, l, acc) state with a
    new KV block.  q: (B, H, Lq, D); k/v: (B, H, Lkv, D); m, l (B, H, Lq),
    acc (B, H, Lq, D), all f32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    m_next = torch.maximum(m_prev, s.amax(dim=-1))
    alpha = torch.exp(m_prev - m_next)
    p = torch.exp(s - m_next[..., None])
    l_next = alpha * l_prev + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return m_next, l_next, acc_prev * alpha[..., None] + pv


class _DenseShard:
    def __init__(self, q):
        b, h, lq, d = q.shape
        self.q, self.scale = q, d ** -0.5
        self.m = torch.full((b, h, lq), float("-inf"), device=q.device)
        self.l = torch.zeros((b, h, lq), device=q.device)
        self.acc = torch.zeros((b, h, lq, d), device=q.device)

    def update(self, k, v):
        self.m, self.l, self.acc = _block_attention(
            self.q, k, v, self.m, self.l, self.acc, scale=self.scale)

    def result(self):
        return (self.acc / self.l[..., None]).to(self.q.dtype)


class _FlashShard:
    def __init__(self, q):
        b, h, lq, d = q.shape
        self.q = q
        self.m = torch.full((b, h, lq), float("-inf"), device=q.device)
        self.den = torch.zeros((b, h, lq), device=q.device)
        self.num = torch.zeros((b, h, lq, d), device=q.device)

    def update(self, k, v):
        o_i, m_i, l_i = flash_attention_stats_packed(self.q, k, v)
        m_new = torch.maximum(self.m, m_i)
        # first rotation: m = -inf, and the rescale must be exactly 0, not
        # exp(-inf - m_new) = nan should m_new be -inf too
        alpha = torch.where(torch.isneginf(self.m), torch.zeros_like(m_new),
                            torch.exp(self.m - m_new))
        w_i = torch.exp(m_i - m_new) * l_i
        self.num = self.num * alpha[..., None] + o_i.float() * w_i[..., None]
        self.den = self.den * alpha + w_i
        self.m = m_new

    def result(self):
        return (self.num / self.den[..., None]).to(self.q.dtype)


_BODIES: dict = {"dense": _DenseShard, "flash": _FlashShard}


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ring, *,
                   body: str = "auto") -> torch.Tensor:
    """Exact attention with the sequence axis split over ``ring``.

    q, k, v: (B, L, H, D), the same full tensors on every rank (the port
    keeps the rest of the program replicated); L must divide by
    ``ring.size()``.  Returns (B, L, H, D) in q's dtype.  ``body``:
    ``"dense"``, ``"flash"`` (kernel F), or ``"auto"`` = dense on the CPU,
    flash on the card."""
    if body == "auto":
        body = "dense" if q.device.type == "cpu" else "flash"
    if body not in _BODIES:
        raise ValueError(f"unknown ring body {body!r}")
    n = ring.size()
    length = q.shape[1]
    if k.shape[1] != length or length % n:
        raise ValueError(f"ring attention needs Lq == Lk divisible by the ring size {n}, "
                         f"got {length} and {k.shape[1]}")
    blk = length // n
    first = ring.rank()
    mine = range(first, first + ring.held())

    def shards(t):
        t = t.permute(0, 2, 1, 3)
        return [t[:, :, r * blk:(r + 1) * blk].contiguous() for r in mine]

    state: List = [_BODIES[body](qs) for qs in shards(q)]
    ks, vs = shards(k), shards(v)
    for step in range(n):
        for st, kb, vb in zip(state, ks, vs):
            st.update(kb, vb)
        if step < n - 1:  # the JAX loop's last rotation is never read
            ks, vs = ring.rotate(ks, vs)
    return ring.gather([st.result() for st in state], dim=2).permute(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# Model integration: ``attention_impl="ring"``.  The ring is supplied
# ambiently by wrapping the call (``generate``, ``unet_forward``) in
# ``ring_context``; ``ops/attention.py`` reads it at every call.
# ---------------------------------------------------------------------------

_ring_ctx = threading.local()


@contextlib.contextmanager
def ring_context(ring):
    """Run ``attention_impl="ring"`` attention inside this block over
    ``ring`` (a ``LocalRing`` or a ``ProcessGroupRing``)."""
    prev = getattr(_ring_ctx, "value", None)
    _ring_ctx.value = ring
    try:
        yield
    finally:
        _ring_ctx.value = prev


def get_ring_context():
    return getattr(_ring_ctx, "value", None)


def maybe_ring_attention(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> Optional[torch.Tensor]:
    """Ring attention over (B, L, H, D) when a context is active and the
    sequence axis divides the ring; None tells the caller to fall back.
    Self-attention only (Lq == Lk): the 77-token text context is never
    sharded, and a ring of one is plain attention."""
    ring = get_ring_context()
    if ring is None:
        return None
    n = ring.size()
    if q.shape[1] != k.shape[1] or q.shape[1] % n != 0 or n == 1:
        return None
    return ring_attention(q, k, v, ring)
