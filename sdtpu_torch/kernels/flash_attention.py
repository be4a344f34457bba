"""Non-causal flash attention over head-major tensors, its per-KV-block
form with softmax statistics, and the packed out-projection.

* Kernel C, ``flash_attention_packed``: counterpart of
  ``sdtpu/kernels/flash_attention.py:flash_attention_packed`` (and of its
  ``(B, L, H, D)`` entry ``flash_attention``).
* Kernel F, ``flash_attention_stats_packed``: counterpart of
  ``flash_attention_stats``, the ring's per-KV-block primitive: C's output
  normalised over this KV block only, plus each row's max ``m`` of the
  scaled scores and sum ``l = sum_j exp(s_j - m)``, both float32.  Its
  ``(B, L, H, D)`` entry is ``flash_attention_stats``.
* Kernel G, ``out_proj_packed``: counterpart of ``out_proj_packed``,
  ``residual + sum_h o_h W_h + bias`` accumulated in float32 and rounded
  once, read straight from the head-major attention output.  It takes its
  output tile and any split of its head/K loop from ``plan_out_proj``; a
  split call adds the fixed-order reduction (``out_proj_packed_splitk``,
  counted on its own; ``out_proj_launches`` derives a call's launches).

The JAX kernels pad the head dim to 128 lanes; here every tensor keeps the
real head dim, and the CUDA kernels (``csrc/flash_attention.cu``,
``csrc/out_proj_packed.cu``) pad the MMA depth inside shared memory only.
C and F take their query tile, and at D > 160 the split of the keys over
blocks, from ``plan_flash``; a split call adds a merge kernel
(``flash_attention_merge``, counted on its own; ``flash_launches`` derives
a call's launches).  The probe kernel H
(``sdtpu_torch/tools/probe_flash_vpu.py``) is C's kernel with the TPU's
legacy softmax body and takes C's query tile; I
(``probe_flash_2stream.py``) is the same kernel with H's body, C's key
mask and its own chains of warps per block.  Both use this module's helpers.
On the CPU each wrapper runs its plain version: the same function in
float32, with the probabilities rounded to v's dtype before the P.V
product as the TPU kernel rounds them.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from sdtpu_torch.kernels import _build, launch_counts


# The tiles csrc/out_proj_packed.cu is built with (``out_proj_packed_tile``).
OUT_PROJ_BM = 128          # output rows per block (of one batch)
OUT_PROJ_BK = 64           # K values per step: one head's depth [j, j + 64), zero past D
OUT_PROJ_STAGES = 4        # TMA ring depth
OUT_PROJ_BNS = (128, 192)  # output columns per block, the plan's two choices
OUT_PROJ_MIN_SPLIT = 2 * OUT_PROJ_STAGES  # K steps a split keeps, at least
OUT_PROJ_MAX_SPLITS = 16


def _attention_parts(q, k, v):
    """(acc, m, l) of softmax(q k^T / sqrt(D)) v over (B, H, L, D): the
    unnormalised f32 P.V with P cast to v.dtype, the row max of the scaled
    scores and the row sum of exp(s - m)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return torch.matmul(p.to(v.dtype).float(), v.float()), m, p.sum(dim=-1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over (B, H, L, D) tensors, f32 softmax,
    P cast to v.dtype before P.V, rows with no mass -> 0."""
    acc, _, l = _attention_parts(q, k, v)
    l = l[..., None]
    return torch.where(l == 0, torch.zeros_like(acc), acc / l).to(q.dtype)


def flash_attention_stats_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Kernel F's function over (B, H, L, D): ``(out, m, l)`` with out in
    q's dtype, ``acc * (1/l)`` with ``1/l -> 1`` where l == 0 (as at
    ``sdtpu/kernels/flash_attention.py:127``), m and l (B, H, Lq) f32."""
    acc, m, l = _attention_parts(q, k, v)
    inv = torch.where(l == 0, torch.ones_like(l), 1.0 / l)
    return (acc * inv[..., None]).to(q.dtype), m, l


def out_proj_packed_plain(o: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                          residual: torch.Tensor) -> torch.Tensor:
    """Kernel G's function: ``(sum_h o_h W_h + bias) + residual`` in f32,
    rounded once to residual's dtype.  o (B, H, L, D), w (H, D, C),
    residual (B, L, C)."""
    out = torch.einsum("bhld,hdc->blc", o.float(), w.float())
    if bias is not None:
        out = out + bias.float()
    return (out + residual.float()).to(residual.dtype)


@functools.lru_cache(maxsize=64)  # a call's host time sits at the enqueue floor
def plan_out_proj(b: int, h: int, l: int, d: int, c: int) -> tuple:
    """``(bn, splits)`` for one call of kernel G over o (b, h, l, d) and w
    (h, d, c): the output tile is ``OUT_PROJ_BM`` rows of one batch x bn
    columns, and the K loop of ``h * ceil(d / OUT_PROJ_BK)`` steps (each one
    head's 64-deep slice) is split over ``splits`` blocks.  Among bn in
    ``OUT_PROJ_BNS``, the one with the least ``waves * steps per block *
    bn`` (waves of one block per SM), then the wider tile.  Where that
    unsplit grid leaves more than half of the SMs idle, the K loop is split
    too: among the splits that keep at least ``OUT_PROJ_MIN_SPLIT`` steps
    each (at most ``OUT_PROJ_MAX_SPLITS``), the same least cost, then the
    fewest splits.  A split writes f32 partials and adds a reduction launch,
    which on the card cost more than they gave wherever the unsplit grid
    already filled half the SMs.  Raises on a shape the kernel does not
    take."""
    if min(b, h, l, d, c) <= 0 or d % 8 or c % 8:
        raise ValueError(f"plan_out_proj: no plan for b={b} h={h} l={l} d={d} c={c} (d and c "
                         "multiples of 8; sizes positive)")
    steps = h * -(-d // OUT_PROJ_BK)

    def best(max_splits):
        top = None
        for bn in OUT_PROJ_BNS:
            tiles = b * -(-l // OUT_PROJ_BM) * -(-c // bn)
            for splits in range(1, max_splits + 1):
                cost = -(-tiles * splits // SMS) * -(-steps // splits) * bn
                key = (cost, splits, -bn, tiles * splits)
                if top is None or key < top:
                    top = key
        return -top[2], top[1], top[3]

    bn, splits, blocks = best(1)
    if 2 * blocks < SMS:
        bn, splits, _ = best(max(1, min(OUT_PROJ_MAX_SPLITS, steps // OUT_PROJ_MIN_SPLIT,
                                        65535 // b)))
    return bn, splits


def out_proj_launches(o_shape, c: int) -> dict:
    """The launch counters one call of kernel G over o ``o_shape`` and c
    output channels adds one to on the card: its own, and the split-K
    reduction where ``plan_out_proj`` splits."""
    keys = {"out_proj_packed": 1}
    if plan_out_proj(*o_shape, c)[1] > 1:
        keys["out_proj_packed_splitk"] = 1
    return keys


def out_proj_splitk_reduce_plain(ws: torch.Tensor, bias: Optional[torch.Tensor],
                                 residual: torch.Tensor) -> torch.Tensor:
    """The split-K reduction's function over ws (S, B, L, C) float32:
    ``bf16(((ws[0] + ... + ws[S-1]) + bias) + residual)``, added in that
    order in float32 and rounded once to residual's dtype."""
    acc = ws[0].clone()
    for part in ws[1:]:
        acc += part
    if bias is not None:
        acc = acc + bias.float()
    return (acc + residual.float()).to(residual.dtype)


def out_proj_splitk_plain(o: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                          residual: torch.Tensor, splits: int) -> torch.Tensor:
    """Kernel G's order of sums: step t of the ``T = h * ceil(d / 64)``
    covers head ``t // per`` at depths ``[(t % per) * 64, ...)`` (per =
    ceil(d / 64)), so split s's steps ``[s * T // splits, (s + 1) * T //
    splits)`` are one contiguous range of the flattened (h, d) contraction;
    each split's float32 partial product is one slice of ws, and
    ``out_proj_splitk_reduce_plain`` finishes the call."""
    b, h, l, d = o.shape
    per = -(-d // OUT_PROJ_BK)
    steps = h * per

    def k_at(t):  # the flattened K index where step t begins
        return (t // per) * d + (t % per) * OUT_PROJ_BK

    bounds = [k_at(s * steps // splits) for s in range(splits + 1)]
    of = o.permute(0, 2, 1, 3).reshape(b, l, h * d).float()
    wf = w.reshape(h * d, -1).float()
    ws = torch.stack([of[..., a:z] @ wf[a:z] for a, z in zip(bounds, bounds[1:])])
    return out_proj_splitk_reduce_plain(ws, bias, residual)


# The tiles csrc/flash_attention.cu is built with (``flash_attention_tile``).
FLASH_MT2_MAX_DP = 48     # the largest padded depth with 128-row tiles
FLASH_WIDE_BQ = 64        # D > 160: query rows per block (8 warps)
FLASH_WIDE_BKV = 32       # D > 160: keys per tile
FLASH_WIDE_DP = 512       # D > 160: the padded depth (and the workspace's row)
FLASH_DEPTHS = (32, 48, 64, 80, 96, 128, 160)  # padded depths of the D <= 160 plans
SMS = 132                 # H100 SXM
MIN_SPLIT_TILES = 2       # key tiles per split, at least
MAX_SPLITS = 16


def flash_depth(d: int) -> int:
    """The MMA depth a head dim is zero-padded to inside the kernel."""
    return next((p for p in FLASH_DEPTHS if d <= p), FLASH_WIDE_DP)


def plan_flash(bh: int, lq: int, lk: int, d: int) -> tuple:
    """``(bq, splits)`` for one call of C or F over (bh, lq, d) queries and
    lk keys.

    D <= 160: 4 warps on 128 query rows (two 16-row tiles per warp, padded
    depth <= 48) where that grid of ``ceil(lq / 128) * bh`` blocks is at
    least one block per SM, else on 64; never a split.  D > 160: 64-row tiles of one 8-warp block per
    SM, and the keys split over ``splits`` blocks: among the splits that
    keep at least ``MIN_SPLIT_TILES`` key tiles each (and at most
    ``MAX_SPLITS``), those giving at least one block per SM where any does,
    the one with the fewest waves per split (the smallest on a tie).
    Raises on a shape the kernels do not take."""
    if min(bh, lq, lk, d) <= 0 or d % 8 or d > FLASH_WIDE_DP:
        raise ValueError(f"plan_flash: no plan for bh={bh} lq={lq} lk={lk} d={d} (head dim a "
                         f"multiple of 8, at most {FLASH_WIDE_DP}; sizes positive)")
    dp = flash_depth(d)
    if dp <= FLASH_DEPTHS[-1]:
        return (128 if dp <= FLASH_MT2_MAX_DP and -(-lq // 128) * bh >= SMS else 64), 1
    rows = -(-lq // FLASH_WIDE_BQ) * bh
    cap = max(1, min(MAX_SPLITS, -(-lk // FLASH_WIDE_BKV) // MIN_SPLIT_TILES))
    cands = [s for s in range(1, cap + 1) if rows * s >= SMS] or list(range(1, cap + 1))
    return FLASH_WIDE_BQ, min(cands, key=lambda s: (-(-rows * s // SMS) / s, s))


def flash_plans(bh: int, lq: int, lk: int, d: int) -> list:
    """Every ``(bq, splits)`` that C's launch takes at this shape, the one
    :func:`plan_flash` picks among them: at D <= 160 the 64-row tile, and
    the 128-row tile where the padded depth is at most
    ``FLASH_MT2_MAX_DP``, one split; past it the 64-row tile with 1 up to
    the ``plan_flash`` cap of key splits."""
    if min(bh, lq, lk, d) <= 0 or d % 8 or d > FLASH_WIDE_DP:
        raise ValueError(f"flash_plans: no plan for bh={bh} lq={lq} lk={lk} d={d}")
    if flash_depth(d) <= FLASH_DEPTHS[-1]:
        return [(64, 1)] + ([(128, 1)] if flash_depth(d) <= FLASH_MT2_MAX_DP else [])
    cap = max(1, min(MAX_SPLITS, -(-lk // FLASH_WIDE_BKV) // MIN_SPLIT_TILES))
    return [(FLASH_WIDE_BQ, s) for s in range(1, cap + 1)]


def flash_launches(key: str, q_shape, lk: int) -> dict:
    """The launch counters one call of C (``key="flash_attention"``) or F
    (``"flash_attention_stats"``) adds one to on the card: its own, and the
    merge where ``plan_flash`` splits the keys."""
    b, h, lq, d = q_shape
    keys = {key: 1}
    if plan_flash(b * h, lq, lk, d)[1] > 1:
        keys["flash_attention_merge"] = 1
    return keys


def flash_merge_plain(ws: torch.Tensor, bh: int, lq: int, d: int, splits: int):
    """The merge kernel's function over the wide plan's workspace ``ws``
    (``splits * bh * lq * (FLASH_WIDE_DP + 2)`` floats: the unnormalised
    acc rows, then m in log2 units, then l): ``(out, m, l)`` with out
    (bh, lq, d) bf16 = ``sum_s w_s acc_s * (1/L)`` in split order, ``w_s =
    2^(m_s - M)``, ``L = sum_s w_s l_s``, ``1/L -> 1`` where L == 0; m the
    natural-log max ``M ln 2`` and l = L, each (bh, lq) float32."""
    n = splits * bh * lq
    acc = ws[:n * FLASH_WIDE_DP].view(splits, bh, lq, FLASH_WIDE_DP)[..., :d]
    m2 = ws[n * FLASH_WIDE_DP:n * (FLASH_WIDE_DP + 1)].view(splits, bh, lq)
    l = ws[n * (FLASH_WIDE_DP + 1):].view(splits, bh, lq)
    big = m2.amax(dim=0)
    w = torch.exp2(m2 - big)
    big_l = (w * l).sum(dim=0)
    out = (w[..., None] * acc).sum(dim=0)
    inv = torch.where(big_l == 0, torch.ones_like(big_l), 1.0 / big_l)
    return (out * inv[..., None]).to(torch.bfloat16), big * math.log(2.0), big_l


def _flash_lib():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [p] * 5 + [i] * 6 + [p]
        lib.flash_attention_launch.restype = i
        lib.flash_attention_stats_launch.argtypes = [p] * 7 + [i] * 6 + [p]
        lib.flash_attention_stats_launch.restype = i
        lib.flash_attention_merge_launch.argtypes = [p] * 4 + [i] * 4 + [p]
        lib.flash_attention_merge_launch.restype = i
        lib.flash_attention_legacy_launch.argtypes = [p] * 4 + [i] * 5 + [p]
        lib.flash_attention_legacy_launch.restype = i
        lib.flash_attention_nq_launch.argtypes = [p] * 4 + [i] * 6 + [p]
        lib.flash_attention_nq_launch.restype = i
        lib.flash_attention_tile.argtypes = [i]
        lib.flash_attention_tile.restype = i
        tiles = tuple(lib.flash_attention_tile(j) for j in range(4))
        want = (FLASH_MT2_MAX_DP, FLASH_WIDE_BQ, FLASH_WIDE_BKV, FLASH_WIDE_DP)
        if tiles != want:
            raise RuntimeError(f"flash_attention.cu runs tiles (MT2_MAX_DP, WIDE_BQ, WIDE_BKV, "
                               f"WIDE_DP) {tiles}, plan_flash assumes {want}")
        lib._typed = True
    return lib


def _out_proj_lib():
    lib = _build.load("out_proj_packed")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.out_proj_packed_launch.argtypes = [p] * 6 + [i] * 7 + [p]
        lib.out_proj_packed_launch.restype = i
        lib.out_proj_packed_splitk_launch.argtypes = [p] * 4 + [i] * 3 + [p]
        lib.out_proj_packed_splitk_launch.restype = i
        lib.out_proj_packed_tile.argtypes = [i]
        lib.out_proj_packed_tile.restype = i
        tiles = tuple(lib.out_proj_packed_tile(j) for j in range(5))
        want = (OUT_PROJ_BM, OUT_PROJ_BK, OUT_PROJ_STAGES, *OUT_PROJ_BNS)
        if tiles != want:
            raise RuntimeError(f"out_proj_packed.cu runs tiles (BM, BK, STAGES, BN_A, BN_B) "
                               f"{tiles}, plan_out_proj assumes {want}")
        lib._typed = True
    return lib


def _on_cpu(what: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (take the plain version), False for a CUDA one
    (launch the kernel); raises on any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return False


def _check_bf16(what: str, device, tensors) -> None:
    for name, t, shape in tensors:
        if (t.device != device or t.dtype != torch.bfloat16
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
            raise ValueError(
                f"{what}: {name} must be contiguous bf16 {tuple(shape)} on "
                f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )


def _check_qkv(what: str, q, k, v) -> tuple:
    b, h, lq, d = q.shape
    lk = k.shape[2]
    _check_bf16(what, q.device, (("q", q, (b, h, lq, d)), ("k", k, (b, h, lk, d)),
                                 ("v", v, (b, h, lk, d))))
    if d % 8 or d > 512:
        raise ValueError(f"{what}: head dim {d} must be a multiple of 8, <= 512")
    return b, h, lq, lk, d


def _flash_call(key: str, q, k, v, stats: bool):
    """Launch C (or F with ``stats``) as ``plan_flash`` says, then the
    merge where it splits the keys; ``(out, m, l)``, m and l None for C."""
    b, h, lq, lk, d = _check_qkv(key, q, k, v)
    bh = b * h
    bq, splits = plan_flash(bh, lq, lk, d)
    lib = _flash_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty_like(q)
    m = l = ws = None
    if stats:
        m = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    if splits > 1:
        ws = torch.empty(splits * bh * lq * (FLASH_WIDE_DP + 2), dtype=torch.float32,
                         device=q.device)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    dims = [bh, lq, lk, d, bq, splits]
    wsp = None if ws is None else ws.data_ptr()
    if stats:
        err = lib.flash_attention_stats_launch(*ptrs, m.data_ptr(), l.data_ptr(), wsp, *dims,
                                               stream)
    else:
        err = lib.flash_attention_launch(*ptrs, wsp, *dims, stream)
    _build.check(err, key)
    launch_counts[key] += 1
    if splits > 1:
        err = lib.flash_attention_merge_launch(wsp, out.data_ptr(),
                                               None if m is None else m.data_ptr(),
                                               None if l is None else l.data_ptr(),
                                               bh, lq, d, splits, stream)
        _build.check(err, "flash_attention_merge")
        launch_counts["flash_attention_merge"] += 1
    return out, m, l


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel C.  q (B, H, Lq, D), k/v (B, H, Lk, D) -> (B, H, Lq, D).

    On the card: bf16, contiguous, D a multiple of 8 and at most 512."""
    if _on_cpu("flash_attention", q):
        return flash_attention_plain(q, k, v)
    return _flash_call("flash_attention", q, k, v, False)[0]


def flash_attention_stats_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Kernel F.  q (B, H, Lq, D), k/v (B, H, Lk, D) -> ``(out, m, l)``:
    out (B, H, Lq, D) in q's dtype, normalised over this KV block; m, l
    (B, H, Lq) float32.  On the card: as kernel C."""
    if _on_cpu("flash_attention_stats", q):
        return flash_attention_stats_plain(q, k, v)
    return _flash_call("flash_attention_stats", q, k, v, True)


def flash_attention_merge(ws: torch.Tensor, bh: int, lq: int, d: int, splits: int,
                          stats: bool = False):
    """The merge kernel alone over a wide call's workspace (layout at
    ``flash_merge_plain``): ``(out, m, l)``, m and l None unless
    ``stats``.  On the card: ws contiguous float32 of
    ``splits * bh * lq * (FLASH_WIDE_DP + 2)``, 160 < d <= 512, d a multiple
    of 8, splits >= 2."""
    if _on_cpu("flash_attention_merge", ws):
        out, m, l = flash_merge_plain(ws, bh, lq, d, splits)
        return (out, m, l) if stats else (out, None, None)
    if (ws.dtype != torch.float32 or not ws.is_contiguous()
            or ws.numel() != splits * bh * lq * (FLASH_WIDE_DP + 2)):
        raise ValueError("flash_attention_merge: ws must be contiguous float32 of "
                         f"{splits * bh * lq * (FLASH_WIDE_DP + 2)} elements")
    out = torch.empty((bh, lq, d), dtype=torch.bfloat16, device=ws.device)
    m = l = None
    if stats:
        m = torch.empty((bh, lq), dtype=torch.float32, device=ws.device)
        l = torch.empty_like(m)
    err = _flash_lib().flash_attention_merge_launch(
        ws.data_ptr(), out.data_ptr(), None if m is None else m.data_ptr(),
        None if l is None else l.data_ptr(), bh, lq, d, splits,
        torch.cuda.current_stream(ws.device).cuda_stream)
    _build.check(err, "flash_attention_merge")
    launch_counts["flash_attention_merge"] += 1
    return out, m, l


def _head_major(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 1, 3).contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over (B, L, H, D) tensors."""
    return flash_attention_packed(_head_major(q), _head_major(k),
                                  _head_major(v)).permute(0, 2, 1, 3)


def flash_attention_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Kernel F over (B, L, H, D) tensors, as the JAX function takes them:
    out (B, Lq, H, D), m and l (B, H, Lq)."""
    out, m, l = flash_attention_stats_packed(_head_major(q), _head_major(k), _head_major(v))
    return out.permute(0, 2, 1, 3), m, l


def _check_bias(what: str, bias: Optional[torch.Tensor], c: int, device):
    """The bias as contiguous float32 on ``device`` (or None); raises on
    another shape or device."""
    if bias is None:
        return None
    if bias.device != device or tuple(bias.shape) != (c,):
        raise ValueError(f"{what}: bias must be ({c},) on {device}, got "
                         f"{tuple(bias.shape)} on {bias.device}")
    return bias.float().contiguous()


def _splitk_call(ws, bias, residual, splits: int) -> torch.Tensor:
    out = torch.empty_like(residual)
    b, l, c = residual.shape
    err = _out_proj_lib().out_proj_packed_splitk_launch(
        ws.data_ptr(), None if bias is None else bias.data_ptr(), residual.data_ptr(),
        out.data_ptr(), b * l, c, splits, torch.cuda.current_stream(ws.device).cuda_stream)
    _build.check(err, "out_proj_packed_splitk")
    launch_counts["out_proj_packed_splitk"] += 1
    return out


def out_proj_packed(o: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                    residual: torch.Tensor) -> torch.Tensor:
    """Kernel G.  o (B, H, L, D), w (H, D, C), bias (C,) or None, residual
    (B, L, C) -> (B, L, C) in residual's dtype.

    On the card: o, w and residual bf16 and contiguous, D and C multiples
    of 8; the bias is taken as float32.  The tile and the split of the K
    loop come from ``plan_out_proj``; a split call ends with the split-K
    reduction."""
    if _on_cpu("out_proj_packed", o):
        return out_proj_packed_plain(o, w, bias, residual)
    b, h, l, d = o.shape
    c = w.shape[-1]
    _check_bf16("out_proj_packed", o.device, (("o", o, (b, h, l, d)), ("w", w, (h, d, c)),
                                              ("residual", residual, (b, l, c))))
    if d % 8 or c % 8:
        raise ValueError(f"out_proj_packed: head dim {d} and channels {c} must be "
                         "multiples of 8")
    bias = _check_bias("out_proj_packed", bias, c, o.device)
    bn, splits = plan_out_proj(b, h, l, d, c)
    out = ws = None
    if splits > 1:
        ws = torch.empty((splits, b, l, c), dtype=torch.float32, device=o.device)
    else:
        out = torch.empty_like(residual)
    err = _out_proj_lib().out_proj_packed_launch(
        o.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        None if ws is not None else residual.data_ptr(),
        None if out is None else out.data_ptr(), None if ws is None else ws.data_ptr(),
        b, h, l, d, c, bn, splits, torch.cuda.current_stream(o.device).cuda_stream,
    )
    _build.check(err, "out_proj_packed")
    launch_counts["out_proj_packed"] += 1
    return out if ws is None else _splitk_call(ws, bias, residual, splits)


def out_proj_splitk_reduce(ws: torch.Tensor, bias: Optional[torch.Tensor],
                           residual: torch.Tensor) -> torch.Tensor:
    """Kernel G's split-K reduction alone: ws (S, B, L, C) float32, bias
    (C,) or None, residual (B, L, C) -> (B, L, C) in residual's dtype, as
    ``out_proj_splitk_reduce_plain``.  On the card: ws contiguous float32,
    residual contiguous bf16, C a multiple of 8."""
    if _on_cpu("out_proj_packed_splitk", ws):
        return out_proj_splitk_reduce_plain(ws, bias, residual)
    b, l, c = residual.shape
    _check_bf16("out_proj_packed_splitk", ws.device, (("residual", residual, (b, l, c)),))
    if (ws.dtype != torch.float32 or not ws.is_contiguous() or ws.dim() != 4
            or tuple(ws.shape[1:]) != (b, l, c) or ws.shape[0] < 1 or c % 8):
        raise ValueError(f"out_proj_packed_splitk: ws must be contiguous float32 (S, {b}, {l}, "
                         f"{c}) with {c} a multiple of 8, got {ws.dtype} {tuple(ws.shape)}")
    bias = _check_bias("out_proj_packed_splitk", bias, c, ws.device)
    return _splitk_call(ws, bias, residual, ws.shape[0])
