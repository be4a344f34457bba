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
  once, read straight from the head-major attention output.

The JAX kernels pad the head dim to 128 lanes; here every tensor keeps the
real head dim, and the CUDA kernels (``csrc/flash_attention.cu``,
``csrc/out_proj_packed.cu``) pad the MMA depth inside shared memory only.
The probe kernels H and I (``sdtpu_torch/tools/probe_flash_vpu.py`` and
``probe_flash_2stream.py``) are modes of the same kernel template
(``csrc/flash_attention.cuh``) and use this module's helpers.
On the CPU each wrapper runs its plain version: the same function in
float32, with the probabilities rounded to v's dtype before the P.V
product as the TPU kernel rounds them.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from sdtpu_torch.kernels import _build, launch_counts


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


def _flash_lib():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [p] * 4 + [i] * 4 + [p]
        lib.flash_attention_launch.restype = i
        lib.flash_attention_stats_launch.argtypes = [p] * 6 + [i] * 4 + [p]
        lib.flash_attention_stats_launch.restype = i
        lib.flash_attention_legacy_launch.argtypes = [p] * 4 + [i] * 4 + [p]
        lib.flash_attention_legacy_launch.restype = i
        lib._typed = True
    return lib


def _out_proj_lib():
    lib = _build.load("out_proj_packed")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.out_proj_packed_launch.argtypes = [p] * 5 + [i] * 5 + [p]
        lib.out_proj_packed_launch.restype = i
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


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel C.  q (B, H, Lq, D), k/v (B, H, Lk, D) -> (B, H, Lq, D).

    On the card: bf16, contiguous, D a multiple of 8 and at most 512."""
    if _on_cpu("flash_attention", q):
        return flash_attention_plain(q, k, v)
    b, h, lq, lk, d = _check_qkv("flash_attention", q, k, v)
    out = torch.empty_like(q)
    err = _flash_lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b * h, lq, lk, d, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attention")
    launch_counts["flash_attention"] += 1
    return out


def flash_attention_stats_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Kernel F.  q (B, H, Lq, D), k/v (B, H, Lk, D) -> ``(out, m, l)``:
    out (B, H, Lq, D) in q's dtype, normalised over this KV block; m, l
    (B, H, Lq) float32.  On the card: as kernel C."""
    if _on_cpu("flash_attention_stats", q):
        return flash_attention_stats_plain(q, k, v)
    b, h, lq, lk, d = _check_qkv("flash_attention_stats", q, k, v)
    out = torch.empty_like(q)
    m = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    err = _flash_lib().flash_attention_stats_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), m.data_ptr(),
        l.data_ptr(), b * h, lq, lk, d, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attention_stats")
    launch_counts["flash_attention_stats"] += 1
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


def out_proj_packed(o: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                    residual: torch.Tensor) -> torch.Tensor:
    """Kernel G.  o (B, H, L, D), w (H, D, C), bias (C,) or None, residual
    (B, L, C) -> (B, L, C) in residual's dtype.

    On the card: o, w and residual bf16 and contiguous, D and C multiples
    of 8; the bias is taken as float32."""
    if _on_cpu("out_proj_packed", o):
        return out_proj_packed_plain(o, w, bias, residual)
    b, h, l, d = o.shape
    c = w.shape[-1]
    _check_bf16("out_proj_packed", o.device, (("o", o, (b, h, l, d)), ("w", w, (h, d, c)),
                                              ("residual", residual, (b, l, c))))
    if d % 8 or c % 8:
        raise ValueError(f"out_proj_packed: head dim {d} and channels {c} must be "
                         "multiples of 8")
    if bias is not None:
        if bias.device != o.device or tuple(bias.shape) != (c,):
            raise ValueError(f"out_proj_packed: bias must be ({c},) on {o.device}, got "
                             f"{tuple(bias.shape)} on {bias.device}")
        bias = bias.float().contiguous()
    out = torch.empty_like(residual)
    err = _out_proj_lib().out_proj_packed_launch(
        o.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        residual.data_ptr(), out.data_ptr(), b, h, l, d, c,
        torch.cuda.current_stream(o.device).cuda_stream,
    )
    _build.check(err, "out_proj_packed")
    launch_counts["out_proj_packed"] += 1
    return out
