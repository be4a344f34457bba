"""Non-causal flash attention over head-major tensors.

Counterpart of ``sdtpu/kernels/flash_attention.py:flash_attention_packed``
(and its ``(B, L, H, D)`` entry ``flash_attention``).  The JAX kernel pads
the head dim to 128 lanes; here q/k/v/out keep the real head dim, and the
CUDA kernel (``csrc/flash_attention.cu``) pads the MMA depth inside shared
memory only.  On the CPU the wrapper runs ``flash_attention_plain``: the
same function in float32, with the probabilities rounded to v's dtype
before the P.V product as the TPU kernel rounds them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sdtpu_torch.kernels import _build, launch_counts


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over (B, H, L, D) tensors, f32 softmax,
    P cast to v.dtype before P.V, rows with no mass -> 0."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return torch.where(l == 0, torch.zeros_like(acc), acc / l).to(q.dtype)


def _lib():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        p = ctypes.c_void_p
        lib.flash_attention_launch.argtypes = [p] * 4 + [ctypes.c_int] * 4 + [p]
        lib.flash_attention_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q (B, H, Lq, D), k/v (B, H, Lk, D) -> (B, H, Lq, D).

    On the card: bf16, contiguous, D a multiple of 8 and at most 512."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    for name, t, shape in (("q", q, (b, h, lq, d)), ("k", k, (b, h, lk, d)),
                           ("v", v, (b, h, lk, d))):
        if (t.device != q.device or t.dtype != torch.bfloat16
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"flash_attention: {name} must be contiguous bf16 {shape} on "
                f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if d % 8 or d > 512:
        raise ValueError(f"flash_attention: head dim {d} must be a multiple of 8, <= 512")
    out = torch.empty_like(q)
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b * h, lq, lk, d, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attention")
    launch_counts["flash_attention"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over (B, L, H, D) tensors."""
    def prep(t):
        return t.permute(0, 2, 1, 3).contiguous()

    return flash_attention_packed(prep(q), prep(k), prep(v)).permute(0, 2, 1, 3)
