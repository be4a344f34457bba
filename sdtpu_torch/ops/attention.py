"""Multi-head attention and the SD transformer block.

Counterpart of ``sdtpu/ops/attention.py``.  Latent self-attention
(``implementation="flash"``, non-causal, no context) runs through the flash
kernel with the head split done by the projections, which emit q/k/v
head-major at the real head dim.  Cross-attention to the 77 text tokens and
CLIP's causal attention stay dense: a matmul for the logits in float32, an
f32 softmax, the weights cast to v's dtype, and a float32-accumulated P.V.
Quantized projections (``utils/quant.py``) go through ``linear``'s int8
forms on both routes.

``implementation="xla"`` is the JAX package's dense route, the library's
attention: on a card ``F.scaled_dot_product_attention`` for every
non-causal call, on the CPU the dense form above.

``implementation="ring"`` is the JAX package's ring route: linear q/k/v,
then sequence-parallel ring attention over the active ``ring_context``
(``parallel/ring_attention.py``, kernel F on the card), else -- no context,
cross-attention, a token count the ring does not divide -- dense attention.

With ``SDTPU_PACKED_OUT_PROJ=1`` (read at import, as in the JAX package;
``_PACKED_OUT_PROJ`` may be set at run time) the flash route's float
out-projection and its residual add run as kernel G (``out_proj_packed``)
wherever a residual is given.  One difference by design: the JAX program
ignores the flag on the CPU, while the port runs G's plain version there,
so that the CPU tests drive the route.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

from sdtpu_torch.kernels.flash_attention import flash_attention_packed, out_proj_packed
from sdtpu_torch.kernels.rowwise import geglu_rows
from sdtpu_torch.ops.linear import init_linear, linear, linear_parts, linear_q8_dyn
from sdtpu_torch.ops.norm import init_norm, layer_norm
from sdtpu_torch.parallel.mesh import tp_of
from sdtpu_torch.parallel.ring_attention import maybe_ring_attention
from sdtpu_torch.utils import hostrng

_PACKED_OUT_PROJ = os.environ.get("SDTPU_PACKED_OUT_PROJ", "0") not in ("0", "false", "")


def attention(
    x: torch.Tensor,
    params: dict,
    *,
    num_heads: int,
    context: Optional[torch.Tensor] = None,
    causal: bool = False,
    implementation: str = "dense",
    kv_cache: Optional[dict] = None,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head (self or cross) attention; x: (B, Lq, D), context:
    (B, Lk, Dctx) or None.  ``kv_cache``: precomputed cross-attention
    ``{"k", "v"}`` (B, Lk, D), or this rank's columns of them under tp.
    ``residual`` is added to the output."""
    b, lq, d = x.shape
    if d % num_heads:
        raise ValueError(f"width {d} not divisible by {num_heads} heads")
    head_dim = d // num_heads
    heads = _Heads(params, num_heads, d)
    if implementation == "flash" and not causal and context is None:
        return _flash_attention_fused_projections(
            x, params, heads=heads, head_dim=head_dim, residual=residual)
    if implementation not in ("dense", "flash", "ring", "xla"):
        raise ValueError(f"unknown attention implementation {implementation!r}")

    ctx = x if context is None else context
    q = heads.fit(linear(x, params["q"])).reshape(b, lq, heads.n, head_dim)
    if kv_cache is not None:
        k, v = kv_cache["k"], kv_cache["v"]
    else:
        k, v = linear(ctx, params["k"]), linear(ctx, params["v"])
    k = heads.fit(k).reshape(b, k.shape[1], heads.n, head_dim)
    v = heads.fit(v).reshape(b, v.shape[1], heads.n, head_dim)
    out = None
    if implementation == "ring" and not causal:
        out = maybe_ring_attention(q, k, v)
    if out is None and implementation == "xla" and q.is_cuda and not causal:
        out = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)
    if out is None:
        out = _dense_attention(q, k, v, causal=causal)
    out = heads.unfit(out.reshape(b, lq, heads.n * head_dim), params["out"])
    out = linear(out, params["out"])
    return out if residual is None else residual + out


class _Heads:
    """The heads attention runs on.  Without tp: all of them.  Under tp
    (a projection of ``params`` holds a slice, ``parallel/mesh.py``): this
    rank's ``num_heads / tp`` where tp divides the heads, else all of them,
    q, k and v gathered over tp (the VAE's single head; GSPMD computes the
    same function).  :meth:`fit` brings a projection's output, full width
    or this rank's columns, to that layout; :meth:`unfit` brings o to what
    the out-projection takes."""

    def __init__(self, params: dict, num_heads: int, width: int):
        meshes = [tp_of(params.get(name)) for name in ("q", "k", "v", "out")]
        self.mesh = next((m for m in meshes if m is not None), None)
        self.width = width
        self.local = self.mesh is not None and num_heads % self.mesh.tp == 0
        self.n = num_heads // self.mesh.tp if self.local else num_heads

    def fit(self, t: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return t
        full = t.shape[-1] == self.width
        if self.local:
            return self.mesh.tp_local(t) if full else t
        return t if full else self.mesh.tp_gather(t)

    def unfit(self, o: torch.Tensor, po: dict) -> torch.Tensor:
        """o (..., n * head_dim): a replicated out-projection (int8) takes
        every head's columns; a row-parallel one cuts what it needs."""
        if self.local and getattr(po, "split", None) != "row":
            return self.mesh.tp_gather(o)
        return o


def _flash_attention_fused_projections(
    x: torch.Tensor, params: dict, *, heads: _Heads, head_dim: int,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Self-attention through the flash kernel: the q/k/v projections emit
    (B, H, L, Dh), the kernel returns (B, H, L, Dh), and the out-projection
    contracts heads and head dim with a (H, Dh, C) view of its kernel.
    Quantized q/k/v projections are ``linear_q8`` per output feature (the
    port keeps the real head dim, so there is no lane pad to keep zero).

    Under tp (``heads``) H is this rank's heads, and a row-parallel
    out-projection contracts them (or, where all heads ran here, this
    rank's columns of o as one head) into a partial sum -- kernel G with a
    zero residual and no bias under the packed flag, rounded once per rank
    -- then sums over tp, adds the bias, then the residual."""
    b, l, c = x.shape

    def head_proj(p):
        out = heads.fit(linear(x, p)).reshape(b, l, heads.n, head_dim)
        return out.permute(0, 2, 1, 3).contiguous()

    o = flash_attention_packed(head_proj(params["q"]), head_proj(params["k"]),
                               head_proj(params["v"]))
    po = params["out"]
    if "kernel_q" in po:
        # int8 out-projection with a run-time scale per (b, l) row over all
        # heads and lanes -- taken whenever the weight is int8, a calibrated
        # static scale included, as the JAX package's flash route does
        # (sdtpu/ops/attention.py:170-187)
        out = linear_q8_dyn(heads.unfit(o.permute(0, 2, 1, 3).reshape(b, l, -1), po), po)
        return out if residual is None else residual + out
    mesh = tp_of(po)
    if mesh is not None and not heads.local:
        o = mesh.tp_local(o.permute(0, 2, 1, 3).reshape(b, l, c))
        o = o.reshape(b, l, 1, -1).permute(0, 2, 1, 3).contiguous()
    wo = po["kernel"].to(x.dtype).reshape(o.shape[1], o.shape[3], c)
    if mesh is not None:
        if residual is not None and _PACKED_OUT_PROJ:
            out = out_proj_packed(o, wo, None, torch.zeros_like(residual))
        else:
            out = torch.einsum("bhld,hdc->blc", o, wo)
        out = mesh.tp_all_reduce(out)
        if "bias" in po:
            out = out + po["bias"].to(out.dtype)
        return out if residual is None else residual + out
    if residual is not None and _PACKED_OUT_PROJ:
        return out_proj_packed(o, wo, po.get("bias"), residual)
    out = torch.einsum("bhld,hdc->blc", o, wo)
    if "bias" in po:
        out = out + po["bias"].to(out.dtype)
    return out if residual is None else residual + out


def _dense_attention(q, k, v, *, causal: bool) -> torch.Tensor:
    """(B, L, H, Dh) inputs; f32 logits and softmax; P cast to v.dtype."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        lq, lk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((lq, lk), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def init_attention(
    key,
    dim: int,
    *,
    context_dim: Optional[int] = None,
    qkv_bias: bool = True,
    out_bias: bool = True,
    dtype=torch.float32,
) -> dict:
    ctx = dim if context_dim is None else context_dim
    kq, kk, kv, ko = hostrng.split(key, 4)
    return {
        "q": init_linear(kq, dim, dim, use_bias=qkv_bias, dtype=dtype),
        "k": init_linear(kk, ctx, dim, use_bias=qkv_bias, dtype=dtype),
        "v": init_linear(kv, ctx, dim, use_bias=qkv_bias, dtype=dtype),
        "out": init_linear(ko, dim, dim, use_bias=out_bias, dtype=dtype),
    }


def transformer_block(
    x: torch.Tensor,
    params: dict,
    *,
    num_heads: int,
    context: torch.Tensor,
    implementation: str = "dense",
    cross_kv: Optional[dict] = None,
    pag_tail: int = 0,
) -> torch.Tensor:
    """BasicTransformerBlock: LN -> self-attn -> LN -> cross-attn -> LN ->
    GeGLU feed-forward, each with its residual.

    ``pag_tail``: Perturbed-Attention Guidance's rows.  The last
    ``pag_tail`` rows take identity self-attention (each query attends to
    itself alone: ``x + out(v(h))``, through ``linear``, so with int8
    weights its static scale where one is calibrated); the head rows go
    through :func:`attention` as without it (on the flash route kernel C at
    the head's batch).  Cross-attention and the feed-forward take all rows.

    The LayerNorms and the feed-forward's bias + GeGLU are one kernel each on
    the card (``kernels/rowwise.py``); the projection's bias goes into
    ``geglu_rows`` where ``linear`` would add it after a plain matmul."""
    h = layer_norm(x, params["norm1"])
    if pag_tail:
        ident = linear(linear(h[-pag_tail:], params["attn1"]["v"]), params["attn1"]["out"])
        head = attention(h[:-pag_tail], params["attn1"], num_heads=num_heads,
                         implementation=implementation, residual=x[:-pag_tail])
        x = torch.cat([head, x[-pag_tail:] + ident])
    else:
        x = attention(h, params["attn1"], num_heads=num_heads,
                      implementation=implementation, residual=x)
    h = layer_norm(x, params["norm2"])
    x = attention(h, params["attn2"], num_heads=num_heads, context=context,
                  implementation=implementation, kv_cache=cross_kv, residual=x)
    h = layer_norm(x, params["norm3"])
    h = geglu_rows(*linear_parts(h, params["ff"]["proj"]))
    return x + linear(h, params["ff"]["out"])


def precompute_transformer_cross_kv(context: torch.Tensor, params: dict) -> dict:
    """Cross-attention K/V of one transformer block (constant over the
    denoise loop)."""
    return {
        "k": linear(context, params["attn2"]["k"]),
        "v": linear(context, params["attn2"]["v"]),
    }


def init_transformer_block(key, dim: int, *, context_dim: int, dtype=torch.float32) -> dict:
    mult = 4
    k1, k2, k3 = hostrng.split(key, 3)
    kp, ko = hostrng.split(k3)  # the GeGLU feed-forward's two linears
    return {
        "norm1": init_norm(dim, dtype=dtype),
        "attn1": init_attention(k1, dim, qkv_bias=False, dtype=dtype),
        "norm2": init_norm(dim, dtype=dtype),
        "attn2": init_attention(k2, dim, context_dim=context_dim,
                                qkv_bias=False, dtype=dtype),
        "norm3": init_norm(dim, dtype=dtype),
        "ff": {
            "proj": init_linear(kp, dim, 2 * mult * dim, dtype=dtype),
            "out": init_linear(ko, mult * dim, dim, dtype=dtype),
        },
    }
