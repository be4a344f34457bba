"""Dense layer with (in, out) kernels, as the JAX package stores them, and
its int8 (W8A8) forms.

Counterpart of ``sdtpu/ops/linear.py``.  ``linear`` dispatches on the dict:
``kernel_q`` with ``act_scale`` is the static W8A8 :func:`linear_q8`,
``kernel_q`` alone the run-time-scaled :func:`linear_q8_dyn`; a
projection ``shard_params_tp`` split by rows reduces over tp.  The int8
products are exact integer sums (:func:`int8_matmul`), never accumulated in
a float type.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from sdtpu_torch.parallel.mesh import tp_of
from sdtpu_torch.utils import hostrng
from sdtpu_torch.utils.quant import quantize_act

_capture = threading.local()


@contextlib.contextmanager
def activation_capture(store: dict, site_by_kernel_id: dict):
    """Record per-feature input abs-max for selected linears (int8
    calibration, ``utils/calibrate.py``).

    ``site_by_kernel_id`` maps ``id(params["kernel"])`` -> site path;
    matched calls max-accumulate ``max |x|`` over all leading axes into
    ``store[path]``.  Eager only: a traced or compiled forward has no values
    and raises."""
    _capture.store = store
    _capture.sites = site_by_kernel_id
    try:
        yield store
    finally:
        _capture.store = None
        _capture.sites = None


def capturing_activations() -> bool:
    """Whether an :func:`activation_capture` block is open on this thread."""
    return bool(getattr(_capture, "sites", None))


def _maybe_capture(x: torch.Tensor, params: dict) -> None:
    sites = getattr(_capture, "sites", None)
    if not sites:
        return
    site = sites.get(id(params.get("kernel")))
    if site is None:
        return
    if torch.jit.is_tracing() or torch.compiler.is_compiling():
        raise RuntimeError(
            "activation_capture needs concrete values: run the forward "
            "eagerly during calibration")
    amax = x.detach().float().abs().amax(dim=tuple(range(x.ndim - 1))).cpu().numpy()
    store = _capture.store
    prev = store.get(site)
    store[site] = amax if prev is None else np.maximum(prev, amax)


def int8_matmul(q: torch.Tensor, kernel_q: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 @ (K, N) int8 -> (..., N) int32, exact.

    On the card this is cuBLAS's int8 GEMM (``torch._int_mm``: K and N
    multiples of 8; fewer than 17 rows are padded); the JAX package leaves
    the same product to XLA.  On the CPU the product runs in float64, whose
    53-bit mantissa holds every sum of |q| <= 128 terms exactly."""
    lead, k = q.shape[:-1], q.shape[-1]
    q2 = q.reshape(-1, k)
    if q.device.type == "cpu":
        return (q2.double() @ kernel_q.double()).to(torch.int32).reshape(*lead, -1)
    m = q2.shape[0]
    if m <= 16:
        q2 = torch.cat([q2, q2.new_zeros((17 - m, k))])
    out = torch._int_mm(q2.contiguous(), kernel_q.contiguous())[:m]
    return out.reshape(*lead, -1)


def linear(x: torch.Tensor, params: dict) -> torch.Tensor:
    out, bias = linear_parts(x, params)
    return out if bias is None else out + bias.to(out.dtype)


def linear_parts(x: torch.Tensor, params: dict):
    """``linear`` as ``(out, bias)``, ``out + bias.to(out.dtype)`` its
    result: where it ends in a plain bias add after ``torch.matmul`` (a
    float kernel, not row-parallel), ``out`` is the product and ``bias`` the
    bias (or None), for a caller that folds the add into its next pass;
    the int8 and row-parallel forms return their result and None."""
    _maybe_capture(x, params)
    mesh = tp_of(params)
    if mesh is not None and params.split == "row":
        return _row_parallel(x, params, mesh), None
    if "kernel_q" in params:
        if "act_scale" in params:
            return linear_q8(x, params), None
        return linear_q8_dyn(x, params), None
    return torch.matmul(x, params["kernel"].to(x.dtype)), params.get("bias")


def _row_parallel(x: torch.Tensor, params: dict, mesh) -> torch.Tensor:
    """A row-parallel projection (``parallel/mesh.py``): this rank's rows of
    the kernel against its columns of ``x`` (a full-width ``x``, from a
    replicated producer, is cut to them), the sum over tp, then the bias
    once."""
    kernel = params["kernel"]
    if x.shape[-1] != kernel.shape[0]:
        x = mesh.tp_local(x)
    out = mesh.tp_all_reduce(torch.matmul(x, kernel.to(x.dtype)))
    bias = params.get("bias")
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def linear_q8(x: torch.Tensor, params: dict) -> torch.Tensor:
    """W8A8 linear: quantize ``x`` with the dict's per-feature affine code,
    contract int8 x int8 -> int32, rescale per output feature, subtract the
    zero-point correction and add the bias, in float32, then cast."""
    acc = int8_matmul(quantize_act(x, params), params["kernel_q"])
    out = acc.float() * params["w_scale"].float()
    out = out - params["zp_corr"].float()
    bias = params.get("bias")
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def linear_q8_dyn(x: torch.Tensor, params: dict) -> torch.Tensor:
    """W8A8 linear with a run-time symmetric per-row scale: each row's
    abs-max maps to +-127 (so no clip), the int32 product is rescaled by
    the row scale and the per-output weight scale, then the bias."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) * (1.0 / 127.0)
    q = torch.round(xf / scale).to(torch.int8)
    acc = int8_matmul(q, params["kernel_q"])
    out = acc.float() * scale
    out = out * params["w_scale"].float()
    bias = params.get("bias")
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def uniform(key, shape, dtype, bound: float) -> torch.Tensor:
    """U(-bound, bound) drawn on the host from ``key``: a CPU tensor."""
    return hostrng.leaf(hostrng.uniform(key, shape, -bound, bound), dtype)


def init_linear(
    key,
    in_features: int,
    out_features: int,
    *,
    use_bias: bool = True,
    dtype=torch.float32,
) -> dict:
    """U(-1/sqrt(in), 1/sqrt(in)) kernel (in, out) and bias, from the key's
    two children as in the JAX package."""
    bound = in_features**-0.5
    k_key, b_key = hostrng.split(key)
    params = {"kernel": uniform(k_key, (in_features, out_features), dtype, bound)}
    if use_bias:
        params["bias"] = uniform(b_key, (out_features,), dtype, bound)
    return params
