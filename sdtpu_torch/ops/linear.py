"""Dense layer with (in, out) kernels, as the JAX package stores them."""

from __future__ import annotations

import torch


def linear(x: torch.Tensor, params: dict) -> torch.Tensor:
    out = torch.matmul(x, params["kernel"].to(x.dtype))
    bias = params.get("bias")
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def uniform(gen: torch.Generator, shape, dtype, bound: float) -> torch.Tensor:
    """U(-bound, bound) drawn in float32 on the generator's device."""
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (u * (2.0 * bound) - bound).to(dtype)


def init_linear(
    gen: torch.Generator,
    in_features: int,
    out_features: int,
    *,
    use_bias: bool = True,
    dtype=torch.float32,
) -> dict:
    """U(-1/sqrt(in), 1/sqrt(in)) kernel (in, out) and bias."""
    bound = in_features**-0.5
    params = {"kernel": uniform(gen, (in_features, out_features), dtype, bound)}
    if use_bias:
        params["bias"] = uniform(gen, (out_features,), dtype, bound)
    return params
