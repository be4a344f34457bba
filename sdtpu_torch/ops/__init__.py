"""Functional NN ops on torch tensors in the JAX package's layouts (NHWC
activations, HWIO conv kernels, (in, out) linear kernels); parameters are
plain dicts of tensors with the JAX package's keys."""

from sdtpu_torch.ops.activations import geglu, gelu_erf, gelu_tanh, quick_gelu, silu
from sdtpu_torch.ops.attention import (
    attention,
    init_attention,
    init_transformer_block,
    precompute_transformer_cross_kv,
    transformer_block,
)
from sdtpu_torch.ops.conv import conv1x1_tokens, conv2d, init_conv2d, nearest_up_conv2d
from sdtpu_torch.ops.embedding import embedding_lookup, init_embedding, timestep_embedding
from sdtpu_torch.ops.linear import init_linear, linear
from sdtpu_torch.ops.norm import group_norm, init_norm, layer_norm
from sdtpu_torch.ops.resize import nearest_upsample, resize_image

__all__ = [
    "attention",
    "conv1x1_tokens",
    "conv2d",
    "embedding_lookup",
    "geglu",
    "gelu_erf",
    "gelu_tanh",
    "group_norm",
    "init_attention",
    "init_conv2d",
    "init_embedding",
    "init_linear",
    "init_norm",
    "init_transformer_block",
    "layer_norm",
    "linear",
    "nearest_up_conv2d",
    "nearest_upsample",
    "precompute_transformer_cross_kv",
    "quick_gelu",
    "resize_image",
    "silu",
    "timestep_embedding",
    "transformer_block",
]
