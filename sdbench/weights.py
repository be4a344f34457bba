"""Weights made on the card from ``--seed`` in a few large draws.

The tree has the served layout (``zero_pipeline_params``' shapes and
dtypes).  Each leaf follows the per-leaf rule of the program's seeded
initialisation: a conv or linear kernel and its bias U(-1/sqrt(fan_in),
1/sqrt(fan_in)) with fan_in = kh * kw * in (a stacked encoder layer's
kernel: its own in), a norm's scale 1 and bias 0, the token embedding
N(0, 1) * 0.02 and the position embedding N(0, 1) * 0.01.  All uniform
leaves of one dtype are views of one buffer filled by one call, every leaf
at a 256-byte aligned offset, then each is scaled in place."""

from __future__ import annotations

import math

import torch

_ALIGN = 256


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _rule(path, leaf, siblings) -> tuple:
    """("uniform", bound) | ("normal", std) | ("ones",) | ("zeros",)."""
    name = path[-1]
    if name == "weight" and path[-2] == "token_embedding":
        return ("normal", 0.02)
    if name == "position_embedding":
        return ("normal", 0.01)
    if name == "scale":
        return ("ones",)
    if name == "bias" and "scale" in siblings:
        return ("zeros",)
    kernel = leaf if name == "kernel" else siblings.get("kernel")
    if kernel is None:
        raise ValueError(f"no rule for the leaf {'/'.join(map(str, path))}")
    shape = kernel.shape
    fan_in = math.prod(shape[:3]) if len(shape) == 4 else shape[-2]
    return ("uniform", fan_in ** -0.5)


def _parent(tree, path):
    for k in path[:-1]:
        tree = tree[k]
    return tree


def _set(tree, path, value):
    _parent(tree, path)[path[-1]] = value


def make_params(shapes: dict, seed: int, device) -> dict:
    """Fill a tree of meta (or any) tensors with the rule's values on
    ``device``, drawn from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    leaves = []
    for path, leaf in _leaves(shapes):
        sib = _parent(shapes, path)
        leaves.append((path, leaf, _rule(path, leaf, sib if isinstance(sib, dict) else {})))
    out = _copy_structure(shapes)
    for kind in ("uniform", "normal"):
        by_dtype = {}
        for path, leaf, rule in leaves:
            if rule[0] == kind:
                by_dtype.setdefault(leaf.dtype, []).append((path, leaf, rule))
        for dtype, group in by_dtype.items():
            per = max(1, _ALIGN // torch.empty((), dtype=dtype).element_size())
            offsets, total = [], 0
            for _, leaf, _ in group:
                offsets.append(total)
                total += -(-leaf.numel() // per) * per
            buf = torch.empty(total, dtype=dtype, device=device)
            if kind == "uniform":
                buf.uniform_(-1.0, 1.0, generator=gen)
            else:
                buf.normal_(generator=gen)
            for off, (path, leaf, rule) in zip(offsets, group):
                t = buf[off:off + leaf.numel()].view(leaf.shape)
                t.mul_(rule[1])
                _set(out, path, t)
    for path, leaf, rule in leaves:
        if rule[0] in ("ones", "zeros"):
            fill = torch.ones if rule[0] == "ones" else torch.zeros
            _set(out, path, fill(leaf.shape, dtype=leaf.dtype, device=device))
    return out


def _copy_structure(tree):
    if isinstance(tree, dict):
        return {k: _copy_structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy_structure(v) for v in tree]
    return None


def pipeline_params(config, seed: int, device) -> dict:
    """The served tree of ``config`` (a ``PipelineConfig``), made from ``seed``."""
    from sdtpu_torch.utils import hostrng
    from sdtpu_torch.utils.weights import init_pipeline_params

    with hostrng.shapes_only():
        shapes = init_pipeline_params(0, config, device="meta")
    return make_params(shapes, seed, device)
