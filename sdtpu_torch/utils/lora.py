"""LoRA adapters fused into the port's parameter tree.

Counterpart of ``sdtpu/utils/lora.py``: an adapter is fused into the base
weights (``W += scale * (alpha / r) * up @ down``), so a fused request runs
the same kernels at the same shapes as the base one, with no adapter
matmul per call.

Layouts (detected per key):

* **kohya / sd-scripts**: ``lora_unet_<name>.lora_down.weight`` /
  ``.lora_up.weight`` / ``.alpha`` with ``_``-separated module names; the
  text encoders as ``lora_te_`` (SD 1.x) or ``lora_te1_`` / ``lora_te2_``
  (SDXL); 3x3 conv adapters (LoCon) included.
* **diffusers / peft**: ``unet.<dotted>.lora_A.weight`` / ``.lora_B.weight``
  (A = down, B = up; alpha defaults to the rank), prefixes
  ``text_encoder.`` / ``text_encoder_2.``.

Names resolve by exact lookup in tables built from the tree itself
(``_index_unet``, ``_index_clip``, mirroring ``utils/weights.py``'s
state-dict mapping).  CLIP layers are stacked on a leading axis, so a
text-encoder delta lands in one row of the stacked leaf.

The arithmetic is the JAX package's, in numpy and in its order: each
target kernel is read to the host through float32 (exact from bf16 and
f16), the delta is ``(up @ down).T`` or ``einsum("or,rikl->oikl")`` times
``scale * alpha / rank``, the fused value ``target + delta`` in float32,
cast back to the leaf's dtype on the leaf's device (round to nearest even,
as ml_dtypes casts).  So a fused tree equals the JAX package's bitwise; a
torch matmul would differ in the last float32 bit.

The tree is never written in place: a fused kernel is a new tensor in a
copied container, and every other leaf is shared with the input tree,
which may be shared with the caller or another pipeline.  Fuse before
``quantize_int8``: an int8-quantized leaf raises.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from sdtpu_torch.utils.quant import _host as host_f32  # float32 numpy; bf16 widens exactly

# ---------------------------------------------------------------------------
# parameter-tree module tables
# ---------------------------------------------------------------------------


def _index_unet(unet: dict) -> dict:
    """``underscored diffusers module name -> (leaf dict, None)`` for every
    LoRA-targetable UNet module (mirrors
    ``weights.unet_params_from_state_dict``)."""
    idx: dict = {}

    def add(name: str, leaf: dict) -> None:
        idx[name.replace(".", "_")] = (leaf, None)

    def resnet(r: dict, p: str) -> None:
        add(f"{p}.conv1", r["conv1"])
        add(f"{p}.conv2", r["conv2"])
        if "time_emb_proj" in r:
            add(f"{p}.time_emb_proj", r["time_emb_proj"])
        if "conv_shortcut" in r:
            add(f"{p}.conv_shortcut", r["conv_shortcut"])

    def attn_block(a: dict, p: str) -> None:
        add(f"{p}.proj_in", a["proj_in"])
        add(f"{p}.proj_out", a["proj_out"])
        for k, blk in enumerate(a["blocks"]):
            bp = f"{p}.transformer_blocks.{k}"
            for an in ("attn1", "attn2"):
                at = blk[an]
                add(f"{bp}.{an}.to_q", at["q"])
                add(f"{bp}.{an}.to_k", at["k"])
                add(f"{bp}.{an}.to_v", at["v"])
                add(f"{bp}.{an}.to_out.0", at["out"])
            add(f"{bp}.ff.net.0.proj", blk["ff"]["proj"])
            add(f"{bp}.ff.net.2", blk["ff"]["out"])

    add("conv_in", unet["conv_in"])
    te = unet["time_embedding"]
    add("time_embedding.linear_1", te["linear_1"])
    add("time_embedding.linear_2", te["linear_2"])
    if "cond_proj" in te:
        add("time_embedding.cond_proj", te["cond_proj"])
    if "add_embedding" in unet:
        add("add_embedding.linear_1", unet["add_embedding"]["linear_1"])
        add("add_embedding.linear_2", unet["add_embedding"]["linear_2"])
    for i, b in enumerate(unet["down_blocks"]):
        for j, r in enumerate(b["resnets"]):
            resnet(r, f"down_blocks.{i}.resnets.{j}")
        for j, a in enumerate(b.get("attentions", ())):
            attn_block(a, f"down_blocks.{i}.attentions.{j}")
        if "downsample" in b:
            add(f"down_blocks.{i}.downsamplers.0.conv", b["downsample"])
    if "mid_block" in unet:
        for j, r in enumerate(unet["mid_block"]["resnets"]):
            resnet(r, f"mid_block.resnets.{j}")
        for j, a in enumerate(unet["mid_block"].get("attentions", ())):
            attn_block(a, f"mid_block.attentions.{j}")
    for i, b in enumerate(unet["up_blocks"]):
        for j, r in enumerate(b["resnets"]):
            resnet(r, f"up_blocks.{i}.resnets.{j}")
        for j, a in enumerate(b.get("attentions", ())):
            attn_block(a, f"up_blocks.{i}.attentions.{j}")
        if "upsample" in b:
            add(f"up_blocks.{i}.upsamplers.0.conv", b["upsample"])
    add("conv_out", unet["conv_out"])
    return idx


def _index_clip(clip: dict) -> dict:
    """``underscored HF module name -> (stacked leaf dict, layer index)``:
    the layer index selects the row of the stacked leaf that the delta
    lands in."""
    idx: dict = {}
    layers = clip["layers"]
    num_layers = int(layers["norm1"]["scale"].shape[0])
    for i in range(num_layers):
        p = f"text_model.encoder.layers.{i}"
        for hf, leaf in (
            (f"{p}.self_attn.q_proj", layers["attn"]["q"]),
            (f"{p}.self_attn.k_proj", layers["attn"]["k"]),
            (f"{p}.self_attn.v_proj", layers["attn"]["v"]),
            (f"{p}.self_attn.out_proj", layers["attn"]["out"]),
            (f"{p}.mlp.fc1", layers["mlp"]["fc1"]),
            (f"{p}.mlp.fc2", layers["mlp"]["fc2"]),
        ):
            idx[hf.replace(".", "_")] = (leaf, i)
    return idx


def _tables(tree: dict) -> dict:
    tables = {"unet": _index_unet(tree["unet"])}
    for tag in ("clip", "clip_2"):
        if tag in tree:
            tables[tag] = _index_clip(tree[tag])
    return tables


def _copy_containers(tree):
    """Copy every dict and list node and share the leaves: the fuse then
    replaces entries of leaf dicts without touching the caller's tree."""
    if isinstance(tree, dict):
        return {k: _copy_containers(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy_containers(v) for v in tree)
    return tree


# ---------------------------------------------------------------------------
# checkpoint-key parsing
# ---------------------------------------------------------------------------

_KOHYA_PREFIXES = (
    ("lora_unet_", "unet"),
    ("lora_te1_", "clip"),
    ("lora_te2_", "clip_2"),
    ("lora_te_", "clip"),
)
_PEFT_PREFIXES = (
    ("unet.", "unet"),
    ("text_encoder_2.", "clip_2"),
    ("text_encoder.", "clip"),
)
_PEFT_SUFFIXES = (
    (".lora_A.weight", "down"),
    (".lora_B.weight", "up"),
    (".lora_A.default.weight", "down"),
    (".lora_B.default.weight", "up"),
    (".lora.down.weight", "down"),
    (".lora.up.weight", "up"),
    (".alpha", "alpha"),
)
_KOHYA_SUFFIXES = (
    (".lora_down.weight", "down"),
    (".lora_up.weight", "up"),
    (".alpha", "alpha"),
)


def _parse_lora_sd(sd: Mapping) -> Tuple[dict, list]:
    """Group raw checkpoint keys into
    ``(model_tag, underscored_name) -> {down, up, alpha}``."""
    groups: dict = {}
    unrecognized: list = []
    for key, val in sd.items():
        tag = name = part = None
        for prefix, t in _KOHYA_PREFIXES:
            if key.startswith(prefix):
                rest = key[len(prefix):]
                for suffix, p in _KOHYA_SUFFIXES:
                    if rest.endswith(suffix):
                        tag, part = t, p
                        name = rest[: -len(suffix)]
                        break
                break
        if tag is None:
            for prefix, t in _PEFT_PREFIXES:
                if key.startswith(prefix):
                    rest = key[len(prefix):]
                    for suffix, p in _PEFT_SUFFIXES:
                        if rest.endswith(suffix):
                            tag, part = t, p
                            name = rest[: -len(suffix)].replace(".", "_")
                            break
                    break
        if tag is None:
            unrecognized.append(key)
            continue
        groups.setdefault((tag, name), {})[part] = val
    return groups, unrecognized


# ---------------------------------------------------------------------------
# fusion
# ---------------------------------------------------------------------------


def _delta_for_leaf(kernel: np.ndarray, down: np.ndarray, up: np.ndarray,
                    name: str) -> np.ndarray:
    """The fused delta in this tree's kernel convention ((I, O) linears,
    (kh, kw, I, O) convs) from torch's (O, I) / (O, I, kh, kw) LoRA pair,
    in float32 numpy."""
    if kernel.ndim in (2, 3):  # linear (or stacked linear)
        # 1x1-conv-shaped factors (proj_in/proj_out LoCon) squeeze to 2-D
        if down.ndim == 4:
            down = down[:, :, 0, 0]
        if up.ndim == 4:
            up = up[:, :, 0, 0]
        return (up @ down).T  # (I, O)
    if kernel.ndim == 4:  # conv (kh, kw, I, O)
        kh, kw, ci, _ = kernel.shape
        if down.ndim == 2:  # flattened LoCon down: (r, I*kh*kw)
            down = down.reshape(down.shape[0], ci, kh, kw)
        if up.ndim == 4:
            up = up[:, :, 0, 0]
        delta = np.einsum("or,rikl->oikl", up, down)
        return delta.transpose(2, 3, 1, 0)
    raise ValueError(f"unsupported kernel rank {kernel.ndim} for {name}")


def apply_lora(params: dict, lora_sd: Mapping, *, scale: float = 1.0) -> Tuple[dict, dict]:
    """Fuse a LoRA state dict (tensors or numpy arrays, any float dtype)
    into a parameter tree.

    Returns ``(new_params, report)``; the input tree is not modified and
    every leaf but the fused kernels is shared.  ``report``: ``applied``
    (modules fused), ``skipped`` (parsed but matching no module of this
    architecture, an incomplete pair or a shape mismatch), ``unrecognized``
    (raw keys of no known layout) and ``originals``: ``(tag, name) ->`` the
    pre-fuse kernel (a row of a stacked CLIP leaf) as a tensor in its dtype
    on its device, what :func:`restore_weights` puts back."""
    new = _copy_containers(params)
    tables = _tables(new)
    groups, unrecognized = _parse_lora_sd(lora_sd)
    applied = 0
    skipped: list = []
    originals: dict = {}
    for (tag, name), g in sorted(groups.items()):
        table = tables.get(tag)
        hit = table.get(name) if table is not None else None
        if hit is None:
            skipped.append(f"{tag}:{name}")
            continue
        if "down" not in g or "up" not in g:
            skipped.append(f"{tag}:{name} (incomplete pair)")
            continue
        leaf, layer_idx = hit
        if "kernel" not in leaf:
            raise ValueError(
                f"{tag}:{name} is int8-quantized — apply LoRA before "
                "quantize_int8() (fusing into quantized weights would "
                "skip requantization)"
            )
        kernel = leaf["kernel"]
        # a stacked row is cloned: a view would keep the whole old leaf alive
        original = kernel[layer_idx].clone() if layer_idx is not None else kernel
        originals.setdefault((tag, name), original)
        target = host_f32(original)
        rank = int(g["down"].shape[0])
        alpha = float(host_f32(g["alpha"])) if "alpha" in g else float(rank)
        delta = _delta_for_leaf(target, host_f32(g["down"]), host_f32(g["up"]), name)
        delta = delta * (scale * alpha / rank)
        if delta.shape != target.shape:
            skipped.append(f"{tag}:{name} (shape {delta.shape} vs {target.shape})")
            continue
        fused = torch.from_numpy(np.ascontiguousarray(target + delta)).to(
            kernel.device).to(kernel.dtype)
        if layer_idx is not None:
            out = kernel.clone()
            out[layer_idx] = fused
            leaf["kernel"] = out
        else:
            leaf["kernel"] = fused
        applied += 1
    return new, {
        "applied": applied,
        "skipped": skipped,
        "unrecognized": unrecognized,
        # putting these back is exact; subtracting the delta again would
        # leave a bf16 rounding residue per fused adapter
        "originals": originals,
    }


def restore_weights(params: dict, originals: Mapping) -> dict:
    """Undo LoRA fusion exactly: a new tree with the pre-fuse kernels of
    ``apply_lora``'s report (``originals``) put back, every other leaf
    shared."""
    new = _copy_containers(params)
    tables = _tables(new)
    for (tag, name), orig in originals.items():
        leaf, layer_idx = tables[tag][name]
        if layer_idx is None:
            leaf["kernel"] = orig
        else:
            k = leaf["kernel"].clone()
            k[layer_idx] = orig
            leaf["kernel"] = k
    return new
