"""Parameter trees for the port: diffusers checkpoints, conversion from the
JAX package's tree, and seeded random initialization.

The port's parameters are the JAX package's tree with the same keys and
layouts (NHWC/HWIO/(in, out)), as nested dicts and lists of tensors, so a
JAX tree converts leaf by leaf with no transposes.

Counterpart of ``sdtpu/utils/weights.py`` for checkpoints: a diffusers /
HF state dict (``.safetensors`` read by ``utils/native_safetensors.py``, or
any mapping of names to tensors or numpy arrays) maps onto the tree with
the layout changes done on the host, each result contiguous:

* conv ``(O, I, kh, kw)`` -> HWIO ``(kh, kw, I, O)``;
* linear ``(O, I)`` -> ``(I, O)``;
* a 1x1 conv used as a projection (Transformer2D proj_in/out, the VAE mid
  attention of older checkpoints) -> a linear ``(I, O)``.

``save_converted`` / ``load_converted`` cache a converted tree as one
safetensors file (the port's own writer, ``save_safetensors``), each leaf
under its tree path.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from sdtpu_torch.config import CLIPConfig, PipelineConfig, UNetConfig, VAEConfig
from sdtpu_torch.utils import hostrng

# ---------------------------------------------------------------------------
# Tensor-level transforms
# ---------------------------------------------------------------------------


def _t(x) -> torch.Tensor:
    return x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def conv_kernel(t) -> torch.Tensor:
    """(O, I, kh, kw) -> (kh, kw, I, O), contiguous."""
    return _t(t).permute(2, 3, 1, 0).contiguous()


def linear_kernel(t) -> torch.Tensor:
    """(O, I) -> (I, O), contiguous."""
    return _t(t).t().contiguous()


def proj_kernel(t) -> torch.Tensor:
    """A 1x1 conv (O, I, 1, 1) or a linear (O, I) -> a linear (I, O)."""
    a = _t(t)
    if a.ndim == 4:
        a = a[:, :, 0, 0]
    return a.t().contiguous()


def _norm(sd: Mapping, prefix: str) -> dict:
    return {"scale": _t(sd[prefix + ".weight"]), "bias": _t(sd[prefix + ".bias"])}


def _lin(sd: Mapping, prefix: str) -> dict:
    p = {"kernel": linear_kernel(sd[prefix + ".weight"])}
    if prefix + ".bias" in sd:
        p["bias"] = _t(sd[prefix + ".bias"])
    return p


def _conv(sd: Mapping, prefix: str) -> dict:
    return {"kernel": conv_kernel(sd[prefix + ".weight"]), "bias": _t(sd[prefix + ".bias"])}


def _proj(sd: Mapping, prefix: str) -> dict:
    p = {"kernel": proj_kernel(sd[prefix + ".weight"])}
    if prefix + ".bias" in sd:
        p["bias"] = _t(sd[prefix + ".bias"])
    return p


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# CLIP text encoder (HF transformers CLIPTextModel state dict)
# ---------------------------------------------------------------------------


def clip_params_from_state_dict(sd: Mapping, config: CLIPConfig) -> dict:
    """``text_model.*`` keys -> the :func:`sdtpu_torch.models.clip` tree
    (layers stacked); keys without the ``text_model.`` prefix are accepted."""
    if not any(k.startswith("text_model.") for k in sd):
        sd = {(k if k == "text_projection.weight" else f"text_model.{k}"): v
              for k, v in sd.items()}

    def layer(i: int) -> dict:
        p = f"text_model.encoder.layers.{i}"
        return {
            "norm1": _norm(sd, f"{p}.layer_norm1"),
            "attn": {
                "q": _lin(sd, f"{p}.self_attn.q_proj"),
                "k": _lin(sd, f"{p}.self_attn.k_proj"),
                "v": _lin(sd, f"{p}.self_attn.v_proj"),
                "out": _lin(sd, f"{p}.self_attn.out_proj"),
            },
            "norm2": _norm(sd, f"{p}.layer_norm2"),
            "mlp": {"fc1": _lin(sd, f"{p}.mlp.fc1"), "fc2": _lin(sd, f"{p}.mlp.fc2")},
        }

    params = {
        "token_embedding": {"weight": _t(sd["text_model.embeddings.token_embedding.weight"])},
        "position_embedding": _t(sd["text_model.embeddings.position_embedding.weight"]),
        "layers": _stack([layer(i) for i in range(config.num_layers)]),
        "final_norm": _norm(sd, "text_model.final_layer_norm"),
    }
    if config.projection_dim is not None:
        params["text_projection"] = {"kernel": linear_kernel(sd["text_projection.weight"])}
    return params


# ---------------------------------------------------------------------------
# UNet (diffusers UNet2DConditionModel state dict)
# ---------------------------------------------------------------------------


def _resnet_from_sd(sd: Mapping, p: str) -> dict:
    params = {
        "norm1": _norm(sd, f"{p}.norm1"),
        "conv1": _conv(sd, f"{p}.conv1"),
        "time_emb_proj": _lin(sd, f"{p}.time_emb_proj"),
        "norm2": _norm(sd, f"{p}.norm2"),
        "conv2": _conv(sd, f"{p}.conv2"),
    }
    if f"{p}.conv_shortcut.weight" in sd:
        params["conv_shortcut"] = _conv(sd, f"{p}.conv_shortcut")
    return params


def _vae_resnet_from_sd(sd: Mapping, p: str) -> dict:
    params = {
        "norm1": _norm(sd, f"{p}.norm1"),
        "conv1": _conv(sd, f"{p}.conv1"),
        "norm2": _norm(sd, f"{p}.norm2"),
        "conv2": _conv(sd, f"{p}.conv2"),
    }
    if f"{p}.conv_shortcut.weight" in sd:
        params["conv_shortcut"] = _conv(sd, f"{p}.conv_shortcut")
    return params


def _transformer_block_from_sd(sd: Mapping, p: str) -> dict:
    def attn(ap: str) -> dict:
        return {"q": _lin(sd, f"{ap}.to_q"), "k": _lin(sd, f"{ap}.to_k"),
                "v": _lin(sd, f"{ap}.to_v"), "out": _lin(sd, f"{ap}.to_out.0")}

    return {
        "norm1": _norm(sd, f"{p}.norm1"),
        "attn1": attn(f"{p}.attn1"),
        "norm2": _norm(sd, f"{p}.norm2"),
        "attn2": attn(f"{p}.attn2"),
        "norm3": _norm(sd, f"{p}.norm3"),
        "ff": {"proj": _lin(sd, f"{p}.ff.net.0.proj"), "out": _lin(sd, f"{p}.ff.net.2")},
    }


def _attn_block_from_sd(sd: Mapping, p: str) -> dict:
    blocks = []
    i = 0
    while f"{p}.transformer_blocks.{i}.norm1.weight" in sd:
        blocks.append(_transformer_block_from_sd(sd, f"{p}.transformer_blocks.{i}"))
        i += 1
    return {
        "norm": _norm(sd, f"{p}.norm"),
        "proj_in": _proj(sd, f"{p}.proj_in"),
        "blocks": blocks,
        "proj_out": _proj(sd, f"{p}.proj_out"),
    }


def _unet_encoder_from_sd(sd: Mapping, config: UNetConfig) -> dict:
    """The encoder half that the UNet and its ControlNet copy share:
    conv_in, the time (and SDXL add-) embeddings, the down blocks, the mid
    block."""
    params = {
        "conv_in": _conv(sd, "conv_in"),
        "time_embedding": {
            "linear_1": _lin(sd, "time_embedding.linear_1"),
            "linear_2": _lin(sd, "time_embedding.linear_2"),
        },
    }
    if "time_embedding.cond_proj.weight" in sd:
        params["time_embedding"]["cond_proj"] = _lin(sd, "time_embedding.cond_proj")
    if config.addition_embed_dim is not None and "add_embedding.linear_1.weight" in sd:
        params["add_embedding"] = {"linear_1": _lin(sd, "add_embedding.linear_1"),
                                   "linear_2": _lin(sd, "add_embedding.linear_2")}

    down_blocks = []
    for level in range(config.num_levels):
        p = f"down_blocks.{level}"
        block = {"resnets": [_resnet_from_sd(sd, f"{p}.resnets.{j}")
                             for j in range(config.layers_per_block)]}
        if config.attention_levels[level]:
            block["attentions"] = [_attn_block_from_sd(sd, f"{p}.attentions.{j}")
                                   for j in range(config.layers_per_block)]
        if f"{p}.downsamplers.0.conv.weight" in sd:
            block["downsample"] = _conv(sd, f"{p}.downsamplers.0.conv")
        down_blocks.append(block)
    params["down_blocks"] = down_blocks

    if config.mid_block:
        params["mid_block"] = {
            "resnets": [_resnet_from_sd(sd, "mid_block.resnets.0"),
                        _resnet_from_sd(sd, "mid_block.resnets.1")],
            "attentions": [_attn_block_from_sd(sd, "mid_block.attentions.0")],
        }
    return params


def unet_params_from_state_dict(sd: Mapping, config: UNetConfig) -> dict:
    params = _unet_encoder_from_sd(sd, config)

    up_blocks = []
    for rev in range(config.num_levels):
        level = config.num_levels - 1 - rev
        p = f"up_blocks.{rev}"
        block = {"resnets": [_resnet_from_sd(sd, f"{p}.resnets.{j}")
                             for j in range(config.layers_per_block + 1)]}
        if config.attention_levels[level]:
            block["attentions"] = [_attn_block_from_sd(sd, f"{p}.attentions.{j}")
                                   for j in range(config.layers_per_block + 1)]
        if f"{p}.upsamplers.0.conv.weight" in sd:
            block["upsample"] = _conv(sd, f"{p}.upsamplers.0.conv")
        up_blocks.append(block)
    params["up_blocks"] = up_blocks
    params["norm_out"] = _norm(sd, "conv_norm_out")
    params["conv_out"] = _conv(sd, "conv_out")
    return params


# ---------------------------------------------------------------------------
# ControlNet (diffusers ControlNetModel state dict)
# ---------------------------------------------------------------------------


def controlnet_params_from_state_dict(sd: Mapping, config: UNetConfig) -> dict:
    """A diffusers ``ControlNetModel`` state dict -> the
    ``models/controlnet.py`` tree.  ``config`` is the base model's UNet
    config, which the encoder copy shares.  Its own keys:
    ``controlnet_cond_embedding.{conv_in, blocks.N, conv_out}``,
    ``controlnet_down_blocks.N`` (a zero conv per saved skip),
    ``controlnet_mid_block``."""
    params = _unet_encoder_from_sd(sd, config)
    zero_convs = []
    while f"controlnet_down_blocks.{len(zero_convs)}.weight" in sd:
        zero_convs.append(_conv(sd, f"controlnet_down_blocks.{len(zero_convs)}"))
    if not zero_convs:
        raise KeyError("no controlnet_down_blocks.* keys — not a ControlNetModel state_dict")
    params["zero_convs"] = zero_convs
    if config.mid_block:
        params["zero_conv_mid"] = _conv(sd, "controlnet_mid_block")
    blocks = []
    while f"controlnet_cond_embedding.blocks.{len(blocks)}.weight" in sd:
        blocks.append(_conv(sd, f"controlnet_cond_embedding.blocks.{len(blocks)}"))
    params["cond_embedding"] = {
        "conv_in": _conv(sd, "controlnet_cond_embedding.conv_in"),
        "blocks": blocks,
        "conv_out": _conv(sd, "controlnet_cond_embedding.conv_out"),
    }
    return params


def load_controlnet_params(path: str, config: UNetConfig, *, dtype=None,
                           device="cuda") -> dict:
    """A diffusers ControlNet from a safetensors file or a model directory
    holding one (e.g. ``lllyasviel/sd-controlnet-canny``), read in place by
    the native reader; floating leaves cast to ``dtype`` where given, each
    leaf an owned copy on ``device``."""
    from sdtpu_torch.utils.native_safetensors import NativeSafetensors

    if os.path.isdir(path):
        path = _find_weight_file(path)
    with NativeSafetensors(path) as f:
        sd = f.state_dict()
        out = cast_tree(controlnet_params_from_state_dict(sd, config), dtype, device)
        del sd
    return out


# ---------------------------------------------------------------------------
# VAE (diffusers AutoencoderKL state dict)
# ---------------------------------------------------------------------------


def _vae_mid_from_sd(sd: Mapping, p: str) -> dict:
    # newer diffusers: attentions.0.{to_q,to_k,to_v,to_out.0,group_norm};
    # older: {query,key,value,proj_attn,norm}
    ap = f"{p}.attentions.0"
    if f"{ap}.to_q.weight" in sd:
        attn = {"q": _proj(sd, f"{ap}.to_q"), "k": _proj(sd, f"{ap}.to_k"),
                "v": _proj(sd, f"{ap}.to_v"), "out": _proj(sd, f"{ap}.to_out.0")}
        norm = _norm(sd, f"{ap}.group_norm")
    else:
        attn = {"q": _proj(sd, f"{ap}.query"), "k": _proj(sd, f"{ap}.key"),
                "v": _proj(sd, f"{ap}.value"), "out": _proj(sd, f"{ap}.proj_attn")}
        norm = _norm(sd, f"{ap}.norm")
    return {
        "resnets": [_vae_resnet_from_sd(sd, f"{p}.resnets.0"),
                    _vae_resnet_from_sd(sd, f"{p}.resnets.1")],
        "attention": {"norm": norm, "attn": attn},
    }


def vae_encoder_params_from_state_dict(sd: Mapping, config: VAEConfig) -> dict:
    params = {"conv_in": _conv(sd, "encoder.conv_in")}
    down_blocks = []
    for level in range(len(config.block_out_channels)):
        p = f"encoder.down_blocks.{level}"
        block = {"resnets": [_vae_resnet_from_sd(sd, f"{p}.resnets.{j}")
                             for j in range(config.layers_per_block)]}
        if f"{p}.downsamplers.0.conv.weight" in sd:
            block["downsample"] = _conv(sd, f"{p}.downsamplers.0.conv")
        down_blocks.append(block)
    params["down_blocks"] = down_blocks
    params["mid_block"] = _vae_mid_from_sd(sd, "encoder.mid_block")
    params["norm_out"] = _norm(sd, "encoder.conv_norm_out")
    params["conv_out"] = _conv(sd, "encoder.conv_out")
    params["quant_conv"] = _conv(sd, "quant_conv")
    return params


def vae_decoder_params_from_state_dict(sd: Mapping, config: VAEConfig) -> dict:
    params = {
        "post_quant_conv": _conv(sd, "post_quant_conv"),
        "conv_in": _conv(sd, "decoder.conv_in"),
        "mid_block": _vae_mid_from_sd(sd, "decoder.mid_block"),
    }
    up_blocks = []
    for rev in range(len(config.block_out_channels)):
        p = f"decoder.up_blocks.{rev}"
        block = {"resnets": [_vae_resnet_from_sd(sd, f"{p}.resnets.{j}")
                             for j in range(config.layers_per_block + 1)]}
        if f"{p}.upsamplers.0.conv.weight" in sd:
            block["upsample"] = _conv(sd, f"{p}.upsamplers.0.conv")
        up_blocks.append(block)
    params["up_blocks"] = up_blocks
    params["norm_out"] = _norm(sd, "decoder.conv_norm_out")
    params["conv_out"] = _conv(sd, "decoder.conv_out")
    return params


# ---------------------------------------------------------------------------
# Safetensors / directory loading
# ---------------------------------------------------------------------------


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file as an owned CPU tensor, by
    the native reader (built on first use; a failed build raises)."""
    from sdtpu_torch.utils import native_safetensors

    return native_safetensors.load(path)


def _find_weight_file(dirpath: str) -> str:
    for n in ("diffusion_pytorch_model.safetensors", "model.safetensors"):
        p = os.path.join(dirpath, n)
        if os.path.exists(p):
            return p
    cands = [f for f in os.listdir(dirpath) if f.endswith(".safetensors")]
    if len(cands) == 1:
        return os.path.join(dirpath, cands[0])
    raise FileNotFoundError(f"no safetensors weight file found in {dirpath}")


def cast_tree(tree, dtype, device):
    """Each floating leaf cast to ``dtype`` (through float32, round to
    nearest even, as the JAX package's ``cast_pytree``; ``None`` keeps each
    leaf's dtype), the others kept; one owned copy per leaf on
    ``device``."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast_tree(v, dtype, device) for v in tree]
    if dtype is not None and tree.is_floating_point() and tree.dtype != dtype:
        return tree.float().to(dtype).to(device)
    # the leaf may be a view of a mapped file: always a copy
    return tree.to(device, copy=True)


def load_subfolder(model_dir: str, sub: str, convert, dtype, device):
    """``convert(state_dict)`` of the weight file in ``model_dir/sub``, its
    tensors read in place from the native reader's mapping, then
    :func:`cast_tree` to ``dtype`` on ``device``."""
    from sdtpu_torch.utils.native_safetensors import NativeSafetensors

    with NativeSafetensors(_find_weight_file(os.path.join(model_dir, sub))) as f:
        sd = f.state_dict()
        out = cast_tree(convert(sd), dtype, device)
        del sd
    return out


def load_pipeline_params(model_dir: str, config: PipelineConfig, *, dtype=None,
                         device="cuda") -> dict:
    """A diffusers-layout local directory
    (``model_dir/{text_encoder,unet,vae}/...safetensors``, and
    ``text_encoder_2`` for SDXL) -> ``{"clip", "unet", "vae_encoder",
    "vae_decoder"[, "clip_2"]}``, every floating leaf in ``dtype or
    config.param_dtype``, on ``device``.  Each file is mapped by the native
    reader and its tensors read in place."""
    dtype = dtype or config.param_dtype
    params = {}
    if config.clip is not None:  # bigG-only models (SDXL refiner) have none
        params["clip"] = load_subfolder(
            model_dir, "text_encoder", lambda sd: clip_params_from_state_dict(sd, config.clip),
            dtype, device)
    params["unet"] = load_subfolder(
        model_dir, "unet", lambda sd: unet_params_from_state_dict(sd, config.unet),
        dtype, device)
    params.update(load_subfolder(model_dir, "vae", lambda sd: {
        "vae_encoder": vae_encoder_params_from_state_dict(sd, config.vae),
        "vae_decoder": vae_decoder_params_from_state_dict(sd, config.vae)}, dtype, device))
    if config.clip_2 is not None:
        params["clip_2"] = load_subfolder(
            model_dir, "text_encoder_2",
            lambda sd: clip_params_from_state_dict(sd, config.clip_2), dtype, device)
    return params


# ---------------------------------------------------------------------------
# Writing safetensors; the converted-tree cache
# ---------------------------------------------------------------------------


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str,
                     metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write ``tensors`` as one standard ``.safetensors`` file: the 8-byte
    little-endian header length, the JSON header (space-padded to 8 bytes),
    then each tensor's raw little-endian bytes in order.  Returns the bytes
    written.  (The ``safetensors`` package is not a dependency.)"""
    from sdtpu_torch.utils.native_safetensors import DTYPES

    names = {dtype: name for name, dtype in DTYPES.items()}
    header, offset, flat = {}, 0, []
    for name, t in tensors.items():
        t = t.detach().contiguous().cpu()
        if t.dtype not in names:
            raise ValueError(f"{name}: no safetensors dtype for {t.dtype}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        flat.append(t.reshape(-1).view(torch.uint8).numpy())
        offset += nbytes
    if metadata:
        header["__metadata__"] = dict(metadata)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little") + raw)
        for arr in flat:
            f.write(arr.data)
    return 8 + len(raw) + offset


def _tree_items(tree, path=()):
    """``("a/b/0/kernel", leaf)`` for every leaf: dict keys and list
    indices joined by ``/``."""
    if isinstance(tree, (dict, list, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        if not tree:
            raise ValueError(f"{'/'.join(map(str, path))}: an empty container has no "
                             "leaf to store")
        for k, v in items:
            yield from _tree_items(v, path + (str(k),))
    elif isinstance(tree, torch.Tensor):
        yield "/".join(path), tree
    else:
        raise TypeError(f"{'/'.join(path)}: a {type(tree).__name__} leaf is not a tensor")


def _rebuild(node):
    """The nested dicts of :func:`load_converted` with integer keys turned
    back into lists."""
    if not isinstance(node, dict):
        return node
    if all(k.isdigit() for k in node):
        return [_rebuild(node[str(i)]) for i in range(len(node))]
    return {k: _rebuild(v) for k, v in node.items()}


def save_converted(params: dict, path: str) -> int:
    """Cache a converted parameter tree (any dtypes: bf16, an int8-quantized
    tree's codes and scales, SDXL's two encoders) as one safetensors file,
    each leaf under its tree path, so that a later load skips the
    checkpoint's mapping.  Returns the bytes written.  The counterpart of
    the JAX package's orbax cache."""
    return save_safetensors(dict(_tree_items(params)), path,
                            metadata={"format": "sdtpu_torch parameter tree"})


def load_converted(path: str, *, device="cuda") -> dict:
    """The tree :func:`save_converted` wrote, every leaf bitwise in its
    dtype and shape, on ``device``; the file is mapped by the native reader
    and each tensor copied once to ``device``."""
    from sdtpu_torch.utils.native_safetensors import NativeSafetensors

    root: dict = {}
    with NativeSafetensors(path) as f:
        for name in f.keys():
            *parents, last = name.split("/")
            node = root
            for p in parents:
                node = node.setdefault(p, {})
            view = f.tensor(name)
            node[last] = view.to(device, copy=True)
            del view
    return _rebuild(root)


# ---------------------------------------------------------------------------
# The JAX package's trees, and seeded random initialization
# ---------------------------------------------------------------------------


def _leaf_to_torch(leaf, device) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device)
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # torch rejects ml_dtypes' bfloat16; bf16 -> f32 -> bf16 is exact
        return torch.tensor(arr.astype(np.float32), device=device).to(torch.bfloat16)
    # a copy: the arrays of a JAX tree are read-only
    return torch.tensor(arr, device=device)


def params_from_numpy(tree, *, device="cuda"):
    """A nested dict/list tree of numpy arrays (e.g. the JAX package's
    parameters after ``jax.tree.map(np.asarray, params)``) -> the same tree
    of tensors on ``device``, each leaf keeping its own dtype (a tensor
    leaf is moved there as it is)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device=device) for v in tree]
    return _leaf_to_torch(tree, device)


def _to(tree, device):
    """Every leaf to ``device`` once, in its own dtype."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def init_pipeline_params(key, config: PipelineConfig, *, device="cuda") -> dict:
    """Seeded random parameters for ``from_random``: the text encoder(s),
    the UNet, the VAE encoder and decoder, equal to the JAX package's
    ``init_pipeline_params(key, config)`` leaf by leaf.  ``key`` (an int
    seed or a ``hostrng.HostKey``) splits five ways as there: CLIP, UNet,
    the VAE encoder, the decoder, the second text encoder (``clip_2``,
    SDXL's bigG; a bigG-only config such as the SDXL refiner has no
    ``clip``).  Every leaf is drawn on the host with numpy's Philox,
    rounded to ``config.param_dtype`` (the CLIP embeddings stay float32)
    and moved to ``device`` once."""
    from sdtpu_torch.models.clip import init_clip
    from sdtpu_torch.models.unet import init_unet
    from sdtpu_torch.models.vae import init_vae_decoder, init_vae_encoder

    k1, k2, k3, k4, k5 = hostrng.split(hostrng.ensure_key(key), 5)
    dtype = config.param_dtype
    params = {
        "unet": init_unet(k2, config.unet, dtype=dtype),
        "vae_encoder": init_vae_encoder(k3, config.vae, dtype=dtype),
        "vae_decoder": init_vae_decoder(k4, config.vae, dtype=dtype),
    }
    if config.clip is not None:
        params["clip"] = init_clip(k1, config.clip, dtype=dtype)
    if config.clip_2 is not None:
        params["clip_2"] = init_clip(k5, config.clip_2, dtype=dtype)
    return _to(params, device)


def zero_tree(tree, device):
    """Zeros with ``tree``'s structure, shapes and dtypes on ``device``."""
    if isinstance(tree, dict):
        return {k: zero_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [zero_tree(v, device) for v in tree]
    return torch.zeros(tree.shape, dtype=tree.dtype, device=device)


def zero_pipeline_params(config: PipelineConfig, *, device="cuda") -> dict:
    """Zeros with ``init_pipeline_params``' tree, shapes and dtypes, made on
    ``device`` without drawing (benchmarks: speed does not depend on the
    weight values)."""
    with hostrng.shapes_only():
        shapes = init_pipeline_params(0, config, device="meta")
    return zero_tree(shapes, device)


def zero_controlnet_params(config: PipelineConfig, *, device="cuda") -> dict:
    """Zeros with ``init_controlnet``'s tree and shapes for ``config``'s UNet
    in its ``param_dtype``, made on ``device`` without drawing (the bench's
    ``--controlnet``)."""
    from sdtpu_torch.models.controlnet import init_controlnet

    with hostrng.shapes_only():
        shapes = init_controlnet(0, config.unet, dtype=config.param_dtype)
    return zero_tree(shapes, device)
