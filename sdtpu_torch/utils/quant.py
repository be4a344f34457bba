"""int8 (W8A8) quantization of the resnet convs and the transformer matmuls.

Counterpart of ``sdtpu/utils/quant.py``; the algebra is the same:

* **Activations** of a resnet conv are the slab prologue's
  ``y = SiLU(GroupNorm(x [+ temb]))``.  GroupNorm pins y per channel to
  ``SiLU(gamma_c * N(0, 1) + beta_c)``, so a k-sigma range follows from the
  norm's own affine with no calibration data; the code is an asymmetric
  per-channel affine ``q = clamp(round(y / s_c) + z_c, -128, 127)``.
* **Weights** carry the per-channel activation scale folded in
  (``w'[ci, co] = w[ci, co] * s_ci``) and are quantized per output channel
  (``sw_co = max_ci |w'| / 127``), so ``out = (qx @ qw) * sw_co - zp_corr``
  where ``zp_corr = sw_co * (z @ qw)`` is an exact integer sum folded into
  one per-co float32 constant.

The quantizers run on host numpy, as in the JAX package: every leaf they
read comes to the host as float32 (bf16 -> f32 is exact), and the leaves
they make keep the JAX package's dtypes whatever the parameter dtype is
(``kernel_q`` int8; ``w_scale``, ``act_scale``, ``act_zp``, ``zp_corr``
float32) and land on the device of the leaf they replace, so a quantized
tree lies wholly on its device.  The runtime helpers
(:func:`quantize_act`, :func:`slab_conv_kernel`, ...) are torch.

A quantized dict carries ``kernel_q``/``w_scale``/``act_scale`` instead of
``kernel``; a dynamically quantized linear carries ``kernel_q``/``w_scale``
and no ``act_scale`` (``ops/linear.py`` dispatches on that).
"""

from __future__ import annotations

import numpy as np
import torch


def _host(t) -> np.ndarray:
    """A leaf on the host as float32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _leaf(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A new leaf on the device of the leaf it replaces, dtype kept."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(like.device)


def _silu(z: np.ndarray) -> np.ndarray:
    return z / (1.0 + np.exp(-z))


def act_range_from_norm(
    norm_params: dict, *, sigmas: float = 4.5
) -> tuple[np.ndarray, np.ndarray]:
    """Per-channel [lo, hi] of SiLU(GroupNorm(x)) from the norm's affine:
    the k-sigma range of gamma * N(0, 1) + beta through SiLU, whose minimum
    -0.2785 at z = -1.2785 is interior; kept zero-containing."""
    gamma = _host(norm_params["scale"])
    beta = _host(norm_params["bias"])
    a = beta - sigmas * np.abs(gamma)
    b = beta + sigmas * np.abs(gamma)
    sa, sb = _silu(a), _silu(b)
    hi = np.maximum(sa, sb)
    lo = np.minimum(sa, sb)
    contains_min = (a <= -1.2785) & (b >= -1.2785)
    lo = np.where(contains_min, -0.2785, lo)
    lo = np.minimum(lo, -1e-3)
    hi = np.maximum(hi, 1e-3)
    return lo.astype(np.float32), hi.astype(np.float32)


def act_qparams_from_norm(
    norm_params: dict, *, sigmas: float = 4.5
) -> tuple[np.ndarray, np.ndarray]:
    """(scale s, zero point z) of the post-GN-SiLU activations:
    ``q = clamp(round(y / s) + z, -128, 127)``, ``y ~ s * (q - z)``."""
    lo, hi = act_range_from_norm(norm_params, sigmas=sigmas)
    s = (hi - lo) / 255.0
    z = np.round(-128.0 - lo / s)
    z = np.clip(z, -128, 127).astype(np.float32)
    return s.astype(np.float32), z


def act_qparams_from_ln(
    norm_params: dict, *, sigmas: float = 4.5
) -> tuple[np.ndarray, np.ndarray]:
    """(scale, zero point) of post-LayerNorm activations (no SiLU): the
    k-sigma range [beta - k|gamma|, beta + k|gamma|] per feature."""
    gamma = _host(norm_params["scale"])
    beta = _host(norm_params["bias"])
    lo = beta - sigmas * np.abs(gamma)
    hi = beta + sigmas * np.abs(gamma)
    lo = np.minimum(lo, -1e-3)
    hi = np.maximum(hi, 1e-3)
    s = (hi - lo) / 255.0
    z = np.clip(np.round(-128.0 - lo / s), -128, 127).astype(np.float32)
    return s.astype(np.float32), z


def quantize_linear_w8a8(
    kernel, act_scale: np.ndarray, act_zp: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(in, out) linear kernel -> (int8, per-out f32 scale, per-out
    zero-point correction): :func:`quantize_conv_w8a8` in 2-D."""
    k = _host(kernel) * np.asarray(act_scale, np.float32)[:, None]
    w_scale = np.maximum(np.max(np.abs(k), axis=0) / 127.0, 1e-12)
    w_scale = w_scale.astype(np.float32)
    q = np.clip(np.round(k / w_scale), -127, 127).astype(np.int8)
    zq = (np.asarray(act_zp, np.int64)[:, None] * q.astype(np.int64)).sum(0)
    zp_corr = (w_scale.astype(np.float64) * zq).astype(np.float32)
    return q, w_scale, zp_corr


def quantize_conv_w8a8(
    kernel, act_scale: np.ndarray, act_zp: np.ndarray = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """HWIO conv kernel -> (int8 HWIO, per-co f32 scale, per-co zero-point
    correction) with ``(qx @ qw) * w_scale - zp_corr == y @ w`` up to
    rounding; ``zp_corr = w_scale * (z @ qw)`` is an exact int64 sum."""
    k = _host(kernel)
    k = k * np.asarray(act_scale, np.float32)[None, None, :, None]
    w_scale = np.max(np.abs(k), axis=(0, 1, 2)) / 127.0
    w_scale = np.maximum(w_scale, 1e-12).astype(np.float32)
    q = np.clip(np.round(k / w_scale), -127, 127).astype(np.int8)
    if act_zp is None:
        act_zp = np.zeros(k.shape[2], np.float32)
    zq = (
        np.asarray(act_zp, np.int64)[None, None, :, None]
        * q.astype(np.int64)
    ).sum(axis=(0, 1, 2))
    zp_corr = (w_scale.astype(np.float64) * zq).astype(np.float32)
    return q, w_scale, zp_corr


def quantize_act(x: torch.Tensor, params: dict) -> torch.Tensor:
    """A float activation in a quantized linear's affine code:
    ``clamp(round(x / s) + z, -128, 127)`` as int8 (a division, where the
    slab prologue multiplies by the reciprocal; rounding half to even)."""
    s = params["act_scale"].float()
    z = params["act_zp"].float()
    q = torch.round(x.float() / s) + z
    return torch.clamp(q, -128.0, 127.0).to(torch.int8)


def dequant_conv_kernel(params: dict) -> torch.Tensor:
    """The approximate float32 HWIO kernel of a quantized conv dict."""
    w = params["kernel_q"].float() * params["w_scale"].float()
    return w / params["act_scale"].float()[None, None, :, None]


# -- runtime helpers shared by the UNet resnet and the VAE resnet -----------


def slab_conv_kernel(p: dict) -> torch.Tensor:
    """The kernel the slab conv consumes: int8 ``kernel_q`` when quantized,
    else the float kernel."""
    return p["kernel_q"] if "kernel_q" in p else p["kernel"]


def slab_quant_kwargs(p: dict) -> dict:
    """The int8 slab conv's extra arguments for a quantized conv dict
    (empty for a float one)."""
    if "kernel_q" not in p:
        return {}
    return {"act_inv_scale": 1.0 / p["act_scale"],
            "act_zp": p.get("act_zp"),
            "w_scale": p["w_scale"]}


def conv_bias_deq(p: dict) -> torch.Tensor:
    """The conv bias with the zero-point contraction folded in."""
    if "zp_corr" in p:
        return p["bias"] - p["zp_corr"]
    return p["bias"]


def float_conv_kernel(p: dict, dtype) -> torch.Tensor:
    """The float HWIO kernel for the dequantized route (a quantized dict
    dequantizes on the fly)."""
    if "kernel_q" in p:
        return dequant_conv_kernel(p).to(dtype)
    return p["kernel"].to(dtype)


def slab_plan_ok(x_shape, kernel_shape) -> bool:
    """The shape part of the JAX package's slab plan
    (``sdtpu/kernels/conv2d.py:plan_slab``; its TPU VMEM budget is not the
    card's): a 3x3 kernel, H and W multiples of 8, Ci and Co >= 64."""
    _, h, w, ci = x_shape
    kh, kw, _, co = kernel_shape
    return (kh, kw) == (3, 3) and h % 8 == 0 and w % 8 == 0 and ci >= 64 and co >= 64


def resnet_takes_slab(x_shape, res: dict, num_groups: int) -> bool:
    """The JAX package's routing rule for a resnet (``sdtpu/models/unet.py:
    233-254``, ``sdtpu/models/vae.py:79-89``): both convs have a slab plan
    (:func:`slab_plan_ok`) and both channel counts divide by ``num_groups``.
    A resnet that passes takes the slab kernels; one that does not takes
    GroupNorm -> SiLU -> conv2d, float or dequantized."""
    k1, k2 = slab_conv_kernel(res["conv1"]), slab_conv_kernel(res["conv2"])
    mid = tuple(x_shape[:-1]) + (k1.shape[-1],)
    return (slab_plan_ok(x_shape, k1.shape) and slab_plan_ok(mid, k2.shape)
            and x_shape[-1] % num_groups == 0 and mid[-1] % num_groups == 0)


def resnet_conv_args(x_shape, res: dict, num_groups: int, dtype) -> list:
    """``[(kernel, bias, kwargs)]`` for a resnet's conv1 and conv2.  A
    quantized conv keeps its int8 kernel (kernel D) only when the resnet
    passes :func:`resnet_takes_slab`; otherwise it takes the dequantized
    route: the float kernel from :func:`float_conv_kernel` with the original
    bias.  A float conv always takes its own kernel and bias."""
    int8_route = resnet_takes_slab(x_shape, res, num_groups)

    def args(c):
        if int8_route and "kernel_q" in c:
            return c["kernel_q"], conv_bias_deq(c), slab_quant_kwargs(c)
        return float_conv_kernel(c, dtype), c["bias"], {}

    return [args(res["conv1"]), args(res["conv2"])]


# -- tree quantizers --------------------------------------------------------


def _quantize_resnet(res: dict, *, min_ch: int = 64, sigmas: float = 4.5):
    """A resnet's conv1/conv2 quantized (a new dict; idempotent)."""
    out = dict(res)
    for conv_name, norm_name in (("conv1", "norm1"), ("conv2", "norm2")):
        conv = res[conv_name]
        if "kernel" not in conv:
            continue
        kh, kw, ci, co = conv["kernel"].shape
        if (kh, kw) != (3, 3) or ci < min_ch or co < min_ch:
            continue
        s_act, z_act = act_qparams_from_norm(res[norm_name], sigmas=sigmas)
        q, w_scale, zp_corr = quantize_conv_w8a8(conv["kernel"], s_act, z_act)
        like = conv["kernel"]
        newconv = {k: v for k, v in conv.items() if k != "kernel"}
        newconv["kernel_q"] = _leaf(q, like)
        newconv["w_scale"] = _leaf(w_scale, like)
        newconv["act_scale"] = _leaf(s_act, like)
        newconv["act_zp"] = _leaf(z_act, like)
        newconv["zp_corr"] = _leaf(zp_corr, like)
        out[conv_name] = newconv
    return out


def _quantize_linear(lin: dict, s_act, z_act) -> dict:
    if "kernel" not in lin:
        return lin
    q, w_scale, zp_corr = quantize_linear_w8a8(lin["kernel"], s_act, z_act)
    like = lin["kernel"]
    out = {k: v for k, v in lin.items() if k != "kernel"}
    out["kernel_q"] = _leaf(q, like)
    out["w_scale"] = _leaf(w_scale, like)
    out["act_scale"] = _leaf(np.asarray(s_act, np.float32), like)
    out["act_zp"] = _leaf(np.asarray(z_act, np.float32), like)
    out["zp_corr"] = _leaf(zp_corr, like)
    return out


def _quantize_linear_dyn(lin: dict) -> dict:
    """Weight-only int8 (per output feature) for a matmul whose input range
    is not norm-pinned: the activation scale is taken per row at run time
    (``linear_q8_dyn``), so the dict has no ``act_scale``."""
    if "kernel" not in lin:
        return lin
    k = _host(lin["kernel"])
    w_scale = np.maximum(np.max(np.abs(k), axis=0) / 127.0, 1e-12)
    w_scale = w_scale.astype(np.float32)
    q = np.clip(np.round(k / w_scale), -127, 127).astype(np.int8)
    like = lin["kernel"]
    out = {kk: v for kk, v in lin.items() if kk != "kernel"}
    out["kernel_q"] = _leaf(q, like)
    out["w_scale"] = _leaf(w_scale, like)
    return out


def _quantize_transformer_block(
    blk: dict, *, min_ch: int = 64, sigmas: float = 4.5,
    dynamic_out: bool = False,
) -> dict:
    """The post-LN matmuls of one transformer block (attn1 q/k/v, attn2 q,
    GeGLU up); ``dynamic_out=True`` adds the attn1/attn2 out-projections
    and the GeGLU down-projection with run-time row scales.  attn2's k/v
    read the raw text context and stay float."""
    kq = blk["attn1"]["q"]
    dim = kq["kernel"].shape[0] if "kernel" in kq else 0
    if dim < min_ch:
        return blk
    s1, z1 = act_qparams_from_ln(blk["norm1"], sigmas=sigmas)
    s2, z2 = act_qparams_from_ln(blk["norm2"], sigmas=sigmas)
    s3, z3 = act_qparams_from_ln(blk["norm3"], sigmas=sigmas)
    out = dict(blk)
    out["attn1"] = {
        **blk["attn1"],
        "q": _quantize_linear(blk["attn1"]["q"], s1, z1),
        "k": _quantize_linear(blk["attn1"]["k"], s1, z1),
        "v": _quantize_linear(blk["attn1"]["v"], s1, z1),
    }
    out["attn2"] = {**blk["attn2"], "q": _quantize_linear(blk["attn2"]["q"], s2, z2)}
    out["ff"] = {**blk["ff"], "proj": _quantize_linear(blk["ff"]["proj"], s3, z3)}
    if dynamic_out:
        out["attn1"]["out"] = _quantize_linear_dyn(blk["attn1"]["out"])
        out["attn2"]["out"] = _quantize_linear_dyn(blk["attn2"]["out"])
        out["ff"]["out"] = _quantize_linear_dyn(blk["ff"]["out"])
    return out


def _quantize_attn_params(
    attn: dict, *, min_ch: int = 64, sigmas: float = 4.5,
    dynamic_out: bool = False,
) -> dict:
    return {
        **attn,
        "blocks": [
            _quantize_transformer_block(b, min_ch=min_ch, sigmas=sigmas,
                                        dynamic_out=dynamic_out)
            for b in attn["blocks"]
        ],
    }


def _set_by_path(tree, path: str, value):
    """Copy-on-write assignment into a dict/list tree by a dotted path
    (list levels use integer segments)."""
    keys = path.split(".")

    def rec(node, i):
        k = keys[i]
        if isinstance(node, list):
            k = int(k)
            new = list(node)
        else:
            new = dict(node)
        new[k] = value if i == len(keys) - 1 else rec(node[k], i + 1)
        return new

    return rec(tree, 0)


def quantize_unet_int8(
    params: dict,
    *,
    min_ch: int = 64,
    sigmas: float = 4.5,
    transformer=False,  # False | True | "full"
    skip_down: tuple = (),
    skip_up: tuple = (),
    act_ranges: dict = None,
    act_margin: float = 1.0,
) -> dict:
    """The UNet's resnet 3x3 convs in W8A8 (shortcuts, up/downsamples and
    the in/out convs stay float).  ``transformer=True`` adds the post-LN
    transformer matmuls; ``"full"`` also the out-projections and the GeGLU
    down-projection with run-time row scales, or, for a site in
    ``act_ranges`` (calibrated per-feature input abs-max,
    ``utils/calibrate.py``), a static symmetric scale
    ``act_margin * amax / 127`` with zero zero point.  ``skip_down`` /
    ``skip_up``: block indices (negatives allowed) left in float."""
    nd, nu = len(params["down_blocks"]), len(params["up_blocks"])
    sd = {i % nd for i in skip_down}
    su = {i % nu for i in skip_up}

    def maybe(r, skip):
        return r if skip else _quantize_resnet(r, min_ch=min_ch, sigmas=sigmas)

    def block(b, skip):
        nb = {**b, "resnets": [maybe(r, skip) for r in b["resnets"]]}
        if transformer and not skip and "attentions" in b:
            nb["attentions"] = [
                _quantize_attn_params(a, min_ch=min_ch, sigmas=sigmas,
                                      dynamic_out=transformer == "full")
                for a in b["attentions"]
            ]
        return nb

    out = dict(params)
    out["down_blocks"] = [block(b, i in sd) for i, b in enumerate(params["down_blocks"])]
    if "mid_block" in params:
        out["mid_block"] = block(params["mid_block"], False)
    out["up_blocks"] = [block(b, i in su) for i, b in enumerate(params["up_blocks"])]

    if transformer == "full" and act_ranges:
        from sdtpu_torch.utils.calibrate import iter_dynamic_sites

        for path, lin in iter_dynamic_sites(params):
            amax = act_ranges.get(path)
            if amax is None or "kernel" not in lin:
                continue
            seg = path.split(".")
            if seg[0] == "down_blocks" and int(seg[1]) in sd:
                continue
            if seg[0] == "up_blocks" and int(seg[1]) in su:
                continue
            if lin["kernel"].shape[0] < min_ch:
                continue
            s = np.maximum(np.asarray(amax, np.float32) * (act_margin / 127.0), 1e-8)
            out = _set_by_path(out, path, _quantize_linear(lin, s, np.zeros_like(s)))
    return out


def quantize_vae_decoder_int8(
    params: dict, *, min_ch: int = 64, sigmas: float = 4.5
) -> dict:
    """The VAE decoder's mid and up-block resnet convs in W8A8; the
    upsample, in and out convs read un-normalized inputs and stay float."""
    out = dict(params)
    out["mid_block"] = {
        **params["mid_block"],
        "resnets": [_quantize_resnet(r, min_ch=min_ch, sigmas=sigmas)
                    for r in params["mid_block"]["resnets"]],
    }
    out["up_blocks"] = [
        {**b, "resnets": [_quantize_resnet(r, min_ch=min_ch, sigmas=sigmas)
                          for r in b["resnets"]]}
        for b in params["up_blocks"]
    ]
    return out


def quantize_pipeline_int8(
    params: dict, *, min_ch: int = 64, vae: bool = False, **kw
) -> dict:
    """A pipeline tree with its UNet quantized (CLIP stays float) and, with
    ``vae=True``, its VAE decoder; ``kw`` goes to :func:`quantize_unet_int8`.
    Every new leaf lands on the device of the leaf it replaces."""
    out = dict(params)
    out["unet"] = quantize_unet_int8(params["unet"], min_ch=min_ch, **kw)
    if vae:
        out["vae_decoder"] = quantize_vae_decoder_int8(
            params["vae_decoder"], min_ch=min_ch, sigmas=kw.get("sigmas", 4.5))
    return out
