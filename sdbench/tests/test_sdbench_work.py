"""The yardstick's work enumeration against what the port computes on the
CPU (``torch.utils.flop_counter.FlopCounterMode``), and its FLOP count
against the port's own ``utils/flops.py``."""

import importlib

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from sdbench import spec, work
from sdbench.tests.tiny import TINY, TINY_XL
from sdbench.weights import pipeline_params


def _conv_ops(convs):
    return sum(2.0 * n * h * w * 9 * ci * co for n, h, w, ci, co, _, _ in convs)


def _att_ops(atts):
    return sum(4.0 * n * heads * length * length * d for n, heads, length, d in atts)


def _counted(fn):
    """(convolution FLOPs, attention FLOPs) the port ran inside ``fn``: every
    ``aten.convolution``, and the plain flash kernel's calls."""
    attn_mod = importlib.import_module("sdtpu_torch.ops.attention")
    original = attn_mod.flash_attention_packed
    att = []

    def counted_flash(q, k, v):
        with FlopCounterMode(display=False) as fc:
            out = original(q, k, v)
        att.append(fc.get_total_flops())
        return out

    attn_mod.flash_attention_packed = counted_flash
    try:
        with FlopCounterMode(display=False) as fc:
            fn()
    finally:
        attn_mod.flash_attention_packed = original
    conv = sum(v for op, v in fc.get_flop_counts()["Global"].items()
               if "convolution" in str(op))
    return conv, sum(att)


@pytest.mark.parametrize("config", [TINY, TINY_XL], ids=["tiny", "tiny-xl"])
def test_unet_step_and_vae_work(config):
    from sdtpu_torch.models.unet import unet_forward
    from sdtpu_torch.models.vae import vae_decode, vae_encode

    pc = spec.pipeline_config(config)
    params = pipeline_params(pc, 3, "cpu")
    rows, lat, size = 2, config["image_size"] // 2, config["image_size"]
    x = torch.randn(rows, lat, lat, 4, dtype=torch.bfloat16)
    ctx = torch.randn(rows, 77, config["unet"]["cross_attention_dim"], dtype=torch.bfloat16)
    added = None
    if config["unet"]["addition_embed_dim"]:
        added = {"text_embeds": torch.randn(rows, config["clip_2"]["projection_dim"]),
                 "time_ids": torch.full((rows, 6), float(size))}
    conv, att = _counted(lambda: unet_forward(x, torch.tensor(500), ctx, params["unet"], pc.unet,
                                              added_cond=added))
    assert conv == _conv_ops(work.unet_convs(config["unet"], lat, rows))
    assert att == _att_ops(work.unet_attentions(config["unet"], lat, rows))

    v = config["vae"]
    conv, att = _counted(lambda: vae_decode(x, params["vae_decoder"], pc.vae))
    # plus the 1x1 post-quant convolution
    one_by_one = 2.0 * rows * lat * lat * v["latent_channels"] ** 2
    assert conv == _conv_ops(work.vae_decode_convs(v, lat, rows)) + one_by_one
    assert att == _att_ops(work.vae_attentions(v, lat, rows))

    img = torch.rand(rows, size, size, 3, dtype=torch.bfloat16) * 2 - 1
    noise = torch.randn(rows, lat, lat, 4)
    conv, att = _counted(lambda: vae_encode(img, noise, params["vae_encoder"], pc.vae))
    one_by_one = 2.0 * rows * lat * lat * (2 * v["latent_channels"]) ** 2
    assert conv == _conv_ops(work.vae_encode_convs(v, size, rows)) + one_by_one
    assert att == _att_ops(work.vae_attentions(v, lat, rows))


@pytest.mark.parametrize("name", ["tiny-sd", "sdxl"])
@pytest.mark.parametrize("strength", [None, 0.3])
@pytest.mark.parametrize("scale", [7.5, 1.0], ids=["guided", "unguided"])
def test_request_flops_equal_the_ports_count(name, strength, scale):
    from sdtpu_torch.config import get_preset
    from sdtpu_torch.utils.flops import pipeline_flops

    cfg = spec.load_cell({"tiny-sd": "tinysd-b8", "sdxl": "sdxl-1024"}[name]).config
    cfg = dict(cfg, cfg_scale=scale)
    for rows in (1, 8):
        theirs = pipeline_flops(get_preset(name), cfg["image_size"], cfg["steps"], rows,
                                cfg=scale > 1, img2img=strength is not None,
                                strength=strength if strength is not None else 0.9)
        assert work.request_flops(cfg, rows, strength) == pytest.approx(theirs, rel=1e-12)


def test_published_tiny_sd_and_sdxl_counts():
    """26.82 TFLOP a tiny-sd 512x512 image, 349 an SDXL 1024x1024 one."""
    for cell, tflop in (("tinysd-b8", 26.82), ("sdxl-1024", 349.0)):
        cfg = spec.load_cell(cell).config
        assert work.request_flops(cfg, 1) / 1e12 == pytest.approx(tflop, rel=5e-3)


def test_least_time_takes_the_larger_bound():
    # a 1x1 map with many channels is byte-bound, a big map compute-bound
    small = [(1, 1, 1, 1024, 1024, 1, False)]
    ops = 2.0 * 9 * 1024 * 1024
    byt = 2 * (1024 + 9 * 1024 * 1024 + 1024 + 1024)
    assert work.conv_least_s(small, 2) == pytest.approx(max(ops / work.PEAK_FLOPS_BF16,
                                                            byt / work.PEAK_BYTES_PER_S))
    assert byt / work.PEAK_BYTES_PER_S > ops / work.PEAK_FLOPS_BF16
    big = [(8, 64, 64, 320, 320, 64 * 64, True)]
    assert work.conv_least_s(big, 2) == pytest.approx(
        2.0 * 8 * 64 * 64 * 9 * 320 * 320 / work.PEAK_FLOPS_BF16)
    assert np.isclose(work.schedule_steps(25, 0.3), 7)
