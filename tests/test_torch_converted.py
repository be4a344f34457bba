"""The port's converted-tree cache (``utils/weights.py:save_converted`` /
``load_converted``, its safetensors writer ``save_safetensors``) and
``tools/convert_checkpoint.py``, the counterparts of the JAX package's
orbax cache (``tests/test_weights.py::TestOrbaxCache``) and its tool.

Tolerance: none; every leaf round-trips bitwise in its dtype and shape
(float32, bf16, an int8-quantized tree's codes and scales, SDXL's two
encoders), the file reads back with the ``safetensors`` package to the same
arrays, and the tool's cache of a seeded diffusers directory equals
``from_pretrained``'s tree and the JAX package's loader's, bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

import sdtpu.utils.weights as jw
import sdtpu_torch.config as tcfg
from sdtpu_torch import StableDiffusionPipeline
from sdtpu_torch.tools import convert_checkpoint
from sdtpu_torch.utils.quant import quantize_pipeline_int8
from sdtpu_torch.utils.weights import (
    cast_tree,
    init_pipeline_params,
    load_converted,
    save_converted,
    save_safetensors,
)
from test_from_pretrained import TINY_CKPT, _write_clip, _write_unet, _write_vae
from test_pipeline import TINY
from test_tokenizer import build_assets
from test_torch_checkpoint import assert_trees_equal, leaves
from test_torch_ops import port_config
from test_torch_sdxl import TINY_XL

torch.set_num_threads(1)


def assert_same_tree(got, want):
    """Two port trees: the same paths (lists kept lists), shapes, dtypes
    and bits."""
    g, w = list(leaves(got)), list(leaves(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8)), path
    assert type(got["unet"]["down_blocks"]) is list


@pytest.fixture(scope="module")
def trees():
    tiny = init_pipeline_params(0, port_config(TINY), device="cpu")
    return {
        "f32": tiny,
        "bf16": cast_tree(tiny, torch.bfloat16, "cpu"),
        "int8": quantize_pipeline_int8(tiny, min_ch=8, transformer=True, vae=True),
        "sdxl": init_pipeline_params(0, port_config(TINY_XL), device="cpu"),
    }


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "sdxl"])
def test_save_and_load_converted_round_trip_bitwise(trees, tmp_path, kind):
    """Every leaf back in its dtype and shape, bitwise; the int8 tree keeps
    its int8 codes beside their float scales, SDXL both encoders."""
    tree = trees[kind]
    path = str(tmp_path / "cache.safetensors")
    nbytes = save_converted(tree, path)
    assert nbytes == (tmp_path / "cache.safetensors").stat().st_size
    got = load_converted(path, device="cpu")
    assert_same_tree(got, tree)
    dtypes = {t.dtype for _, t in leaves(got)}
    if kind == "int8":
        assert torch.int8 in dtypes and torch.float32 in dtypes
    if kind == "sdxl":
        assert "clip_2" in got and "add_embedding" in got["unet"]


def test_the_cache_is_a_standard_safetensors_file(trees, tmp_path):
    """The ``safetensors`` package reads the file to the same arrays (bf16
    as ml_dtypes' bfloat16, the same bits), under the leaves' tree paths."""
    tree = trees["int8"] | {"clip": trees["bf16"]["clip"]}
    path = str(tmp_path / "cache.safetensors")
    save_converted(tree, path)
    read = load_file(path)
    flat = {"/".join(map(str, p)): t for p, t in leaves(tree)}
    assert set(read) == set(flat)
    assert "unet/down_blocks/0/resnets/0/conv1/kernel_q" in read
    for name, t in flat.items():
        arr = read[name]
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(arr.view(np.int16), t.view(torch.int16).numpy(),
                                          err_msg=name)
        else:
            assert arr.dtype == t.numpy().dtype, name
            np.testing.assert_array_equal(arr, t.numpy(), err_msg=name)


@pytest.mark.parametrize("tree,error,match", [
    ({"a": {"kernel": np.ones(3, np.float32)}}, TypeError, "a/kernel: a ndarray leaf"),
    ({"a": [torch.ones(2), 3.0]}, TypeError, "a/1: a float leaf"),
    ({"a": torch.ones(2), "b": {}}, ValueError, "b: an empty container"),
])
def test_save_converted_refuses_what_is_not_a_tensor_tree(tmp_path, tree, error, match):
    with pytest.raises(error, match=match):
        save_converted(tree, str(tmp_path / "x.safetensors"))
    assert not (tmp_path / "x.safetensors").exists()


def test_save_safetensors_refuses_an_unknown_dtype(tmp_path):
    with pytest.raises(ValueError, match="no safetensors dtype"):
        save_safetensors({"c": torch.ones(2, dtype=torch.complex64)},
                         str(tmp_path / "x.safetensors"))


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """A seeded diffusers directory of ``test_from_pretrained.py``'s
    TINY_CKPT, as ``test_torch_checkpoint.py`` writes one."""
    root = tmp_path_factory.mktemp("ckpt") / "tiny-seeded"
    _write_clip(root / "text_encoder", TINY_CKPT.clip)
    _write_unet(root / "unet", TINY_CKPT.unet)
    _write_vae(root / "vae", TINY_CKPT.vae)
    build_assets(root / "tokenizer")
    return root


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_convert_checkpoint_equals_from_pretrained(ckpt_dir, tmp_path, monkeypatch, capsys,
                                                   dtype):
    """The tool's cache loads bitwise to ``from_pretrained``'s tree of the
    same directory in the same dtype, and to the JAX package's loader's."""
    monkeypatch.setitem(tcfg.PRESETS, "test/ckpt-tiny", port_config(TINY_CKPT))
    out = str(tmp_path / "cache.safetensors")
    res = convert_checkpoint.main([str(ckpt_dir), "--preset", "test/ckpt-tiny", "--out", out,
                                   "--dtype", dtype, "--device", "cpu"])
    assert capsys.readouterr().out.startswith(f"converted {ckpt_dir} (test/ckpt-tiny, {dtype})")
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    got = load_converted(out, device="cpu")
    assert res["bytes"] == (tmp_path / "cache.safetensors").stat().st_size
    want = StableDiffusionPipeline.from_pretrained(str(ckpt_dir), preset="test/ckpt-tiny",
                                                   dtype=tdt, device="cpu").params
    assert_same_tree(got, want)
    assert_trees_equal(got, jax.tree.map(np.asarray, jw.load_pipeline_params(
        str(ckpt_dir), TINY_CKPT, dtype=jdt)))


def test_convert_checkpoint_needs_a_card_for_cuda(ckpt_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as e:
        convert_checkpoint.main([str(ckpt_dir), "--out", str(tmp_path / "x.safetensors")])
    assert e.value.code == 2


@pytest.mark.gpu
def test_load_converted_onto_the_card_is_bitwise(trees, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    path = str(tmp_path / "cache.safetensors")
    save_converted(trees["int8"], path)
    got = load_converted(path, device="cuda")
    assert all(t.device.type == "cuda" for _, t in leaves(got))
    assert_same_tree(jax.tree.map(lambda t: t.cpu(), got), trees["int8"])
