"""The denoise step's UNet forward as a CUDA graph
(``sdtpu_torch/pipeline/unet_graphs.py``).

On the CPU: the graph key changes with every field that fixes the captured
work and with nothing else; the route predicate keeps ControlNet steps, the
encoder cache's grouped steps, a tp mesh, int8 calibration and the CPU
eager; the launch counts a capture records are taken back out and credited
at every replay (a stub graph); assigning the parameter tree
(``load_lora``, ``unload_loras``, ``quantize_int8``) drops every graph; a
CPU request runs every step eagerly and says so on its ``unet_step`` spans.

On the card (``gpu``): graphed requests (the capture's, and then one that
replays every step) equal the eager loop bitwise, with the eager loop's
launch counts key by key: a tiny-sd-shaped request at batch 1 and 2, a
tiny SDXL-shaped one with the add-embedding, and a LoRA-fused tree.  The
eager loop is the same request inside a one-process ``tp_context``, which
keeps the route off and computes the same function.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import sdtpu_torch.kernels.conv2d as conv_kernels
import sdtpu_torch.utils.lora as tlora
from sdtpu_torch import StableDiffusionPipeline
from sdtpu_torch.kernels import launch_counts, reset_launch_counts
from sdtpu_torch.ops.linear import activation_capture
from sdtpu_torch.parallel.mesh import make_mesh, tp_context
from sdtpu_torch.pipeline.unet_graphs import (
    UNetGraphs,
    _Graph,
    graph_key,
    graph_route,
    held_launches,
)
from sdtpu_torch.utils import profiling
from test_pipeline import TINY, TOKENS
from test_torch_ops import port_config
from test_torch_sdxl import TINY_XL

torch.set_num_threads(1)

TTINY = port_config(TINY)
attention_ops = importlib.import_module("sdtpu_torch.ops.attention")


# ----------------------------------------------------------------- key --

def _tree(rows, dim, steps=3):
    """A context, a cross K/V tree and a time cache shaped as the UNet's."""
    context = torch.zeros((rows, 16, 32))
    kv = {"down": [[[{"k": torch.zeros((rows, 16, dim)), "v": torch.zeros((rows, 16, dim))}]]],
          "mid": [], "up": []}
    time_cache = {"temb": torch.zeros((steps, rows, 64)),
                  "down": [[torch.zeros((steps, rows, dim))]], "mid": [], "up": []}
    return context, kv, time_cache


BASE = dict(lat_shape=(2, 8, 8, 4), dtype=torch.bfloat16, device="cuda", rows=2, dim=16,
            pag_tail=0, freeu=None, added_cond=False, timestep_cond=False,
            attention_impl="flash", conv_impl="gemm")


def _key(**over):
    a = dict(BASE, **over)
    context, kv, tc = _tree(a.pop("rows"), a.pop("dim"), a.pop("steps", 3))
    return graph_key(a.pop("lat_shape"), a.pop("dtype"), a.pop("device"), context, kv, tc, **a)


@pytest.mark.parametrize("field,value", [
    ("lat_shape", (4, 8, 8, 4)),  # rows: n_rep * batch
    ("lat_shape", (2, 16, 16, 4)),  # the latent size
    ("lat_shape", (2, 8, 8, 9)),  # extra channels (inpaint, InstructPix2Pix)
    ("dtype", torch.float32),
    ("device", "cpu"),
    ("rows", 3),  # the context's and the K/V's rows
    ("dim", 24),  # the K/V's and the time projections' widths
    ("pag_tail", 1),
    ("freeu", (1.5, 1.6, 0.9, 0.2)),
    ("added_cond", True),
    ("timestep_cond", True),
    ("attention_impl", "xla"),
    ("conv_impl", "xla"),
])
def test_the_key_changes_with_each_field(field, value):
    assert _key(**{field: value}) != _key()
    assert _key(**{field: value}) == _key(**{field: value})


def test_the_key_ignores_the_step_count():
    """One step's time slice is keyed, not the schedule's length."""
    assert _key(steps=25) == _key(steps=3)


@pytest.mark.parametrize("module,switch", [(conv_kernels, "CONV_STATS_CHAIN"),
                                           (attention_ops, "_PACKED_OUT_PROJ")])
def test_the_key_follows_the_run_time_kernel_switches(monkeypatch, module, switch):
    """Conv-stats chaining and the packed out-projection change the
    captured kernels."""
    base = _key()
    monkeypatch.setattr(module, switch, not getattr(module, switch))
    assert _key() != base


# --------------------------------------------------------------- route --

ROUTE = dict(attention_impl="flash", unet={})


def test_the_route_applies_to_a_plain_step_on_a_card():
    assert graph_route("cuda", **ROUTE)
    assert graph_route(torch.device("cuda", 0), **dict(ROUTE, attention_impl="xla"))


@pytest.mark.parametrize("case", ["cpu", "controlnet", "grouped", "ring", "mesh",
                                  "calibration"])
def test_the_route_stays_eager(case):
    kw = dict(ROUTE)
    device = "cpu" if case == "cpu" else "cuda"
    if case == "controlnet":
        kw["control"] = [("net", None, None, None, 1.0)]
    elif case == "grouped":
        kw["grouped"] = True
    elif case == "ring":
        kw["attention_impl"] = "ring"
    if case == "mesh":
        with tp_context(make_mesh()):
            assert not graph_route(device, **kw)
    elif case == "calibration":
        with activation_capture({}, {1: "site"}):
            assert not graph_route(device, **kw)
    else:
        assert not graph_route(device, **kw)
    assert graph_route("cuda", **ROUTE)  # the block left nothing behind


# ------------------------------------------------------------ launches --

def test_held_launches_records_and_restores():
    """A capture's launches are recorded and taken back out; nested, as the
    capture nests in the warm-up, the outer block restores the counts from
    before the warm-up."""
    reset_launch_counts()
    launch_counts["geglu_rows"] = 5
    with held_launches() as outer:
        launch_counts["conv3x3_slab"] += 7  # the warm-up
        with held_launches() as made:
            launch_counts["conv3x3_slab"] += 2
            launch_counts["geglu_rows"] += 1
        assert launch_counts["conv3x3_slab"] == 7 and launch_counts["geglu_rows"] == 5
    assert made == {"conv3x3_slab": 2, "geglu_rows": 1}
    assert outer == {"conv3x3_slab": 7}
    assert launch_counts["conv3x3_slab"] == 0 and launch_counts["geglu_rows"] == 5
    reset_launch_counts()


class _StubGraph:
    """Stands in for a ``torch.cuda.CUDAGraph``: its replay reads the
    static buffers and writes the static output."""

    def __init__(self, step_in, request_in, out):
        self.step_in, self.request_in, self.out = step_in, request_in, out
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.out.copy_(self.step_in[0] + self.step_in[1].sum() + self.request_in[0].sum())


def test_a_replay_copies_in_credits_its_launches_and_copies_out():
    step_in = [torch.zeros((2, 3)), torch.zeros(4)]
    request_in = [torch.zeros(5)]
    out = torch.zeros((2, 3), dtype=torch.bfloat16)
    stub = _StubGraph(step_in, request_in, out)
    graphs = UNetGraphs()
    graphs._graphs["k"] = _Graph(stub, step_in, request_in, out,
                                 {"conv3x3_slab": 3, "flash_attention": 1})
    reset_launch_counts()
    first, second = graphs.request(), graphs.request()

    got = graphs.replay("k", (torch.ones((2, 3)), [torch.full((4,), 2.0)]),
                        (torch.ones(5),), first)
    assert got.dtype == torch.float32 and torch.equal(got, torch.full((2, 3), 14.0))
    assert launch_counts["conv3x3_slab"] == 3 and launch_counts["flash_attention"] == 1
    # the same request: its context and K/V are not copied again
    got = graphs.replay("k", (torch.zeros((2, 3)), [torch.zeros(4)]), (torch.zeros(5),), first)
    assert torch.equal(got, torch.full((2, 3), 5.0)) and torch.equal(request_in[0], torch.ones(5))
    # another request: they are
    got = graphs.replay("k", (torch.zeros((2, 3)), [torch.zeros(4)]), (torch.zeros(5),), second)
    assert torch.equal(got, torch.zeros((2, 3)))
    assert launch_counts["conv3x3_slab"] == 9 and launch_counts["flash_attention"] == 3
    assert stub.replays == 3 and graphs.replays == 3
    # the output is a copy: the next replay does not overwrite it
    assert got.data_ptr() != out.data_ptr()
    # a request that started before the tree changed replays nothing
    third = graphs.request()
    graphs.clear()
    graphs._graphs["k"] = _Graph(stub, step_in, request_in, out, {"conv3x3_slab": 3})
    assert graphs.replay("k", (torch.zeros((2, 3)), [torch.zeros(4)]), (torch.zeros(5),),
                         third) is None
    assert stub.replays == 3 and launch_counts["conv3x3_slab"] == 9
    assert graphs.replay("k", (torch.zeros((2, 3)), [torch.zeros(4)]), (torch.zeros(5),),
                         graphs.request()) is not None
    reset_launch_counts()


# ------------------------------------------------------------- the tree --

@pytest.fixture(scope="module")
def cpu_pipe():
    return StableDiffusionPipeline.from_random(TTINY, seed=0, device="cpu")


def _one_module_lora(tree):
    """A kohya adapter over one UNet projection (the first self-attention
    query)."""
    name, (leaf, _) = next((n, e) for n, e in sorted(tlora._index_unet(tree["unet"]).items())
                           if n.endswith("attn1_to_q"))
    ci, co = leaf["kernel"].shape[-2:]
    rng = np.random.default_rng(0)
    return {f"lora_unet_{name}.lora_down.weight": rng.standard_normal((2, ci)).astype(np.float32),
            f"lora_unet_{name}.lora_up.weight": rng.standard_normal((co, 2)).astype(np.float32)}


@pytest.mark.parametrize("change", ["load_lora", "unload_loras", "quantize_int8", "assign"])
def test_changing_the_tree_drops_every_graph(cpu_pipe, change):
    pipe = StableDiffusionPipeline(cpu_pipe.config, cpu_pipe.params, device="cpu")
    if change == "unload_loras":
        pipe.load_lora(_one_module_lora(pipe.params))
    pipe._unet_graphs._graphs["key"] = object()
    assert len(pipe._unet_graphs) == 1
    if change == "load_lora":
        assert pipe.load_lora(_one_module_lora(pipe.params))["applied"] == 1
    elif change == "unload_loras":
        assert pipe.unload_loras() == 1
    elif change == "quantize_int8":
        pipe.quantize_int8(vae=False)
    else:
        pipe.params = dict(pipe.params)
    assert len(pipe._unet_graphs) == 0


def test_a_cpu_request_runs_every_step_eagerly(cpu_pipe):
    pipe = StableDiffusionPipeline(cpu_pipe.config, cpu_pipe.params, device="cpu")
    with profiling.record_spans():
        profiling.clear_spans()
        pipe.generate(token_ids=TOKENS, num_inference_steps=2, seed=1)
        steps = [s for s in profiling.spans() if s["name"] == "unet_step"]
    assert [s["attrs"] for s in steps] == [{"graph": "eager"}] * 2
    g = pipe._unet_graphs
    assert (g.captures, g.replays, g.eager_steps, len(g)) == (0, 0, 2, 0)


# ---------------------------------------------------------------- card --

def _card(config, **unet):
    """``config`` in bf16 with these UNet fields: its resnets and
    up-samples take the slab kernels, its attention the flash kernel."""
    cfg = port_config(config)
    return cfg.replace(unet=dataclasses.replace(cfg.unet, **unet),
                       compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16)


def _compare(pipe, call):
    """The eager loop's image and launch counts, then a graphed request that
    captures and one that replays every step: each bitwise the eager image,
    with its launch counts key by key."""
    def run():
        reset_launch_counts()
        img = call()
        return img, dict(launch_counts)

    with tp_context(make_mesh()):  # the route off: the eager loop
        want, want_counts = run()
    g = pipe._unet_graphs
    for mode in ("capture", "replay"):
        captures, replays = g.captures, g.replays
        got, counts = run()
        np.testing.assert_array_equal(got, want, err_msg=mode)
        assert counts == want_counts, mode
        assert g.captures == captures + (mode == "capture")
        assert g.replays > replays
    return want


def _skip_without_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs have no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 2])
def test_a_graphed_tiny_sd_request_is_the_eager_one_bitwise(batch):
    _skip_without_a_card()
    pipe = StableDiffusionPipeline.from_random(_card(TINY, block_out_channels=(64, 64, 64)),
                                               seed=0, device="cuda")
    ids = np.tile(TOKENS[:1], (batch, 1))
    _compare(pipe, lambda: pipe.generate_batch(
        [""] * batch, token_ids=ids, seeds=list(range(batch)), num_inference_steps=3,
        image_size=64, output="float"))


@pytest.mark.gpu
def test_a_graphed_sdxl_shaped_request_is_the_eager_one_bitwise():
    """Two text encoders and the add-embedding folded into the time
    projections."""
    _skip_without_a_card()
    pipe = StableDiffusionPipeline.from_random(_card(TINY_XL, block_out_channels=(64, 64)),
                                               seed=0, device="cuda")
    ids = np.array([[1, 9, 200, 3] + [0] * 8])
    _compare(pipe, lambda: pipe.generate(token_ids=ids, num_inference_steps=3, seed=2,
                                         output="float"))


@pytest.mark.gpu
def test_a_graphed_lora_fused_request_is_the_eager_one_bitwise():
    """After ``load_lora`` the graphs of the base tree are gone: the fused
    request captures anew and equals the eager fused image, not the base."""
    _skip_without_a_card()
    pipe = StableDiffusionPipeline.from_random(_card(TINY, block_out_channels=(64, 64, 64)),
                                               seed=0, device="cuda")
    kw = dict(token_ids=TOKENS, num_inference_steps=3, seed=1, image_size=64, output="float")
    base = _compare(pipe, lambda: pipe.generate(**kw))
    assert len(pipe._unet_graphs) == 1
    pipe.load_lora({k: v * 4 for k, v in _one_module_lora(pipe.params).items()})
    assert len(pipe._unet_graphs) == 0
    fused = _compare(pipe, lambda: pipe.generate(**kw))
    assert not np.array_equal(fused, base)
