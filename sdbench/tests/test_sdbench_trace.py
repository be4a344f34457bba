"""The trace arithmetic on synthetic Chrome-trace records: the slice's idle
share and gaps, the whole requests, launch calls and elementwise device
time per step, the rooflines' kernel sets."""

import types

import pytest

from sdbench import spec, work
from sdbench.tests.tiny import TINY
from sdbench.trace import View, split


def span(name, ts, dur, cat="user_annotation", corr=0):
    return {"cat": cat, "name": name, "ts": float(ts), "dur": float(dur), "corr": corr, "tid": 1}


def synthetic():
    """Request 0 in flight before the trace (its fetch alone is traced),
    request 1 whole (two steps of three launches each, a decode), request 2
    dispatched but not fetched.  Device: kernels of request 1 and one of
    request 0 (launched before the trace: no launch record)."""
    ev = [span("sdbench.slice", 0, 1000),
          span("sdbench.request.1", 0, 300), span("unet_step", 10, 100),
          span("unet_step", 120, 100), span("vae_decode", 230, 50),
          span("sdbench.fetch.0", 310, 40), span("sdbench.request.2", 360, 300),
          span("unet_step", 370, 100), span("sdbench.fetch.1", 700, 250)]
    corr = 100
    for step in (10, 120, 370):
        for j in range(3):
            corr += 1
            ev.append(span("cudaLaunchKernel", step + 10 + 20 * j, 5, "cuda_runtime", corr))
            kind = ("void at::native::vectorized_elementwise_kernel<4>(...)" if j < 2 else
                    "void (anonymous namespace)::conv3x3_kernel<true>(...)")
            ev.append(span(kind, 400 + 20 * (corr - 100), 10, "kernel", corr))
    ev.append(span("void cudnn::fprop_kernel(...)", 0, 100, "kernel", 7))  # request 0's
    ev.append(span("cudaMemcpyAsync", 920, 5, "cuda_runtime", 900))
    ev.append(span("Memcpy DtoH", 940, 20, "gpu_memcpy", 900))
    return ev


def test_whole_requests_steps_and_launches():
    v = View(synthetic())
    assert v.whole == [(0.0, 300.0)]
    assert len(v.steps) == 2 and len(v.decodes) == 1 and not v.encodes
    assert v.launches_in(v.steps) == 6


def test_split_idle_share_and_gaps():
    sp = split(View(synthetic()))
    # busy: [0, 100) + nine 10 us kernels at 420, 440, ... 580 + [940, 960)
    assert sp["window_s"] == pytest.approx(1000e-6)
    assert sp["busy_s"] == pytest.approx((100 + 90 + 20) * 1e-6)
    assert sp["idle_share"] == pytest.approx(1 - 210 / 1000)
    longest = sp["idle_gaps"][0]
    assert longest == ["between stages", pytest.approx(350e-6)]  # 590 -> 940
    assert sp["idle_gaps"][1][1] == pytest.approx(320e-6)  # 100 -> 420
    assert sp["device_ops"][0][0] == "void cudnn::fprop_kernel(...)"


def _metric(name):
    from sdbench.run import load_metric

    return load_metric(name)


def _ctx(view, mix=None):
    return types.SimpleNamespace(cfg=TINY, mix=mix or {"batch": 1}, view=view,
                                 split=split(view) if view else None, work=work)


def test_per_step_readers():
    ctx = _ctx(View(synthetic()))
    assert _metric("host_launch_calls_per_step")(ctx) == 3
    # two at::native kernels of 10 us in each of request 1's two steps
    assert _metric("elementwise_ms_per_step")(ctx) == pytest.approx(0.020)
    assert _metric("device_idle_pct")(ctx) == pytest.approx(79.0)


def test_conv_roofline_sums_request_ones_kernels_only():
    ctx = _ctx(View(synthetic()))
    lat = TINY["image_size"] // 2
    least = work.conv_least_s(work.unet_convs(TINY["unet"], lat, 2) * 2
                              + work.vae_decode_convs(TINY["vae"], lat, 1), 2)
    # request 1's two conv3x3_kernel launches; request 0's cudnn kernel is not its
    assert _metric("conv3x3_roofline")(ctx) == pytest.approx(100 * least / 20e-6)


@pytest.mark.parametrize("name", ["host_launch_calls_per_step", "elementwise_ms_per_step",
                                  "conv3x3_roofline", "attention_roofline",
                                  "device_idle_pct", "device_idle_pct.serve"])
def test_readers_return_nothing_without_a_trace(name):
    assert _metric(name)(_ctx(None)) is None


def test_attention_kernel_names():
    read = _metric("attention_roofline")
    pattern = read.__globals__["KERNELS"]
    for name in ("void (anonymous namespace)::flash_reg_kernel<64, 4, false>(...)",
                 "void (anonymous namespace)::flash_wide_kernel<512>(...)",
                 "void (anonymous namespace)::flash_merge_kernel(float const*, ...)",
                 "void pytorch_flash::flash_fwd_kernel<...>(...)",
                 "fmha_cutlassF_bf16_aligned_64x64_rf_sm80"):
        assert pattern.search(name), name
    for name in ("void at::native::vectorized_elementwise_kernel<4>(...)",
                 "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
                 "void (anonymous namespace)::conv3x3_kernel<true>(...)"):
        assert not pattern.search(name), name


def test_conv_kernel_names():
    pattern = _metric("conv3x3_roofline").__globals__["KERNELS"]
    for name in ("void (anonymous namespace)::conv3x3_kernel<true, false>(...)",
                 "void (anonymous namespace)::prologue_kernel(__nv_bfloat16 const*, ...)",
                 "void (anonymous namespace)::splitk_reduce_kernel<true, true>(float const*)",
                 "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
                 "void cudnn::engines_precompiled::nchwToNhwcKernel<...>"):
        assert pattern.search(name), name
    for name in ("void (anonymous namespace)::splitk_reduce_kernel(float const*, float const*)",
                 "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
                 "void (anonymous namespace)::flash_reg_kernel<64, 4, false>(...)"):
        assert not pattern.search(name), name


def test_a_closed_loop_traces_one_whole_request_after_the_window():
    """The host side of a real profiler run on the CPU: the traced request
    is whole, its steps and decode are found, the window's records hold no
    traced request."""
    from sdbench import drive
    from sdbench.tests.tiny import TINY as cfg
    from sdbench.traffic import batched
    from sdbench.tests.tiny import mix
    from sdbench.trace import Tracer
    from sdbench.weights import pipeline_params
    from sdtpu_torch import StableDiffusionPipeline

    m = mix("batch8", batch=2)
    pc = spec.pipeline_config(cfg)
    pipe = StableDiffusionPipeline(pc, pipeline_params(pc, 1, "cpu"), device="cpu")
    inputs = drive.Inputs(1, m, cfg)
    tracer = Tracer(True)
    w = batched.run(pipe, cfg, m, inputs, 0.3, tracer)
    v = View(tracer.events)
    assert len(v.whole) == 1
    assert len(v.steps) == cfg["steps"] and len(v.decodes) == 1
    last = max(r.batch for r in w.records)
    traced = [e["name"] for e in tracer.events if e["name"].startswith("sdbench.request.")]
    assert all(int(n.rsplit(".", 1)[1]) > last for n in traced)
