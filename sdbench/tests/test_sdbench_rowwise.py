"""``rowwise_ms_per_step`` on synthetic Chrome-trace records: nothing without
the row kernels, and only the row kernels launched inside the whole
requests' ``unet_step`` spans, per span."""

import pytest

from sdbench.tests.test_sdbench_trace import _ctx, _metric, span, synthetic
from sdbench.trace import View

LN = "void (anonymous namespace)::layer_norm_rows_kernel<__nv_bfloat16, __nv_bfloat16, 2>(...)"
GEGLU = "void (anonymous namespace)::geglu_rows_kernel<__nv_bfloat16, __nv_bfloat16>(...)"


def with_row_kernels():
    """``synthetic()``'s trace plus row kernels: in request 1's two steps
    (LayerNorm 3 and 5 us, GeGLU 7 us in the first; GeGLU 11 us in the
    second), in its decode (13 us) and in request 2's step, whose request
    was not fetched (17 us)."""
    ev = synthetic()
    corr = 500
    for launch_ts, name, dur in ((15, LN, 3), (60, LN, 5), (90, GEGLU, 7), (130, GEGLU, 11),
                                 (240, LN, 13), (380, GEGLU, 17)):
        corr += 1
        ev.append(span("cudaLaunchKernel", launch_ts, 2, "cuda_runtime", corr))
        ev.append(span(name, 600 + corr, dur, "kernel", corr))
    return ev


def test_none_without_the_row_kernels():
    assert _metric("rowwise_ms_per_step")(_ctx(View(synthetic()))) is None


def test_none_without_a_trace():
    for name in ("rowwise_ms_per_step", "rowwise_ms_per_step.sdxl", "rowwise_ms_per_step.i2i"):
        assert _metric(name)(_ctx(None)) is None


def test_sums_the_whole_requests_steps_only():
    ctx = _ctx(View(with_row_kernels()))
    # (3 + 5 + 7) + 11 us over request 1's two steps; the decode's and the
    # unfetched request's kernels are outside
    assert _metric("rowwise_ms_per_step")(ctx) == pytest.approx(0.013)
    # the per-cell names read the same file
    assert _metric("rowwise_ms_per_step.sdxl")(ctx) == pytest.approx(0.013)
    # the row kernels are no at::native kernel: elementwise time is unchanged
    assert _metric("elementwise_ms_per_step")(ctx) == pytest.approx(0.020)


def test_row_kernel_names():
    pattern = _metric("rowwise_ms_per_step").__globals__["KERNELS"]
    for name in (LN, GEGLU, "void (anonymous namespace)::layer_norm_rows_kernel<float, float, 10>"
                 "(float const*, ...)"):
        assert pattern.search(name), name
    for name in ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<...>(...)",
                 "void at::native::vectorized_elementwise_kernel<4>(...)",
                 "void (anonymous namespace)::splitk_reduce_kernel(float const*, ...)"):
        assert not pattern.search(name), name
