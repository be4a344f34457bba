"""Device milliseconds of the transformer block's row kernels (the
``layer_norm_rows_kernel`` and ``geglu_rows_kernel`` ``__global__``
functions of ``sdtpu_torch/csrc/rowwise.cu``) launched inside the traced
requests' ``unet_step`` spans, per span; None where the trace holds none
of them (a program without the kernels)."""

import re

KERNELS = re.compile(r"::(?:layer_norm_rows|geglu_rows)_kernel\b")


def read(ctx):
    v = ctx.view
    if v is None or not v.steps:
        return None
    device = v.device_in(v.steps, KERNELS)
    return 1e3 * device / len(v.steps) if device > 0 else None
