"""Device milliseconds of PyTorch's own kernels (``at::native``) launched
inside the traced requests' ``unet_step`` spans, per span."""

import re

NATIVE = re.compile(r"at::native")


def read(ctx):
    v = ctx.view
    if v is None or not v.steps:
        return None
    return 1e3 * v.device_in(v.steps, NATIVE) / len(v.steps)
