"""Device milliseconds of the kernels launched inside the program's
``unet.plain_resnet`` spans (a resnet whose map the slab rule refuses, on
GroupNorm -> SiLU -> conv2d) that lie inside the traced requests'
``unet_step`` spans, per ``unet_step`` span; None where the trace holds no
such span (a program without it, or a model whose every map takes the
slab route)."""

SPAN = "unet.plain_resnet"


def read(ctx):
    v = ctx.view
    if v is None or not v.steps:
        return None
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in v.events
                   if e["cat"] == "user_annotation" and e["name"] == SPAN
                   and any(a <= e["ts"] < b for a, b in v.steps))
    if not spans:
        return None
    return 1e3 * v.device_in(spans) / len(v.steps)
