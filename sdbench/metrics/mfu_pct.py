"""The analytic FLOPs of the images finished in the window
(``work.request_flops``: matmuls and convolutions) over the window's wall
time, as a share of the H100's dense bf16 peak."""


def read(ctx):
    w, work = ctx.window, ctx.work
    if w.seconds <= 0:
        return None
    strength = ctx.mix.get("strength") if "init_image" in ctx.mix else None
    flops = sum(work.request_flops(ctx.cfg, r.rows, strength) / r.rows
                for r in w.records if r.image is not None)
    return 100.0 * flops / w.seconds / work.PEAK_FLOPS_BF16
