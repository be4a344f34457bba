"""CUDA launch API calls (``cudaLaunchKernel*``, ``cuLaunchKernel*``,
``cudaGraphLaunch``) the host made inside the traced requests'
``unet_step`` spans, over the number of those spans."""


def read(ctx):
    v = ctx.view
    if v is None or not v.steps:
        return None
    return v.launches_in(v.steps) / len(v.steps)
