"""sdtpu_torch: the PyTorch/CUDA port of sdtpu for one NVIDIA H100.

Same module layout, function names, parameter trees and tensor layouts as
the JAX package ``sdtpu`` (NHWC activations, HWIO conv kernels, (in, out)
linear kernels), in plain PyTorch, with hand-written CUDA kernels for the
hot path (``kernels/``, sources in ``csrc/``).  The kernels build with
``nvcc`` on first use; importing the package needs neither ``nvcc`` nor a
card.

    from sdtpu_torch import StableDiffusionPipeline
    pipe = StableDiffusionPipeline.from_random("tiny-sd", seed=0)   # on cuda
    image = pipe.generate(token_ids=ids, num_inference_steps=25, seed=40)
"""

from sdtpu_torch.config import (
    CLIPConfig,
    PipelineConfig,
    SchedulerConfig,
    TINY_SD,
    UNetConfig,
    VAEConfig,
    get_preset,
)

__version__ = "0.1.0"


def __getattr__(name):
    if name == "StableDiffusionPipeline":
        from sdtpu_torch.pipeline.pipeline import StableDiffusionPipeline

        return StableDiffusionPipeline
    raise AttributeError(f"module 'sdtpu_torch' has no attribute {name!r}")


__all__ = [
    "CLIPConfig",
    "PipelineConfig",
    "SchedulerConfig",
    "StableDiffusionPipeline",
    "TINY_SD",
    "UNetConfig",
    "VAEConfig",
    "get_preset",
    "__version__",
]
