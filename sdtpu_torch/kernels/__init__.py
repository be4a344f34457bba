"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper runs its plain version for a tensor on the CPU and launches its
CUDA kernel for a tensor on the card (it raises on anything else).  Every
launch of a CUDA kernel adds one to its entry in ``launch_counts``; the
plain versions count nothing.  A float 3x3 conv counts its GEMM under its
wrapper's name (``conv3x3_slab``, ``conv3x3_slab_upsample``,
``conv3x3_gemm``), and its prologue pre-pass and split-K reduction, where it
runs them, under ``conv3x3_slab_prologue`` and ``conv3x3_slab_splitk``
(``kernels/conv2d.py:conv3x3_launches``); the int8 conv counts its GEMM
under ``conv3x3_slab_int8`` and its pre-pass and split-K reduction under
``conv3x3_slab_int8_prologue`` and ``conv3x3_slab_int8_splitk``
(``conv3x3_int8_launches``).  Flash attention at D > 160
counts its key-split merge, where ``plan_flash`` splits, under
``flash_attention_merge`` (``kernels/flash_attention.py:flash_launches``),
kernel G's split-K reduction under ``out_proj_packed_splitk``
(``kernels/flash_attention.py:out_proj_launches``), kernel J's bf16
split-K reduction under ``dot_bf16_splitk``, and J int8's transpose of w
and split-K reduction under ``dot_int8_transpose`` and ``dot_int8_splitk``
(``tools/probe_int8_dot.py:dot_launches``).  The transformer block's row
passes, which replace no TPU kernel, count under ``layer_norm_rows`` and
``geglu_rows`` (``kernels/rowwise.py``).
"""

launch_counts = {
    "conv3x3_slab": 0,
    "conv3x3_slab_upsample": 0,
    "conv3x3_slab_prologue": 0,
    "conv3x3_slab_splitk": 0,
    "conv3x3_slab_int8": 0,
    "conv3x3_slab_int8_prologue": 0,
    "conv3x3_slab_int8_splitk": 0,
    "flash_attention": 0,
    "flash_attention_stats": 0,
    "flash_attention_merge": 0,
    "out_proj_packed": 0,
    "out_proj_packed_splitk": 0,
    "conv3x3_gemm": 0,
    "flash_attention_legacy": 0,
    "flash_attention_nq": 0,
    "dot_bf16": 0,
    "dot_bf16_splitk": 0,
    "dot_int8": 0,
    "dot_int8_transpose": 0,
    "dot_int8_splitk": 0,
    "layer_norm_rows": 0,
    "geglu_rows": 0,
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
