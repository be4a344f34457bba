#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sdtpu_torch``) once on one NVIDIA card.

    python3 chip_smoke.py [--out details.json] [--trace-dir build/trace]

Phases, each printing its own lines; any failure ends the run non-zero:

1. device  -- needs CUDA; prints ``nvidia-smi`` name and power limit.
2. build   -- compiles every ``sdtpu_torch/csrc/*.cu`` with nvcc for sm_90a
              into ``build/`` (one nvcc per source, all started together);
              prints each kernel's registers and spills as ptxas reports
              them.
3. kernels -- each hand-written kernel against its plain PyTorch version on
              the card at the main paths' shapes (tolerance stated per
              line; the slab conv also at its split-K shapes, and its
              pre-pass and split-K reduction alone; flash attention C and F,
              out, m and l, also at ragged shapes at D = 40, 80, 160, 512:
              Lq and Lk no multiple of their tiles, Lq under one tile; the
              key-split merge alone), then every kernel call
              configuration of the main paths timed with CUDA events, each
              slab conv configuration with its split S, each attention one
              with its plan (query tile, key splits) and, beside the events,
              the profiler's device time of the kernels and the library
              (per call and per image): the kernel, its plain version, and one
              library call for the same function as a yardstick (for the
              int8 slab conv, which no one call computes, two float
              counterparts instead: kernel A and cuDNN bf16).  Kernels F
              and G are checked and timed at every call shape of the ring
              and the packed routes, recorded from a one-step image of each
              (G with its plan: column tile, K splits; two calls bitwise
              equal; where it splits, its split-K reduction alone, bitwise),
              and their device time is also read from torch.profiler (at
              these shapes a call's kernel can be shorter than its
              host-side enqueue, which then sets the CUDA-event time).
              The transformer block's row passes (``layer_norm_rows``,
              ``geglu_rows``) are checked at every call configuration of the
              bf16 image (CLIP-L's and the UNet's) within ROW_ULPS of their
              plain versions and timed the same way, beside F.layer_norm
              and the bytes bound; every later phase checks the
              configurations its requests add (``hold_shapes``), SDXL's
              with bigG's and its UNet's timed per image.
4. e2e     -- ``StableDiffusionPipeline.from_random("tiny-sd")`` and one
              512x512, 25-step DDPM + CFG image (after a warm-up image);
              checks the image and the kernels' launch counts (the slab
              conv's pre-pass and split-K reductions derived from the
              recorded calls and the split plan; the row passes'
              E2E_COUNTS held to the recorded calls), prints
              seconds per image and peak memory; then one full-width UNet
              forward and one VAE decode through the kernels and through
              the plain versions, beside the plain path's own bf16-versus-
              float32 difference; and the request with its UNet forwards
              replayed as CUDA graphs against the eager loop (a one-process
              ``tp_context`` keeps the graphs off, as ``routed`` does for
              every shim): float images bitwise equal, launches exact.
5. ring    -- ``attention_impl="ring"`` under ``ring_context(LocalRing(4))``:
              all four shards of the sequence-parallel ring on the one card,
              every latent self-attention through kernel F (16 launches per
              attention call); a warm-up and one timed image with exact launch
              counts (derived from the tree), then the ring UNet forward and
              VAE decode through the kernels against the plain ring route,
              beside that route's bf16-vs-f32 difference, and (for
              information) against the flash route.
6. nccl    -- ``health_check`` on a one-rank NCCL group, and the ring over
              ``ProcessGroupRing`` on it against ``LocalRing(1)``.
7. packed  -- the flash route with ``_PACKED_OUT_PROJ`` on: every
              self-attention's out-projection and residual add through
              kernel G; an image with exact launch counts (G's split-K
              reductions derived from the recorded calls and the plan) and the same
              kernels-vs-plain control; then seconds per image of the
              flash, packed and ring routes in turns (flash, packed, ring,
              ring, packed, flash).
8. int8    -- the same pipeline after ``quantize_int8(transformer=True,
              vae=True)``: the quantization's host seconds; the int8 slab
              kernel checked and timed (phase 3's work) at every int8 call
              shape; a warm-up and one timed image with exact launch counts
              (every resnet conv on the int8 slab kernel); then the int8
              UNet forward and VAE decode through the kernels against the
              plain int8 route, beside the plain int8 route's own
              bf16-vs-float32 difference (the tolerance's yardstick), its
              int8-vs-bf16 difference, and the bf16 route's bf16-vs-f32.
9. probes  -- the kernels of the measurement entry points: E (the whole-map
              conv of ``conv2d(impl="gemm")``) at the tiny-sd resnet shapes
              that ``plan_co_tile`` accepts (two of them split-K) and at a
              ragged split-K shape, H and I (every chain count) at
              two latent self-attention shapes, J (int8 bitwise, bf16) at
              the probe's two GEMM shapes and J's bf16 split-K reduction
              alone (bitwise) where ``plan_dot`` splits, each against its
              plain version, then timed beside its bound, its plain version
              and one library call where there is one (CUDA events and
              profiler device time); then
              every kernel variant the tools run, at the tools' own shapes
              and inputs, against its plain version (``ab_conv``'s E and A
              with and without prologue; C, H and every chain variant of I
              at tiny-sd b1 and b8, SD2.1 768 and SDXL 1024, the plain
              attention over blocks of query rows); then each tool's ``main()`` (``sdtpu_torch/tools/``) at a short
              chain, with the launch counters held to the calls it made.
10. seeds  -- ``utils/prng.py``'s draws on the card against its numpy form
              for seeds 0, 40 and 2^32-1 at the image's shape (bits and
              uniforms bitwise, normals within 4 ulp); the host time of one
              request's draws; two ``generate(seed=40)`` images bitwise
              equal; the host syncs left in one ``output="device"`` request
              (``torch.cuda.set_sync_debug_mode("warn")``).  Phase 3 prints
              ``from_random``'s host seconds; phase 8 quantizes the same tree.
11. bench  -- ``sdtpu_torch.bench.main`` in this process with ``--repeats
              3``: default, ``--int8`` and the packed route, each JSON line
              checked (value > 0, device, 0 < mfu_pct <= 100) and its
              launches held to its images (the default's to phase 4's
              counts).
12. library -- s/image of the kernel route and of ``attention_impl="xla",
              conv_impl="xla"`` (SDPA and cuDNN) in turns; the library route
              launches no kernel but the row passes, which every route takes.
13. stages -- ``tools/profile_stages`` at tiny-sd 512; one ``profiling.trace``
              of a warm bf16 image, read back from its ``trace.json`` by
              ``tools/summarize_trace.trace_split``: wall, device-busy time
              (the union of the card's activity intervals), idle share,
              device time by kind (hand-written kernels, library
              GEMMs/convs, PyTorch's elementwise and reductions, copies),
              the ten device ops with the most time, the five longest
              device-idle gaps with the host stage each falls in (the
              library route's image traced and summarised beside it);
              ``StageTimer``'s split of the same request; then
              ``tools/capture_trace`` at tiny-sd 512 (1 repeat: 2
              pipelined images of the bench's workload) and
              ``summarize_trace`` on its file: the unet_step window's
              device and host self time, and its split, whose kinds must
              be the bf16 image's and whose idle share must lie within
              CAPTURE_IDLE_TOL of it (~15-18 s).
14. checkpoint -- a full-width tiny-sd directory in diffusers' fp16 layout
              written under ``build/`` (``tests/torch_ref.py``'s UNet and
              VAE with seeded random weights, the CLIP keys from the port's
              seeded tree, the JSON configs), loaded by
              ``from_pretrained(device="cuda")`` (host seconds, bytes read,
              peak memory; the config from its JSON equal to tiny-sd's);
              ``tools/validate_checkpoint``: the UNet (batch 2, 64x64), the
              VAE decode and the 512x512 VAE encode through the kernels
              (bf16) against the mirror in float32, within max(2 x the
              plain route's bf16-vs-f32 difference, 1e-2); one encode's
              launches of A (its pre-passes and split-K reductions) and C
              (its merge) held to the counts derived from its recorded
              calls and the plans, against its plain version, and its
              kernels timed; one 512x512, 25-step, CFG 7.5 image per
              sampler (ddim, euler, euler-a, dpm++-karras, dpm++-sde, unipc,
              lcm, after ddpm as the yardstick): s/image, finite, two runs
              bitwise equal, the bf16 image's launch counts; ``bench
              --sampler dpm++-karras``; the directory converted by
              ``tools/convert_checkpoint`` (bf16, on the card) and
              ``load_converted`` onto the card, held bitwise to
              ``from_pretrained``'s tree (the cache's bytes, both load
              times); ``tools/generate_grid --model-dir`` on the directory
              (1 prompt x 2 seeds, 4 dpm++ steps at 512x512), each tile
              bitwise its seed's row of the same ``generate_batch`` (~2-3 s).
              The directory, its cache and the grid are deleted at the end.
15. conditioned -- on the seed-0 tiny-sd tree again: (a) img2img and
              latent-blend inpainting at 512x512, 25 DDPM steps at strength
              0.75 (18 steps), CFG 7.5: exact launches (recorded calls,
              and A/B/C predicted from a UNet step's, the decode's and the
              encode's), the final latents through the kernels against the
              plain route in bf16, beside its bf16-vs-f32 difference;
              (b) ``generate_batch`` of 4 rows with per-request seeds (the
              bf16 image's A/B/C launches, s, peak memory) and the ported
              ``tools/check_batch_invariance`` at its defaults, on its own
              weights (0.04 x normals, the JAX tool's); (c) on those
              weights a ``ServingEngine`` answering 8 requests (a txt2img
              bucket with two negative prompts and an img2img bucket, at
              most 4 rows a batch), each image held to its solo row within
              the gate's envelope at its 4 Euler steps; then, measured
              beside a yardstick (the solo image through the kernels
              against the plain versions), the same at 25 DDPM steps and
              4 requests on the seed-0 tree; (d)
              ``sd15-inpaint`` and ``ip2p`` at full width on seeded random
              weights (``sd15-inpaint``'s ``from_random`` tree, drawn once on
              the host for phases 15-17, its seconds printed; ``ip2p`` takes
              its conv_in's first 8 channels): one 512x512 request each with
              exact launches, one UNet forward at its inputs (batch 2 and
              3) through the kernels against the plain route; (e) the
              bench's ``--img2img``, ``--batch 4`` and ``--serving`` lines
              with their launches held to their requests.
16. sdxl   -- the SDXL family and LCM's guidance embedding on seeded random
              weights: (a) ``sdxl`` at 1024x1024 (``from_random`` host
              seconds, the tree's bytes), one 25-step DDPM CFG 7.5 image
              with its launches held to its recorded calls (a UNet step's
              times 25, plus the decode's; the configs' A/B/C printed
              beside), every A, B and C call shape of it held to its plain
              version at TOL_REL and timed beside it and the library (per
              image: kernels, plain, library, bound), one traced 10-step
              image's device-busy time and idle share, one UNet forward at
              batch 2
              (128x128 latents, 2048-wide context, the add-embedding)
              through the kernels against the plain route and float32;
              (b) ``sdxl-turbo`` at 512x512 on the same tree (4 Euler steps,
              no CFG) with its launches held, then on the gate's weights
              (0.04 x normals, drawn on the card)
              ``generate_batch`` of 4 and a ``ServingEngine`` answering 8
              requests, each row within 1 level on 3% of values of its
              solo image; (c) the handoff: ``sdxl`` with
              ``denoising_end=0.8, output="latents"``, then
              ``sdxl-refiner`` (the base's clip_2 and VAE leaves, its UNet
              drawn from ``from_random``'s key) with ``denoising_start=0.8``,
              launches held; (d) ``lcm-sd15`` (the SD-1.5 family's tree, a
              ``cond_proj`` drawn), one 512x512 4-step request, launches
              held; in (b)-(d) every A, B and C call shape that
              sdxl's image did not run (turbo at batch 1 and 4, the
              refiner's 384/768/1536 channels, LCM) held to its plain
              version at TOL_REL; (e) the bench's ``--preset sdxl --steps 10
              --repeats 3`` and ``--preset sdxl-turbo --batch 4 --repeats
              3`` lines with their launches held to their requests.
17. features -- ControlNet and the denoise step's features on ``sd15`` at
              full width and depth (the SD-1.5 family's tree; the ControlNet
              ``init_controlnet(1)`` as the JAX package draws it, a second
              net drawn on the card, the zero convs and the cond embedding's
              conv_out drawn non-zero on the card), 512x512, 25 DDPM steps,
              CFG 7.5, bf16: one ControlNet image, one step's residuals
              and the UNet output with them kernels vs plain (the rule of
              phase 4), a two-net image, ControlNet with img2img at strength
              0.75, ControlNet on ``generate_batch`` of 4 on the gate's
              weights (4 Euler steps, each row within the gate's envelope of
              its solo image), PAG 3.0 (the mid block's site), FreeU, CFG
              rescale 0.7, ``generate_hires`` from 256 to 512; on tiny-sd's
              seed-0 tree PAG at the deepest attention level, the encoder
              cache at k = 3 and a ControlNet of zeros; every request's
              launches held to its recorded calls (A/B/C beside the configs'
              reading), every A/C call configuration of the phase held to
              its plain version at TOL_REL; the bench's ``--controlnet``,
              ``--pag-scale 3`` and ``--encoder-cache 3`` lines (``--repeats
              3``) with their launches held to the tiny-sd requests.
18. text   -- the text features on ``sd15`` at full width and depth (the
              SD-1.5 family's tree), 512x512, 25 DDPM steps, CFG 7.5, bf16,
              a byte-level tokenizer: (a) a seeded rank-8 kohya LoRA over
              every UNet module (conv_in, the 1x1 shortcuts, the samplers'
              convs, LoCon 3x3 convs with a flattened down) and every CLIP
              layer at scale 0.8: the base image, ``load_lora`` (host s, the
              snapshots' bytes), the fused image, one fused UNet forward
              kernels vs plain (phase 4's rule), ``unload_loras`` (the tree
              bitwise the pre-load tree) and the restored image (bitwise
              the base image); (b) a 2-vector textual-inversion concept in a
              prompt (its ids in the prompt's); (c) a prompt-weighted image,
              all-ones token weights (bitwise the base image), a two-window
              weighted prompt; every request's launches held to its
              recorded calls (the one-window requests to the base's), every
              A/C call configuration of the phase held to its plain version
              at TOL_REL; (d) four weighted requests through a
              ``ServingEngine`` on the gate's weights (4 Euler steps): one
              batch of 4, each row within the gate's envelope of its solo
              image.  The phase's seconds are printed, and the script's.
19. mesh   -- the dp/tp mesh (``sdtpu_torch.parallel``) on ``tiny-sd`` at
              full width on the gate's weights (0.04 x normals drawn on
              the card), 512x512, 4 Euler steps, CFG, two requests with
              their own seeds: (a) one process, ``make_mesh(1, 1)``:
              ``generate_batch(mesh=)`` and ``ServingEngine(mesh=)`` give
              bitwise the images and exactly the launches of the same calls
              without a mesh, and ``health_check(mesh)`` is ok; (b) two
              gloo processes that both drive the card (the kernels from
              phase 2's ``build/``, the tree written once by
              ``save_converted`` and read by each rank with
              ``load_converted``; which collectives gloo takes on CUDA
              tensors printed): dp = 2, each rank's row bitwise the request
              alone at batch 1 and within the gate's envelope of the
              one-process batch of 2; tp = 2 on ``shard_params_tp``'s tree,
              the image within the envelope of the one-process image, C on
              4 of the 8 heads on each rank and the VAE's single head
              gathered, A, B and C launched as without a mesh; the same
              with kernel G as the partial product; every C and G call
              shape of the shards held to its plain version.  Each run's
              launches are held to its recorded calls; the phase's seconds
              are printed.  The ``kernels`` line's A, B, C and G rows carry
              the phase's launches as ``mesh_launches``.  About 25 s, the
              two ranks' processes ~22 s of it.
20. fidelity -- the on-card fidelity gates and the presets no earlier phase
              runs, each part with its own lines and ``details`` entry:
              (a) ``tools/device_precision`` at tiny-sd 512x512 through its
              functions: CLIP, one CFG-batched UNet forward and one VAE
              decode, bf16 through kernels A, B and C against float32 on
              the library route (TF32 off), gated at the JAX tool's values;
              (b) ``tools/check_int8`` at tiny-sd 512x512, 25 steps: D
              against A at (2, 16, 16, 1280), one UNet forward and one
              decode int8 against bf16, the pipeline's int8-vs-bf16 PSNR
              against the bf16-vs-float32 control (the library route in
              float32: the kernels take bf16 only), gated at the JAX tool's
              values (phase 8's int8 VAE PSNR is printed there, gated
              here); (c) ``sd21`` at 768x768 (``from_random`` on the host, a
              warm-up and one timed 25-step v-prediction image, s/image and
              peak memory), its launches held to its recorded calls beside
              the configs' reading, every new A/B/C call configuration held
              to its plain version, one UNet forward (b2 96x96) kernels vs
              plain vs float32; (d) ``sdxl`` in int8 on phase 16's shapes
              with the int8 gate's weights drawn on the card (norm scales
              ones, biases zeros): ``quantize_int8(transformer=True,
              vae=True)``'s host seconds, one 10-step 1024x1024 image with
              its launches held and D's count read from the tree, kernel D
              checked and timed at every call configuration phase 8 did not
              run (beside its bound, plain version, kernel A and cuDNN
              bf16), then ``check_int8``'s gates on the tool's own int8
              tree (the UNet's convs): the UNet forward (b2 128x128, the
              add-embedding) measured, not gated (gate 2 at SDXL is open:
              PERF.md section 6), beside its bf16-vs-float32 yardstick and
              its split by part (int8 in the encoder's, the mid block's or
              the decoder's resnets alone), the 1024x1024 decode and the
              10-step pipeline margin gated; the margin of the served
              ``transformer=True`` tree printed beside it; (e) ``sdxl-inpaint`` on phase 16's tree with a
              9-channel conv_in drawn from ``init_unet``'s key for it
              (= its ``from_random``), one 1024x1024 10-step request at
              strength 1 with an init image and a mask (two 1024x1024 VAE
              encodes), launches held, new shapes held to plain; (f) one
              ControlNet at 1024x1024, its encoder half phase 16's UNet
              leaves (checked key by key against ``init_controlnet``'s
              shapes), its cond embedding drawn from its key, the zero
              convs and conv_out drawn on the card: a 10-step image with
              its launches held beside the configs' reading, one step's
              residuals and the UNet output with them kernels vs plain vs
              float32, the new A/C shapes held to plain.  Phase 16 keeps
              its ``sdxl`` tree for (d)-(f).
21. last tools -- the last tools of ``tools/`` on the card, ~45 s: (a) the probes'
              ``main()`` at a chain of 2 (``probe_slab_halo``: A at the
              five large maps and B against nearest upsample + A;
              ``probe_out_proj``: G at the six out-projection shapes, real
              head dims; ``probe_flash_blocks``, ``probe_flash_int8``,
              ``probe_head_packing``: C under every plan it takes, beside
              SDPA, traced and summarized; ``ab_slab_grid``: A under every
              split S up to the plan's cap), each variant held by the tool
              to its plain version within TOL_REL and each tool's launches
              to the calls it made; (b) the A/B chains at tiny-sd 512,
              chain 2 (``ab_conv_stats`` UNet and ``--vae``,
              ``ab_packed_proj``, ``ab_flash_nq``), their launches held to
              one recorded chain of each variant times its runs; (c) C
              under every plan at the probes' shapes against its plain
              version; (d) ``CONV_STATS_CHAIN`` off against on on the
              seed-0 tree: a full-width UNet forward and VAE decode through
              the kernels within max(2 x the plain route's bf16-vs-f32,
              1e-2) of each other (phase 4's rule), and one 512x512 25-step
              image each, finite, with the bf16 image's launches and its
              s/image (the images are not held to each other: a rounding
              change moves the seed-0 image by levels).  Phase 21 with the
              additions to phases 13 and 14 is printed; it should stay
              within 90 s.

A flash kernel's bound counts one exponential per score at 16 per clock
per SM (``nvidia-smi`` clocks.max.sm) beside its bytes and tensor
operations.

Every float32 reference on the card runs with TF32 off (cuBLAS and cuDNN).
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import time
from collections import Counter

# event_ms: CUDA events around back-to-back calls; device_ms: the kernels'
# own time under torch.profiler, so that a call whose kernel is shorter than
# its host-side enqueue is not timed by the host; the card's peaks and rates
# (H100 SXM data sheet), TOL_REL (max |kernel - plain| <= TOL_REL * max
# |plain|), the bound of a call's cost, the plain attention by query rows
from sdtpu_torch.tools import (
    EXP_PER_CLOCK_SM,
    PEAK_BF16_FLOPS,
    PEAK_INT8_OPS,
    SMS,
    TOL_REL,
    bound_ms,
    bound_terms,
    by_rows,
    device_ms,
    event_ms,
    flash_cost,
)
# the stage spans of a profiler trace and its split into device-busy and
# idle time (phases 13 and 16)
from sdtpu_torch.tools.summarize_trace import STAGES, trace_split

STEPS = 25                # the main path's DDPM steps (bench.py's default workload)
# the bf16 image's launches of each wrapper; the slab conv's pre-pass and
# split-K reduction (conv3x3_slab_prologue, conv3x3_slab_splitk, and the
# int8 conv's conv3x3_slab_int8_prologue, conv3x3_slab_int8_splitk) are
# added per path from its recorded calls (conv_sub_counts)
# and flash attention's key-split merge (flash_attention_merge) likewise from
# its recorded calls (flash_sub_counts)
E2E_COUNTS = {"conv3x3_slab": 478, "conv3x3_slab_upsample": 53, "conv3x3_slab_int8": 0,
              "conv3x3_slab_int8_prologue": 0, "conv3x3_slab_int8_splitk": 0,
              "flash_attention": 226, "flash_attention_stats": 0, "flash_attention_merge": 0,
              "out_proj_packed": 0, "out_proj_packed_splitk": 0,
              "conv3x3_gemm": 0, "flash_attention_legacy": 0, "flash_attention_nq": 0,
              "dot_bf16": 0, "dot_bf16_splitk": 0, "dot_int8": 0, "dot_int8_transpose": 0,
              "dot_int8_splitk": 0, "layer_norm_rows": 700, "geglu_rows": 225}
# the row passes of the bf16 image: 3 LayerNorms and 1 GeGLU in each of tiny-sd's 9
# transformer blocks a step, and CLIP-L's 25 LayerNorms (2 a layer, the final one)
ROW_KERNELS = ("layer_norm_rows", "geglu_rows")
ROW_ULPS = {"bfloat16": 1, "float32": 8}  # row kernels vs plain, ulps at the row's max |plain|
RING = 4                  # shards of the sequence-parallel ring on the one card
SOURCES = {  # kernel: (its source, the pallas_call of the TPU kernel it replaces)
    "conv3x3_slab": ("sdtpu_torch/csrc/conv3x3_slab.cu", "sdtpu/kernels/conv2d.py:456"),
    "conv3x3_slab_upsample": ("sdtpu_torch/csrc/conv3x3_slab.cu",
                              "sdtpu/kernels/conv2d.py:456"),
    "conv3x3_slab_prologue": ("sdtpu_torch/csrc/conv3x3_slab.cu",
                              "sdtpu/kernels/conv2d.py:456"),
    "conv3x3_slab_splitk": ("sdtpu_torch/csrc/conv3x3_slab.cu",
                            "sdtpu/kernels/conv2d.py:456"),
    "flash_attention": ("sdtpu_torch/csrc/flash_attention.cu",
                        "sdtpu/kernels/flash_attention.py:267"),
    "conv3x3_slab_int8": ("sdtpu_torch/csrc/conv3x3_slab_int8.cu",
                          "sdtpu/kernels/conv2d.py:456"),
    "conv3x3_slab_int8_prologue": ("sdtpu_torch/csrc/conv3x3_slab_int8.cu",
                                   "sdtpu/kernels/conv2d.py:456"),
    "conv3x3_slab_int8_splitk": ("sdtpu_torch/csrc/conv3x3_slab_int8.cu",
                                 "sdtpu/kernels/conv2d.py:456"),
    "flash_attention_stats": ("sdtpu_torch/csrc/flash_attention.cu",
                              "sdtpu/kernels/flash_attention.py:379"),
    "flash_attention_merge": ("sdtpu_torch/csrc/flash_attention.cu",
                              "sdtpu/kernels/flash_attention.py:267"),
    "out_proj_packed": ("sdtpu_torch/csrc/out_proj_packed.cu",
                        "sdtpu/kernels/flash_attention.py:464"),
    "out_proj_packed_splitk": ("sdtpu_torch/csrc/out_proj_packed.cu",
                               "sdtpu/kernels/flash_attention.py:464"),
    "conv3x3_gemm": ("sdtpu_torch/csrc/conv3x3_slab.cu", "sdtpu/kernels/conv2d.py:606"),
    "flash_attention_legacy": ("sdtpu_torch/csrc/flash_attention.cu",
                               "tools/probe_flash_vpu.py:105"),
    "flash_attention_nq": ("sdtpu_torch/csrc/flash_attention.cu",
                           "tools/probe_flash_2stream.py:124"),
    "dot_bf16": ("sdtpu_torch/csrc/dot.cu", "tools/probe_int8_dot.py:39"),
    "dot_bf16_splitk": ("sdtpu_torch/csrc/dot.cu", "tools/probe_int8_dot.py:39"),
    "dot_int8": ("sdtpu_torch/csrc/dot.cu", "tools/probe_int8_dot.py:39"),
    "dot_int8_transpose": ("sdtpu_torch/csrc/dot.cu", "tools/probe_int8_dot.py:39"),
    "dot_int8_splitk": ("sdtpu_torch/csrc/dot.cu", "tools/probe_int8_dot.py:39"),
    "layer_norm_rows": ("sdtpu_torch/csrc/rowwise.cu",
                        "none (XLA fuses sdtpu/ops/norm.py:layer_norm)"),
    "geglu_rows": ("sdtpu_torch/csrc/rowwise.cu",
                   "none (XLA fuses sdtpu/ops/activations.py:geglu)"),
}
MAIN_KERNELS = ("conv3x3_slab", "conv3x3_slab_upsample", "conv3x3_slab_prologue",
                "conv3x3_slab_splitk", "flash_attention",
                "flash_attention_merge", *ROW_KERNELS)  # launched by the bf16 image
INT8_KERNELS = ("conv3x3_slab_int8", "conv3x3_slab_int8_prologue",
                "conv3x3_slab_int8_splitk")  # launched by the int8 image
PROBE_KERNELS = ("conv3x3_gemm", "flash_attention_legacy", "flash_attention_nq", "dot_bf16",
                 "dot_bf16_splitk", "dot_int8", "dot_int8_transpose", "dot_int8_splitk")


def log(msg: str) -> None:
    print(msg, flush=True)


def demangle(symbol: str) -> str:
    """A kernel's C++ name by c++filt where the toolkit's host has it, else
    the symbol as it is."""
    try:
        out = subprocess.run(["c++filt", symbol], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return symbol
    return out.replace("(anonymous namespace)::", "").split("(", 1)[0] or symbol


# ---------------------------------------------------------------- routing --

_SITES = {  # each kernel wrapper's call sites on the main paths
    "conv3x3_slab": (("sdtpu_torch.kernels.conv2d", "conv3x3_slab"),
                     ("sdtpu_torch.ops.conv", "conv3x3_slab")),
    "flash_attention_packed": (("sdtpu_torch.ops.attention", "flash_attention_packed"),),
    "flash_attention_stats_packed": (("sdtpu_torch.parallel.ring_attention",
                                      "flash_attention_stats_packed"),),
    "out_proj_packed": (("sdtpu_torch.ops.attention", "out_proj_packed"),),
    "layer_norm_rows": (("sdtpu_torch.ops.norm", "layer_norm_rows"),),
    "geglu_rows": (("sdtpu_torch.ops.attention", "geglu_rows"),
                   ("sdtpu_torch.ops.activations", "geglu_rows")),
}


@contextlib.contextmanager
def routed(**fns):
    """Point every call site of the named kernel wrappers at other
    functions (a recording shim, or the plain versions) for the duration.
    The block runs inside a one-process ``tp_context``, which keeps the
    denoise loop's UNet graphs off: a replay would run the captured
    kernels, not the functions named here."""
    from sdtpu_torch.parallel.mesh import Mesh, tp_context

    saved = []
    for key, fn in fns.items():
        for mod, name in _SITES[key]:
            m = sys.modules[mod]
            saved.append((m, name, getattr(m, name)))
            setattr(m, name, fn)
    try:
        with tp_context(Mesh(1, 1)):
            yield
    finally:
        for m, name, f in reversed(saved):
            setattr(m, name, f)


def plain_routes():
    from sdtpu_torch.kernels.conv2d import conv3x3_slab_plain
    from sdtpu_torch.kernels.flash_attention import (
        flash_attention_plain,
        flash_attention_stats_plain,
        out_proj_packed_plain,
    )
    from sdtpu_torch.kernels.rowwise import geglu_rows_plain, layer_norm_rows_plain

    return {"conv3x3_slab": conv3x3_slab_plain, "flash_attention_packed": flash_attention_plain,
            "flash_attention_stats_packed": flash_attention_stats_plain,
            "out_proj_packed": out_proj_packed_plain, "layer_norm_rows": layer_norm_rows_plain,
            "geglu_rows": geglu_rows_plain}


# ---------------------------------------------------------- kernel cases --

def conv_inputs(torch, gen, x_shape, co, *, pro, res, up):
    b, hx, wx, ci = x_shape
    h, w = (2 * hx, 2 * wx) if up else (hx, wx)
    dev = "cuda"
    x = torch.randn(x_shape, generator=gen, device=dev).to(torch.bfloat16)
    k = (torch.randn((3, 3, ci, co), generator=gen, device=dev)
         * (9 * ci) ** -0.5).to(torch.bfloat16)
    bias = torch.randn((co,), generator=gen, device=dev) * 0.1
    kw = {"upsample": up}
    if pro:
        kw["prologue_scale"] = 0.5 + torch.rand((b, ci), generator=gen, device=dev)
        kw["prologue_bias"] = torch.randn((b, ci), generator=gen, device=dev) * 0.5
    if res:
        kw["residual"] = torch.randn((b, h, w, co), generator=gen, device=dev).to(torch.bfloat16)
    return x, k, bias, kw


def conv_cost(x_shape, co, *, pro, res, up, stats):
    """(bytes, flops): each input read once, each output written once."""
    b, hx, wx, ci = x_shape
    h, w = (2 * hx, 2 * wx) if up else (hx, wx)
    by = b * hx * wx * ci * 2 + 9 * ci * co * 2 + co * 4 + b * h * w * co * 2
    by += 2 * b * ci * 4 if pro else 0
    by += b * h * w * co * 2 if res else 0
    by += b * 2 * co * 4 if stats else 0
    return by, 2.0 * b * h * w * co * 9 * ci


def flash_stats_cost(q_shape, lk):
    """Kernel C's bytes and operations plus the m and l rows it writes."""
    b, h, lq, _ = q_shape
    by, ops, exps = flash_cost(q_shape, lk)
    return by + 2 * b * h * lq * 4, ops, exps


def out_proj_cost(o_shape, c):
    """o, w, the f32 bias, the residual read once; the output written once."""
    b, h, l, d = o_shape
    return b * h * l * d * 2 + h * d * c * 2 + c * 4 + 2 * b * l * c * 2, 2.0 * b * l * c * h * d


def int8_conv_cost(x_shape, co, *, res, stats):
    """(bytes, int8 ops) of one int8 slab call: x bf16, the int8 kernel,
    bias, w_scale, the (B, Ci) prologue, the (Ci,) codes' scale and zero
    point, the bf16 output, residual and moments."""
    b, h, w, ci = x_shape
    by = b * h * w * ci * 2 + 9 * ci * co + 2 * co * 4 + 2 * b * ci * 4 + 2 * ci * 4
    by += b * h * w * co * 2 * (2 if res else 1)
    by += b * 2 * co * 4 if stats else 0
    return by, 2.0 * b * h * w * co * 9 * ci


def max_err(a, b):
    return float((a.float() - b.float()).abs().max()), float(b.float().abs().max())


def check_conv(torch, gen, case):
    from sdtpu_torch.kernels.conv2d import conv3x3_slab, conv3x3_slab_plain

    x_shape, co, pro, res, up, stats = case
    x, k, bias, kw = conv_inputs(torch, gen, x_shape, co, pro=pro, res=res, up=up)
    got = conv3x3_slab(x, k, bias, emit_stats=stats, **kw)
    want = conv3x3_slab_plain(x, k, bias, emit_stats=stats, **kw)
    torch.cuda.synchronize()
    if stats:
        (got, gst), (want, wst) = got, want
        serr, sref = max_err(gst, wst)
    err, ref = max_err(got, want)
    ok = err <= TOL_REL * ref and (not stats or serr <= TOL_REL * sref)
    name = "conv3x3_slab_upsample" if up else "conv3x3_slab"
    moments = f" moments max_abs_err={serr:.4g} (max={sref:.4g})" if stats else ""
    log(f"check {name} x={tuple(x_shape)} co={co} prologue={pro} residual={res} "
        f"stats={stats}: max_abs_err={err:.4g} (max|plain|={ref:.4g}, rel {err / ref:.3g}, "
        f"tol {TOL_REL:g}){moments}" + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return name, err


def flash_qkv(torch, gen, q_shape, lk):
    q = torch.randn(q_shape, generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(q_shape[:2] + (lk, q_shape[3]), generator=gen,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    return q, k, v


def check_flash(torch, gen, q_shape, lk=None, stats=False):
    """Kernel C (or F with ``stats``: out, m and l) against its plain
    version, each within TOL_REL of its max |plain|."""
    from sdtpu_torch.kernels.flash_attention import (
        flash_attention_packed,
        flash_attention_plain,
        flash_attention_stats_packed,
        flash_attention_stats_plain,
        plan_flash,
    )

    lk = q_shape[2] if lk is None else lk
    q, k, v = flash_qkv(torch, gen, q_shape, lk)
    if stats:
        got, want = flash_attention_stats_packed(q, k, v), flash_attention_stats_plain(q, k, v)
    else:
        got, want = (flash_attention_packed(q, k, v),), (flash_attention_plain(q, k, v),)
    torch.cuda.synchronize()
    errs = [max_err(g, w) for g, w in zip(got, want)]
    ok = all(e <= TOL_REL * r for e, r in errs)
    name = "flash_attention_stats" if stats else "flash_attention"
    b, h, lq, d = q_shape
    log(f"check {name} q={tuple(q_shape)} lk={lk} plan (bq, splits)="
        f"{plan_flash(b * h, lq, lk, d)}: "
        + ", ".join(f"{n} max_abs_err={e:.4g} (max|plain|={r:.4g})"
                    for n, (e, r) in zip(("out", "m", "l"), errs))
        + f", tol {TOL_REL:g} rel" + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return name, errs[0][0]


def merge_ws(torch, gen, splits, bh, lq):
    """A random workspace of the wide plan's merge (l > 0)."""
    from sdtpu_torch.kernels.flash_attention import FLASH_WIDE_DP

    n = splits * bh * lq
    return torch.cat([torch.randn(n * FLASH_WIDE_DP, generator=gen, device="cuda"),
                      4.0 * torch.randn(n, generator=gen, device="cuda"),
                      1.0 + 49.0 * torch.rand(n, generator=gen, device="cuda")])


def check_merge(torch, gen, splits, bh, lq, d):
    """The merge kernel alone against its plain version (out, m, l, each
    within TOL_REL of its max |plain|)."""
    from sdtpu_torch.kernels.flash_attention import flash_attention_merge, flash_merge_plain

    ws = merge_ws(torch, gen, splits, bh, lq)
    got = flash_attention_merge(ws, bh, lq, d, splits, stats=True)
    want = flash_merge_plain(ws, bh, lq, d, splits)
    torch.cuda.synchronize()
    errs = [max_err(g, w) for g, w in zip(got, want)]
    ok = all(e <= TOL_REL * r for e, r in errs)
    log(f"check flash_attention_merge splits={splits} rows={bh}x{lq} d={d}: "
        + ", ".join(f"{n} max_abs_err={e:.4g} (max|plain|={r:.4g})"
                    for n, (e, r) in zip(("out", "m", "l"), errs))
        + f", tol {TOL_REL:g} rel" + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError("flash_attention_merge disagrees with its plain version")
    return errs[0][0]


def time_conv(torch, gen, cfg, reps=None, device=True):
    """Kernel, plain and cuDNN ms by CUDA events (``reps`` calls each, by
    default 20, or 5 where the map times ``co`` passes 2**31; the plain
    version a quarter as many), then, with ``device``, the kernel's (every
    kernel of the wrapper call) and cuDNN's device ms by the profiler."""
    from sdtpu_torch.kernels.conv2d import conv3x3_slab, conv3x3_slab_plain

    x_shape, co, pro, res, up, stats = cfg
    x, k, bias, kw = conv_inputs(torch, gen, x_shape, co, pro=pro, res=res, up=up)
    reps = reps or (5 if x.numel() * co > 2**31 else 20)
    run = functools.partial(conv3x3_slab, x, k, bias, emit_stats=stats, **kw)
    lib = cudnn_call(torch, x, k, bias, kw)
    times = (event_ms(run, reps),
             event_ms(lambda: conv3x3_slab_plain(x, k, bias, emit_stats=stats, **kw),
                      max(2, (reps + 2) // 4)),
             event_ms(lib, reps))
    return times + ((device_ms(run, 10), device_ms(lib, 10)) if device else ())


def cudnn_call(torch, x, k, bias, kw):
    """Yardstick: one cuDNN bf16 conv on the prologued (and upsampled)
    input, as a function of no arguments."""
    import torch.nn.functional as F

    y = x
    if kw.get("prologue_scale") is not None:
        y = x.float() * kw["prologue_scale"][:, None, None, :] + kw["prologue_bias"][:, None, None, :]
        y = (y * torch.sigmoid(y)).to(torch.bfloat16)
    if kw.get("upsample"):
        y = y.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    y_nchw = y.permute(0, 3, 1, 2)  # channels_last memory
    w_oihw = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    b16 = 0 if bias is None else bias.to(torch.bfloat16)
    return lambda: F.conv2d(y_nchw, w_oihw, b16, padding=1)


def int8_case(torch, gen, x_shape, co, res, stats):
    """One int8 slab call configuration: kernel D against its plain version
    (within TOL_REL, the share of differing outputs printed), then its
    pieces: the pre-pass's codes within one code of the plain version's (an
    ulp of the card's expf may flip a rounding; the zero-point ring exact),
    the whole call bitwise equal to the plain reduction of the plain GEMM on
    the card's own codes, and at a split shape the GEMM's int32 partials and
    the reduction alone bitwise.  Then D timed by CUDA events and by the
    profiler per piece, its pre-pass and reduction alone, its plain version,
    and the two float counterparts at the same shape (kernel A, cuDNN bf16),
    which compute a different function.  The codes' scale and zero point
    come from a GroupNorm affine equal to batch 0's prologue, so they cover
    the activations as the model's own do."""
    from sdtpu_torch.kernels.conv2d import (
        conv3x3_int8_codes_plain,
        conv3x3_int8_prologue,
        conv3x3_int8_reduce_plain,
        conv3x3_int8_split,
        conv3x3_int8_split_plain,
        conv3x3_int8_splitk_reduce,
        conv3x3_kmajor_plain,
        conv3x3_slab,
        conv3x3_slab_plain,
        plan_conv3x3_int8_split,
    )
    from sdtpu_torch.tools import device_ms_by_kernel
    from sdtpu_torch.tools.ab_slab import int8_pieces
    from sdtpu_torch.utils.quant import act_qparams_from_norm, quantize_conv_w8a8

    x, k, bias, kw = conv_inputs(torch, gen, x_shape, co, pro=True, res=res, up=False)
    s, z = act_qparams_from_norm({"scale": kw["prologue_scale"][0],
                                  "bias": kw["prologue_bias"][0]})
    q, ws, zp = quantize_conv_w8a8(k, s, z)

    def dev(a):
        return torch.from_numpy(a).to("cuda")

    q, qbias, wsc = dev(q), bias - dev(zp), dev(ws)
    qkw = dict(kw, act_inv_scale=1.0 / dev(s), act_zp=dev(z), w_scale=wsc)
    run = functools.partial(conv3x3_slab, x, q, qbias, emit_stats=stats, **qkw)
    got = run()
    want = conv3x3_slab_plain(x, q, qbias, emit_stats=stats, **qkw)
    torch.cuda.synchronize()
    serr = sref = 0.0
    if stats:
        (got, gst), (want, wst) = got, want
        serr, sref = max_err(gst, wst)
    err, ref = max_err(got, want)
    share = float((got.float() != want.float()).float().mean())
    ok = err <= TOL_REL * ref and serr <= TOL_REL * max(sref, 1e-30)
    log(f"check conv3x3_slab_int8 x={tuple(x_shape)} co={co} residual={res} stats={stats}: "
        f"max_abs_err={err:.4g} (max|plain|={ref:.4g}, tol {TOL_REL:g} rel), "
        f"share of outputs differing {share:.3g}"
        + (f", moments max_abs_err={serr:.4g} (max={sref:.4g})" if stats else "")
        + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError("conv3x3_slab_int8 disagrees with its plain version")

    b, h, w, ci = x_shape
    pa, pc, qs, qz = kw["prologue_scale"], kw["prologue_bias"], qkw["act_inv_scale"], qkw["act_zp"]
    r = kw.get("residual")
    codes = conv3x3_int8_prologue(x, pa, pc, qs, qz)
    want_codes = conv3x3_int8_codes_plain(x, pa, pc, qs, qz)
    cdiff = (codes.int() - want_codes.int()).abs()
    ring = torch.ones((h + 2, w + 2), dtype=torch.bool, device="cuda")
    ring[1:-1, 1:-1] = False
    code_err, code_share = int(cdiff.max()), float((cdiff > 0).float().mean())
    ring_ok = bool(torch.equal(codes[:, ring], want_codes[:, ring]))
    del cdiff, want_codes
    wk = conv3x3_kmajor_plain(q)
    gemm_ok = bool(torch.equal(got, conv3x3_int8_reduce_plain(
        conv3x3_int8_split_plain(codes, wk, 1), wsc, qbias, r, dtype=torch.bfloat16)))
    splits = plan_conv3x3_int8_split(b, h, w, ci, co)
    part_ok = red_ok = True
    red = None
    if splits > 1:
        wsp = conv3x3_int8_split(codes, q, splits)
        part_ok = bool(torch.equal(wsp, conv3x3_int8_split_plain(codes, wk, splits)))
        red_run = functools.partial(conv3x3_int8_splitk_reduce, wsp, wsc, qbias, r,
                                    emit_stats=stats)
        red_plain = functools.partial(conv3x3_int8_reduce_plain, wsp, wsc, qbias, r,
                                      emit_stats=stats)
        g_red, w_red = red_run(), red_plain()
        red_ok = bool(torch.equal(g_red[0] if stats else g_red, w_red[0] if stats else w_red))
        red = {"ms": event_ms(red_run, 20), "device_ms": device_ms(red_run, 10),
               "plain_ms": event_ms(red_plain, 5),
               "cost": (wsp.numel() * 4 + 2 * co * 4 + b * h * w * co * 2 * (2 if res else 1)
                        + (b * 2 * co * 4 if stats else 0), 0.0)}
    ok = code_err <= 1 and code_share <= 1e-3 and ring_ok and gemm_ok and part_ok and red_ok
    log(f"check conv3x3_slab_int8 pieces x={tuple(x_shape)} co={co} S={splits}: pre-pass codes "
        f"max |diff| {code_err} code (tol 1), share differing {code_share:.3g} (tol 1e-3), "
        f"ring == z {ring_ok}; the call == plain reduction of the plain GEMM on the card's "
        f"codes bitwise {gemm_ok}; split partials bitwise {part_ok}; reduction bitwise {red_ok}"
        + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError("a piece of conv3x3_slab_int8 disagrees with its plain version")

    big = x.numel() * co > 2**31
    reps = 5 if big else 20
    by = device_ms_by_kernel(run, 10)
    pro_run = functools.partial(conv3x3_int8_prologue, x, pa, pc, qs, qz)
    pro = {"ms": event_ms(pro_run, reps), "device_ms": device_ms(pro_run, 10),
           "plain_ms": event_ms(lambda: conv3x3_int8_codes_plain(x, pa, pc, qs, qz), 2),
           "cost": (x.numel() * 2 + codes.numel() + 2 * b * ci * 4 + 2 * ci * 4, 0.0)}
    return {"err": err, "share": share, "ms": event_ms(run, reps),
            "plain_ms": event_ms(lambda: conv3x3_slab_plain(x, q, qbias, emit_stats=stats,
                                                            **qkw), 2),
            "kernel_A_ms": event_ms(lambda: conv3x3_slab(x, k, bias, emit_stats=stats, **kw),
                                    reps),
            "cudnn_ms": event_ms(cudnn_call(torch, x, k, bias, kw), reps),
            "device": None if by is None else int8_pieces(by), "splits": splits,
            "code_err": code_err, "code_share": code_share, "prologue": pro, "reduction": red}


def time_flash(torch, gen, q_shape, lk, reps=10, device=True):
    """Kernel C (with its merge where the plan splits), its plain version
    (a quarter as many calls) and the library by CUDA events, then, with
    ``device``, the kernels' and the library's device ms by the profiler.
    Library: SDPA, the memory-efficient one where flash refuses the head
    dim (D > 256)."""
    from sdtpu_torch.kernels.flash_attention import flash_attention_packed, flash_attention_plain

    q, k, v = flash_qkv(torch, gen, q_shape, lk)
    aten = torch.ops.aten
    if q_shape[3] > 256:
        lib = lambda: aten._scaled_dot_product_efficient_attention(q, k, v, None, False)  # noqa: E731
    else:
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)  # noqa: E731
    run = functools.partial(flash_attention_packed, q, k, v)
    times = (event_ms(run, reps),
             event_ms(lambda: flash_attention_plain(q, k, v), max(2, (reps + 2) // 4)),
             event_ms(lib, reps))
    return times + ((device_ms(run, 10), device_ms(lib, 10)) if device else ())


def flash_stats_case(torch, gen, q_shape, lk):
    """Kernel F at one call shape: out, m and l against the plain version
    (each within TOL_REL of its max |plain|), then the times.  Library: the
    flash SDPA that returns the log-sum-exp (m + log l, not m and l), or the
    memory-efficient one where flash refuses the head dim."""
    from sdtpu_torch.kernels.flash_attention import (
        flash_attention_stats_packed,
        flash_attention_stats_plain,
    )

    q = torch.randn(q_shape, generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(q_shape[:2] + (lk, q_shape[3]), generator=gen,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    got = flash_attention_stats_packed(q, k, v)
    want = flash_attention_stats_plain(q, k, v)
    torch.cuda.synchronize()
    errs = [max_err(g, w) for g, w in zip(got, want)]
    ok = all(e <= TOL_REL * r for e, r in errs)
    log(f"check flash_attention_stats q={tuple(q_shape)} lk={lk}: "
        + ", ".join(f"{n} max_abs_err={e:.4g} (max|plain|={r:.4g})"
                    for n, (e, r) in zip(("out", "m", "l"), errs))
        + f", tol {TOL_REL:g} rel" + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError("flash_attention_stats disagrees with its plain version")
    t_k = event_ms(lambda: flash_attention_stats_packed(q, k, v), 10)
    t_p = event_ms(lambda: flash_attention_stats_plain(q, k, v), 3)
    aten = torch.ops.aten
    libs = (("_scaled_dot_product_flash_attention", lambda: aten._scaled_dot_product_flash_attention(q, k, v)),
            ("_scaled_dot_product_efficient_attention",
             lambda: aten._scaled_dot_product_efficient_attention(q, k, v, None, True)))
    t_l = lib_call = None
    for name, fn in libs:
        try:
            t_l = event_ms(fn, 10)
        except RuntimeError as exc:
            log(f"library {name} refuses q={tuple(q_shape)}: {str(exc).splitlines()[0]}")
            continue
        log(f"library for flash_attention_stats q={tuple(q_shape)} lk={lk}: aten.{name} "
            f"(returns the log-sum-exp m + log l, not m and l): {t_l:.4f} ms")
        lib_call = f"aten.{name}"
        break
    dev = {"kernel": device_ms(lambda: flash_attention_stats_packed(q, k, v), 10),
           "library": None if t_l is None else device_ms(fn, 10),
           "library_call": lib_call}
    return errs[0][0], t_k, t_p, t_l, dev


def out_proj_case(torch, gen, o_shape, c, partial=False):
    """Kernel G at one call shape against its plain version (and a second
    call bitwise equal to the first), then the times.  Library: the default
    route's einsum + bias + residual in bf16 (three roundings where G rounds
    once).  ``partial``: the form tp launches, the partial product before
    the sum over tp (no bias, a zero residual)."""
    from sdtpu_torch.kernels.flash_attention import (
        out_proj_packed,
        out_proj_packed_plain,
        plan_out_proj,
    )

    b, h, l, d = o_shape
    o = torch.randn(o_shape, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((h, d, c), generator=gen, device="cuda") * (h * d) ** -0.5).to(torch.bfloat16)
    bias = torch.randn((c,), generator=gen, device="cuda") * 0.1
    res = torch.randn((b, l, c), generator=gen, device="cuda").to(torch.bfloat16)
    if partial:
        bias, res = None, torch.zeros_like(res)
    got = out_proj_packed(o, w, bias, res)
    want = out_proj_packed_plain(o, w, bias, res)
    torch.cuda.synchronize()
    err, ref = max_err(got, want)
    same = bool(torch.equal(out_proj_packed(o, w, bias, res), got))
    ok = err <= TOL_REL * ref and same
    log(f"check out_proj_packed{' partial' if partial else ''} o={tuple(o_shape)} c={c} "
        f"(bn, splits)="
        f"{plan_out_proj(*o_shape, c)}: max_abs_err={err:.4g} (max|plain|={ref:.4g}, rel "
        f"{err / ref:.3g}, tol {TOL_REL:g}); two calls bitwise equal {same}"
        + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError("out_proj_packed disagrees with its plain version or itself")
    b16 = 0 if bias is None else bias.to(torch.bfloat16)
    t_k = event_ms(lambda: out_proj_packed(o, w, bias, res), 20)
    t_p = event_ms(lambda: out_proj_packed_plain(o, w, bias, res), 5)
    t_l = event_ms(lambda: torch.einsum("bhld,hdc->blc", o, w) + b16 + res, 20)
    dev = {"kernel": device_ms(lambda: out_proj_packed(o, w, bias, res), 20),
           "library": device_ms(lambda: torch.einsum("bhld,hdc->blc", o, w) + b16 + res,
                                20),
           "library_call": "einsum + bias + residual"}
    return err, t_k, t_p, t_l, dev


def record_calls(torch, fn):
    """``fn()`` run once through recording shims: each kernel wrapper's call
    configurations with their counts, ``{wrapper: Counter(config)}``; a
    conv configuration is (x shape, Co, prologue, residual, upsample,
    moments, int8 kernel), an attention one (q shape, Lk), an
    out-projection one (o shape, C), a row pass's (x shape, x's dtype, the
    parameters' dtype or "none"), on the card only.  The ring context in
    force, if any, applies."""
    # sys.modules: the package sdtpu_torch.ops re-exports a function named
    # ``attention`` that shadows its submodule of that name
    real = {key: getattr(sys.modules[sites[0][0]], sites[0][1]) for key, sites in _SITES.items()}
    calls = {key: Counter() for key in _SITES}

    def conv_shim(x, kernel, conv_bias=None, **kw):
        calls["conv3x3_slab"][(tuple(x.shape), kernel.shape[-1],
                               kw.get("prologue_scale") is not None,
                               kw.get("residual") is not None, bool(kw.get("upsample")),
                               bool(kw.get("emit_stats")), kernel.dtype == torch.int8)] += 1
        return real["conv3x3_slab"](x, kernel, conv_bias, **kw)

    def attn_shim(key):
        def shim(q, k, v):
            calls[key][(tuple(q.shape), k.shape[2])] += 1
            return real[key](q, k, v)
        return shim

    def out_proj_shim(o, w, bias, residual):
        calls["out_proj_packed"][(tuple(o.shape), w.shape[-1])] += 1
        return real["out_proj_packed"](o, w, bias, residual)

    def row_shim(key):
        def shim(x, p=None, *rest):
            if x.is_cuda:
                calls[key][(tuple(x.shape), str(x.dtype)[6:],
                            "none" if p is None else str(p.dtype)[6:])] += 1
            return real[key](x, p, *rest)
        return shim

    with routed(conv3x3_slab=conv_shim,
                flash_attention_packed=attn_shim("flash_attention_packed"),
                flash_attention_stats_packed=attn_shim("flash_attention_stats_packed"),
                out_proj_packed=out_proj_shim,
                **{key: row_shim(key) for key in ROW_KERNELS}):
        fn()
    return calls


def record_main_path_calls(torch, pipe, ids):
    """A main path's kernel call configurations (:func:`record_calls`) with
    their counts per image: a 1-step and a 2-step image recorded, the
    first's calls plus STEPS - 1 times a step's (the second's less the
    first's: the UNet's, where the text encoder and the VAE run once)."""
    one, two = (record_calls(torch, lambda n=n: pipe.generate(
        token_ids=ids, num_inference_steps=n, seed=1, image_size=512)) for n in (1, 2))
    return {key: {c: one[key][c] + (STEPS - 1) * (n - one[key][c]) for c, n in cs.items()}
            for key, cs in two.items()}


def expected_launches(calls, keys):
    """The launches of every kernel that a run's recorded calls
    (:func:`record_calls`) make: one A, B, C, D or row pass a call, the
    pre-passes, split-K reductions and merges from the plans, 0 for the rest
    of ``keys``."""
    slab = calls["conv3x3_slab"]
    expected = dict.fromkeys(keys, 0)
    expected["conv3x3_slab"] = sum(n for c, n in slab.items() if not c[4] and not c[6])
    expected["conv3x3_slab_int8"] = sum(n for c, n in slab.items() if c[6])
    expected["conv3x3_slab_upsample"] = sum(n for c, n in slab.items() if c[4])
    expected["flash_attention"] = sum(calls["flash_attention_packed"].values())
    for key in ROW_KERNELS:
        expected[key] = sum(calls[key].values())
    expected.update(conv_sub_counts(slab), **flash_sub_counts(calls))
    return expected


def conv_sub_counts(conv_calls):
    """The slab convs' pre-pass and split-K reduction launches per image of
    a path, from its recorded slab calls (float and int8) and the split
    plans."""
    from sdtpu_torch.kernels.conv2d import conv3x3_int8_launches, conv3x3_launches

    subs = {"conv3x3_slab_prologue": 0, "conv3x3_slab_splitk": 0,
            "conv3x3_slab_int8_prologue": 0, "conv3x3_slab_int8_splitk": 0}
    for (x_shape, co, pro, _res, up, _stats, quant), n in conv_calls.items():
        keys = (conv3x3_int8_launches(x_shape, co) if quant else
                conv3x3_launches("conv3x3_slab", x_shape, co, prologue=pro, upsample=up))
        for key, v in keys.items():
            if key in subs:
                subs[key] += n * v
    return subs


def out_proj_sub_counts(calls):
    """Kernel G's split-K reduction launches per image of a path, from its
    recorded G calls and the plan."""
    from sdtpu_torch.kernels.flash_attention import out_proj_launches

    return {"out_proj_packed_splitk": sum(
        n * out_proj_launches(o_shape, c).get("out_proj_packed_splitk", 0)
        for (o_shape, c), n in calls["out_proj_packed"].items())}


def splitk_reduce_case(torch, gen, o_shape, c, splits):
    """G's split-K reduction alone at one call's workspace, bitwise against
    its plain version (the same f32 adds in the same order, one rounding);
    returns (err, event ms, plain ms, device ms, (bytes, ops))."""
    from sdtpu_torch.kernels.flash_attention import (
        out_proj_splitk_reduce,
        out_proj_splitk_reduce_plain,
    )

    b, _, l, _ = o_shape
    ws = torch.randn((splits, b, l, c), generator=gen, device="cuda")
    bias = torch.randn((c,), generator=gen, device="cuda") * 0.1
    res = torch.randn((b, l, c), generator=gen, device="cuda").to(torch.bfloat16)
    run = functools.partial(out_proj_splitk_reduce, ws, bias, res)
    err = judge_probe(torch, "out_proj_packed_splitk", f"ws={tuple(ws.shape)}", run(),
                      out_proj_splitk_reduce_plain(ws, bias, res), exact=True)
    cost = (ws.numel() * 4 + c * 4 + 2 * b * l * c * 2, 0.0)
    return (err, event_ms(run, 20),
            event_ms(lambda: out_proj_splitk_reduce_plain(ws, bias, res), 5),
            device_ms(run, 20), cost)


def row_case(torch, gen, kind, key):
    """One row-pass call configuration (:func:`record_calls`' key) on seeded
    inputs, the kernel held to its plain version within ROW_ULPS ulps of its
    dtype at the row's largest plain value: GeGLU repeats every rounding of
    the eager chain (it reads 0), LayerNorm's row sums run in another order
    than PyTorch's reductions, which moves a value by a float32 rounding of
    the normalised row (an output that cancels against the bias is not held
    to its own ulp).  Returns (max abs error, kernel call, plain call,
    library call or None, (bytes, 0))."""
    import torch.nn.functional as F

    from sdtpu_torch.kernels import rowwise

    shape, dt, pdt = key
    dt = getattr(torch, dt)
    c = shape[-1]
    if kind == "layer_norm_rows":
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dt)
        p = getattr(torch, pdt)
        args = (x, (1 + 0.2 * torch.randn(c, generator=gen, device="cuda")).to(p),
                (0.2 * torch.randn(c, generator=gen, device="cuda")).to(p), 1e-5)
        run, plain = rowwise.layer_norm_rows, rowwise.layer_norm_rows_plain
        sx, bx = args[1].to(dt), args[2].to(dt)
        lib = functools.partial(F.layer_norm, x, (c,), sx, bx, 1e-5)
        nbytes = 2 * x.numel() * x.element_size() + 2 * c * args[1].element_size()
    else:
        h = (torch.randn(shape, generator=gen, device="cuda") * 1.5).to(dt)
        b = (None if pdt == "none" else
             (0.3 * torch.randn(c, generator=gen, device="cuda")).to(getattr(torch, pdt)))
        args = (h, b)
        run, plain, lib = rowwise.geglu_rows, rowwise.geglu_rows_plain, None
        nbytes = 3 * h.numel() // 2 * h.element_size() + (0 if b is None else
                                                          c * b.element_size())
    got, want = run(*args), plain(*args)
    bits = 7 if dt == torch.bfloat16 else 23
    top = want.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
    ulps = float(((got.float() - want.float()).abs()
                  / torch.exp2(torch.floor(torch.log2(top)) - bits)).max())
    err = float((got.float() - want.float()).abs().max())
    ok = ulps <= ROW_ULPS[str(dt)[6:]]
    log(f"check {kind} x={shape} {str(dt)[6:]} p={pdt}: {ulps:.3g} ulps at the row's max, max "
        f"abs {err:.3g} (<= {ROW_ULPS[str(dt)[6:]]})" + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError(f"{kind} {key}: the kernel is off its plain version")
    return (err, functools.partial(run, *args), functools.partial(plain, *args), lib,
            (nbytes, 0.0))


def flash_sub_counts(calls):
    """Flash attention's key-split merge launches per image of a path, from
    its recorded C and F calls and the tile plan."""
    from sdtpu_torch.kernels.flash_attention import flash_launches

    n_merge = 0
    for key, wrapper in (("flash_attention", "flash_attention_packed"),
                         ("flash_attention_stats", "flash_attention_stats_packed")):
        for (q_shape, lk), n in calls[wrapper].items():
            n_merge += n * flash_launches(key, q_shape, lk).get("flash_attention_merge", 0)
    return {"flash_attention_merge": n_merge}


def check_prologue(torch, gen, x_shape):
    """The pre-pass alone against its plain version (tolerance TOL_REL)."""
    from sdtpu_torch.kernels.conv2d import conv3x3_prologue, conv3x3_prologue_plain

    x, _, _, kw = conv_inputs(torch, gen, x_shape, 8, pro=True, res=False, up=False)
    a, c = kw["prologue_scale"], kw["prologue_bias"]
    got, want = conv3x3_prologue(x, a, c), conv3x3_prologue_plain(x, a, c)
    torch.cuda.synchronize()
    err, ref = max_err(got, want)
    ok = err <= TOL_REL * ref
    log(f"check conv3x3_slab_prologue x={tuple(x_shape)}: max_abs_err={err:.4g} "
        f"(max|plain|={ref:.4g}, tol {TOL_REL:g} rel)" + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError("conv3x3_prologue disagrees with its plain version")
    return err


def splitk_inputs(torch, gen, ws_shape, *, res):
    splits, b, h, w, co = ws_shape
    ws = torch.randn(ws_shape, generator=gen, device="cuda")
    bias = torch.randn((co,), generator=gen, device="cuda") * 0.1
    r = (torch.randn((b, h, w, co), generator=gen, device="cuda").to(torch.bfloat16)
         if res else None)
    return ws, bias, r


def check_splitk(torch, gen, ws_shape, res):
    """The split-K reduction alone against its plain version: the same
    float32 additions in the same order, so the output bitwise; moments
    within TOL_REL."""
    from sdtpu_torch.kernels.conv2d import conv3x3_splitk_reduce, splitk_reduce_plain

    ws, bias, r = splitk_inputs(torch, gen, ws_shape, res=res)
    got, gst = conv3x3_splitk_reduce(ws, bias, r, emit_stats=True)
    want, wst = splitk_reduce_plain(ws, bias, r, emit_stats=True)
    torch.cuda.synchronize()
    err, ref = max_err(got, want)
    serr, sref = max_err(gst, wst)
    ok = bool(torch.equal(got, want)) and serr <= TOL_REL * sref
    log(f"check conv3x3_slab_splitk ws={tuple(ws_shape)} residual={res}: max_abs_err={err:.4g} "
        f"(bitwise), moments max_abs_err={serr:.4g} (max={sref:.4g}, tol {TOL_REL:g} rel)"
        + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError("conv3x3_splitk_reduce disagrees with its plain version")
    return err


def rel_l2(torch, a, b):
    return float(torch.linalg.vector_norm((a.float() - b.float()).flatten())
                 / torch.linalg.vector_norm(b.float().flatten()))


def to_dtype(tree, dtype):
    if isinstance(tree, dict):
        return {k: to_dtype(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_dtype(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def trees_bitwise(torch, a, b) -> bool:
    """The same paths, dtypes, shapes and bits (lists as lists)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(trees_bitwise(torch, a[k], b[k]) for k in a))
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(trees_bitwise(torch, x, y) for x, y in zip(a, b)))
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def sd15_pipeline(torch, host, preset):
    """A pipeline of the SD-1.5 family (``sd15``, ``sd15-inpaint``, ``ip2p``,
    ``lcm-sd15``) on the card from one host tree, ``sd15-inpaint``'s seed-0
    ``init_pipeline_params`` (= its ``from_random``): the presets differ
    only in conv_in's input channels (its first 4 or 8 taken) and LCM's
    guidance projection (``cond_proj``, drawn as ``init_unet`` draws it, on
    the host).  One draw serves phases 15-17: each costs 14-16 s of numpy
    Philox."""
    from sdtpu_torch import StableDiffusionPipeline
    from sdtpu_torch.config import get_preset
    from sdtpu_torch.ops import init_linear
    from sdtpu_torch.utils import hostrng

    config = get_preset(preset)
    ucfg = config.unet
    unet = dict(host["unet"])
    conv_in = host["unet"]["conv_in"]
    unet["conv_in"] = {"kernel": conv_in["kernel"][:, :, :ucfg.in_channels].contiguous(),
                       "bias": conv_in["bias"]}
    if ucfg.time_cond_proj_dim is not None:
        unet["time_embedding"] = dict(unet["time_embedding"], cond_proj=init_linear(
            hostrng.key(0), ucfg.time_cond_proj_dim, ucfg.block_out_channels[0], use_bias=False,
            dtype=config.param_dtype))
    return StableDiffusionPipeline(config, tree_to(dict(host, unet=unet), "cuda"),
                                   device="cuda")


# ------------------------------------------------------------------- main --

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every measurement to this JSON file")
    ap.add_argument("--trace-dir", default="build/trace",
                    help="where phase 13 writes its profiler trace (trace.json)")
    ap.add_argument("--mesh-worker", nargs=5, metavar=("TREE", "DIR", "RANK", "WORLD", "URL"),
                    help=argparse.SUPPRESS)  # one rank of phase 19 (b)
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if args.mesh_worker:
        tree, out_dir, rank, world, url = args.mesh_worker
        return mesh_worker(tree, out_dir, int(rank), int(world), url)

    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("float32 references: torch.backends.cuda.matmul.allow_tf32=False, "
        "torch.backends.cudnn.allow_tf32=False")
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    exp_rate = EXP_PER_CLOCK_SM * SMS * sm_mhz * 1e6
    log(f"exponential units: {EXP_PER_CLOCK_SM}/clock/SM x {SMS} SMs x {sm_mhz:.0f} MHz "
        f"(clocks.max.sm) = {exp_rate:.4g} exp/s")

    import numpy as np

    from sdtpu_torch import StableDiffusionPipeline
    from sdtpu_torch.kernels import _build, launch_counts, reset_launch_counts
    from sdtpu_torch.kernels.conv2d import (
        conv3x3_prologue,
        conv3x3_prologue_plain,
        conv3x3_splitk_reduce,
        plan_conv3x3_split,
        splitk_reduce_plain,
    )
    from sdtpu_torch.kernels.flash_attention import (
        flash_attention_merge,
        flash_merge_plain,
        plan_flash,
        plan_out_proj,
    )
    from sdtpu_torch.parallel import LocalRing, ring_context

    details = {"device": smi, "sm_clock_max_mhz": sm_mhz, "exp_per_s": exp_rate}
    plain = plain_routes()

    # phase 2: build
    t0 = time.perf_counter()
    report = _build.build(ptxas_verbose=True)
    build_s = time.perf_counter() - t0
    details["ptxas"] = []
    for name, (secs, out) in report.items():
        log(f"build {name}.cu: {secs:.1f} s")
        kernel = "?"
        for ln in out.splitlines():
            if "Function properties for " in ln:
                kernel = demangle(ln.split("Function properties for ", 1)[1].strip())
            elif "registers" in ln or "spill" in ln:
                log(f"  ptxas {name} {kernel}: {ln.strip()}")
                details["ptxas"].append({"source": name, "kernel": kernel, "line": ln.strip()})
    log(f"build: {build_s:.1f} s for {len(report)} sources (nvcc sm_90a)")
    details["build_s"] = build_s

    # phase 3: kernels
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    for case in [
        ((2, 64, 64, 320), 320, True, True, False, True),
        ((2, 16, 16, 2560), 1280, True, False, False, True),
        ((1, 512, 512, 256), 128, True, False, False, True),
        ((2, 16, 16, 1280), 1280, False, False, True, False),
        ((1, 256, 256, 256), 256, False, False, True, True),
        # split-K shapes (S = 4, 2, 2): residual and moments through the reduction
        ((2, 16, 16, 2560), 1280, True, True, False, True),
        ((2, 32, 32, 640), 640, True, True, False, True),
        ((1, 64, 64, 512), 512, True, True, False, True),
    ]:
        name, err = check_conv(torch, gen, case)
        errs[name] = max(errs.get(name, 0.0), err)
    errs["conv3x3_slab_prologue"] = max(check_prologue(torch, gen, s) for s in (
        (2, 64, 64, 320), (2, 16, 16, 2560), (1, 512, 512, 256)))
    errs["conv3x3_slab_splitk"] = max(check_splitk(torch, gen, s, r) for s, r in (
        ((4, 2, 16, 16, 1280), True), ((2, 2, 32, 32, 640), False), ((2, 1, 64, 64, 512), True)))
    for q_shape in [(2, 8, 4096, 40), (2, 8, 1024, 80), (2, 8, 256, 160), (1, 1, 4096, 512)]:
        name, err = check_flash(torch, gen, q_shape)
        errs[name] = max(errs.get(name, 0.0), err)
    # ragged shapes, C and F: Lq and Lk no multiple of their tiles (4000 rows
    # take 128-row tiles at D = 40), and Lq under one tile
    for d in (40, 80, 160, 512):
        for lq, lk in ((4000, 3999), (1000, 1001), (10, 77)):
            for stats in (False, True):
                name, err = check_flash(torch, gen, (2, 8, lq, d), lk, stats)
                errs[name] = max(errs.get(name, 0.0), err)
    errs["flash_attention_merge"] = max(check_merge(torch, gen, *c) for c in (
        (4, 1, 4096, 512), (16, 1, 1024, 512), (2, 3, 100, 168)))

    ids = np.random.default_rng(40).integers(1, 49408, (2, 77))
    t0 = time.perf_counter()
    pipe = StableDiffusionPipeline.from_random("tiny-sd", seed=0, device="cuda")
    torch.cuda.synchronize()
    from_random_s = time.perf_counter() - t0
    log(f"from_random(\"tiny-sd\", seed=0): {from_random_s:.3f} s on the host (numpy Philox "
        "draws as the JAX package's init, then one copy of each leaf to the card)")
    details["from_random_s"] = from_random_s
    pcfg = pipe.config
    pipe_ring = StableDiffusionPipeline(pcfg.replace(attention_impl="ring"), pipe.params,
                                        device="cuda")
    attn_mod = sys.modules["sdtpu_torch.ops.attention"]
    calls = record_main_path_calls(torch, pipe, ids)
    with ring_context(LocalRing(RING)):
        ring_calls = record_main_path_calls(torch, pipe_ring, ids)
    attn_mod._PACKED_OUT_PROJ = True
    try:
        packed_calls = record_main_path_calls(torch, pipe, ids)
    finally:
        attn_mod._PACKED_OUT_PROJ = False
    totals = {n: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                  "bound_ms_without_exp": 0.0, "byte_ms": 0.0, "op_ms": 0.0,
                  "per_image_calls": 0} for n in SOURCES}
    rows = []
    # the profiler's device time per image beside the CUDA-event sums: a
    # small conv's back-to-back calls can be bound by their host-side
    # enqueue (three kernels and their checks), which events then time
    device = {}

    def add_device(name, n, d_k, d_l=None):
        tot = device.setdefault(name, {"kernel_ms": 0.0, "library_ms": 0.0})
        for key, d in (("kernel_ms", d_k), ("library_ms", d_l)):
            tot[key] = None if d is None or tot[key] is None else tot[key] + n * d

    def fmt_ms(v):
        return "not measured" if v is None else f"{v:.4f} ms"

    details["conv_configs"] = []
    for cfg, n in sorted(calls["conv3x3_slab"].items()):
        x_shape, co, pro, res, up, stats, _ = cfg
        b, hx, wx, ci = x_shape
        h, w = (2 * hx, 2 * wx) if up else (hx, wx)
        splits = plan_conv3x3_split(b, h, w, ci, co)
        details["conv_configs"].append({"x": list(x_shape), "co": co, "pro": pro, "res": res,
                                        "up": up, "stats": stats, "per_image": n,
                                        "split": splits})
        t_k, t_p, t_l, d_k, d_l = time_conv(torch, gen, cfg[:6])
        cost = conv_cost(x_shape, co, pro=pro, res=res, up=up, stats=stats)
        desc = f"x={x_shape} co={co} pro={int(pro)} res={int(res)} st={int(stats)} S={splits}"
        name = "conv3x3_slab_upsample" if up else "conv3x3_slab"
        rows.append((name, desc, n, t_k, t_p, t_l, cost, PEAK_BF16_FLOPS))
        add_device(name, n, d_k, d_l)
        details["conv_configs"][-1].update(device_ms=d_k, cudnn_device_ms=d_l)
        log(f"device time {name} {desc}: kernels {fmt_ms(d_k)}, cuDNN {fmt_ms(d_l)} "
            f"(torch.profiler, per call)")
        # the call's sub-kernels alone: the pre-pass, the split-K reduction
        if pro:
            x, _, _, kw = conv_inputs(torch, gen, x_shape, 8, pro=True, res=False, up=False)
            a, c = kw["prologue_scale"], kw["prologue_bias"]
            run = functools.partial(conv3x3_prologue, x, a, c)
            rows.append(("conv3x3_slab_prologue", f"x={x_shape}", n, event_ms(run, 20),
                         event_ms(lambda: conv3x3_prologue_plain(x, a, c), 5), None,
                         (2 * x.numel() * 2 + 2 * b * ci * 4, 0.0), PEAK_BF16_FLOPS))
            d_sub = device_ms(run, 10)
            add_device("conv3x3_slab_prologue", n, d_sub)
            details["conv_configs"][-1]["prologue_device_ms"] = d_sub
            share = "" if None in (d_sub, d_k) else f", {100 * d_sub / d_k:.1f}% of the call's"
            log(f"device time conv3x3_slab_prologue x={x_shape}: {fmt_ms(d_sub)}{share}")
            del x
        if splits > 1:
            ws_shape = (splits, b, h, w, co)
            ws, bias, r = splitk_inputs(torch, gen, ws_shape, res=res)
            run = functools.partial(conv3x3_splitk_reduce, ws, bias, r, emit_stats=stats)
            d_sub = device_ms(run, 10)
            add_device("conv3x3_slab_splitk", n, d_sub)
            details["conv_configs"][-1]["splitk_device_ms"] = d_sub
            share = "" if None in (d_sub, d_k) else f", {100 * d_sub / d_k:.1f}% of the call's"
            log(f"device time conv3x3_slab_splitk ws={ws_shape}: {fmt_ms(d_sub)}{share}")
            rows.append(("conv3x3_slab_splitk", f"ws={ws_shape} res={int(res)} st={int(stats)}",
                         n, event_ms(run, 20),
                         event_ms(lambda: splitk_reduce_plain(ws, bias, r, emit_stats=stats), 5),
                         None, (ws.numel() * 4 + co * 4 + b * h * w * co * 2 * (2 if res else 1)
                                + (b * 2 * co * 4 if stats else 0), 0.0), PEAK_BF16_FLOPS))
            del ws
    for (q_shape, lk), n in sorted(calls["flash_attention_packed"].items()):
        t_k, t_p, t_l, d_k, d_l = time_flash(torch, gen, q_shape, lk)
        b, h, lq, d = q_shape
        bq, splits = plan_flash(b * h, lq, lk, d)
        desc = f"q={q_shape} lk={lk} bq={bq} splits={splits}"
        rows.append(("flash_attention", desc, n, t_k, t_p, t_l, flash_cost(q_shape, lk),
                     PEAK_BF16_FLOPS))
        add_device("flash_attention", n, d_k, d_l)
        details.setdefault("flash_configs", []).append(
            {"q": list(q_shape), "lk": lk, "per_image": n, "bq": bq, "splits": splits,
             "ms": t_k, "plain_ms": t_p, "library_ms": t_l, "device_ms": d_k,
             "library_device_ms": d_l})
        log(f"device time flash_attention {desc}: kernels {fmt_ms(d_k)}, library "
            f"{fmt_ms(d_l)} (torch.profiler, per call)")
        if splits > 1:  # the merge alone, on a workspace of this call's shape
            ws = merge_ws(torch, gen, splits, b * h, lq)
            run = functools.partial(flash_attention_merge, ws, b * h, lq, d, splits)
            d_sub = device_ms(run, 10)
            add_device("flash_attention_merge", n, d_sub)
            share = "" if None in (d_sub, d_k) else f", {100 * d_sub / d_k:.1f}% of the call's"
            log(f"device time flash_attention_merge splits={splits} rows={b * h}x{lq}: "
                f"{fmt_ms(d_sub)}{share}")
            rows.append(("flash_attention_merge", f"splits={splits} rows={b * h}x{lq} d={d}", n,
                         event_ms(run, 20),
                         event_ms(lambda: flash_merge_plain(ws, b * h, lq, d, splits), 5), None,
                         (ws.numel() * 4 + b * h * lq * d * 2, 0.0), PEAK_BF16_FLOPS))
            del ws
    log("device time flash_attention per image (torch.profiler): kernels "
        f"{fmt_ms(device['flash_attention']['kernel_ms'])}, library "
        f"{fmt_ms(device['flash_attention']['library_ms'])}")
    # the row passes at every call configuration of the main path, beside
    # F.layer_norm (GeGLU has no one library call)
    for row_kernel in ROW_KERNELS:
        for key, n in sorted(calls[row_kernel].items()):
            err, run, plain_run, lib, cost = row_case(torch, gen, row_kernel, key)
            errs[row_kernel] = max(errs.get(row_kernel, 0.0), err)
            t_k = event_ms(run, 20)
            rows.append((row_kernel, f"x={key[0]} {key[1]} p={key[2]}", n, t_k,
                         event_ms(plain_run, 5), None if lib is None else event_ms(lib, 20),
                         cost, PEAK_BF16_FLOPS))
            d_k, d_l = device_ms(run, 10), None if lib is None else device_ms(lib, 10)
            add_device(row_kernel, n, d_k, d_l)
            log(f"device time {row_kernel} x={key[0]}: kernel {fmt_ms(d_k)}, "
                f"{'none' if lib is None else 'F.layer_norm ' + fmt_ms(d_l)} (torch.profiler, "
                f"per call); {cost[0] / 1e6:.1f} MB, "
                + ("not measured" if d_k is None else
                   f"{cost[0] / (d_k * 1e-3) / 3.35e12 * 100:.1f}% of 3.35 TB/s"))
    # F and G: besides the CUDA-event time of back-to-back calls, the
    # profiler's device time, since at these shapes a call's kernel can be
    # shorter than its host-side enqueue
    cases = [("flash_attention_stats", f"q={q} lk={lk}", n, flash_stats_cost(q, lk),
              functools.partial(flash_stats_case, torch, gen, q, lk))
             for (q, lk), n in sorted(ring_calls["flash_attention_stats_packed"].items())]
    cases += [("out_proj_packed", f"o={o} c={c}", n, out_proj_cost(o, c),
               functools.partial(out_proj_case, torch, gen, o, c))
              for (o, c), n in sorted(packed_calls["out_proj_packed"].items())]
    for name, desc, n, cost, case in cases:
        err, t_k, t_p, t_l, dev = case()
        errs[name] = max(errs.get(name, 0.0), err)
        rows.append((name, desc, n, t_k, t_p, t_l, cost, PEAK_BF16_FLOPS))
        fmt = {k: "not measured" if dev[k] is None else f"{dev[k]:.4f} ms"
               for k in ("kernel", "library")}
        log(f"device time {name} {desc}: kernel {fmt['kernel']}, library "
            f"({dev['library_call']}) {fmt['library']} (torch.profiler, per call)")
        details.setdefault("device_ms_per_call", []).append(
            {"kernel": name, "config": desc, "per_image": n, "kernel_ms": dev["kernel"],
             "library_ms": dev["library"], "library_call": dev["library_call"]})
        tot = device.setdefault(name, {"kernel_ms": 0.0, "library_ms": 0.0})
        for k in ("kernel", "library"):
            tot[f"{k}_ms"] = None if dev[k] is None or tot[f"{k}_ms"] is None \
                else tot[f"{k}_ms"] + n * dev[k]
    # G's split-K reduction alone where the plan splits (its time is inside G's)
    for (o_shape, c), n in sorted(packed_calls["out_proj_packed"].items()):
        splits = plan_out_proj(*o_shape, c)[1]
        if splits == 1:
            continue
        err, t_s, t_sp, d_sub, s_cost = splitk_reduce_case(torch, gen, o_shape, c, splits)
        errs["out_proj_packed_splitk"] = max(errs.get("out_proj_packed_splitk", 0.0), err)
        desc = f"o={o_shape} c={c} splits={splits}"
        rows.append(("out_proj_packed_splitk", desc, n, t_s, t_sp, None, s_cost,
                     PEAK_BF16_FLOPS))
        add_device("out_proj_packed_splitk", n, d_sub)
        log(f"device time out_proj_packed_splitk {desc}: {fmt_ms(d_sub)} (torch.profiler, "
            "per call)")
    details["device_ms_per_image"] = device
    log(f"device time per image (torch.profiler): {device}")

    # phase 4: end to end, bf16
    counts, e2e = run_image(torch, np, pipe, ids, "e2e", launch_counts, reset_launch_counts)
    e2e_expected = dict(E2E_COUNTS, **conv_sub_counts(calls["conv3x3_slab"]),
                        **flash_sub_counts(calls))
    log(f"e2e expected launches: {e2e_expected}")
    recorded = {k: sum(calls[k].values()) for k in ROW_KERNELS}
    if recorded != {k: E2E_COUNTS[k] for k in ROW_KERNELS}:
        raise AssertionError(f"the row passes' recorded calls {recorded} are not E2E_COUNTS'")
    if counts != e2e_expected:
        raise AssertionError(f"launch counts {counts} != expected {e2e_expected}")
    idle = [name for name in MAIN_KERNELS if counts[name] == 0]
    if idle:
        raise AssertionError(f"the bf16 image launched no {idle}")
    details["e2e"] = e2e
    details["graphs"] = graphs_check(torch, np, pipe, ids, e2e_expected, launch_counts,
                                     reset_launch_counts)

    # control: one UNet forward and one VAE decode, kernels vs plain, beside
    # the plain path's bf16-vs-float32 difference
    from sdtpu_torch.models.unet import unet_forward
    from sdtpu_torch.models.vae import vae_decode

    lat = torch.randn((2, 64, 64, 4), generator=gen, device="cuda")
    ctx = torch.randn((2, 77, 768), generator=gen, device="cuda")
    ts = torch.full((2,), 501.0, device="cuda")
    dec_in = torch.randn((1, 64, 64, 4), generator=gen, device="cuda")

    def unet(params, dt, impl="flash"):
        return unet_forward(lat.to(dt), ts, ctx.to(dt), params, pcfg.unet,
                            attention_impl=impl).float()

    def vae(params, dt, impl="flash"):
        return vae_decode(dec_in.to(dt), params, pcfg.vae, attention_impl=impl).float()

    def route_outputs(params, impl="flash"):
        """(kernels bf16, plain bf16, plain f32) of the UNet forward and of
        the VAE decode through one attention route."""
        params32 = {k: to_dtype(params[k], torch.float32) for k in ("unet", "vae_decoder")}
        with torch.inference_mode():
            k_out = (unet(params["unet"], torch.bfloat16, impl),
                     vae(params["vae_decoder"], torch.bfloat16, impl))
            with routed(**plain):
                p_out = (unet(params["unet"], torch.bfloat16, impl),
                         vae(params["vae_decoder"], torch.bfloat16, impl))
                f_out = (unet(params32["unet"], torch.float32, impl),
                         vae(params32["vae_decoder"], torch.float32, impl))
        return k_out, p_out, f_out

    def judge(label, outs):
        """kernels vs plain <= max(2 x the plain route's bf16-vs-f32, 1e-2)."""
        result = {}
        for i, what in enumerate(("unet_forward", "vae_decode")):
            k_out, p_out, f_out = (o[i] for o in outs)
            finite = bool(torch.isfinite(k_out).all())
            d_kp = rel_l2(torch, k_out, p_out)
            d_pf = rel_l2(torch, p_out, f_out)
            d_kf = rel_l2(torch, k_out, f_out)
            ok = finite and d_kp <= max(2.0 * d_pf, 1e-2)
            log(f"{label} {what}: rel L2 kernels-vs-plain (bf16) {d_kp:.4g}; plain "
                f"bf16-vs-f32 {d_pf:.4g}; kernels-vs-plain-f32 {d_kf:.4g}; finite {finite}; "
                f"tol max(2x bf16-vs-f32, 1e-2)" + (" ok" if ok else " FAIL"))
            result[what] = {"kernels_vs_plain": d_kp, "plain_bf16_vs_f32": d_pf,
                            "kernels_vs_f32": d_kf}
            if not ok:
                raise AssertionError(f"{label} {what}: kernels disagree with the plain route")
        return result

    flash_outs = route_outputs(pipe.params)
    (k_unet, k_vae), (p_unet, p_vae), _ = flash_outs
    control = judge("control", flash_outs)
    details["control"] = control

    # derived from the tree: the self-attention calls per image (every UNet
    # transformer block per step, the VAE mid-block's attention once)
    uparams = pipe.params["unet"]
    n_blocks = sum(len(a["blocks"]) for blk in uparams["down_blocks"] + uparams["up_blocks"]
                   for a in blk.get("attentions", []))
    n_blocks += sum(len(a["blocks"]) for a in uparams.get("mid_block", {}).get("attentions", []))
    n_self = STEPS * n_blocks + 1
    log(f"{n_blocks} UNet transformer blocks x {STEPS} steps + 1 VAE attention = {n_self} "
        f"self-attention calls per image")
    if n_self != E2E_COUNTS["flash_attention"]:
        raise AssertionError(f"{n_self} self-attention calls, but kernel C runs "
                             f"{E2E_COUNTS['flash_attention']} times per image")

    # phase 5: the sequence-parallel ring on the one card, kernel F
    ring_expected = dict(E2E_COUNTS, flash_attention=0, flash_attention_stats=RING * RING * n_self,
                         **conv_sub_counts(ring_calls["conv3x3_slab"]),
                         **flash_sub_counts(ring_calls))
    with ring_context(LocalRing(RING)):
        ring_counts, ring_e2e = run_image(torch, np, pipe_ring, ids, "ring", launch_counts,
                                          reset_launch_counts)
        log(f"ring expected launches ({RING}x{RING} F launches per self-attention call): "
            f"{ring_expected}")
        if ring_counts != ring_expected:
            raise AssertionError(f"ring launch counts {ring_counts} != expected {ring_expected}")
        ring_outs = route_outputs(pipe.params, "ring")
    details["ring"] = ring_e2e
    details["ring_control"] = judge("ring control", ring_outs)
    for i, what in enumerate(("unet_forward", "vae_decode")):
        d = rel_l2(torch, ring_outs[0][i], flash_outs[0][i])
        log(f"ring vs flash route (kernels, bf16) {what}: rel L2 {d:.4g} (for information)")
        details["ring_control"][what]["ring_vs_flash"] = d

    # phase 6: one-rank NCCL group: health_check and the ring over it
    details["nccl"] = nccl_phase(torch)

    # phase 7: the packed out-projection, kernel G
    packed_expected = dict(E2E_COUNTS, out_proj_packed=n_self,
                           **conv_sub_counts(packed_calls["conv3x3_slab"]),
                           **flash_sub_counts(packed_calls), **out_proj_sub_counts(packed_calls))
    attn_mod._PACKED_OUT_PROJ = True
    try:
        packed_counts, packed_e2e = run_image(torch, np, pipe, ids, "packed", launch_counts,
                                              reset_launch_counts)
        log(f"packed expected launches: {packed_expected}")
        if packed_counts != packed_expected:
            raise AssertionError(
                f"packed launch counts {packed_counts} != expected {packed_expected}")
        details["packed"] = packed_e2e
        details["packed_control"] = judge("packed control", route_outputs(pipe.params))
    finally:
        attn_mod._PACKED_OUT_PROJ = False
    # the three routes' seconds per image in turns inside this call (host-
    # side variance between calls is large)
    turns = []
    for route in ("flash", "packed", "ring", "ring", "packed", "flash"):
        attn_mod._PACKED_OUT_PROJ = route == "packed"
        try:
            with ring_context(LocalRing(RING) if route == "ring" else None):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                (pipe_ring if route == "ring" else pipe).generate(
                    token_ids=ids, num_inference_steps=STEPS, seed=40, image_size=512)
                turns.append((route, time.perf_counter() - t0))
        finally:
            attn_mod._PACKED_OUT_PROJ = False
    log("s/image in turns: " + ", ".join(f"{r} {t:.4f}" for r, t in turns))
    details["route_turns_s"] = turns
    # phase 8's int8 pipeline quantizes the same tree (quantize_int8 makes a
    # new tree and leaves this one as it is); a host copy serves phases 10-13
    host_params = tree_to(pipe.params, "cpu")
    pipe_q = StableDiffusionPipeline(pcfg, pipe.params, device="cuda")
    pipe.params = pipe_ring.params = None  # the int8 image's peak memory holds only its own tree

    # phase 8: int8 (W8A8); kernel D checked and timed at every int8 call
    # shape (phase 3's work for this path), then the int8 image
    t0 = time.perf_counter()
    pipe_q.quantize_int8(transformer=True, vae=True)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    log(f"int8: quantize_int8(transformer=True, vae=True) took {quant_s:.3f} s on the host")
    details["quantize_s"] = quant_s
    q_all_calls = record_main_path_calls(torch, pipe_q, ids)
    q_calls = q_all_calls["conv3x3_slab"]
    # kernel D at every int8 call shape of the int8 path, with its pieces
    counterparts = {"kernel_A_ms": 0.0, "cudnn_bf16_ms": 0.0}
    d_configs = []
    d_device = dict.fromkeys(("prologue", "gemm", "reduction", "other"), 0.0)
    for (x_shape, co, pro, res, up, stats, quant), n in sorted(q_calls.items()):
        if not quant:
            continue
        c = int8_case(torch, gen, x_shape, co, res, stats)
        errs["conv3x3_slab_int8"] = max(errs.get("conv3x3_slab_int8", 0.0), c["err"])
        errs["conv3x3_slab_int8_prologue"] = max(errs.get("conv3x3_slab_int8_prologue", 0.0),
                                                 float(c["code_err"]))
        counterparts["kernel_A_ms"] += n * c["kernel_A_ms"]
        counterparts["cudnn_bf16_ms"] += n * c["cudnn_ms"]
        desc = f"x={x_shape} co={co} res={int(res)} st={int(stats)} S={c['splits']}"
        cost = int8_conv_cost(x_shape, co, res=res, stats=stats)
        rows.append(("conv3x3_slab_int8", desc, n, c["ms"], c["plain_ms"], None, cost,
                     PEAK_INT8_OPS))
        p = c["prologue"]
        rows.append(("conv3x3_slab_int8_prologue", f"x={x_shape}", n, p["ms"], p["plain_ms"],
                     None, p["cost"], PEAK_INT8_OPS))
        red = c["reduction"]
        if red is not None:
            errs["conv3x3_slab_int8_splitk"] = 0.0  # held bitwise in int8_case
            rows.append(("conv3x3_slab_int8_splitk",
                         f"ws={(c['splits'],) + tuple(x_shape[:3]) + (co,)} res={int(res)} "
                         f"st={int(stats)}", n, red["ms"], red["plain_ms"], None, red["cost"],
                         PEAK_INT8_OPS))
        if c["device"] is None:
            d_device = None
        elif d_device is not None:
            for key, v in c["device"].items():
                d_device[key] += n * v
        d_configs.append({"x": list(x_shape), "co": co, "res": res, "stats": stats,
                          "per_image": n, "split": c["splits"], "config": desc, "ms": c["ms"],
                          "plain_ms": c["plain_ms"], "device_ms": c["device"],
                          "prologue_alone": {k: p[k] for k in ("ms", "device_ms", "plain_ms")},
                          "reduction_alone": None if red is None else
                          {k: red[k] for k in ("ms", "device_ms", "plain_ms")},
                          "float_counterpart_kernel_A_ms": c["kernel_A_ms"],
                          "float_counterpart_cudnn_bf16_ms": c["cudnn_ms"],
                          "max_abs_err": c["err"], "share_differing": c["share"],
                          "code_max_diff": c["code_err"], "code_share_differing": c["code_share"],
                          "tops": cost[1] / c["ms"] / 1e9})
        dev_s = ("not measured" if c["device"] is None else
                 ", ".join(f"{k} {v:.4f}" for k, v in c["device"].items()) + " ms")
        log(f"device time conv3x3_slab_int8 {desc} (torch.profiler, per call): {dev_s}; "
            f"pre-pass alone {fmt_ms(p['device_ms'])}"
            + ("" if red is None else f", reduction alone {fmt_ms(red['device_ms'])}"))
        log(f"float counterparts of conv3x3_slab_int8 {desc} (not the same function): "
            f"kernel A {c['kernel_A_ms']:.4f} ms, cuDNN bf16 {c['cudnn_ms']:.4f} ms; "
            f"D {cost[1] / c['ms'] / 1e9:.1f} TOP/s, A {cost[1] / c['kernel_A_ms'] / 1e9:.1f} "
            f"TFLOP/s, cuDNN {cost[1] / c['cudnn_ms'] / 1e9:.1f} TFLOP/s")
    log("device time conv3x3_slab_int8 per int8 image (torch.profiler): "
        + ("not measured" if d_device is None else
           ", ".join(f"{k} {v:.3f}" for k, v in d_device.items())
           + f" ms; total {sum(d_device.values()):.3f} ms"))
    details["int8_device_ms_per_image"] = d_device
    details["int8_configs"] = d_configs
    details["configs"] = []
    for name, desc, n, t_k, t_p, t_l, cost, peak in rows:
        b_ms, b_by = bound_ms(cost, peak, exp_rate)
        b_old = bound_ms(cost[:2], peak)[0]
        t_by, t_ops = bound_terms(cost, peak, exp_rate)
        tot = totals[name]
        tot["per_image_calls"] += n
        tot["ms"] += n * t_k
        tot["plain_ms"] += n * t_p
        tot["library_ms"] = None if t_l is None else tot["library_ms"] + n * t_l
        tot["bound_ms"] += n * b_ms
        tot["bound_ms_without_exp"] += n * b_old
        tot["byte_ms"] += n * t_by
        tot["op_ms"] += n * t_ops
        lib = "library none" if t_l is None else f"library {t_l:.4f} ms"
        old = f", without the exp term {b_old:.4f} ms" if len(cost) > 2 else ""
        log(f"time {name} {desc} x{n}/image ({n * t_k:.3f} ms/image): kernel {t_k:.4f} ms, "
            f"plain {t_p:.4f} ms, "
            f"{lib}, bound {b_ms:.4f} ms ({b_by}{old}), {cost[1] / t_k / 1e9:.1f} T(FL)OP/s")
        details["configs"].append({"kernel": name, "config": desc, "per_image": n,
                                   "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                                   "bound_ms": b_ms, "bound_by": b_by,
                                   "bound_ms_without_exp": b_old,
                                   "bytes": cost[0], "ops": cost[1]})
    log("per-image bounds with the exp term (without): " + ", ".join(
        f"{n} {totals[n]['bound_ms']:.3f} ({totals[n]['bound_ms_without_exp']:.3f}) ms"
        for n in ("flash_attention", "flash_attention_stats")))
    log(f"float counterparts of conv3x3_slab_int8 per image (not the same function): "
        f"kernel A {counterparts['kernel_A_ms']:.3f} ms, cuDNN bf16 "
        f"{counterparts['cudnn_bf16_ms']:.3f} ms; D {totals['conv3x3_slab_int8']['ms']:.3f} ms")
    details["int8_float_counterparts_per_image"] = counterparts

    n_unet, n_vae = unet_resnets(pipe_q.params["unet"]), unet_resnets(pipe_q.params["vae_decoder"])
    d_expected = 2 * n_unet * STEPS + 2 * n_vae
    log(f"int8: {n_unet} UNet resnets x 2 convs x {STEPS} steps + {n_vae} VAE resnets x 2 "
        f"convs = {d_expected} int8 slab convs per image")
    q_expected = dict(E2E_COUNTS, conv3x3_slab=0, conv3x3_slab_int8=d_expected,
                      **conv_sub_counts(q_calls), **flash_sub_counts(q_all_calls))
    if d_expected != 478:
        raise AssertionError(f"tiny-sd should have 478 resnet convs per image, got {d_expected}")
    q_counts, q_e2e = run_image(torch, np, pipe_q, ids, "int8", launch_counts,
                                reset_launch_counts)
    log(f"int8 expected launches: {q_expected}")
    if q_counts != q_expected:
        raise AssertionError(f"int8 launch counts {q_counts} != expected {q_expected}")
    idle = [name for name in INT8_KERNELS if q_counts[name] == 0]
    if idle:
        raise AssertionError(f"the int8 image launched no {idle}")
    details["int8"] = q_e2e

    q32 = {k: to_dtype(pipe_q.params[k], torch.float32) for k in ("unet", "vae_decoder")}
    with torch.inference_mode():
        kq_unet = unet(pipe_q.params["unet"], torch.bfloat16)
        kq_vae = vae(pipe_q.params["vae_decoder"], torch.bfloat16)
        with routed(**plain):
            pq_unet = unet(pipe_q.params["unet"], torch.bfloat16)
            pq_vae = vae(pipe_q.params["vae_decoder"], torch.bfloat16)
            fq_unet = unet(q32["unet"], torch.float32)
            fq_vae = vae(q32["vae_decoder"], torch.float32)
        # one kernel on the card, the rest plain: how far a single kernel's
        # bf16-level differences move the int8 route
        with routed(conv3x3_slab=plain["conv3x3_slab"]):
            cq_unet = unet(pipe_q.params["unet"], torch.bfloat16)
            cq_vae = vae(pipe_q.params["vae_decoder"], torch.bfloat16)
    del q32
    q_control = {}
    for what, k_out, p_out, f_out, c_out, p_bf16 in (
            ("unet_forward", kq_unet, pq_unet, fq_unet, cq_unet, p_unet),
            ("vae_decode", kq_vae, pq_vae, fq_vae, cq_vae, p_vae)):
        finite = bool(torch.isfinite(k_out).all())
        d_kp = rel_l2(torch, k_out, p_out)
        d_qf = rel_l2(torch, p_out, f_out)
        d_cp = rel_l2(torch, c_out, p_out)
        d_qb = rel_l2(torch, p_out, p_bf16)
        d_pf = control[what]["plain_bf16_vs_f32"]
        # an int8 code flips wherever a bf16-level difference crosses a
        # rounding boundary, so the int8 route is judged against its own
        # bf16-vs-f32 difference, as the bf16 route is against its own
        ok = finite and d_kp <= max(2.0 * d_qf, 1e-2)
        log(f"int8 control {what}: rel L2 kernels-vs-plain (int8) {d_kp:.4g}; plain int8 "
            f"bf16-vs-f32 {d_qf:.4g}; only flash_attention on the card vs plain {d_cp:.4g}; "
            f"plain int8-vs-bf16 {d_qb:.4g}; plain bf16-vs-f32 (bf16 route) {d_pf:.4g}; "
            f"finite {finite}; tol max(2x int8 bf16-vs-f32, 1e-2)" + (" ok" if ok else " FAIL"))
        q_control[what] = {"kernels_vs_plain": d_kp, "plain_int8_bf16_vs_f32": d_qf,
                           "flash_only_vs_plain": d_cp, "plain_int8_vs_bf16": d_qb,
                           "plain_bf16_vs_f32": d_pf}
        if not ok:
            raise AssertionError(f"int8 {what}: kernels disagree with the plain int8 route")
    mse = float((kq_vae - k_vae).square().mean())
    vae_psnr = 10.0 * math.log10(4.0 / mse) if mse > 0 else float("inf")
    log(f"int8 VAE decode vs bf16 decode (kernels, same latents): PSNR {vae_psnr:.2f} dB "
        f"(range 2, for information; phase 20 (b) gates it on check_int8's weights)")
    q_control["vae_decode_psnr_db"] = vae_psnr
    details["int8_control"] = q_control

    # phase 9: the measurement entry points' kernels E, H, I, J
    probes = probes_phase(torch, gen, exp_rate, launch_counts, reset_launch_counts)
    details["probes"] = probes

    # phases 10-13: seeds, bench, the library row, stages and trace, on the
    # bf16 tree again
    t0 = time.perf_counter()
    pipe_q.params = None
    pipe.params = tree_to(host_params, "cuda")
    details["seeds"] = seeds_phase(torch, np, pipe, ids)
    details["seeds"]["from_random_s"] = from_random_s
    t1 = time.perf_counter()
    details["bench"] = bench_phase(torch, launch_counts, reset_launch_counts, kind,
                                   e2e_expected, n_self, 2 * n_unet * STEPS)
    t2 = time.perf_counter()
    details["library_row"] = library_phase(torch, np, pipe, ids, launch_counts,
                                           reset_launch_counts)
    t3 = time.perf_counter()
    details["stages"] = stages_phase(torch, pipe, ids, args.trace_dir)
    t4 = time.perf_counter()

    # phase 14: a diffusers checkpoint, the VAE encoder, the samplers
    pipe.params = None
    torch.cuda.empty_cache()
    details["checkpoint"] = checkpoint_phase(torch, np, gen, exp_rate, ids, host_params["clip"],
                                             launch_counts, reset_launch_counts, e2e_expected,
                                             kind)
    t5 = time.perf_counter()

    # phase 15: image-conditioned requests and batched serving, on the
    # seed-0 tree again; the SD-1.5 family's tree of phases 15-17
    # (sd15-inpaint's from_random, drawn once on the host: sd15_pipeline)
    from sdtpu_torch.config import get_preset
    from sdtpu_torch.utils.weights import init_pipeline_params

    t_draw = time.perf_counter()
    sd15_host = init_pipeline_params(0, get_preset("sd15-inpaint"), device="cpu")
    details["sd15_from_random_s"] = time.perf_counter() - t_draw
    log(f"sd15-inpaint: from_random(seed=0)'s tree drawn in {details['sd15_from_random_s']:.3f}"
        " s on the host (the SD-1.5 family of phases 15-17: sd15, sd15-inpaint, ip2p, "
        "lcm-sd15)")
    pipe.params = tree_to(host_params, "cuda")
    details["conditioned"] = conditioned_phase(torch, np, gen, pipe, ids, sd15_host,
                                               launch_counts,
                                               reset_launch_counts, kind, e2e_expected)
    t6 = time.perf_counter()

    # phase 16: the SDXL family and LCM's guidance embedding
    pipe.params = None
    torch.cuda.empty_cache()
    details["sdxl"], xl_params, xl_held = sdxl_phase(torch, np, gen, sd15_host, launch_counts,
                                                     reset_launch_counts, kind, exp_rate)
    t7 = time.perf_counter()

    # phase 17: ControlNet and the denoise step's features (sd15; tiny-sd's
    # seed-0 tree for the deepest-level PAG site and the encoder cache)
    torch.cuda.empty_cache()
    details["features"] = features_phase(torch, np, gen, host_params, sd15_host, launch_counts,
                                         reset_launch_counts, kind)
    t8 = time.perf_counter()

    # phase 18: the text features (sd15)
    torch.cuda.empty_cache()
    details["text"] = text_phase(torch, np, gen, sd15_host, launch_counts, reset_launch_counts)
    del sd15_host
    t9 = time.perf_counter()

    # phase 19: the dp/tp mesh (tiny-sd on the gate's weights): one process,
    # then two gloo processes on the one card
    torch.cuda.empty_cache()
    details["mesh"] = mesh_phase(torch, np, launch_counts, reset_launch_counts)
    t10 = time.perf_counter()
    log(f"phase 19 (mesh): {t10 - t9:.1f} s")

    # phase 20: the fidelity gates (device_precision, check_int8) and the
    # presets no earlier phase ran (sd21, sdxl in int8, sdxl-inpaint, an
    # SDXL ControlNet) on phase 16's tree
    torch.cuda.empty_cache()
    int8_held = {(tuple(c["x"]), c["co"], c["res"], c["stats"]) for c in details["int8_configs"]}
    details["fidelity"] = fidelity_phase(torch, np, gen, xl_params, xl_held, int8_held,
                                         launch_counts, reset_launch_counts)
    del xl_params
    t11 = time.perf_counter()

    # phase 21: the last tools, C's plans at the probes' shapes, and the
    # GroupNorm statistics chaining off against on (tiny-sd's seed-0 tree)
    torch.cuda.empty_cache()
    details["last_tools"] = last_tools_phase(torch, np, gen, host_params, ids, args.trace_dir,
                                             launch_counts, reset_launch_counts, e2e_expected)
    del host_params
    t12 = time.perf_counter()
    details["phase_s"] = {"seeds": t1 - t0, "bench": t2 - t1, "library": t3 - t2,
                          "stages": t4 - t3, "checkpoint": t5 - t4, "conditioned": t6 - t5,
                          "sdxl": t7 - t6, "features": t8 - t7, "text": t9 - t8,
                          "mesh": t10 - t9, "fidelity": t11 - t10, "last_tools": t12 - t11}
    log("phases 10-21 wall s: " + ", ".join(f"{k} {v:.1f}"
                                            for k, v in details["phase_s"].items()))
    added = (details["last_tools"]["phase_s"] + details["stages"]["capture_phase_s"]
             + details["checkpoint"]["grid"]["s"])
    details["added_s"] = added
    log(f"phase 21 with the additions to phases 13 (capture_trace, summarize_trace) and 14 "
        f"(generate_grid): {added:.1f} s")

    kernels = []
    for name, (src, replaces) in SOURCES.items():
        if name in PROBE_KERNELS:
            kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                            **probes["kernels"][name]})
            continue
        tot = totals[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": {"conv3x3_slab_int8": q_counts, "conv3x3_slab_int8_prologue": q_counts,
                         "conv3x3_slab_int8_splitk": q_counts,
                         "flash_attention_stats": ring_counts,
                         "out_proj_packed": packed_counts,
                         "out_proj_packed_splitk": packed_counts}.get(name, counts)[name],
            "max_abs_err": errs[name],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if tot["byte_ms"] > tot["op_ms"] else "operations",
            "library_ms": tot["library_ms"],
        })
        if name in MESH_KERNELS:  # phase 19's launches: 1x1 mesh, then per rank
            kernels[-1]["mesh_launches"] = details["mesh"]["mesh_launches"][name]
    details["kernels"] = kernels
    details["total_s"] = time.perf_counter() - t_start
    log(f"chip_smoke: {details['total_s']:.1f} s in all, the kernels' build included")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(details, f, indent=1)
    log("kernel times are per image: the sum over the main path's calls "
        "(count per image x CUDA-event time per call); launches of conv3x3_slab_int8 and its "
        "pre-pass and reduction are the int8 image's, of flash_attention_stats the ring image's, of out_proj_packed "
        "and out_proj_packed_splitk the packed image's, the others the bf16 image's; for the probe kernels "
        f"{', '.join(PROBE_KERNELS)} the times are sums over phase 9's check calls (one per "
        "shape and variant) and the launches those of their tool's run")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------- probes --

E_SHAPES = ((2, 64, 64, 320), (2, 32, 32, 640), (2, 16, 16, 1280))  # tiny-sd resnets, Ci = Co
HI_SHAPES = ((2, 8, 4096, 40), (2, 8, 1024, 80))                  # tiny-sd self-attention
TOOL_CHAIN = 3                                                      # calls per timed chain


def judge_probe(torch, name, desc, got, want, *, exact=False):
    """Fail unless ``got`` equals ``want`` (bitwise when ``exact``, else
    within TOL_REL of max |want|); returns the max abs error."""
    torch.cuda.synchronize()
    if exact:
        err = float((got.double() - want.double()).abs().max())
        ref = float(want.double().abs().max())
        ok = bool(torch.equal(got, want))
        tol = "bitwise"
    else:
        err, ref = max_err(got, want)
        ok = err <= TOL_REL * ref
        tol = f"tol {TOL_REL:g} rel"
    log(f"check {name} {desc}: max_abs_err={err:.4g} (max|plain|={ref:.4g}, {tol})"
        + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError(f"{name} {desc} disagrees with its plain version")
    return err


def tool_checks(torch, errs):
    """Every kernel variant that the tools run, on the tools' own inputs and
    shapes, against its plain version (``errs[name]`` collects the errors):
    ab_conv's E and A with and without prologue, and at every shape of the
    flash probes C, H and I at each card variant."""
    from sdtpu_torch.kernels.conv2d import (
        conv3x3_gemm_plain,
        conv3x3_slab,
        conv3x3_slab_plain,
        gn_silu_conv3x3_slab,
        plan_co_tile,
    )
    from sdtpu_torch.kernels.flash_attention import flash_attention_packed, flash_attention_plain
    from sdtpu_torch.ops import conv2d
    from sdtpu_torch.tools import ab_conv, probe_flash_vpu
    from sdtpu_torch.tools.probe_flash_2stream import CARD_VARIANTS, flash_2q
    from sdtpu_torch.tools.probe_flash_vpu import legacy_flash, legacy_flash_plain, qkv_inputs
    from sdtpu_torch.utils.quant import slab_plan_ok

    for b, h, w, c in E_SHAPES + tuple(ab_conv.DEFAULT_SHAPES):
        x, k, bias, norm = ab_conv.conv_inputs(b, h, w, c)
        desc, g = f"ab_conv x={(b, h, w, c)} co={c}", 32 if c % 32 == 0 else 16
        if plan_co_tile((b, h, w, c), (3, 3, c, c)) is not None:
            errs["conv3x3_gemm"].append(judge_probe(
                torch, "conv3x3_gemm", desc, conv2d(x, k, bias, padding=1, impl="gemm"),
                conv3x3_gemm_plain(x, k, bias)))
        if slab_plan_ok((b, h, w, c), (3, 3, c, c)):
            judge_probe(torch, "conv3x3_slab", desc, conv3x3_slab(x, k, bias),
                        conv3x3_slab_plain(x, k, bias))
            got = gn_silu_conv3x3_slab(x, norm, k, bias, num_groups=g)
            with routed(conv3x3_slab=conv3x3_slab_plain):
                want = gn_silu_conv3x3_slab(x, norm, k, bias, num_groups=g)
            judge_probe(torch, "conv3x3_slab", desc + " gn-prologue", got, want)
        del x, k
    for label, b, h, l, d in probe_flash_vpu.SHAPES:
        q, k, v = qkv_inputs(b, h, l, d)
        desc = f"{label} q=k=v={(b, h, l, d)}"
        judge_probe(torch, "flash_attention", desc, flash_attention_packed(q, k, v),
                    by_rows(flash_attention_plain, q, k, v))
        # flash_2q_plain is legacy_flash_plain behind its Lq check, so one
        # reference serves H and every variant of I (on its first lq rows)
        want = by_rows(legacy_flash_plain, q, k, v)
        errs["flash_attention_legacy"].append(judge_probe(
            torch, "flash_attention_legacy", desc, legacy_flash(q, k, v), want))
        for nq, bq in CARD_VARIANTS:
            lq = l // (nq * bq) * (nq * bq)  # the largest Lq the variant takes
            qi = q if lq == l else q[:, :, :lq].contiguous()
            errs["flash_attention_nq"].append(judge_probe(
                torch, "flash_attention_nq", f"nq={nq} bq={bq} {desc} lq={lq}",
                flash_2q(qi, k, v, bq=bq, nq=nq), want[:, :, :lq]))
        del q, k, v, want
        torch.cuda.empty_cache()


def probe_case(torch, name, desc, run, plain, library, cost, peak, exp_rate, *, exact=False):
    """One probe kernel at one shape: ``run()`` against ``plain()`` (bitwise
    when ``exact``, else within TOL_REL of max |plain|), then the kernel,
    plain and library times by CUDA events and the kernel's and library's
    device times by the profiler, beside the bound.  ``library`` None: no
    one PyTorch call computes the function (its times are None)."""
    err = judge_probe(torch, name, desc, run(), plain(), exact=exact)
    t_k, t_p = event_ms(run, 10), event_ms(plain, 3)
    t_l = None if library is None else event_ms(library, 10)
    d_k, d_l = device_ms(run, 10), None if library is None else device_ms(library, 10)
    b_ms, b_by = bound_ms(cost, peak, exp_rate)
    t_by, t_ops = bound_terms(cost, peak, exp_rate)
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"  # noqa: E731
    old = f", without the exp term {bound_ms(cost[:2], peak)[0]:.4f} ms" if len(cost) > 2 else ""
    lib = "none" if library is None else f"{t_l:.4f} ms (device {fmt(d_l)})"
    log(f"time {name} {desc}: kernel {t_k:.4f} ms (device {fmt(d_k)}), plain {t_p:.4f} ms, "
        f"library {lib}, bound {b_ms:.4f} ms ({b_by}{old}), "
        f"{cost[1] / t_k / 1e9:.1f} T(FL)OP/s")
    return {"config": desc, "max_abs_err": err, "ms": t_k, "device_ms": d_k, "plain_ms": t_p,
            "library_ms": t_l, "library_device_ms": d_l, "bound_ms": b_ms, "bound_by": b_by,
            "byte_ms": t_by, "op_ms": t_ops}


def probes_phase(torch, gen, exp_rate, launch_counts, reset_launch_counts):
    """Phase 9: E, H, I and J against their plain versions and timed, then
    each tool's main() with the launch counters held to its calls.  Returns
    the per-kernel sums for the kernels line and every case."""
    import torch.nn.functional as F

    from sdtpu_torch.kernels.conv2d import conv3x3_gemm, conv3x3_gemm_plain, plan_co_tile
    from sdtpu_torch.tools import ab_conv, probe_flash_2stream, probe_flash_vpu, probe_int8_dot
    from sdtpu_torch.tools.probe_flash_2stream import CARD_VARIANTS, flash_2q, flash_2q_plain
    from sdtpu_torch.tools.probe_flash_vpu import legacy_flash, legacy_flash_plain
    from sdtpu_torch.tools.probe_int8_dot import (
        dot_inputs,
        dot_int8_reduce_plain,
        dot_int8_split_plain,
        dot_int8_transpose,
        dot_plain,
        dot_splitk_reduce,
        dot_transpose_plain,
        make,
        plan_dot,
        splitk_reduce_plain,
    )

    t0 = time.perf_counter()
    cases = {n: [] for n in PROBE_KERNELS}
    for b, h, w, c in E_SHAPES:
        if plan_co_tile((b, h, w, c), (3, 3, c, c)) is None:
            raise AssertionError(f"plan_co_tile refuses {(b, h, w, c)}")
        x, k, bias, _ = conv_inputs(torch, gen, (b, h, w, c), c, pro=False, res=False, up=False)
        x_nchw, b16 = x.permute(0, 3, 1, 2), bias.to(torch.bfloat16)
        k_oihw = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        cases["conv3x3_gemm"].append(probe_case(
            torch, "conv3x3_gemm", f"x={(b, h, w, c)} co={c}",
            lambda: conv3x3_gemm(x, k, bias), lambda: conv3x3_gemm_plain(x, k, bias),
            lambda: F.conv2d(x_nchw, k_oihw, b16, padding=1),
            conv_cost((b, h, w, c), c, pro=False, res=False, up=False, stats=False),
            PEAK_BF16_FLOPS, exp_rate))
    sdpa = F.scaled_dot_product_attention
    for b, h, l, d in HI_SHAPES:
        q, k, v = (torch.randn((b, h, l, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        cases["flash_attention_legacy"].append(probe_case(
            torch, "flash_attention_legacy", f"q=k=v={(b, h, l, d)}",
            lambda: legacy_flash(q, k, v), lambda: legacy_flash_plain(q, k, v),
            lambda: sdpa(q, k, v), flash_cost((b, h, l, d), l), PEAK_BF16_FLOPS, exp_rate))
        for nq, bq in CARD_VARIANTS:
            lq = l // (nq * bq) * (nq * bq)  # the largest Lq the variant takes
            qi = q[:, :, :lq].contiguous()
            cases["flash_attention_nq"].append(probe_case(
                torch, "flash_attention_nq", f"nq={nq} bq={bq} q={(b, h, lq, d)} lk={l}",
                lambda: flash_2q(qi, k, v, bq=bq, nq=nq),
                lambda: flash_2q_plain(qi, k, v, bq=bq, nq=nq),
                lambda: sdpa(qi, k, v), flash_cost((b, h, lq, d), l), PEAK_BF16_FLOPS,
                exp_rate))
    for m, kk, n in probe_int8_dot.SHAPES:
        x8, w8, x16, w16 = dot_inputs(m, kk, n)
        f16 = make(m, kk, n, torch.bfloat16, torch.float32, torch.bfloat16)
        f8 = make(m, kk, n, torch.int8, torch.int32, torch.int32)
        desc = f"({m},{kk})@({kk},{n})"
        cases["dot_bf16"].append(probe_case(
            torch, "dot_bf16", desc, lambda: f16(x16, w16),
            lambda: dot_plain(x16, w16, torch.float32, torch.bfloat16),
            lambda: torch.matmul(x16, w16), (2 * (m * kk + kk * n + m * n), 2.0 * m * kk * n),
            PEAK_BF16_FLOPS, exp_rate))
        cases["dot_int8"].append(probe_case(
            torch, "dot_int8", desc, lambda: f8(x8, w8),
            lambda: dot_plain(x8, w8, torch.int32, torch.int32),
            lambda: torch._int_mm(x8, w8), (m * kk + kk * n + 4 * m * n, 2.0 * m * kk * n),
            PEAK_INT8_OPS, exp_rate, exact=True))
        # J int8's transpose of w and, where its plan splits, its reduction, alone
        cases["dot_int8_transpose"].append(probe_case(
            torch, "dot_int8_transpose", f"w=({kk},{n})", lambda: dot_int8_transpose(w8),
            lambda: dot_transpose_plain(w8), lambda: w8.t().contiguous(), (2 * kk * n, 0.0),
            PEAK_INT8_OPS, exp_rate, exact=True))
        splits8 = plan_dot(m, kk, n, True)[1]
        if splits8 > 1:
            ws8 = dot_int8_split_plain(x8, w8, splits8)
            cases["dot_int8_splitk"].append(probe_case(
                torch, "dot_int8_splitk", f"ws={(splits8, m, n)}", lambda: dot_splitk_reduce(ws8),
                lambda: dot_int8_reduce_plain(ws8), lambda: ws8.sum(dim=0, dtype=torch.int32),
                (ws8.numel() * 4 + m * n * 4, 0.0), PEAK_INT8_OPS, exp_rate, exact=True))
        splits = plan_dot(m, kk, n)[1]
        if splits > 1:  # the bf16 call's split-K reduction alone, bitwise
            ws = torch.randn((splits, m, n), generator=gen, device="cuda")
            cases["dot_bf16_splitk"].append(probe_case(
                torch, "dot_bf16_splitk", f"ws={(splits, m, n)}", lambda: dot_splitk_reduce(ws),
                lambda: splitk_reduce_plain(ws), None, (ws.numel() * 4 + m * n * 2, 0.0),
                PEAK_BF16_FLOPS, exp_rate, exact=True))
    tool_errs = {n: [] for n in PROBE_KERNELS}
    tool_checks(torch, tool_errs)
    # E at a ragged split-K shape (S = 2; ragged M, Ci and N tiles)
    x, k, bias, _ = conv_inputs(torch, gen, (1, 12, 20, 40), 72, pro=False, res=False, up=False)
    tool_errs["conv3x3_gemm"].append(judge_probe(
        torch, "conv3x3_gemm", "x=(1, 12, 20, 40) co=72 S=2", conv3x3_gemm(x, k, bias),
        conv3x3_gemm_plain(x, k, bias)))
    checks_s = time.perf_counter() - t0

    runs = ((ab_conv, [str(TOOL_CHAIN)] + ["x".join(map(str, s)) for s in
                                           E_SHAPES + tuple(ab_conv.DEFAULT_SHAPES)]),
            (probe_flash_vpu, [str(TOOL_CHAIN)]), (probe_flash_2stream, [str(TOOL_CHAIN)]),
            (probe_int8_dot, [str(10 * TOOL_CHAIN)]))
    tool_launches, tool_runs = {}, []
    for mod, argv in runs:
        tool = mod.__name__.rsplit(".", 1)[1]
        log(f"tool: python -m sdtpu_torch.tools.{tool} {' '.join(argv)}")
        reset_launch_counts()
        t1 = time.perf_counter()
        calls = mod.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        counts = {key: n for key, n in launch_counts.items() if n}
        log(f"tool {tool}: {secs:.1f} s; launches {counts}, calls of each wrapper {dict(calls)}"
            + (" ok" if counts == dict(calls) else " FAIL"))
        if counts != dict(calls):
            raise AssertionError(f"{tool}: launches {counts} != its calls {dict(calls)}")
        tool_launches.update({k: n for k, n in counts.items() if k in PROBE_KERNELS})
        tool_runs.append({"tool": tool, "argv": argv, "s": secs, "launches": counts})
    if set(tool_launches) != set(PROBE_KERNELS):
        raise AssertionError(f"the tools launched {sorted(tool_launches)}, not every probe "
                             f"kernel {PROBE_KERNELS}")

    kernels = {}
    for name, rows in cases.items():
        dev = [r["device_ms"] for r in rows]
        lib = [r["library_ms"] for r in rows]
        kernels[name] = {
            "launches": tool_launches[name],
            "max_abs_err": max([r["max_abs_err"] for r in rows] + tool_errs[name]),
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": ("bytes" if sum(r["byte_ms"] for r in rows) > sum(r["op_ms"] for r in rows)
                         else "operations"),
            "library_ms": None if None in lib else sum(lib),
        }
        log(f"probe kernel {name}: {len(rows)} check calls, sums: kernel {kernels[name]['ms']:.4f} "
            f"ms, device " + ("not measured" if None in dev else f"{sum(dev):.4f} ms")
            + f", plain {kernels[name]['plain_ms']:.4f} ms, library "
            + ("none" if None in lib else f"{sum(lib):.4f} ms")
            + f", bound {kernels[name]['bound_ms']:.4f} ms")
    log(f"probes: checks and times {checks_s:.1f} s, tools "
        f"{sum(r['s'] for r in tool_runs):.1f} s")
    return {"kernels": kernels, "cases": cases, "tools": tool_runs}


def nccl_phase(torch):
    """A one-rank NCCL group on the card: ``health_check`` over it, and the
    ring over ``ProcessGroupRing`` (its all_gather on NCCL) against
    ``LocalRing(1)``, bitwise.  Several ranks would need several cards."""
    import socket

    import torch.distributed as dist

    from sdtpu_torch.parallel import LocalRing, ProcessGroupRing, health_check, ring_attention

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0, device_id=torch.device("cuda", 0))
    try:
        report = health_check()
        gen = torch.Generator(device="cuda").manual_seed(1)
        q, k, v = (torch.randn((2, 256, 8, 40), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        same = bool(torch.equal(ring_attention(q, k, v, ProcessGroupRing()),
                                ring_attention(q, k, v, LocalRing(1))))
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    log(f"nccl: health_check on a 1-rank NCCL group: {report}; ring over ProcessGroupRing "
        f"== LocalRing(1) bitwise: {same}" + (" ok" if report["ok"] and same else " FAIL"))
    if not (report["ok"] and same):
        raise AssertionError("the one-rank NCCL group is not healthy")
    return {"health_check": report, "process_group_ring_equals_local": same}


def run_image(torch, np, pipe, ids, label, launch_counts, reset_launch_counts):
    """A warm-up image, then one timed 512x512 STEPS-step image with the
    launch counts zeroed just before it and read just after."""
    reset_launch_counts()
    t0 = time.perf_counter()
    warm = pipe.generate(token_ids=ids, num_inference_steps=STEPS, seed=40, image_size=512,
                         output="float")
    warm_s = time.perf_counter() - t0
    if warm.shape != (1, 512, 512, 3) or not np.isfinite(warm).all():
        raise AssertionError(f"{label} warm-up image: shape {warm.shape}, finite "
                             f"{bool(np.isfinite(warm).all())}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    img = pipe.generate(token_ids=ids, num_inference_steps=STEPS, seed=40, image_size=512)
    sec = time.perf_counter() - t0
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated()
    log(f"{label}: image {img.shape} {img.dtype}, pixel std {float(img.std()):.3f}, "
        f"warm-up {warm_s:.3f} s, {sec:.4f} s/image, peak memory {peak / 2**30:.3f} GiB")
    log(f"{label} launches: {counts}")
    if img.shape != (1, 512, 512, 3) or img.dtype != np.uint8 or float(img.std()) == 0.0:
        raise AssertionError(f"{label} image is not a non-constant (1, 512, 512, 3) uint8 image")
    return counts, {"s_per_image": sec, "warmup_s": warm_s, "peak_bytes": peak,
                    "launches": counts}


def graphs_check(torch, np, pipe, ids, expected, launch_counts, reset_launch_counts):
    """The main path's request with every UNet forward replayed as a CUDA
    graph (captured by ``run_image``'s warm-up) against the eager loop (the
    same request inside a one-process ``tp_context``, where the graphs stay
    off): the float images bitwise equal, both with ``expected`` launches
    key by key; the seconds of each and the runner's counters."""
    from sdtpu_torch.parallel.mesh import Mesh, tp_context

    kw = dict(token_ids=ids, num_inference_steps=STEPS, seed=40, image_size=512, output="float")
    g = pipe._unet_graphs
    images, out = {}, {}
    for mode in ("eager", "graphed", "eager again"):
        replays = g.replays
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with tp_context(Mesh(1, 1)) if mode != "graphed" else contextlib.nullcontext():
            images[mode] = pipe.generate(**kw)
        sec = time.perf_counter() - t0
        counts = dict(launch_counts)
        out[mode] = {"s_per_image": sec, "replays": g.replays - replays}
        log(f"graphs: {mode} image {sec:.4f} s, {g.replays - replays} steps replayed")
        if counts != expected:
            raise AssertionError(f"graphs: the {mode} image's launches {counts} != {expected}")
    same = all(np.array_equal(images["graphed"], images[m]) for m in ("eager", "eager again"))
    log(f"graphs: the graphed float image bitwise the eager one: {same}; launches equal "
        f"(the bf16 image's); captures {g.captures}, replays {g.replays}, eager steps "
        f"{g.eager_steps}" + (" ok" if same else " FAIL"))
    if not same:
        raise AssertionError("graphs: the graphed image differs from the eager loop's")
    if (out["graphed"]["replays"], out["eager"]["replays"]) != (STEPS, 0):
        raise AssertionError(f"graphs: {out['graphed']['replays']} of {STEPS} steps replayed")
    out.update(captures=g.captures, replays=g.replays, eager_steps=g.eager_steps)
    return out


# ------------------------------------------------- measurement phases --

ULP_MAX = 4           # device normals against numpy's
BENCH_REPEATS = 3


def seeds_phase(torch, np, pipe, ids):
    """The device draws of ``utils/prng.py`` against its numpy form (bits
    and uniforms bitwise, normals within ULP_MAX), their host time per
    request, two seed-40 images bitwise equal, and the host syncs left in
    one ``output="device"`` request."""
    import warnings

    from sdtpu_torch.pipeline.pipeline import request_keys, request_noise
    from sdtpu_torch.utils import prng

    shape = (1, 64, 64, 4)
    out = {"draws": []}
    for seed in (0, 40, 2**32 - 1):
        keys = request_keys(prng.key(seed), STEPS)
        bits = prng.bits_torch(keys, shape, "cuda").cpu().numpy()
        uni = prng.uniform_torch(keys, shape, "cuda").cpu().numpy()
        nor = prng.normal_torch(keys, shape, "cuda").cpu().numpy()
        bits_ok = all(np.array_equal(bits[i], prng.random_bits(k, shape))
                      for i, k in enumerate(keys))
        uni_ok = all(np.array_equal(uni[i].view(np.uint32), prng.uniform(k, shape).view(np.uint32))
                     for i, k in enumerate(keys))
        want = np.stack([prng.normal(k, shape) for k in keys])
        ulp = int(np.abs(nor.view(np.int32).astype(np.int64)
                         - want.view(np.int32).astype(np.int64)).max())
        share = float((nor != want).mean())
        ok = bits_ok and uni_ok and ulp <= ULP_MAX
        log(f"seeds: seed {seed}, {len(keys)} draws of {shape} on the card vs numpy: bits "
            f"equal {bits_ok}, uniforms equal {uni_ok}, normals max {ulp} ulp "
            f"(tol {ULP_MAX}), {share:.4f} of them differ" + (" ok" if ok else " FAIL"))
        out["draws"].append({"seed": seed, "bits_equal": bits_ok, "uniform_equal": uni_ok,
                             "normal_max_ulp": ulp, "normal_share_differing": share})
        if not ok:
            raise AssertionError(f"seed {seed}: the card's draws disagree with numpy's")

    # host time of one request's draws (keys split on the host, 26 normals
    # of the latent shape on the card): eager torch ops, and the replayed
    # CUDA graph that generate uses (equal to the eager draw bitwise); the
    # numpy path for comparison
    graphs = prng.NormalGraphs()
    for i in range(3):
        eager = request_noise(prng.key(i), STEPS, shape, "cuda")
        replay = request_noise(prng.key(i), STEPS, shape, "cuda", graphs=graphs)
    same = bool(torch.equal(eager, replay))
    log(f"seeds: the replayed draw equals the eager draw bitwise: {same}"
        + (" ok" if same else " FAIL"))
    if not same:
        raise AssertionError("the CUDA graph's draw differs from the eager draw")

    def host_ms(draw):
        torch.cuda.synchronize()
        ms = []
        for i in range(20):
            t0 = time.perf_counter()
            draw(i)
            ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return sorted(ms)[len(ms) // 2], min(ms)

    keys_ms = host_ms(lambda i: request_keys(prng.key(i), STEPS))
    eager_ms = host_ms(lambda i: request_noise(prng.key(i), STEPS, shape, "cuda"))
    graph_ms = host_ms(lambda i: request_noise(prng.key(i), STEPS, shape, "cuda",
                                               graphs=graphs))
    keys0 = request_keys(prng.key(0), STEPS)
    dev_ms = event_ms(lambda: graphs(keys0, shape, "cuda"), 20)
    t0 = time.perf_counter()
    request_noise(prng.key(0), STEPS, shape, "cpu")
    numpy_ms = (time.perf_counter() - t0) * 1e3
    log(f"seeds: one request's draws ({STEPS + 1} x {shape}), host ms median (min) of 20: "
        f"replayed graph {graph_ms[0]:.3f} ({graph_ms[1]:.3f}), eager torch ops "
        f"{eager_ms[0]:.3f} ({eager_ms[1]:.3f}), of which the host key splits "
        f"{keys_ms[0]:.3f}; copy + replay back to back by CUDA events {dev_ms:.3f} ms; "
        f"the numpy path "
        f"{numpy_ms:.1f} ms" + (" ok" if graph_ms[0] <= 2.0 else " (above the 2 ms aim)"))
    out.update(draw_host_ms=graph_ms[0], draw_host_ms_min=graph_ms[1],
               draw_eager_host_ms=eager_ms[0], key_split_ms=keys_ms[0],
               draw_event_ms=dev_ms, draw_numpy_ms=numpy_ms)

    a = pipe.generate(token_ids=ids, num_inference_steps=STEPS, seed=40, image_size=512)
    b = pipe.generate(token_ids=ids, num_inference_steps=STEPS, seed=40, image_size=512)
    same = bool(np.array_equal(a, b))
    log(f"seeds: two generate(seed=40) images on the card bitwise equal: {same}"
        + (" ok" if same else " FAIL"))
    if not same:
        raise AssertionError("generate(seed=40) is not deterministic on the card")
    out["seed40_images_equal"] = same

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            img = pipe.generate(token_ids=ids, num_inference_steps=STEPS, seed=40,
                                image_size=512, output="device")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = Counter(f"{w.filename}:{w.lineno}" for w in caught
                    if "called a synchronizing" in str(w.message))
    same = bool(np.array_equal(img.cpu().numpy(), a))
    log(f"seeds: host syncs in one output='device' request (set_sync_debug_mode warn): "
        f"{sum(syncs.values())} {dict(syncs)}; its tensor equals the uint8 image: {same}")
    out["host_syncs_per_request"] = dict(syncs)
    if not same:
        raise AssertionError("output='device' differs from the uint8 output")
    if syncs:
        raise AssertionError(f"an output='device' request synchronised the host: {dict(syncs)}")
    return out


def bench_phase(torch, launch_counts, reset_launch_counts, kind, e2e_expected, n_self,
                n_unet_convs):
    """``sdtpu_torch.bench``'s entry in this process: default, --int8, and
    the packed route, each with its JSON line checked and its launches held
    to the images it made (the first run, then 1 + repeats pipelined)."""
    from sdtpu_torch import bench

    attn_mod = sys.modules["sdtpu_torch.ops.attention"]
    images = BENCH_REPEATS + 2
    out = {}
    for route, argv in (("default", []), ("int8", ["--int8"]), ("packed", [])):
        attn_mod._PACKED_OUT_PROJ = route == "packed"
        reset_launch_counts()
        try:
            line = bench.main(["--repeats", str(BENCH_REPEATS), *argv])
        finally:
            attn_mod._PACKED_OUT_PROJ = False
        counts = dict(launch_counts)
        problems = []
        if not line["value"] > 0:
            problems.append("value")
        if line["device"] != kind:
            problems.append("device")
        if not (line["mfu_pct"] is not None and 0 < line["mfu_pct"] <= 100):
            problems.append("mfu_pct")
        if route == "default" and counts != {k: images * v for k, v in e2e_expected.items()}:
            problems.append(f"launches {counts} != {images} x {e2e_expected}")
        if route == "int8" and counts["conv3x3_slab_int8"] != images * n_unet_convs:
            problems.append(f"conv3x3_slab_int8 {counts['conv3x3_slab_int8']} != "
                            f"{images} x {n_unet_convs}")
        if route == "packed" and counts["out_proj_packed"] != images * n_self:
            problems.append(f"out_proj_packed {counts['out_proj_packed']} != {images} x {n_self}")
        log(f"bench {route}: {json.dumps(line)}")
        log(f"bench {route} launches ({images} images): {counts}"
            + (" ok" if not problems else f" FAIL {problems}"))
        if problems:
            raise AssertionError(f"bench {route}: {problems}")
        out[route] = {"line": line, "launches": counts}
    return out


def library_phase(torch, np, pipe, ids, launch_counts, reset_launch_counts):
    """Seconds per image of the kernel route and of the library route
    (``attention_impl="xla", conv_impl="xla"``: SDPA and cuDNN convs) in
    turns on the same weights; the library route launches no kernel but the
    row passes, which every route takes."""
    from sdtpu_torch import StableDiffusionPipeline

    lib = StableDiffusionPipeline(pipe.config.replace(attention_impl="xla", conv_impl="xla"),
                                  pipe.params, device="cuda")
    kw = dict(token_ids=ids, num_inference_steps=STEPS, seed=40, image_size=512)
    reset_launch_counts()
    lib_img = lib.generate(**kw)
    kernel_img = pipe.generate(**kw)
    turns = []
    for route in ("kernels", "library", "library", "kernels"):
        if route == "library":
            reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (lib if route == "library" else pipe).generate(**kw)
        turns.append((route, time.perf_counter() - t0))
        if route == "library" and any(n for k, n in launch_counts.items()
                                      if k not in ROW_KERNELS):
            raise AssertionError(f"the library route launched kernels: {dict(launch_counts)}")
    diff = int(np.abs(lib_img.astype(int) - kernel_img.astype(int)).max())
    per = {r: sorted(t for rr, t in turns if rr == r) for r in ("kernels", "library")}
    log("library row, s/image in turns: " + ", ".join(f"{r} {t:.4f}" for r, t in turns)
        + "; the library route launched no kernel but the row passes; its image vs the "
        f"kernels' image: max {diff} uint8 levels (for information)")
    return {"turns_s": turns, "kernels_s": per["kernels"], "library_s": per["library"],
            "max_level_diff": diff}


# ---------------------------------------------- checkpoint and samplers --

# the samplers of phase 14, after the main path's ddpm as the yardstick
SAMPLER_RUNS = ("ddpm", "ddim", "euler", "euler-a", "dpm++-karras", "dpm++-sde", "unipc", "lcm")
GRID_PROMPT = "a cat flying a spaceship"  # generate_grid's default prompt
GRID_STEPS = 4                            # phase 14's grid: 1 prompt x 2 seeds
# the JSON configs of a diffusers tiny-sd directory, as diffusers and
# transformers write them (widths of the port's tiny-sd preset)
TINY_SD_JSON = {
    "unet/config.json": {
        "_class_name": "UNet2DConditionModel", "_diffusers_version": "0.27.2", "act_fn": "silu",
        "attention_head_dim": 8, "block_out_channels": [320, 640, 1280],
        "center_input_sample": False, "cross_attention_dim": 768,
        "down_block_types": ["CrossAttnDownBlock2D"] * 3, "downsample_padding": 1,
        "flip_sin_to_cos": True, "freq_shift": 0, "in_channels": 4, "layers_per_block": 1,
        "mid_block_scale_factor": 1, "mid_block_type": None, "norm_eps": 1e-05,
        "norm_num_groups": 32, "out_channels": 4, "sample_size": 64,
        "up_block_types": ["CrossAttnUpBlock2D"] * 3, "use_linear_projection": False},
    "vae/config.json": {
        "_class_name": "AutoencoderKL", "_diffusers_version": "0.27.2", "act_fn": "silu",
        "block_out_channels": [128, 256, 512, 512],
        "down_block_types": ["DownEncoderBlock2D"] * 4, "in_channels": 3,
        "latent_channels": 4, "layers_per_block": 2, "norm_num_groups": 32,
        "out_channels": 3, "sample_size": 512, "scaling_factor": 0.18215,
        "up_block_types": ["UpDecoderBlock2D"] * 4},
    "text_encoder/config.json": {
        "architectures": ["CLIPTextModel"], "hidden_act": "quick_gelu", "hidden_size": 768,
        "intermediate_size": 3072, "layer_norm_eps": 1e-05, "max_position_embeddings": 77,
        "model_type": "clip_text_model", "num_attention_heads": 12, "num_hidden_layers": 12,
        "projection_dim": 768, "torch_dtype": "float16", "vocab_size": 49408},
    "scheduler/scheduler_config.json": {
        "_class_name": "PNDMScheduler", "_diffusers_version": "0.27.2", "beta_end": 0.012,
        "beta_schedule": "scaled_linear", "beta_start": 0.00085, "clip_sample": False,
        "num_train_timesteps": 1000, "set_alpha_to_one": False, "skip_prk_steps": True,
        "steps_offset": 1, "trained_betas": None},
}


def clip_state_dict(tree, config):
    """The port's CLIP tree -> HF ``CLIPTextModel`` keys: the inverse of
    ``utils/weights.py:clip_params_from_state_dict`` (linears (I, O) ->
    (O, I), the stacked layers unstacked)."""
    sd = {"text_model.embeddings.token_embedding.weight": tree["token_embedding"]["weight"],
          "text_model.embeddings.position_embedding.weight": tree["position_embedding"],
          "text_model.final_layer_norm.weight": tree["final_norm"]["scale"],
          "text_model.final_layer_norm.bias": tree["final_norm"]["bias"]}
    lay = tree["layers"]
    for i in range(config.num_layers):
        p = f"text_model.encoder.layers.{i}"
        for hf, ours in (("layer_norm1", lay["norm1"]), ("layer_norm2", lay["norm2"])):
            sd[f"{p}.{hf}.weight"], sd[f"{p}.{hf}.bias"] = ours["scale"][i], ours["bias"][i]
        for hf, ours in (("self_attn.q_proj", lay["attn"]["q"]),
                         ("self_attn.k_proj", lay["attn"]["k"]),
                         ("self_attn.v_proj", lay["attn"]["v"]),
                         ("self_attn.out_proj", lay["attn"]["out"]),
                         ("mlp.fc1", lay["mlp"]["fc1"]), ("mlp.fc2", lay["mlp"]["fc2"])):
            sd[f"{p}.{hf}.weight"] = ours["kernel"][i].t()
            sd[f"{p}.{hf}.bias"] = ours["bias"][i]
    return sd


def write_tiny_sd_checkpoint(torch, root, clip_tree, config):
    """A full-width tiny-sd directory in diffusers' fp16 layout: the UNet and
    VAE of ``tests/torch_ref.py``'s mirror (built on the meta device,
    then every parameter drawn by ``randomize_`` from seeds 1 and 2), the
    CLIP keys from the port's seeded CLIP tree, and the JSON configs.
    Returns the bytes written."""
    from sdtpu_torch.tools.validate_checkpoint import torch_ref
    from sdtpu_torch.utils.weights import save_safetensors

    ref = torch_ref()
    parts = {}
    for sub, cls, seed in (("unet", ref.RefUNet, 1), ("vae", ref.RefAutoencoderKL, 2)):
        with torch.device("meta"):
            model = cls(getattr(config, sub))
        model = model.to_empty(device="cpu")
        ref.randomize_(model, seed=seed)
        parts[sub] = ("diffusion_pytorch_model.fp16.safetensors", model.state_dict())
    parts["text_encoder"] = ("model.fp16.safetensors", clip_state_dict(clip_tree, config.clip))
    total = 0
    for sub, (fname, sd) in parts.items():
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        path = os.path.join(root, sub, fname)
        save_safetensors({k: v.to(torch.float16) for k, v in sd.items()}, path,
                         metadata={"format": "pt"})
        total += os.path.getsize(path)
    for rel, cfg in TINY_SD_JSON.items():
        os.makedirs(os.path.join(root, os.path.dirname(rel)), exist_ok=True)
        with open(os.path.join(root, rel), "w") as f:
            json.dump(cfg, f, indent=2)
    return total


def checkpoint_phase(torch, np, gen, exp_rate, ids, clip_tree, launch_counts,
                     reset_launch_counts, e2e_expected, kind):
    """Phase 14: a full-width tiny-sd checkpoint written, loaded with
    ``from_pretrained`` and held to the diffusers mirror; the VAE encoder's
    kernels; an image per sampler; the bench with ``--sampler``."""
    import shutil
    import tempfile

    from sdtpu_torch import StableDiffusionPipeline, bench
    from sdtpu_torch.config import get_preset
    from sdtpu_torch.kernels._build import BUILD_DIR
    from sdtpu_torch.models.vae import vae_encoder
    from sdtpu_torch.tools import convert_checkpoint, generate_grid
    from sdtpu_torch.tools import validate_checkpoint as vc
    from sdtpu_torch.utils import native_safetensors
    from sdtpu_torch.utils.weights import load_converted
    from sdtpu_torch.utils.image import to_uint8

    out = {}
    preset = get_preset("tiny-sd")
    os.makedirs(BUILD_DIR, exist_ok=True)
    root = os.path.join(tempfile.mkdtemp(prefix="ckpt-", dir=BUILD_DIR), "tiny-sd-seeded")
    try:
        t0 = time.perf_counter()
        nbytes = write_tiny_sd_checkpoint(torch, root, clip_tree, preset)
        write_s = time.perf_counter() - t0
        log(f"checkpoint: wrote {root} ({nbytes / 2**30:.3f} GiB of fp16 safetensors, "
            f"diffusers layout) in {write_s:.1f} s")

        # from_pretrained: the config from the directory's own JSON (its
        # name is no preset), the weights by the native reader (built first,
        # with g++, so that the load's time holds no build), bf16
        t0 = time.perf_counter()
        native_safetensors.build()
        log(f"checkpoint: the native reader's library ready in {time.perf_counter() - t0:.1f} s "
            f"({native_safetensors.library_path()})")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        pipe = StableDiffusionPipeline.from_pretrained(root, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base_mem
        cfg = pipe.config
        same = (cfg.unet, cfg.vae, cfg.clip) == (preset.unet, preset.vae, preset.clip)
        log(f"checkpoint: from_pretrained(device='cuda') {load_s:.3f} s on the host, "
            f"{nbytes} bytes read, peak device memory {peak / 2**30:.3f} GiB; config "
            f"{cfg.name!r} from its JSON: architecture == tiny-sd preset: {same}; scheduler "
            f"{cfg.scheduler}" + (" ok" if same else " FAIL"))
        if not same:
            raise AssertionError("the checkpoint's JSON configs did not give tiny-sd")
        out.update(write_s=write_s, bytes=nbytes, from_pretrained_s=load_s, peak_bytes=peak)

        # the converted-tree cache: the directory converted by the tool (on
        # the card, bf16), loaded back onto the card and held bitwise to
        # from_pretrained's tree; the cache goes with the directory
        cache = os.path.join(os.path.dirname(root), "tiny-sd.cache.safetensors")
        t0 = time.perf_counter()
        conv = convert_checkpoint.main([root, "--preset", "tiny-sd", "--out", cache,
                                        "--dtype", "bf16"])
        convert_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cached = load_converted(cache, device="cuda")
        torch.cuda.synchronize()
        cache_load_s = time.perf_counter() - t0
        same = trees_bitwise(torch, cached, pipe.params)
        log(f"checkpoint: convert_checkpoint {convert_s:.3f} s, cache {conv['bytes']} bytes; "
            f"load_converted(device='cuda') {cache_load_s:.3f} s against from_pretrained's "
            f"{load_s:.3f} s; every leaf bitwise from_pretrained's: {same}"
            + (" ok" if same else " FAIL"))
        if not same:
            raise AssertionError("the converted cache differs from from_pretrained's tree")
        out["cache"] = {"bytes": conv["bytes"], "convert_s": convert_s,
                        "load_converted_s": cache_load_s}
        del cached

        # validate_checkpoint on the card: the kernel route (bf16) and the
        # plain route (bf16) against the mirror in float32
        t0 = time.perf_counter()
        mirror = vc.load_mirror(root, cfg, device="cuda")
        inputs = vc.make_inputs(cfg, latent=64, batch=2, image=512)
        want = vc.run_mirror(mirror, cfg, inputs, device="cuda")
        del mirror
        got = vc.run_port(pipe.params, cfg, inputs, dtype=torch.bfloat16, device="cuda")
        with routed(**plain_routes()):
            got_plain = vc.run_port(pipe.params, cfg, inputs, dtype=torch.bfloat16,
                                    device="cuda")
        e_k, e_p = vc.errors(got, want), vc.errors(got_plain, want)
        val = {}
        for name in vc.NETWORKS:
            finite = bool(torch.isfinite(got[name]).all())
            d_k, d_p = e_k[name]["rel_l2"], e_p[name]["rel_l2"]
            ok = finite and d_k <= max(2.0 * d_p, 1e-2)
            psnr = (f", PSNR kernels {e_k[name]['psnr_db']:.2f} dB, plain "
                    f"{e_p[name]['psnr_db']:.2f} dB" if "psnr_db" in e_k[name] else "")
            log(f"validate_checkpoint {name}: rel L2 kernels (bf16) vs mirror (f32) {d_k:.4g}, "
                f"max abs {e_k[name]['max_abs']:.4g}; plain bf16 vs mirror f32 {d_p:.4g}{psnr}; "
                f"finite {finite}; tol max(2x plain bf16-vs-f32, 1e-2)"
                + (" ok" if ok else " FAIL"))
            val[name] = {"kernels": e_k[name], "plain": e_p[name]}
            if not ok:
                raise AssertionError(f"validate_checkpoint {name}: the kernel route is off "
                                     "the mirror")
        out["validate"] = val
        out["validate_s"] = time.perf_counter() - t0

        # the encoder's kernels: one 512x512 encode with the counts zeroed
        # just before and read just after, against the counts derived from
        # its recorded calls and the plans, and against its plain version
        img = torch.from_numpy(inputs["img"]).cuda().to(torch.bfloat16)
        enc = pipe.params["vae_encoder"]
        with torch.inference_mode():
            calls = record_calls(torch, lambda: vae_encoder(img, enc, cfg.vae))
            slab = calls["conv3x3_slab"]
            expected = expected_launches(calls, launch_counts)
            torch.cuda.synchronize()
            reset_launch_counts()
            moments = vae_encoder(img, enc, cfg.vae)
            counts = dict(launch_counts)
            torch.cuda.synchronize()
        log(f"encoder 512x512 launches: {counts}; expected from its recorded calls and the "
            f"plans: {expected}" + (" ok" if counts == expected else " FAIL"))
        if counts != expected or counts["conv3x3_slab"] == 0 or counts["flash_attention"] == 0:
            raise AssertionError("the VAE encoder's launch counts are off")
        d_kp = rel_l2(torch, moments, got_plain["vae_encode"])
        d_pf = e_p["vae_encode"]["rel_l2"]
        ok = bool(torch.isfinite(moments.float()).all()) and d_kp <= max(2.0 * d_pf, 1e-2)
        log(f"encoder kernels vs plain (bf16): rel L2 {d_kp:.4g}; plain bf16 vs mirror f32 "
            f"{d_pf:.4g}; tol max(2x, 1e-2)" + (" ok" if ok else " FAIL"))
        if not ok:
            raise AssertionError("the VAE encoder's kernels disagree with their plain versions")
        # the encoder's kernel time per encode: each recorded call shape by
        # CUDA events and by the profiler's device time, beside its bound
        enc_ms = {"conv3x3_slab": [0.0, 0.0, 0.0], "flash_attention": [0.0, 0.0, 0.0]}
        configs = []

        def add_enc(name, n, t_k, d_k, cost):
            tot = enc_ms[name]
            tot[0] += n * t_k
            tot[1] = None if d_k is None or tot[1] is None else tot[1] + n * d_k
            tot[2] += n * bound_ms(cost, PEAK_BF16_FLOPS, exp_rate)[0]

        for cfg6, n in sorted(slab.items()):
            x_shape, co, pro, res, up, stats, _ = cfg6
            x, k, bias, kw = conv_inputs(torch, gen, x_shape, co, pro=pro, res=res, up=up)
            run = functools.partial(sys.modules["sdtpu_torch.kernels.conv2d"].conv3x3_slab,
                                    x, k, bias, emit_stats=stats, **kw)
            t_k, d_k = event_ms(run, 10), device_ms(run, 5)
            configs.append({"x": list(x_shape), "co": co, "pro": pro, "res": res,
                            "stats": stats, "per_encode": n, "ms": t_k, "device_ms": d_k})
            add_enc("conv3x3_slab", n, t_k, d_k,
                    conv_cost(x_shape, co, pro=pro, res=res, up=up, stats=stats))
            del x, k, kw
        for (q_shape, lk), n in sorted(calls["flash_attention_packed"].items()):
            from sdtpu_torch.kernels.flash_attention import flash_attention_packed

            q, k, v = flash_qkv(torch, gen, q_shape, lk)
            run = functools.partial(flash_attention_packed, q, k, v)
            t_k, d_k = event_ms(run, 10), device_ms(run, 5)
            configs.append({"q": list(q_shape), "lk": lk, "per_encode": n, "ms": t_k,
                            "device_ms": d_k})
            add_enc("flash_attention", n, t_k, d_k, flash_cost(q_shape, lk))
        log("encoder kernel time per 512x512 encode (CUDA events; profiler device time; "
            "bound): " + ", ".join(
                f"{k} {v[0]:.3f} ms; " + ("dev not measured" if v[1] is None
                                          else f"dev {v[1]:.3f} ms") + f"; bound {v[2]:.3f} ms"
                for k, v in enc_ms.items()))
        out["encoder"] = {"launches": counts, "kernels_vs_plain": d_kp, "configs": configs,
                          "ms_per_encode": enc_ms}

        # one 512x512, STEPS-step, CFG 7.5 image per sampler: a float run
        # (finite), then a uint8 run timed with the counts zeroed just before
        # it, which must equal the first bitwise
        kw = dict(token_ids=ids, num_inference_steps=STEPS, seed=40, image_size=512,
                  cfg_scale=7.5)
        runs = {}
        for name in SAMPLER_RUNS:
            first = pipe.generate(sampler=name, output="float", **kw)
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            img = pipe.generate(sampler=name, **kw)
            sec = time.perf_counter() - t0
            counts = dict(launch_counts)
            finite = bool(np.isfinite(first).all())
            same = bool(np.array_equal(to_uint8(first), img))
            problems = [p for p, bad in (("not finite", not finite),
                                         ("not bitwise equal", not same),
                                         ("constant", float(img.std()) == 0.0),
                                         (f"launches {counts}", counts != e2e_expected)) if bad]
            log(f"sampler {name}: {sec:.4f} s/image, pixel std {float(img.std()):.3f}, finite "
                f"{finite}, two runs bitwise equal {same}, launches == the bf16 image's "
                f"{counts == e2e_expected}" + (" ok" if not problems else f" FAIL {problems}"))
            if problems:
                raise AssertionError(f"sampler {name}: {problems}")
            runs[name] = {"s_per_image": sec, "launches": counts}
        out["samplers"] = runs

        # tools/generate_grid on the directory: 1 prompt x 2 seeds, GRID_STEPS
        # dpm++ steps at 512x512; each tile bitwise its seed's row of the
        # same generate_batch on the pipeline the tool loads (the preset's
        # config over the directory's weights)
        t0 = time.perf_counter()
        grid_png = os.path.join(os.path.dirname(root), "grid.png")
        argv = ["--model-dir", root, "--preset", "tiny-sd", "--prompts", GRID_PROMPT,
                "--seeds", "0", "1", "--steps", str(GRID_STEPS), "--image-size", "512",
                "--out", grid_png]
        log(f"tool: python -m sdtpu_torch.tools.generate_grid {' '.join(argv)}")
        grid = generate_grid.main(argv)
        grid_s = time.perf_counter() - t0
        gpipe = StableDiffusionPipeline.from_pretrained(root, preset="tiny-sd", device="cuda")
        ids_g = None
        if gpipe.tokenizer is None:
            ids_g = generate_grid.prompt_ids(GRID_PROMPT, gpipe.config.clip.vocab_size,
                                             gpipe.config.clip.max_length, 2)
        rows = gpipe.generate_batch([GRID_PROMPT] * 2, seeds=[0, 1],
                                    num_inference_steps=GRID_STEPS, image_size=512,
                                    sampler="dpm++", cfg_scale=7.5, token_ids=ids_g)
        same = [bool(np.array_equal(grid[:, 512 * j:512 * (j + 1)], rows[j])) for j in range(2)]
        ok = grid.shape == (512, 1024, 3) and all(same) and float(grid.std()) > 0.0
        log(f"generate_grid: {grid_s:.1f} s (the directory loaded, two 512x512 "
            f"{GRID_STEPS}-step rows), grid {grid.shape}, tokenizer "
            f"{gpipe.tokenizer is not None}; each tile bitwise its generate_batch row: {same}"
            + (" ok" if ok else " FAIL"))
        if not ok:
            raise AssertionError("generate_grid's tiles are not the generate_batch rows")
        out["grid"] = {"s": grid_s, "shape": list(grid.shape), "tiles_bitwise": same}
        del pipe, gpipe
    finally:
        shutil.rmtree(os.path.dirname(root), ignore_errors=True)

    # the bench with a sampler: its line, and its launches held to its images
    images = BENCH_REPEATS + 2
    reset_launch_counts()
    line = bench.main(["--sampler", "dpm++-karras", "--repeats", str(BENCH_REPEATS)])
    counts = dict(launch_counts)
    ok = (line["value"] > 0 and line["device"] == kind and "dpm++-karras" in line["metric"]
          and counts == {k: images * v for k, v in e2e_expected.items()})
    log(f"bench --sampler dpm++-karras: {json.dumps(line)}; launches ({images} images) "
        f"{counts}" + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError("bench --sampler dpm++-karras")
    out["bench"] = {"line": line, "launches": counts}
    return out


# ------------------------------------------- conditioned requests, serving --

STRENGTH = 0.75            # phase 15's img2img strength (the bench's default)
INV_LEVEL, INV_FRAC = 1, 0.03  # the batch-invariance envelope (tools/check_batch_invariance.py)
# tiny-sd's launches of A, B and C: one UNet step (CFG batch), one VAE
# decode, one 512x512 VAE encode (E2E_COUNTS = 25 steps + one decode)
UNET_STEP = {"conv3x3_slab": 18, "conv3x3_slab_upsample": 2, "flash_attention": 9}
VAE_DECODE = {"conv3x3_slab": 28, "conv3x3_slab_upsample": 3, "flash_attention": 1}
VAE_ENCODE = {"conv3x3_slab": 20, "conv3x3_slab_upsample": 0, "flash_attention": 1}


def byte_tokenizer():
    """A CLIP tokenizer over the 256 byte symbols and their word-final
    forms, with no merges (its ids lie below tiny-sd's vocabulary size):
    the serving requests' negative prompts need a tokenizer, and no CLIP
    vocabulary ships in the repository."""
    from sdtpu_torch.tokenizer.bpe import BOS_TOKEN, EOS_TOKEN, CLIPTokenizer, bytes_to_unicode

    symbols = list(bytes_to_unicode().values())
    vocab = {t: i for i, t in enumerate(symbols + [c + "</w>" for c in symbols]
                                        + [BOS_TOKEN, EOS_TOKEN])}
    return CLIPTokenizer(vocab, [])


def counted(torch, run, launch_counts, reset_launch_counts, calls=None):
    """``run()`` once through the recording shims (unless its ``calls`` are
    given), then once more with the launch counts zeroed just before it and
    read just after: (its result, seconds, counts, the counts expected from
    the calls, the calls, peak bytes above what was allocated before it)."""
    if calls is None:
        calls = record_calls(torch, run)
    expected = expected_launches(calls, launch_counts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = dict(launch_counts)
    return out, sec, counts, expected, calls, torch.cuda.max_memory_allocated() - base


def hold_counts(label, counts, expected, predicted=None):
    """Fail unless the run's launches equal those of its recorded calls and,
    where given, the predicted A/B/C counts."""
    main = {k: counts[k] for k in ("conv3x3_slab", "conv3x3_slab_upsample", "flash_attention")}
    ok = counts == expected and (predicted is None or main == predicted)
    log(f"{label} launches: {counts}; expected from its recorded calls and the plans: "
        f"{expected}" + ("" if predicted is None else f"; A/B/C predicted {predicted}")
        + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError(f"{label}: the launch counts are off")


def judge_rel(torch, label, k_out, p_out, f_out):
    """kernels vs plain (bf16) <= max(2 x the plain route's bf16-vs-f32, 1e-2)."""
    finite = bool(torch.isfinite(k_out).all())
    d_kp, d_pf = rel_l2(torch, k_out, p_out), rel_l2(torch, p_out, f_out)
    ok = finite and d_kp <= max(2.0 * d_pf, 1e-2)
    log(f"{label}: rel L2 kernels-vs-plain (bf16) {d_kp:.4g}; plain bf16-vs-f32 {d_pf:.4g}; "
        f"finite {finite}; tol max(2x bf16-vs-f32, 1e-2)" + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError(f"{label}: the kernels disagree with the plain route")
    return {"kernels_vs_plain": d_kp, "plain_bf16_vs_f32": d_pf}


def conditioned_phase(torch, np, gen, pipe, ids, sd15_host, launch_counts, reset_launch_counts,
                      kind, e2e_expected):
    """Phase 15: tiny-sd img2img and latent-blend inpainting (kernels vs
    plain on the final latents, exact launches), ``generate_batch`` at B =
    4 with the ported invariance gate, a ``ServingEngine`` answering 8
    requests, the SD-1.5 widths of ``sd15-inpaint`` and ``ip2p``, and the
    bench's image-conditioned, batch and serving lines."""
    from sdtpu_torch import StableDiffusionPipeline, bench
    from sdtpu_torch.models.unet import unet_forward
    from sdtpu_torch.pipeline.serving import ServingEngine
    from sdtpu_torch.samplers import get_sampler
    from sdtpu_torch.tools import check_batch_invariance

    out = {}
    t_phase = time.perf_counter()
    pcfg = pipe.config
    rng = np.random.default_rng(15)
    init = rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)
    mask = np.zeros((512, 512), np.uint8)
    mask[:, 256:] = 255
    s_eff = get_sampler("ddpm").make_schedule(pcfg.scheduler, STEPS, STRENGTH).num_steps
    if {k: STEPS * v + VAE_DECODE[k] for k, v in UNET_STEP.items()} != {
            k: E2E_COUNTS[k] for k in UNET_STEP}:
        raise AssertionError("UNET_STEP and VAE_DECODE do not add up to the bf16 image's counts")
    predicted = {k: s_eff * v + VAE_DECODE[k] + VAE_ENCODE[k] for k, v in UNET_STEP.items()}

    # (a) img2img and latent-blend inpainting
    pipe32 = StableDiffusionPipeline(
        pcfg.replace(compute_dtype=torch.float32, param_dtype=torch.float32),
        to_dtype(pipe.params, torch.float32), device="cuda")
    base = dict(token_ids=ids, num_inference_steps=STEPS, seed=40, image_size=512,
                cfg_scale=7.5, strength=STRENGTH, init_image=init)
    for label, extra in (("img2img", {}), ("inpaint", {"mask_image": mask})):
        kw = dict(base, **extra)
        img, sec, counts, expected, _, _ = counted(torch, lambda: pipe.generate(**kw),
                                                   launch_counts, reset_launch_counts)
        log(f"{label} (tiny-sd 512x512, {STEPS} DDPM steps at strength {STRENGTH} = {s_eff} "
            f"steps, CFG 7.5): image {img.shape} {img.dtype}, pixel std {float(img.std()):.3f}, "
            f"{sec:.4f} s/image")
        if img.shape != (1, 512, 512, 3) or img.dtype != np.uint8 or float(img.std()) == 0.0:
            raise AssertionError(f"{label}: not a non-constant (1, 512, 512, 3) uint8 image")
        hold_counts(label, counts, expected, predicted)
        with torch.inference_mode():
            k_lat = torch.from_numpy(pipe.generate(output="latents", **kw))
            with routed(**plain_routes()):
                p_lat = torch.from_numpy(pipe.generate(output="latents", **kw))
                f_lat = torch.from_numpy(pipe32.generate(output="latents", **kw))
        out[label] = {"s_per_image": sec, "launches": counts,
                      **judge_rel(torch, f"{label} final latents", k_lat, p_lat, f_lat)}
    del pipe32
    torch.cuda.empty_cache()

    # (b) generate_batch at B = 4: one request of 4 rows, per-request seeds
    bids = np.random.default_rng(4).integers(1, 49408, (4, 77))
    bkw = dict(token_ids=bids, num_inference_steps=STEPS, seeds=[10, 11, 12, 13],
               image_size=512)
    imgs, sec, counts, expected, _, peak = counted(
        torch, lambda: pipe.generate_batch(["x"] * 4, **bkw), launch_counts, reset_launch_counts)
    log(f"generate_batch B=4 (512x512, {STEPS} steps, CFG, UNet batch 8): {imgs.shape}, "
        f"{sec:.4f} s for 4 images ({4 / sec:.4f} images/s), peak memory above what was "
        f"allocated before it {peak / 2**30:.3f} GiB")
    if imgs.shape != (4, 512, 512, 3) or min(float(i.std()) for i in imgs) == 0.0:
        raise AssertionError("generate_batch: not four non-constant images")
    hold_counts("generate_batch B=4", counts, expected,
                {k: e2e_expected[k] for k in UNET_STEP})
    out["batch4"] = {"s_per_batch": sec, "images_per_s": 4 / sec, "peak_bytes": peak,
                     "launches": counts}
    # the gate's own weights (0.04 x normals, the JAX tool's): on them the
    # envelope was set, while the seed-0 tree's image moves by several
    # levels for any rounding change (see (c))
    t0 = time.perf_counter()
    inv_pipe = check_batch_invariance.gate_pipeline("tiny-sd", "cuda")
    log(f"check_batch_invariance weights in {time.perf_counter() - t0:.1f} s")
    inv = check_batch_invariance.run_gate(inv_pipe, check_batch_invariance.parse_args([]))
    if not inv["pass"]:
        raise AssertionError(f"check_batch_invariance: {inv['rows']}")
    out["batch_invariance"] = inv

    # (c) a ServingEngine answering 8 requests on the gate's weights: a
    # txt2img bucket with two negative prompts and an img2img bucket, at
    # most 4 rows a batch; each image held to its solo generate_batch row
    # within the gate's envelope at its own settings (4 Euler steps); then
    # the same requests at STEPS DDPM steps, and request 0 at 4 Euler steps
    # on the seed-0 tree, their gaps measured beside a yardstick: the solo
    # image through the kernels against the plain versions
    tok = byte_tokenizer()
    sids = np.random.default_rng(8).integers(1, 49408, (8, 77))
    out["serving"] = {}
    for label, serve_pipe, sampler, steps, n_req in (
            ("gate weights, 4-step euler", inv_pipe, "euler", 4, 8),
            (f"gate weights, {STEPS}-step ddpm", inv_pipe, "ddpm", STEPS, 8),
            ("seed-0 tree, 4-step euler", pipe, "euler", 4, 4)):
        gated = serve_pipe is inv_pipe and steps == 4
        serve_pipe.tokenizer = tok
        reqs = []
        for i in range(n_req):
            r = dict(token_ids=sids[i], seed=100 + i, num_inference_steps=steps,
                     sampler=sampler, image_size=512,
                     negative_prompt=("" if i % 2 else "blurry, low quality"))
            if i in (1, 4, 6):
                r.update(init_image=init[::-1] if i == 4 else init, strength=STRENGTH)
            reqs.append(r)
        engine = ServingEngine(serve_pipe, max_batch_size=4, max_wait_ms=20.0)
        try:
            t0 = time.perf_counter()
            futs = [engine.submit("x", **r) for r in reqs]
            served = [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t0
            stats = engine.stats()
        finally:
            engine.shutdown()
        log(f"serving ({label}): {n_req} requests in {wall:.3f} s; stats {stats}")
        if stats["requests"] != n_req or stats["failures"] or stats["batches"] < 2:
            raise AssertionError(f"serving ({label}): stats {stats}")
        gaps = []
        for i, r in enumerate(reqs):
            kw = dict(token_ids=r["token_ids"][None], seeds=[r["seed"]], sampler=sampler,
                      negative_prompt=[r["negative_prompt"]], num_inference_steps=steps,
                      image_size=512)
            if "init_image" in r:
                kw.update(init_images=[r["init_image"]], strength=r["strength"])
            solo = serve_pipe.generate_batch(["x"], **kw)[0]
            gap = check_batch_invariance.row_gap(served[i], solo)
            level, frac = gap["max_level_diff"], gap["mismatched_frac"]
            gaps.append({"request": i, "max_level_diff": level, "mismatched_frac": frac})
            ok = served[i].shape == (512, 512, 3) and (
                not gated or (level <= INV_LEVEL and frac <= INV_FRAC))
            log(f"serving ({label}) request {i} ({'img2img' if 'init_image' in r else 'txt2img'}"
                f", negative {r['negative_prompt']!r}): against its solo image max {level} "
                f"level(s), {frac:.4%} of values differ"
                + (f" (envelope {INV_LEVEL}, {INV_FRAC:.0%})" if gated else " (measured)")
                + (" ok" if ok else " FAIL"))
            if not ok:
                raise AssertionError(f"serving ({label}) request {i} is off its solo image")
            if i == 0:
                with routed(**plain_routes()):
                    plain = serve_pipe.generate_batch(["x"], **kw)[0]
                y_gap = check_batch_invariance.row_gap(plain, solo)
                y_level, y_frac = y_gap["max_level_diff"], y_gap["mismatched_frac"]
                log(f"serving ({label}) request 0 yardstick: its solo image through the "
                    f"kernels vs through the plain versions: max {y_level} level(s), "
                    f"{y_frac:.4%} of values differ")
                gaps[-1].update(yardstick_max_level=y_level, yardstick_frac=y_frac)
        serve_pipe.tokenizer = None
        out["serving"][label] = {"wall_s": wall, "stats": stats, "gaps": gaps}
    del inv_pipe
    torch.cuda.empty_cache()

    # (d) the SD-1.5 widths: sd15-inpaint (9-channel UNet, its mid block)
    # and ip2p (8 channels, three guidance branches), one 512x512 request
    # each on seeded random weights (sd15-inpaint's from_random tree; ip2p
    # takes its conv_in's first 8 channels)
    sd_ids = np.random.default_rng(40).integers(1, 49408, (2, 77))
    for preset, extra, rows in (("sd15-inpaint", {"mask_image": mask, "strength": 1.0}, 2),
                                ("ip2p", {"image_guidance_scale": 1.5}, 3)):
        t0 = time.perf_counter()
        sd = sd15_pipeline(torch, sd15_host, preset)
        torch.cuda.synchronize()
        fr_s = time.perf_counter() - t0
        kw = dict(token_ids=sd_ids, num_inference_steps=STEPS, seed=40, image_size=512,
                  init_image=init, **extra)
        img, sec, counts, expected, calls, peak = counted(torch, lambda: sd.generate(**kw),
                                                          launch_counts, reset_launch_counts)
        log(f"{preset}: the tree to the card {fr_s:.3f} s; 512x512, {STEPS} DDPM "
            f"steps, CFG 7.5, UNet batch {rows}: image {img.shape}, pixel std "
            f"{float(img.std()):.3f}, {sec:.4f} s/image, peak memory above the resident "
            f"trees {peak / 2**30:.3f} GiB")
        if img.shape != (1, 512, 512, 3) or float(img.std()) == 0.0:
            raise AssertionError(f"{preset}: not a non-constant (1, 512, 512, 3) image")
        hold_counts(preset, counts, expected)
        attn = sorted({(q, lk) for (q, lk) in calls["flash_attention_packed"]})
        log(f"{preset} attention call shapes (q, Lk): {attn}")
        # kernels vs plain on one UNet forward at the request's inputs
        ucfg = sd.config.unet
        lat = torch.randn((rows, 64, 64, ucfg.in_channels), generator=gen, device="cuda")
        ctx = torch.randn((rows, 77, ucfg.cross_attention_dim), generator=gen, device="cuda")
        ts = torch.full((rows,), 501.0, device="cuda")
        u32 = to_dtype(sd.params["unet"], torch.float32)
        with torch.inference_mode():
            k_out = unet_forward(lat.bfloat16(), ts, ctx.bfloat16(), sd.params["unet"],
                                 ucfg).float()
            with routed(**plain_routes()):
                p_out = unet_forward(lat.bfloat16(), ts, ctx.bfloat16(), sd.params["unet"],
                                     ucfg).float()
                f_out = unet_forward(lat, ts, ctx, u32, ucfg).float()
        del u32
        out[preset] = {"to_card_s": fr_s, "s_per_image": sec, "peak_bytes": peak,
                       "launches": counts, "attention_shapes": [list(a) for a in attn],
                       **judge_rel(torch, f"{preset} unet_forward b{rows}", k_out, p_out, f_out)}
        del sd, k_out, p_out, f_out
        torch.cuda.empty_cache()

    # (e) the bench's lines: --img2img, --batch 4, --serving, each with its
    # launches held to the requests it made (the first run, then 1 + repeats
    # pipelined; the serving line's warmup, then its 16 requests, which the
    # engine may coalesce into any batches: A, B and C launch once a call
    # whatever the batch, the plans' pre-passes and reductions do not)
    images = BENCH_REPEATS + 2
    i2i_counts = out["img2img"]["launches"]
    b4_counts = out["batch4"]["launches"]
    for label, argv, want, keys in (
            ("--img2img", ["--img2img"], {k: images * v for k, v in i2i_counts.items()},
             i2i_counts),
            ("--batch 4", ["--batch", "4"], {k: images * v for k, v in b4_counts.items()},
             b4_counts),
            ("--serving", ["--serving", "--requests", "16", "--batch", "4"], None,
             [k for k in b4_counts if k in UNET_STEP or b4_counts[k] == 0])):
        reset_launch_counts()
        line = bench.main(["--repeats", str(BENCH_REPEATS), *argv])
        counts = dict(launch_counts)
        if want is None:  # the warmup's request, then one per batch the engine ran
            want = {k: (1 + line["batches"]) * v for k, v in b4_counts.items()}
        ok = (line["value"] > 0 and line["device"] == kind
              and all(counts[k] == want[k] for k in keys))
        log(f"bench {label}: {json.dumps(line)}; launches {counts}" + (" ok" if ok else
                                                                        f" FAIL (want {want})"))
        if not ok:
            raise AssertionError(f"bench {label}")
        out[f"bench {label}"] = {"line": line, "launches": counts}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 15: {out['phase_s']:.1f} s")
    return out


# ------------------------------------------------------- the SDXL family --

SDXL_STEPS = 25            # the sdxl preset's default: DDPM, CFG 7.5, 1024x1024
# the traced sdxl image's and the sdxl bench line's steps: cut from 25 so
# that phase 17 fits the script's time (the 25-step image above keeps its
# launches, kernel shapes and seconds)
SDXL_SHORT_STEPS = 10
SPLIT = 0.8                # the base -> refiner handoff (diffusers' default)
# A/B/C per UNet step, read from the configs (the recorded
# calls decide): sdxl 17 resnets, 2 upsamplers, 70 transformer blocks;
# the refiner 22, 3, 44; SD-1.5 (lcm-sd15) 22, 3, 16
PREDICTED_STEP = {"sdxl": {"conv3x3_slab": 34, "conv3x3_slab_upsample": 2,
                           "flash_attention": 70},
                  "sdxl-refiner": {"conv3x3_slab": 44, "conv3x3_slab_upsample": 3,
                                   "flash_attention": 44},
                  "lcm-sd15": {"conv3x3_slab": 44, "conv3x3_slab_upsample": 3,
                               "flash_attention": 16}}


def request_calls(torch, pipe, kw, n_steps, decode=True, batch=None):
    """A request's kernel call configurations (:func:`record_calls`): a
    1-step and a 2-step request that return their latents (with ``batch``
    ``generate_batch`` of that many rows, which decodes as the JAX
    package's does, less one decode's calls), the first's calls plus
    ``n_steps - 1`` times a UNet step's (the second's less the first's: the
    text encoders run once a request), plus one VAE decode's where
    ``decode``."""
    base = {k: v for k, v in kw.items() if k not in ("latents", "denoising_start",
                                                    "denoising_end", "output")}
    f = pipe.config.vae.downscale_factor
    lat_hw = kw.get("image_size", pipe.config.default_image_size) // f
    z = torch.zeros((batch or 1, lat_hw, lat_hw, pipe.config.vae.latent_channels),
                    device="cuda")
    dec = record_calls(torch, lambda: pipe._finish(z, "uint8"))

    def recorded(n):
        one = dict(base, num_inference_steps=n)
        if batch is None:
            return record_calls(torch, lambda: pipe.generate(output="latents", **one))
        got = record_calls(torch, lambda: pipe.generate_batch(["x"] * batch, **one))
        return {key: cs - dec[key] for key, cs in got.items()}

    first, second = recorded(1), recorded(2)
    calls = {key: Counter({c: first[key][c] + (n_steps - 1) * (n - first[key][c])
                           for c, n in cs.items()}) for key, cs in second.items()}
    if decode:
        for key, cs in dec.items():
            calls[key].update(cs)
    return calls


def held_run(torch, label, run, calls, launch_counts, reset_launch_counts, predicted=None):
    """:func:`counted` on a request's ``calls``, its launches held to them;
    the predicted A/B/C counts are printed beside them.  Returns (its
    result, seconds, counts, peak bytes above what was allocated before
    it)."""
    out, sec, counts, expected, _, peak = counted(torch, run, launch_counts,
                                                  reset_launch_counts, calls)
    hold_counts(label, counts, expected)
    if predicted is not None:
        main = {k: counts[k] for k in predicted}
        log(f"{label} A/B/C {main}; predicted from the configs {predicted}: "
            + ("agree" if main == predicted else "DIFFER (the recorded calls decide)"))
    return out, sec, counts, peak


def card_normal_tree(torch, like, seed, scale=0.04, norms=False):
    """The batch-invariance gate's weights (``tools/check_batch_invariance``:
    ``scale`` x standard normals, rounded to each leaf's dtype) for the tree
    of ``like``, drawn on the card by a seeded torch generator: the JAX
    tool's numpy draws of SDXL's 3.5 G values cost tens of seconds of host
    time.  ``norms``: the int8 gate's rule (``tools/check_int8.py``), a 1-D
    ``scale`` leaf ones and a 1-D ``bias`` leaf zeros."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(t, name=None):
        if isinstance(t, dict):
            return {k: draw(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [draw(v) for v in t]
        if norms and t.ndim == 1 and name in ("scale", "bias"):
            return (torch.ones if name == "scale" else torch.zeros)(
                t.shape, dtype=t.dtype, device="cuda")
        return (torch.randn(t.shape, generator=gen, device="cuda") * scale).to(t.dtype)

    return draw(like)


def kineto_events(torch, prof):
    """A profiler run's activities as the Chrome-trace records that
    ``summarize_trace.trace_split`` reads (``ph``, ``cat``, ``name``, ``ts``
    and ``dur`` in us), taken straight from kineto's results: building the
    profiler's event tree, or exporting and reading its trace file, costs
    seconds a step at an SDXL step's ~8.5k device activities."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            cat = "gpu_user_annotation" if e.is_user_annotation() else "kernel"
        else:
            cat = "user_annotation" if e.is_user_annotation() or e.name() in STAGES else "cpu_op"
        out.append({"ph": "X", "cat": cat, "name": e.name(), "ts": e.start_ns() / 1e3,
                    "dur": e.duration_ns() / 1e3})
    return out


def check_image(label, img, size, rows=1):
    if (img.shape != (rows, size, size, 3) or img.dtype.name != "uint8"
            or min(float(i.std()) for i in img) == 0.0):
        raise AssertionError(f"{label}: not {rows} non-constant ({size}, {size}, 3) uint8 "
                             f"image(s): {img.shape} {img.dtype}")


def call_keys(calls):
    """A path's kernel A/B/C and row-pass call configurations, keyed as
    :func:`check_conv`, :func:`check_flash` and :func:`row_case` take them."""
    return ({("conv", cfg[:6]) for cfg in calls["conv3x3_slab"]}
            | {("flash", key) for key in calls["flash_attention_packed"]}
            | {(kind, key) for kind in ROW_KERNELS for key in calls[kind]})


def hold_shapes(torch, gen, label, calls, held):
    """Kernels A, B and C at each call configuration of ``calls`` not in
    ``held`` yet, each held to its plain version at TOL_REL, and the row
    passes within ROW_ULPS; ``held`` gains them.  Returns how many were
    new."""
    new = sorted(call_keys(calls) - held)
    for kind, key in new:
        if kind == "conv":
            check_conv(torch, gen, key)
        elif kind == "flash":
            check_flash(torch, gen, *key)
        else:
            row_case(torch, gen, kind, key)
    held.update(new)
    log(f"{label}: {len(new)} kernel call configuration(s) that the earlier requests did not "
        f"run, each within TOL_REL of its plain version")
    return len(new)


def shape_times(torch, gen, calls, exp_rate):
    """Kernels A, B and C and the row passes at every call configuration of
    a path: each held to its plain version (TOL_REL; ROW_ULPS), then timed
    by CUDA events beside its plain version and one library call where
    there is one (:func:`time_conv`, :func:`time_flash`, :func:`row_case`;
    5 calls each).  Returns the per-image sums over the path's calls with
    the bound, ``{kernel: totals}``, and the per-call rows."""
    from sdtpu_torch.kernels.flash_attention import plan_flash

    tot = {n: {"launches": 0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
               "byte_ms": 0.0, "op_ms": 0.0, "max_abs_err": 0.0}
           for n in ("conv3x3_slab", "conv3x3_slab_upsample", "flash_attention", *ROW_KERNELS)}

    rows = []

    def add(name, n, times, cost, err, desc):
        t_k, t_p, t_l = times
        rows.append({"kernel": name, "call": desc, "per_image": n, "ms": t_k, "plain_ms": t_p,
                     "library_ms": t_l})
        t_by, t_ops = bound_terms(cost, PEAK_BF16_FLOPS, exp_rate)
        row = tot[name]
        for key, v in (("launches", 1), ("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l),
                       ("byte_ms", t_by), ("op_ms", t_ops), ("bound_ms", max(t_by, t_ops))):
            row[key] = None if v is None or row[key] is None else row[key] + n * v
        row["max_abs_err"] = max(row["max_abs_err"], err)
        lib = "none" if t_l is None else f"{t_l:.4f}"
        log(f"time {name} {desc} x{n}: kernels {t_k:.4f} ms, plain {t_p:.4f}, library "
            f"{lib} (CUDA events, per call)")

    for cfg, n in sorted(calls["conv3x3_slab"].items()):
        x_shape, co, pro, res, up, stats, _ = cfg
        name, err = check_conv(torch, gen, cfg[:6])
        add(name, n, time_conv(torch, gen, cfg[:6], reps=5, device=False),
            conv_cost(x_shape, co, pro=pro, res=res, up=up, stats=stats), err,
            f"x={x_shape} co={co} pro={int(pro)} res={int(res)} st={int(stats)}")
    for (q_shape, lk), n in sorted(calls["flash_attention_packed"].items()):
        _, err = check_flash(torch, gen, q_shape, lk)
        b, h, lq, d = q_shape
        add("flash_attention", n, time_flash(torch, gen, q_shape, lk, reps=5, device=False),
            flash_cost(q_shape, lk), err, f"q={q_shape} lk={lk} plan={plan_flash(b * h, lq, lk, d)}")
    for row_kernel in ROW_KERNELS:
        for key, n in sorted(calls[row_kernel].items()):
            err, run, plain_run, lib, cost = row_case(torch, gen, row_kernel, key)
            add(row_kernel, n, (event_ms(run, 5), event_ms(plain_run, 5),
                          None if lib is None else event_ms(lib, 5)), cost, err,
                f"x={key[0]} {key[1]} p={key[2]}")
    for row in tot.values():
        row["bound_by"] = "bytes" if row.pop("byte_ms") > row.pop("op_ms") else "operations"
    return tot, rows


def sdxl_phase(torch, np, gen, sd15_host, launch_counts, reset_launch_counts, kind, exp_rate):
    """Phase 16: ``sdxl`` at 1024x1024 on seeded random weights (one
    25-step CFG image with its launches held, its kernel shapes held to
    their plain versions and timed, a traced image, one UNet forward
    against the plain route and float32), ``sdxl-turbo`` on the same tree
    (a request, ``generate_batch`` of 4 and the ServingEngine on the gate's
    weights), the base -> refiner handoff, ``lcm-sd15`` (each later
    request's new A/B/C call shapes held to their plain versions), and the
    bench's SDXL lines.  Returns its details, the ``sdxl`` tree (kept for
    phase 20) and the A/B/C call configurations it held."""
    from sdtpu_torch import StableDiffusionPipeline, bench
    from sdtpu_torch.config import get_preset
    from sdtpu_torch.models.unet import init_unet, unet_forward
    from sdtpu_torch.pipeline.serving import ServingEngine
    from sdtpu_torch.samplers import get_sampler, slice_schedule
    from sdtpu_torch.tools import check_batch_invariance
    from sdtpu_torch.utils import hostrng

    out = {}
    t_phase = time.perf_counter()
    ids = np.random.default_rng(16).integers(1, 49408, (2, 77))

    # (a) sdxl at 1024x1024: from_random, one image, its kernel shapes
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    base = StableDiffusionPipeline.from_random("sdxl", seed=0, device="cuda")
    torch.cuda.synchronize()
    fr_s = time.perf_counter() - t0
    tree_bytes = torch.cuda.memory_allocated() - before
    log(f"sdxl: from_random(seed=0) {fr_s:.3f} s on the host, the tree {tree_bytes / 2**30:.3f} "
        "GiB on the card")
    kw = dict(token_ids=ids, num_inference_steps=SDXL_STEPS, seed=40, image_size=1024)
    calls = request_calls(torch, base, kw, SDXL_STEPS)
    predicted = {k: SDXL_STEPS * v + VAE_DECODE[k] for k, v in PREDICTED_STEP["sdxl"].items()}
    img, sec, counts, peak = held_run(torch, "sdxl", lambda: base.generate(**kw), calls,
                                      launch_counts, reset_launch_counts, predicted)
    check_image("sdxl", img, 1024)
    log(f"sdxl (1024x1024, {SDXL_STEPS} DDPM steps, CFG 7.5, UNet batch 2): pixel std "
        f"{float(img.std()):.3f}, {sec:.4f} s/image, peak memory above the tree "
        f"{peak / 2**30:.3f} GiB")
    out["sdxl"] = {"from_random_s": fr_s, "tree_bytes": tree_bytes, "s_per_image": sec,
                   "peak_bytes": peak, "launches": counts,
                   "attention_shapes": sorted([list(q), lk] for q, lk in
                                              calls["flash_attention_packed"])}
    out["sdxl"]["kernels"], out["sdxl"]["kernel_calls"] = shape_times(torch, gen, calls,
                                                                     exp_rate)
    for name, row in out["sdxl"]["kernels"].items():
        log(f"sdxl per image, {name}: {json.dumps(row)}")
    # every later request's A/B/C call configurations that sdxl's did not
    # run are held to their plain versions too
    held = call_keys(calls)
    out["shapes_held"] = {"sdxl": len(held)}
    # the bench line's request (its zero tree has this tree's shapes)
    short_counts = expected_launches(request_calls(torch, base, kw, SDXL_SHORT_STEPS),
                                     launch_counts)
    # one traced image: device-busy time and idle share
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        base.generate(**dict(kw, num_inference_steps=SDXL_SHORT_STEPS))
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    split = trace_split(kineto_events(torch, prof), wall)
    del prof
    log(f"trace of one sdxl image ({SDXL_SHORT_STEPS} steps, read in {time.perf_counter() - t0:.1f}"
        f" s): wall {split['wall_ms']:.1f} ms, window {split['window_ms']:.1f} ms, device busy "
        f"{split['device_busy_ms']:.1f} ms ({split['device_events']} device activities), idle "
        f"share {split['idle_share']:.4f}")
    log("trace sdxl device ms by kind: " + ", ".join(
        f"{k} {v['ms']:.1f} (x{v['count']})" for k, v in split["device_ms_by_kind"].items()))
    log("trace sdxl host stage ms: " + ", ".join(f"{n} {v:.1f}"
                                                 for n, v in split["host_stage_ms"].items()))
    for op in split["top_device_ops"][:5]:
        log(f"trace sdxl device op {op['total_ms']:9.3f} ms x{op['count']:5d} {op['name'][:100]}")
    for g in split["longest_idle_gaps"][:3]:
        log(f"trace sdxl idle gap {g['ms']:8.3f} ms at +{g['at_ms']:.1f} ms, host in "
            f"{g['stage']}")
    out["sdxl"]["trace"] = split
    # one UNet forward at batch 2 (128x128 latents): kernels vs plain vs f32
    ucfg = base.config.unet
    lat = torch.randn((2, 128, 128, 4), generator=gen, device="cuda")
    ctx = torch.randn((2, 77, ucfg.cross_attention_dim), generator=gen, device="cuda")
    ts = torch.full((2,), 501.0, device="cuda")
    added = {"text_embeds": torch.randn((2, 1280), generator=gen, device="cuda"),
             "time_ids": torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * 2, device="cuda")}
    a16 = {"text_embeds": added["text_embeds"].bfloat16(), "time_ids": added["time_ids"]}
    with torch.inference_mode():
        k_out = unet_forward(lat.bfloat16(), ts, ctx.bfloat16(), base.params["unet"], ucfg,
                             added_cond=a16).float()
        with routed(**plain_routes()):
            p_out = unet_forward(lat.bfloat16(), ts, ctx.bfloat16(), base.params["unet"], ucfg,
                                 added_cond=a16).float()
            u32 = to_dtype(base.params["unet"], torch.float32)
            f_out = unet_forward(lat, ts, ctx, u32, ucfg, added_cond=added).float()
            del u32
    out["sdxl"]["unet_control"] = judge_rel(torch, "sdxl unet_forward b2 128x128", k_out, p_out,
                                            f_out)
    del k_out, p_out, f_out, lat, ctx
    torch.cuda.empty_cache()

    # (b) sdxl-turbo at 512x512 on the same tree: one request; then, on the
    # gate's weights, generate_batch of 4 and the ServingEngine, each row
    # within the gate's envelope of its solo image
    tcfg = get_preset("sdxl-turbo")
    turbo = StableDiffusionPipeline(tcfg, base.params, device="cuda")
    tsteps = tcfg.default_steps
    tkw = dict(token_ids=ids[:1], seed=40)
    tcalls = request_calls(torch, turbo, tkw, tsteps)
    predicted = {k: tsteps * v + VAE_DECODE[k] for k, v in PREDICTED_STEP["sdxl"].items()}
    img, sec, counts, _ = held_run(torch, "sdxl-turbo", lambda: turbo.generate(**tkw), tcalls,
                                   launch_counts, reset_launch_counts, predicted)
    check_image("sdxl-turbo", img, 512)
    log(f"sdxl-turbo (512x512, {tsteps} Euler steps, no CFG, UNet batch 1): {sec:.4f} s/image")
    out["shapes_held"]["sdxl-turbo"] = hold_shapes(torch, gen, "sdxl-turbo", tcalls, held)
    out["sdxl-turbo"] = {"s_per_image": sec, "launches": counts,
                         "attention_shapes": sorted([list(q), lk] for q, lk in
                                                    tcalls["flash_attention_packed"])}
    t0 = time.perf_counter()
    gate = StableDiffusionPipeline(tcfg, card_normal_tree(torch, base.params, 1234),
                                   device="cuda")
    log(f"sdxl-turbo gate weights (0.04 x normals drawn on the card, seed 1234) in "
        f"{time.perf_counter() - t0:.1f} s")
    bids = np.random.default_rng(4).integers(1, 49408, (8, 77))
    bkw = dict(token_ids=bids[:4], seeds=[10, 11, 12, 13])
    bcalls = request_calls(torch, gate, bkw, tsteps, batch=4)
    imgs, sec, bcounts, peak = held_run(
        torch, "sdxl-turbo generate_batch B=4", lambda: gate.generate_batch(["x"] * 4, **bkw),
        bcalls, launch_counts, reset_launch_counts)
    check_image("sdxl-turbo generate_batch", imgs, 512, 4)
    out["shapes_held"]["sdxl-turbo B=4"] = hold_shapes(torch, gen, "sdxl-turbo generate_batch B=4",
                                                       bcalls, held)
    log(f"sdxl-turbo generate_batch B=4: {sec:.4f} s ({4 / sec:.4f} images/s), peak memory "
        f"above what was allocated before it {peak / 2**30:.3f} GiB")
    out["sdxl-turbo"]["batch4"] = {"s_per_batch": sec, "images_per_s": 4 / sec,
                                   "peak_bytes": peak, "launches": bcounts}

    def gated(label, served, rows):
        gaps = []
        for i, (img, (tok, seed)) in enumerate(zip(served, rows)):
            solo = gate.generate_batch(["x"], token_ids=tok[None], seeds=[seed])[0]
            gap = check_batch_invariance.row_gap(img, solo)
            level, frac = gap["max_level_diff"], gap["mismatched_frac"]
            ok = level <= INV_LEVEL and frac <= INV_FRAC
            log(f"sdxl-turbo {label} row {i}: against its solo image max {level} level(s), "
                f"{frac:.4%} of values differ (envelope {INV_LEVEL}, {INV_FRAC:.0%})"
                + (" ok" if ok else " FAIL"))
            if not ok:
                raise AssertionError(f"sdxl-turbo {label} row {i} is off its solo image")
            gaps.append({"row": i, "max_level_diff": level, "mismatched_frac": frac})
        return gaps

    out["sdxl-turbo"]["batch4"]["gaps"] = gated("generate_batch B=4", imgs,
                                                list(zip(bids[:4], bkw["seeds"])))
    reqs = [dict(token_ids=bids[i], seed=100 + i) for i in range(8)]
    engine = ServingEngine(gate, max_batch_size=4, max_wait_ms=20.0)
    try:
        t0 = time.perf_counter()
        futs = [engine.submit("x", **r) for r in reqs]
        served = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        stats = engine.stats()
    finally:
        engine.shutdown()
    log(f"sdxl-turbo serving: 8 requests in {wall:.3f} s; stats {stats}")
    if stats["requests"] != 8 or stats["failures"] or stats["batches"] < 2:
        raise AssertionError(f"sdxl-turbo serving: stats {stats}")
    out["sdxl-turbo"]["serving"] = {
        "wall_s": wall, "stats": stats,
        "gaps": gated("serving", served, [(r["token_ids"], r["seed"]) for r in reqs])}
    del gate, turbo, imgs, served
    torch.cuda.empty_cache()

    # (c) the handoff: the base's head to SPLIT, then the refiner's tail; the
    # refiner shares the base's clip_2 and VAE configs, so its tree is the
    # base's leaves there and a UNet drawn from from_random's key
    # (= from_random("sdxl-refiner", seed=0), leaf for leaf)
    sched = get_sampler("ddpm").make_schedule(base.config.scheduler, SDXL_STEPS, device="cuda")
    n_train = base.config.scheduler.num_train_timesteps
    n_head = slice_schedule(sched, num_train_timesteps=n_train, denoising_end=SPLIT).num_steps
    n_tail = slice_schedule(sched, num_train_timesteps=n_train,
                            denoising_start=SPLIT).num_steps
    hkw = dict(kw, denoising_end=SPLIT, output="latents")
    hcalls = request_calls(torch, base, hkw, n_head, decode=False)
    head, sec_h, hcounts, _ = held_run(
        torch, f"sdxl head ({n_head} steps, no decode)", lambda: base.generate(**hkw), hcalls,
        launch_counts, reset_launch_counts,
        {k: n_head * v for k, v in PREDICTED_STEP["sdxl"].items()})
    out["shapes_held"]["sdxl head"] = hold_shapes(torch, gen, "sdxl head", hcalls, held)
    if head.shape != (1, 128, 128, 4) or not np.isfinite(head).all():
        raise AssertionError(f"sdxl head latents: {head.shape}, finite {np.isfinite(head).all()}")
    rcfg = get_preset("sdxl-refiner")
    t0 = time.perf_counter()
    r_unet = tree_to(init_unet(hostrng.split(hostrng.ensure_key(0), 5)[1], rcfg.unet,
                               dtype=rcfg.param_dtype), "cuda")
    torch.cuda.synchronize()
    r_s = time.perf_counter() - t0
    refiner = StableDiffusionPipeline(rcfg, {"unet": r_unet, "clip_2": base.params["clip_2"],
                                             "vae_encoder": base.params["vae_encoder"],
                                             "vae_decoder": base.params["vae_decoder"]},
                                      device="cuda")
    log(f"sdxl-refiner: its UNet drawn in {r_s:.3f} s on the host")
    rkw = dict(kw, latents=head, denoising_start=SPLIT)
    rcalls = request_calls(torch, refiner, rkw, n_tail)
    img, sec_r, rcounts, peak = held_run(
        torch, f"sdxl-refiner tail ({n_tail} steps + decode)", lambda: refiner.generate(**rkw),
        rcalls, launch_counts, reset_launch_counts,
        {k: n_tail * v + VAE_DECODE[k] for k, v in PREDICTED_STEP["sdxl-refiner"].items()})
    check_image("sdxl-refiner", img, 1024)
    out["shapes_held"]["sdxl-refiner"] = hold_shapes(torch, gen, "sdxl-refiner tail", rcalls,
                                                     held)
    log(f"handoff at {SPLIT}: base head {n_head} steps {sec_h:.4f} s, refiner tail {n_tail} "
        f"steps + decode {sec_r:.4f} s, peak memory above the trees {peak / 2**30:.3f} GiB")
    out["handoff"] = {"head_steps": n_head, "tail_steps": n_tail, "head_s": sec_h,
                      "tail_s": sec_r, "refiner_unet_s": r_s, "head_launches": hcounts,
                      "tail_launches": rcounts, "peak_bytes": peak}
    xl_params = base.params  # phase 20's SDXL int8, inpaint and ControlNet requests
    del refiner, base, r_unet
    torch.cuda.empty_cache()

    # (d) lcm-sd15 at 512x512: 4 LCM steps, the guidance as an embedding,
    # on the SD-1.5 family's tree (sd15_pipeline)
    t0 = time.perf_counter()
    lcm = sd15_pipeline(torch, sd15_host, "lcm-sd15")
    torch.cuda.synchronize()
    l_s = time.perf_counter() - t0
    lsteps = lcm.config.default_steps
    lkw = dict(token_ids=ids[:1], seed=40)
    lcalls = request_calls(torch, lcm, lkw, lsteps)
    img, sec, counts, _ = held_run(
        torch, "lcm-sd15", lambda: lcm.generate(**lkw), lcalls, launch_counts,
        reset_launch_counts,
        {k: lsteps * v + VAE_DECODE[k] for k, v in PREDICTED_STEP["lcm-sd15"].items()})
    check_image("lcm-sd15", img, 512)
    out["shapes_held"]["lcm-sd15"] = hold_shapes(torch, gen, "lcm-sd15", lcalls, held)
    log(f"lcm-sd15: the tree to the card {l_s:.3f} s; 512x512, {lsteps} LCM steps, guidance embedding "
        f"(8 - 1) x 1000, UNet batch 1: {sec:.4f} s/image")
    out["lcm-sd15"] = {"to_card_s": l_s, "s_per_image": sec, "launches": counts}
    del lcm
    torch.cuda.empty_cache()

    # (e) the bench's lines: the first run, then 1 + repeats pipelined, each
    # with the launches of the request above.  Three repeats, not two: the
    # line is the median of the gaps between fetches, and the last gap is
    # only the card's tail after the host's last enqueue, which two gaps
    # would average in
    for label, argv, per_request in (
            (f"--preset sdxl --steps {SDXL_SHORT_STEPS}",
             ["--preset", "sdxl", "--steps", str(SDXL_SHORT_STEPS), "--repeats",
              str(BENCH_REPEATS)], short_counts),
            ("--preset sdxl-turbo --batch 4",
             ["--preset", "sdxl-turbo", "--batch", "4", "--repeats", str(BENCH_REPEATS)],
             bcounts)):
        reset_launch_counts()
        line = bench.main(argv)
        got = dict(launch_counts)
        want = {k: (BENCH_REPEATS + 2) * v for k, v in per_request.items()}
        ok = line["value"] > 0 and line["device"] == kind and got == want
        log(f"bench {label}: {json.dumps(line)}; launches {got}"
            + (" ok" if ok else f" FAIL (want {want})"))
        if not ok:
            raise AssertionError(f"bench {label}")
        out[f"bench {label}"] = {"line": line, "launches": got}
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 16: {out['phase_s']:.1f} s; A/B/C call configurations held to their plain "
        f"versions: {out['shapes_held']} ({len(held)} in all)")
    return out, xl_params, held


# --------------------------------------------- ControlNet and step features --

CN_SCALE = 0.02            # the zero convs' and conv_out's card draws (x normals)
PAG_SCALE = 3.0
FREEU = (1.5, 1.6, 0.9, 0.2)
RESCALE = 0.7
CACHE_K = 3                # the encoder cache's interval on tiny-sd
HIRES_BASE = 256
GATE_STEPS = 4             # the batch gate's Euler steps (its own settings)
# A/B/C per SD-1.5 step, read from the configs (the recorded calls decide):
# the UNet 22 resnets, 3 upsamplers, 16 transformer blocks; a ControlNet's
# encoder copy 10 resnets and 7 blocks
SD15_STEP = {"conv3x3_slab": 44, "conv3x3_slab_upsample": 3, "flash_attention": 16}
CN_STEP = {"conv3x3_slab": 20, "conv3x3_slab_upsample": 0, "flash_attention": 7}


def phase_run(torch, out, phase_calls, launch_counts, reset_launch_counts, label, fn,
              predicted=None, calls=None):
    """``fn`` counted (its calls recorded, unless ``calls`` are given, then a
    run with the launches zeroed just before it and held to them), its
    A/B/C beside the configs' reading; ``out[label]`` its seconds, launches
    and peak bytes, ``phase_calls`` its calls.  Returns (result, seconds,
    counts, peak bytes)."""
    res, sec, counts, expected, calls, peak = counted(torch, fn, launch_counts,
                                                      reset_launch_counts, calls)
    hold_counts(label, counts, expected)
    log(f"{label}: {sec:.4f} s, peak memory above what was allocated before it "
        f"{peak / 2**30:.3f} GiB")
    phase_calls.append(calls)
    if predicted is not None:
        main = {k: counts[k] for k in predicted}
        log(f"{label} A/B/C {main}; predicted from the configs {predicted}: "
            + ("agree" if main == predicted else "DIFFER (the recorded calls decide)"))
    out[label] = {"s_per_image": sec, "launches": counts, "peak_bytes": peak}
    return res, sec, counts, peak


def nonzero_controlnet(torch, tree, seed):
    """``tree`` with its zero convs and its cond embedding's conv_out drawn
    as CN_SCALE x normals on the card (a fresh ControlNet is an exact no-op:
    its residuals would compare zeros with zeros)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(t):
        return (torch.randn(t.shape, generator=gen, device="cuda") * CN_SCALE).to(t.dtype)

    out = dict(tree)
    out["zero_convs"] = [{k: draw(v) for k, v in zc.items()} for zc in tree["zero_convs"]]
    if "zero_conv_mid" in tree:
        out["zero_conv_mid"] = {k: draw(v) for k, v in tree["zero_conv_mid"].items()}
    out["cond_embedding"] = dict(tree["cond_embedding"],
                                 conv_out={k: draw(v) for k, v in
                                           tree["cond_embedding"]["conv_out"].items()})
    return out


def features_phase(torch, np, gen, tiny_params, sd15_host, launch_counts, reset_launch_counts,
                   kind):
    """Phase 17: ControlNet (one and two nets, with img2img, on
    ``generate_batch`` within the batch gate's envelope) and the step
    features (PAG at SD-1.5's mid block and tiny-sd's deepest level, FreeU,
    CFG rescale, tiny-sd's encoder cache, the hires fix) on ``sd15`` at
    full width and depth, 512x512, 25 DDPM steps, CFG 7.5, bf16: every
    request's launches held to its recorded calls, every A/C call
    configuration of the phase held to its plain version, one step's
    ControlNet residuals and the UNet output with them kernels vs plain,
    and the bench's ``--controlnet``, ``--pag-scale`` and ``--encoder-cache``
    lines."""
    from sdtpu_torch import StableDiffusionPipeline, bench
    from sdtpu_torch.config import get_preset
    from sdtpu_torch.models.controlnet import (
        controlnet_cond_embed,
        controlnet_forward,
        init_controlnet,
    )
    from sdtpu_torch.models.unet import unet_forward
    from sdtpu_torch.samplers import get_sampler
    from sdtpu_torch.tools import check_batch_invariance
    from sdtpu_torch.utils.weights import zero_controlnet_params

    out = {}
    t_phase = time.perf_counter()
    held = set()  # hold_shapes' record
    phase_calls = []
    rng = np.random.default_rng(17)
    ids = rng.integers(1, 49408, (2, 77))
    ctrl_a = rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)
    ctrl_b = rng.integers(0, 256, (512, 512), dtype=np.uint8)  # a grey map
    init = rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)

    run = functools.partial(phase_run, torch, out, phase_calls, launch_counts,
                            reset_launch_counts)

    def per_image(step, nets=0):
        return {k: STEPS * (v + nets * CN_STEP[k]) + VAE_DECODE[k] for k, v in step.items()}

    # the weights: sd15 from the SD-1.5 family's tree (sd15_pipeline) and a
    # ControlNet drawn as the JAX package draws it (the encoder half of a
    # whole SD-1.5 UNet), a second net on the card
    t0 = time.perf_counter()
    sd = sd15_pipeline(torch, sd15_host, "sd15")
    torch.cuda.synchronize()
    fr_s = time.perf_counter() - t0
    pcfg = sd.config
    t0 = time.perf_counter()
    cn_host = init_controlnet(1, pcfg.unet, dtype=pcfg.param_dtype)
    cn_s = time.perf_counter() - t0
    cn1 = nonzero_controlnet(torch, tree_to(cn_host, "cuda"), 171)
    del cn_host
    cn2 = nonzero_controlnet(torch, card_normal_tree(torch, cn1, 172), 173)
    torch.cuda.synchronize()
    log(f"sd15: the tree to the card {fr_s:.3f} s; init_controlnet(1) {cn_s:.3f} s "
        f"on the host (a whole SD-1.5 UNet drawn, its encoder half kept); the second net "
        f"0.04 x normals drawn on the card; zero convs and conv_out {CN_SCALE} x normals")
    out["to_card_s"], out["init_controlnet_s"] = fr_s, cn_s
    kw = dict(token_ids=ids, num_inference_steps=STEPS, seed=40, image_size=512,
              cfg_scale=7.5)
    # the yardstick of the features' seconds: the plain sd15 image
    img, sec, _, _ = run("sd15", lambda: sd.generate(**kw), per_image(SD15_STEP))
    check_image("sd15", img, 512)
    log(f"sd15 (512x512, {STEPS} DDPM steps, CFG 7.5, UNet batch 2): {sec:.4f} s/image")

    # (1) one ControlNet image; one step's residuals and the UNet output with
    # them, kernels vs plain
    sd.load_controlnet(cn1)
    img, sec, _, peak = run("controlnet", lambda: sd.generate(control_image=ctrl_a, **kw),
                             per_image(SD15_STEP, 1))
    check_image("controlnet", img, 512)
    log(f"controlnet (sd15 512x512, {STEPS} DDPM steps, CFG 7.5, UNet and ControlNet batch 2):"
        f" {sec:.4f} s/image, peak memory above the trees {peak / 2**30:.3f} GiB")
    ucfg = pcfg.unet
    lat = torch.randn((2, 64, 64, ucfg.in_channels), generator=gen, device="cuda")
    ctx = torch.randn((2, 77, ucfg.cross_attention_dim), generator=gen, device="cuda")
    ts = torch.full((2,), 501.0, device="cuda")
    cond = torch.rand((2, 512, 512, 3), generator=gen, device="cuda")

    def step(unet, net, dt):
        emb = controlnet_cond_embed(cond.to(dt), net["cond_embedding"])
        res = controlnet_forward(lat.to(dt), ts, ctx.to(dt), emb, net, ucfg,
                                 conditioning_scale=0.8)
        flat = torch.cat([r.float().flatten() for r in res["down"] + [res["mid"]]])
        return flat, unet_forward(lat.to(dt), ts, ctx.to(dt), unet, ucfg, control=res).float()

    with torch.inference_mode():
        k_res, k_out = step(sd.params["unet"], cn1, torch.bfloat16)
        with routed(**plain_routes()):
            p_res, p_out = step(sd.params["unet"], cn1, torch.bfloat16)
            f_res, f_out = step(to_dtype(sd.params["unet"], torch.float32),
                                to_dtype(cn1, torch.float32), torch.float32)
    out["controlnet"]["residuals"] = judge_rel(
        torch, "controlnet residuals of one step (13 skips + mid, b2 64x64)", k_res, p_res, f_res)
    out["controlnet"]["unet_control"] = judge_rel(
        torch, "sd15 unet_forward b2 64x64 with the residuals", k_out, p_out, f_out)
    del k_res, p_res, f_res, k_out, p_out, f_out
    torch.cuda.empty_cache()

    # (2) two nets, one map each, the residuals summed
    sd.load_controlnet([cn1, cn2])
    img, sec, _, _ = run("controlnet x2", lambda: sd.generate(
        control_image=[ctrl_a, ctrl_b], controlnet_scale=[1.0, 0.6], **kw),
        per_image(SD15_STEP, 2))
    check_image("controlnet x2", img, 512)
    log(f"controlnet x2: {sec:.4f} s/image")

    # (3) one net with img2img at strength STRENGTH
    sd.load_controlnet(cn1)
    s_eff = get_sampler("ddpm").make_schedule(pcfg.scheduler, STEPS, STRENGTH).num_steps
    img, sec, _, _ = run("controlnet img2img", lambda: sd.generate(
        control_image=ctrl_a, init_image=init, strength=STRENGTH, **kw))
    check_image("controlnet img2img", img, 512)
    log(f"controlnet img2img (strength {STRENGTH}: {s_eff} steps): {sec:.4f} s/image")

    # (4) generate_batch of 4 on the gate's weights (0.04 x normals drawn on
    # the card), GATE_STEPS Euler steps: each row within the gate's envelope
    # of its solo image
    gate = StableDiffusionPipeline(pcfg, card_normal_tree(torch, sd.params, 1234), device="cuda")
    gate.load_controlnet(card_normal_tree(torch, cn1, 1235))
    maps = [ctrl_a, ctrl_b, ctrl_a[::-1], init]
    bids = np.random.default_rng(4).integers(1, 49408, (4, 77))
    bkw = dict(num_inference_steps=GATE_STEPS, sampler="euler", image_size=512)
    imgs, sec, _, peak = run("controlnet generate_batch B=4", lambda: gate.generate_batch(
        ["x"] * 4, token_ids=bids, seeds=[10, 11, 12, 13], control_images=maps, **bkw))
    check_image("controlnet generate_batch", imgs, 512, 4)
    gaps = []
    for i in range(4):
        solo = gate.generate_batch(["x"], token_ids=bids[i:i + 1], seeds=[10 + i],
                                   control_images=[maps[i]], **bkw)[0]
        gap = check_batch_invariance.row_gap(imgs[i], solo)
        level, frac = gap["max_level_diff"], gap["mismatched_frac"]
        ok = level <= INV_LEVEL and frac <= INV_FRAC
        log(f"controlnet generate_batch row {i}: against its solo image max {level} level(s), "
            f"{frac:.4%} of values differ (envelope {INV_LEVEL}, {INV_FRAC:.0%})"
            + (" ok" if ok else " FAIL"))
        if not ok:
            raise AssertionError(f"controlnet generate_batch row {i} is off its solo image")
        gaps.append({"row": i, "max_level_diff": level, "mismatched_frac": frac})
    log(f"controlnet generate_batch B=4 ({GATE_STEPS} Euler steps, UNet batch 8): {sec:.4f} s "
        f"({4 / sec:.4f} images/s), peak memory {peak / 2**30:.3f} GiB")
    out["controlnet generate_batch B=4"]["gaps"] = gaps
    del gate
    sd.controlnet = None
    torch.cuda.empty_cache()

    # (5)-(7) PAG at the mid block, FreeU, CFG rescale on sd15
    for label, feat, predicted in (
            (f"pag {PAG_SCALE}", dict(pag_scale=PAG_SCALE), per_image(SD15_STEP)),
            ("freeu", dict(freeu=FREEU), per_image(SD15_STEP)),
            (f"guidance_rescale {RESCALE}", dict(guidance_rescale=RESCALE),
             per_image(SD15_STEP))):
        img, sec, _, _ = run(label, lambda: sd.generate(**kw, **feat), predicted)
        check_image(label, img, 512)
        log(f"{label} (sd15 512x512, {STEPS} steps): {sec:.4f} s/image")

    # (9) the hires fix: txt2img at HIRES_BASE, then img2img at 512
    img, sec, _, _ = run(f"generate_hires {HIRES_BASE}->512", lambda: sd.generate_hires(
        token_ids=ids, num_inference_steps=STEPS, seed=40, image_size=512,
        base_size=HIRES_BASE))
    check_image("generate_hires", img, 512)
    log(f"generate_hires {HIRES_BASE}->512 (hires_strength 0.7): {sec:.4f} s/image")
    del sd
    torch.cuda.empty_cache()

    # (5), (8) on tiny-sd: PAG at the deepest attention level, the encoder
    # cache at CACHE_K (the encoder on 25 // k groups + the remainder's
    # steps), and a ControlNet of zeros (the bench's tree): each request's
    # launches are the bench line's per image
    tiny = StableDiffusionPipeline(get_preset("tiny-sd"), tree_to(tiny_params, "cuda"),
                                   device="cuda")
    tkw = dict(token_ids=ids, num_inference_steps=STEPS, seed=40, image_size=512)
    n_enc = STEPS // CACHE_K + STEPS % CACHE_K
    per_request = {}
    for label, flag, feat in (
            (f"tiny-sd pag {PAG_SCALE}", ["--pag-scale", str(PAG_SCALE)],
             dict(pag_scale=PAG_SCALE)),
            (f"tiny-sd encoder cache k={CACHE_K}", ["--encoder-cache", str(CACHE_K)],
             dict(encoder_cache_interval=CACHE_K)),
            ("tiny-sd controlnet (zeros)", ["--controlnet"], dict(control_image=ctrl_a))):
        if "control_image" in feat:
            tiny.load_controlnet(zero_controlnet_params(tiny.config, device="cuda"))
        img, sec, counts, _ = run(label, lambda: tiny.generate(**tkw, **feat))
        check_image(label, img, 512)
        log(f"{label} (512x512, {STEPS} steps"
            + (f", the encoder on {n_enc} of them" if "encoder_cache_interval" in feat else "")
            + f"): {sec:.4f} s/image")
        per_request[tuple(flag)] = counts
    del tiny
    torch.cuda.empty_cache()

    # every A/C call configuration of the phase against its plain version
    merged = {key: Counter() for key in phase_calls[0]}
    for calls in phase_calls:
        for key, cs in calls.items():
            merged[key].update(cs)
    out["shapes_held"] = hold_shapes(torch, gen, "phase 17's requests", merged, held)

    # (10) the bench's lines (tiny-sd, the default preset): the first run,
    # then 1 + repeats pipelined, each with the launches of the request above
    for flag, per in per_request.items():
        reset_launch_counts()
        line = bench.main([*flag, "--repeats", str(BENCH_REPEATS)])
        got = dict(launch_counts)
        want = {k: (BENCH_REPEATS + 2) * v for k, v in per.items()}
        ok = (line["value"] > 0 and line["device"] == kind and got == want
              and line["mfu_pct"] is None)
        log(f"bench {' '.join(flag)}: {json.dumps(line)}; launches {got}"
            + (" ok" if ok else f" FAIL (want {want})"))
        if not ok:
            raise AssertionError(f"bench {' '.join(flag)}")
        out[f"bench {' '.join(flag)}"] = {"line": line, "launches": got}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 17: {out['phase_s']:.1f} s; A/B/C call configurations held to their plain "
        f"versions: {len(held)}")
    return out


# ------------------------------------------------------------ text features --

LORA_RANK = 8
LORA_SCALE = 0.8
LORA_UP_STD = 0.01         # the up factor's normals (a trained up is small)
PW_PROMPT = "a (red:1.4) cube on a [table]"
TI_TOKEN = "<sdtpu-concept>"
LONG_PROMPT = ("a photograph of an astronaut riding a horse on the surface of the moon, "
               "(highly detailed:1.2), cinematic lighting")  # over 75 byte tokens


def seeded_lora(np, tree, seed):
    """A kohya-layout adapter over every module of ``utils/lora.py``'s
    tables: the UNet's convs (conv_in, the resnets', the 1x1 shortcuts, the
    down- and upsamplers', conv_out), linears and projections, and every
    text-encoder layer; a 3x3 conv's down flattened to (r, I*9), as LoCon
    files store it.  Down ~ N(0, 1/I), up ~ LORA_UP_STD x N(0, 1), alpha the
    rank: the delta is ~2% of a fan-in-scaled weight."""
    from sdtpu_torch.utils.lora import _index_clip, _index_unet

    rng = np.random.default_rng(seed)
    sd = {}

    def pair(key, shape):
        if len(shape) == 4:
            kh, kw, ci, co = shape
            down = rng.standard_normal((LORA_RANK, ci * kh * kw), dtype=np.float32)
            up = rng.standard_normal((co, LORA_RANK, 1, 1), dtype=np.float32)
            if (kh, kw) == (1, 1):
                down = down.reshape(LORA_RANK, ci, 1, 1)
        else:
            ci, co = shape
            down = rng.standard_normal((LORA_RANK, ci), dtype=np.float32)
            up = rng.standard_normal((co, LORA_RANK), dtype=np.float32)
        fan_in = int(np.prod(down.shape[1:]))
        sd[f"{key}.lora_down.weight"] = down / np.float32(math.sqrt(fan_in))
        sd[f"{key}.lora_up.weight"] = up * np.float32(LORA_UP_STD)
        sd[f"{key}.alpha"] = np.float32(LORA_RANK)

    for name, (leaf, _) in sorted(_index_unet(tree["unet"]).items()):
        pair(f"lora_unet_{name}", tuple(leaf["kernel"].shape))
    for name, (leaf, _) in sorted(_index_clip(tree["clip"]).items()):
        pair(f"lora_te_{name}", tuple(leaf["kernel"].shape[1:]))
    return sd


def text_phase(torch, np, gen, sd15_host, launch_counts, reset_launch_counts):
    """Phase 18: the text features on ``sd15`` at full width and depth
    (the SD-1.5 family's tree), 512x512, 25 DDPM steps, CFG 7.5, bf16: a
    LoRA fused, its UNet forward kernels vs plain, unloaded bitwise; a
    textual-inversion concept; prompt weighting, unit token weights
    (bitwise the unweighted image), a two-window prompt; weighted requests
    through the ServingEngine within the batch gate's envelope."""
    from sdtpu_torch import StableDiffusionPipeline
    from sdtpu_torch.models.unet import unet_forward
    from sdtpu_torch.pipeline.serving import ServingEngine
    from sdtpu_torch.tools import check_batch_invariance

    out = {}
    t_phase = time.perf_counter()
    held = set()  # hold_shapes' record
    phase_calls = []
    run = functools.partial(phase_run, torch, out, phase_calls, launch_counts,
                            reset_launch_counts)
    sd = sd15_pipeline(torch, sd15_host, "sd15")
    sd.tokenizer = byte_tokenizer()
    pcfg = sd.config
    rng = np.random.default_rng(18)
    ids = rng.integers(1, 49408, (2, 77))
    kw = dict(num_inference_steps=STEPS, seed=40, image_size=512, cfg_scale=7.5)
    per_image = {k: STEPS * v + VAE_DECODE[k] for k, v in SD15_STEP.items()}

    # (a) LoRA: the base image, the fused one, the restored one; the fused
    # and restored images' launches held to the base image's calls
    base, _, _, _ = run("text base", lambda: sd.generate(token_ids=ids, **kw), per_image)
    check_image("text base", base, 512)
    base_calls = phase_calls[-1]
    before = sd.params
    t0 = time.perf_counter()
    adapter = seeded_lora(np, sd.params, 181)
    draw_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = sd.load_lora(adapter, scale=LORA_SCALE)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n_mod = len(adapter) // 3
    snap = sum(t.numel() * t.element_size() for t in sd._lora_originals.values())
    ok = report["applied"] == n_mod and not report["skipped"] and not report["unrecognized"]
    log(f"lora: rank {LORA_RANK}, scale {LORA_SCALE}, {n_mod} modules (drawn in {draw_s:.3f} s); "
        f"load_lora {load_s:.3f} s (applied {report['applied']}, skipped "
        f"{len(report['skipped'])}, unrecognized {len(report['unrecognized'])}); the "
        f"snapshots for unload {snap} bytes on the card" + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError("load_lora did not fuse every module of the adapter")
    fused, sec, _, _ = run("lora", lambda: sd.generate(token_ids=ids, **kw), calls=base_calls)
    check_image("lora", fused, 512)
    changed = float(np.abs(fused.astype(np.int16) - base.astype(np.int16)).mean())
    log(f"lora (sd15 512x512, {STEPS} DDPM steps, CFG 7.5): {sec:.4f} s/image; mean |fused - "
        f"base| {changed:.3f} levels")
    if changed == 0.0:
        raise AssertionError("the fused adapter did not change the image")
    ucfg = pcfg.unet
    lat = torch.randn((2, 64, 64, ucfg.in_channels), generator=gen, device="cuda")
    ctx = torch.randn((2, 77, ucfg.cross_attention_dim), generator=gen, device="cuda")
    ts = torch.full((2,), 501.0, device="cuda")

    def forward(unet, dt):
        return unet_forward(lat.to(dt), ts, ctx.to(dt), unet, ucfg).float()

    with torch.inference_mode():
        k_out = forward(sd.params["unet"], torch.bfloat16)
        with routed(**plain_routes()):
            p_out = forward(sd.params["unet"], torch.bfloat16)
            f_out = forward(to_dtype(sd.params["unet"], torch.float32), torch.float32)
    out["lora"]["unet"] = judge_rel(torch, "sd15 unet_forward b2 64x64 on the fused tree",
                                    k_out, p_out, f_out)
    del k_out, p_out, f_out
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    n_back = sd.unload_loras()
    torch.cuda.synchronize()
    unload_s = time.perf_counter() - t0
    same = trees_bitwise(torch, sd.params, before)
    log(f"unload_loras {unload_s:.4f} s, {n_back} modules restored; the tree bitwise the "
        f"pre-load tree: {same}" + (" ok" if same and n_back == n_mod else " FAIL"))
    if not same or n_back != n_mod:
        raise AssertionError("unload_loras did not restore the tree")
    restored, _, _, _ = run("lora unloaded", lambda: sd.generate(token_ids=ids, **kw),
                            calls=base_calls)
    same = bool(np.array_equal(restored, base))
    log(f"lora unloaded: the image bitwise the base image: {same}" + (" ok" if same else " FAIL"))
    if not same:
        raise AssertionError("the image after unload_loras differs from the base image")
    out["lora"].update(load_s=load_s, unload_s=unload_s, modules=n_mod, snapshot_bytes=snap,
                       mean_level_change=changed)

    # (b) a 2-vector textual-inversion concept (diffusers layout) in a prompt
    table = sd.params["clip"]["token_embedding"]["weight"]
    emb = {TI_TOKEN: (torch.randn((2, table.shape[1]), generator=gen, device="cuda")
                      * table.float().std()).cpu()}
    t0 = time.perf_counter()
    reg = sd.load_textual_inversion(emb)
    ti_s = time.perf_counter() - t0
    prompt = f"a photo of {TI_TOKEN} on a table"
    new_ids = reg[TI_TOKEN]
    tok_ids = sd.tokenizer.encode(prompt, max_length=77)
    ok = new_ids == [table.shape[0], table.shape[0] + 1] and all(i in tok_ids for i in new_ids)
    log(f"textual inversion: {TI_TOKEN} -> {new_ids} in {ti_s:.4f} s; the prompt's ids hold "
        f"them: {ok}" + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError("textual inversion: the placeholder's ids are off")
    img, sec, _, _ = run("ti", lambda: sd.generate(prompt, **kw), calls=base_calls)
    check_image("ti", img, 512)
    log(f"ti (sd15 512x512, {STEPS} steps): {sec:.4f} s/image")
    out["ti"]["ids"] = new_ids

    # (c) weighted prompts: emphasis, unit token weights (bitwise the base
    # image), a two-window prompt
    img, sec, _, _ = run("pw", lambda: sd.generate(PW_PROMPT, prompt_weighting=True, **kw),
                         calls=base_calls)
    check_image("pw", img, 512)
    log(f"pw {PW_PROMPT!r}: {sec:.4f} s/image")
    img, sec, _, _ = run("tw ones", lambda: sd.generate(
        token_ids=ids, token_weights=np.ones(ids.shape, np.float32), **kw), calls=base_calls)
    same = bool(np.array_equal(img, base))
    log(f"tw ones: {sec:.4f} s/image; bitwise the unweighted image: {same}"
        + (" ok" if same else " FAIL"))
    if not same:
        raise AssertionError("unit token weights changed the image")
    n_win = len(sd.tokenizer.encode_weighted_long(LONG_PROMPT, window=77)[0]) // 77
    img, sec, _, _ = run("2win", lambda: sd.generate(LONG_PROMPT, prompt_weighting=True, **kw))
    check_image("2win", img, 512)
    log(f"2win ({n_win} windows, weighted): {sec:.4f} s/image")
    if n_win != 2:
        raise AssertionError(f"the long prompt takes {n_win} windows, not 2")

    # every A/C call configuration of the phase against its plain version
    merged = {key: Counter() for key in phase_calls[0]}
    for calls in phase_calls:
        for key, cs in calls.items():
            merged[key].update(cs)
    out["shapes_held"] = hold_shapes(torch, gen, "phase 18's requests", merged, held)

    # (d) four weighted requests through the engine on the gate's weights
    # (GATE_STEPS Euler steps): one batch, each row within the gate's
    # envelope of its solo weighted image
    gate = StableDiffusionPipeline(pcfg, card_normal_tree(torch, sd.params, 1818),
                                   byte_tokenizer(), device="cuda")
    del sd
    torch.cuda.empty_cache()
    sizes = []
    batch_fn = gate.generate_batch

    def spy(prompts, *a, **k):
        sizes.append(len(prompts))
        return batch_fn(prompts, *a, **k)

    prompts = [PW_PROMPT, "a (blue:1.3) sphere", "[a green] (pyramid:1.2)", "a cube ((red))"]
    bkw = dict(num_inference_steps=GATE_STEPS, sampler="euler", image_size=512)
    gate.generate_batch = spy
    engine = ServingEngine(gate, max_batch_size=4, max_wait_ms=200)
    try:
        t0 = time.perf_counter()
        futs = [engine.submit(p, seed=50 + i, prompt_weighting=True, **bkw)
                for i, p in enumerate(prompts)]
        imgs = [f.result(timeout=600) for f in futs]
        eng_s = time.perf_counter() - t0
    finally:
        engine.shutdown()
    gate.generate_batch = batch_fn
    gaps = []
    for i, p in enumerate(prompts):
        solo = gate.generate_batch([p], seeds=[50 + i], prompt_weighting=True, **bkw)[0]
        gap = check_batch_invariance.row_gap(imgs[i], solo)
        level, frac = gap["max_level_diff"], gap["mismatched_frac"]
        ok = level <= INV_LEVEL and frac <= INV_FRAC
        log(f"engine weighted row {i}: against its solo image max {level} level(s), "
            f"{frac:.4%} of values differ (envelope {INV_LEVEL}, {INV_FRAC:.0%})"
            + (" ok" if ok else " FAIL"))
        if not ok:
            raise AssertionError(f"engine weighted row {i} is off its solo image")
        gaps.append({"row": i, "max_level_diff": level, "mismatched_frac": frac})
    log(f"engine: 4 weighted requests ({GATE_STEPS} Euler steps) in batches of {sizes}, "
        f"{eng_s:.4f} s" + (" ok" if sizes == [4] else " FAIL"))
    if sizes != [4]:
        raise AssertionError(f"the weighted requests did not coalesce: batches {sizes}")
    out["engine"] = {"batch_sizes": sizes, "s": eng_s, "gaps": gaps}
    del gate
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 18: {out['phase_s']:.1f} s; A/B/C call configurations held to their plain "
        f"versions: {len(held)}")
    return out


# ------------------------------------------------------------------ mesh --

MESH_KERNELS = ("conv3x3_slab", "conv3x3_slab_upsample", "flash_attention", "out_proj_packed")


def mesh_request(np, config, seeds):
    """Phase 19's ``generate_batch`` arguments: request i's token ids (a
    fixed row of its own) and seed i, the gate's settings."""
    ids = np.random.default_rng(7).integers(1, config.clip.vocab_size,
                                            (2, config.clip.max_length))
    return dict(token_ids=ids[list(seeds)], seeds=list(seeds), num_inference_steps=GATE_STEPS,
                image_size=512, sampler="euler", cfg=True)


def gloo_collectives(torch):
    """Which collectives gloo takes on CUDA tensors, each tried on card 0:
    {name: "ok" or the error}.  The mesh layer uses all_reduce, all_gather,
    broadcast and broadcast_object_list on the card's tensors."""
    import torch.distributed as dist

    dev = torch.device("cuda", 0)

    def gather(dtype):
        t = torch.ones(4, device=dev, dtype=dtype)
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t)
        return all(bool((p == 1).all()) for p in parts)

    def reduce(dtype):
        t = torch.ones(4, device=dev, dtype=dtype)
        dist.all_reduce(t)
        return bool((t == dist.get_world_size()).all())

    def bcast(dtype):
        t = torch.full((4,), dist.get_rank(), device=dev, dtype=dtype)
        dist.broadcast(t, src=0)
        return bool((t == 0).all())

    def gather_into():
        t = torch.ones(4, device=dev)
        out = torch.empty(4 * dist.get_world_size(), device=dev)
        dist.all_gather_into_tensor(out, t)
        return bool((out == 1).all())

    def objects():
        msg = [dist.get_rank()]
        dist.broadcast_object_list(msg, src=0)
        return msg == [0]

    report = {}
    for name, fn in [("all_reduce float32", lambda: reduce(torch.float32)),
                     ("all_reduce bfloat16", lambda: reduce(torch.bfloat16)),
                     ("all_gather float32", lambda: gather(torch.float32)),
                     ("all_gather bfloat16", lambda: gather(torch.bfloat16)),
                     ("all_gather uint8", lambda: gather(torch.uint8)),
                     ("all_gather_into_tensor float32", gather_into),
                     ("broadcast bfloat16", lambda: bcast(torch.bfloat16)),
                     ("broadcast int8", lambda: bcast(torch.int8)),
                     ("broadcast_object_list", objects)]:
        try:
            report[name] = "ok" if fn() else "wrong values"
        except RuntimeError as exc:  # gloo refuses a device or dtype so
            report[name] = f"refused: {exc}"[:200]
    return report


def mesh_worker(tree_path, out_dir, rank, world, url) -> int:
    """One gloo rank of phase 19 (b) on card 0: the tree ``load_converted``
    reads; a dp = 2 request of two rows, then one request on a tp = 2 mesh
    on ``shard_params_tp``'s tree, and the same with kernel G (the partial
    product); each run's calls recorded (a warm-up too), then run again with
    its launches counted and held to them.  Rank 0 holds every C and G
    call shape of the tp runs to its plain version, G in the form tp
    launches (no bias, a zero residual).  Writes
    ``rank<r>.json`` and ``rank<r>.npz`` to ``out_dir``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from sdtpu_torch.config import get_preset
    from sdtpu_torch.kernels import launch_counts, reset_launch_counts
    from sdtpu_torch.parallel import initialize, make_mesh, shard_params_tp
    from sdtpu_torch.pipeline.pipeline import StableDiffusionPipeline
    from sdtpu_torch.utils.weights import load_converted

    attn_mod = sys.modules["sdtpu_torch.ops.attention"]
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    initialize(url, world, rank, backend="gloo")
    rep = {"rank": rank, "collectives": gloo_collectives(torch)}
    config = get_preset("tiny-sd")
    t1 = time.perf_counter()
    pipe = StableDiffusionPipeline(config, load_converted(tree_path, device="cuda"),
                                   device="cuda")
    rep["load_converted_s"] = time.perf_counter() - t1
    dp_mesh, tp_mesh = make_mesh(2, 1), make_mesh(1, 2)
    sharded = StableDiffusionPipeline(config, shard_params_tp(pipe.params, tp_mesh),
                                      device="cuda")
    images = {}

    def run(label, fn, packed=False):
        attn_mod._PACKED_OUT_PROJ = packed
        try:
            calls = record_calls(torch, fn)  # the warm-up too
            expected = expected_launches(calls, launch_counts)
            if packed:
                expected.update(out_proj_packed=sum(calls["out_proj_packed"].values()),
                                **out_proj_sub_counts(calls))
            torch.cuda.synchronize()
            reset_launch_counts()
            t = time.perf_counter()
            images[label] = fn()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t
            counts = dict(launch_counts)
        finally:
            attn_mod._PACKED_OUT_PROJ = False
        hold_counts(f"mesh rank {rank} {label}", counts, expected)
        rep[label] = {"seconds": sec, "launches": counts,
                      "flash_calls": [[list(q), lk, n] for (q, lk), n
                                      in calls["flash_attention_packed"].items()],
                      "out_proj_calls": [[list(o), c, n] for (o, c), n
                                         in calls["out_proj_packed"].items()]}
        return calls

    run("dp", lambda: pipe.generate_batch(["mesh"] * 2, mesh=dp_mesh,
                                          **mesh_request(np, config, (0, 1))))
    one = mesh_request(np, config, (0,))
    tp_calls = run("tp", lambda: sharded.generate_batch(["mesh"], mesh=tp_mesh, **one))
    pk_calls = run("tp_packed", lambda: sharded.generate_batch(["mesh"], mesh=tp_mesh, **one),
                   packed=True)
    if rank == 0:  # the call shapes the shards give C and G, against plain
        gen = torch.Generator(device="cuda").manual_seed(19)
        shapes = sorted(set(tp_calls["flash_attention_packed"])
                        | set(pk_calls["flash_attention_packed"]))
        rep["flash_attention_err"] = max(check_flash(torch, gen, q, lk)[1] for q, lk in shapes)
        rep["out_proj_packed_err"] = max(out_proj_case(torch, gen, o, c, partial=True)[0]
                                         for o, c in sorted(pk_calls["out_proj_packed"]))
    rep["seconds"] = time.perf_counter() - t0
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **images)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rep, f)
    dist.destroy_process_group()
    return 0


def mesh_phase(torch, np, launch_counts, reset_launch_counts):
    """Phase 19: the mesh on the card, tiny-sd 512x512 at full width on the
    gate's weights (0.04 x normals drawn on the card), 4 Euler steps, CFG.
    (a) One process, ``make_mesh(1, 1)``: ``generate_batch(mesh=)`` and
    ``ServingEngine(mesh=)`` with 2 requests give bitwise the images and
    exactly the launches of the same calls without a mesh;
    ``health_check(mesh)``.  (b) Two gloo processes that both drive card 0
    (the kernels from phase 2's ``build/``, the tree written once with
    ``save_converted`` and read by each rank with ``load_converted``):
    dp = 2 over two requests, each rank's row bitwise the request alone at
    batch 1 and within the gate's envelope of the one-process batch of 2;
    tp = 2, the image within the envelope of the one-process image, C on
    4 of tiny-sd's 8 heads per rank (the VAE's single head gathered), A
    and B launched as without a mesh; the same with kernel G as the
    partial product.  Which collectives gloo takes on CUDA tensors is
    printed."""
    from sdtpu_torch.config import get_preset
    from sdtpu_torch.parallel import health_check, make_mesh
    from sdtpu_torch.pipeline.pipeline import StableDiffusionPipeline
    from sdtpu_torch.pipeline.serving import ServingEngine
    from sdtpu_torch.tools.check_batch_invariance import row_gap
    from sdtpu_torch.tools.dryrun_multichip import run_ranks
    from sdtpu_torch.utils import hostrng
    from sdtpu_torch.utils.weights import init_pipeline_params, save_converted

    attn_mod = sys.modules["sdtpu_torch.ops.attention"]
    out = {}
    config = get_preset("tiny-sd")
    with hostrng.shapes_only():
        shapes = init_pipeline_params(0, config, device="meta")
    pipe = StableDiffusionPipeline(config, card_normal_tree(torch, shapes, 1234), device="cuda")
    heads = config.unet.num_attention_heads

    def counted_run(fn, timed=None):
        torch.cuda.synchronize()
        reset_launch_counts()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        if timed:
            out[timed] = time.perf_counter() - t
        return res, {k: n for k, n in launch_counts.items() if n}

    def serve(mesh):
        engine = ServingEngine(pipe, max_batch_size=2, max_wait_ms=2000.0,
                               device_batch_size=2, mesh=mesh)
        try:
            kw = mesh_request(np, config, (0, 1))
            futs = [engine.submit("mesh", token_ids=kw["token_ids"][i], seed=i,
                                  num_inference_steps=GATE_STEPS, image_size=512,
                                  sampler="euler", cfg=True) for i in range(2)]
            return np.stack([f.result(timeout=300) for f in futs])
        finally:
            engine.shutdown()

    # (a) one process, a 1x1 mesh
    one = make_mesh()
    two = mesh_request(np, config, (0, 1))
    pipe.generate_batch(["mesh"] * 2, **two)  # warm-up
    batch2, c_plain = counted_run(lambda: pipe.generate_batch(["mesh"] * 2, **two))
    got, c_mesh = counted_run(lambda: pipe.generate_batch(["mesh"] * 2, mesh=one, **two))
    served, c_served = counted_run(lambda: serve(None))
    served_mesh, c_served_mesh = counted_run(lambda: serve(one))
    report = health_check(one)
    ok = (np.array_equal(got, batch2) and c_mesh == c_plain
          and np.array_equal(served_mesh, served) and c_served_mesh == c_served
          and report["ok"])
    log(f"mesh (a) 1x1: generate_batch(mesh=) == no mesh bitwise "
        f"{np.array_equal(got, batch2)}, launches {c_mesh} == {c_plain}; ServingEngine(mesh=) "
        f"== no mesh bitwise {np.array_equal(served_mesh, served)}, launches "
        f"{c_served_mesh} == {c_served}; health_check(mesh) {report}" + (" ok" if ok else " FAIL"))
    if not ok:
        raise AssertionError("a 1x1 mesh changed the images or the launches")
    out["one_rank"] = {"launches": c_mesh, "engine_launches": c_served_mesh,
                       "health_check": report}

    # the one-process yardsticks of (b): each request alone at batch 1, and
    # request 0 with kernel G
    solo, c_solo = zip(*[counted_run(lambda i=i: pipe.generate_batch(
        ["mesh"], **mesh_request(np, config, (i,))), f"solo{i}_s") for i in (0, 1)])
    attn_mod._PACKED_OUT_PROJ = True
    try:
        pipe.generate_batch(["mesh"], **mesh_request(np, config, (0,)))  # warm-up
        solo_pk, c_solo_pk = counted_run(lambda: pipe.generate_batch(
            ["mesh"], **mesh_request(np, config, (0,))), "solo_packed_s")
    finally:
        attn_mod._PACKED_OUT_PROJ = False

    # (b) two gloo processes on card 0
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "mesh")
    os.makedirs(root, exist_ok=True)
    tree_path = os.path.join(root, "tree.safetensors")
    try:
        t0 = time.perf_counter()
        out["tree_bytes"] = save_converted(pipe.params, tree_path)
        out["save_converted_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_ranks([sys.executable, os.path.abspath(__file__), "--mesh-worker", tree_path, root],
                  2, timeout=600)
        out["ranks_s"] = time.perf_counter() - t0
        reps, imgs = [], []
        for r in range(2):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                reps.append(json.load(f))
            with np.load(os.path.join(root, f"rank{r}.npz")) as z:
                imgs.append({k: z[k] for k in z.files})
    finally:
        for name in os.listdir(root):
            os.remove(os.path.join(root, name))
        os.rmdir(root)
    log(f"mesh (b): gloo on CUDA tensors (torch {torch.__version__}): {reps[0]['collectives']}; "
        f"one process, a request alone {out['solo0_s']:.3f}, {out['solo1_s']:.3f} s, packed "
        f"{out['solo_packed_s']:.3f} s; the ranks' processes {out['ranks_s']:.1f} s")
    refused = [k for k, v in reps[0]["collectives"].items() if v != "ok"]
    if refused:
        raise AssertionError(f"gloo refused collectives the mesh layer uses: {refused}")

    def envelope(label, got, want):
        gap = row_gap(want, got)
        ok = gap["max_level_diff"] <= 1 and gap["mismatched_frac"] <= 0.03
        log(f"mesh {label}: {gap['mismatched_pixels']} values differ "
            f"({gap['mismatched_frac']:.4%}), max level diff {gap['max_level_diff']} "
            "(envelope <= 1 level on <= 3%)" + (" ok" if ok else " FAIL"))
        if not ok:
            raise AssertionError(f"mesh {label}: outside the batch-invariance envelope")
        return gap

    def main3(c):
        return {k: c.get(k, 0) for k in ("conv3x3_slab", "conv3x3_slab_upsample",
                                         "flash_attention")}

    checks = []
    for r in range(2):
        dp = imgs[r]["dp"]
        bitwise = all(np.array_equal(dp[i:i + 1], solo[i]) for i in (0, 1))
        same = np.array_equal(dp, imgs[0]["dp"])
        checks.append(bitwise and same and main3(reps[r]["dp"]["launches"]) == main3(c_solo[0]))
        log(f"mesh (b) dp=2 rank {r}: rows == solo batch-1 rows bitwise {bitwise}, == rank 0's "
            f"{same}; A/B/C {main3(reps[r]['dp']['launches'])} vs solo {main3(c_solo[0])}; "
            f"{reps[r]['dp']['seconds']:.3f} s")
    out["dp_vs_batch2"] = [envelope(f"dp=2 row {i} vs the one-process batch of 2",
                                    imgs[0]["dp"][i:i + 1], batch2[i:i + 1]) for i in (0, 1)]
    out["tp_vs_solo"] = envelope("tp=2 vs one process", imgs[0]["tp"], solo[0])
    out["tp_packed_vs_solo"] = envelope("tp=2 packed vs one process packed",
                                        imgs[0]["tp_packed"], solo_pk)
    for r in range(2):
        for label, want in (("tp", c_solo[0]), ("tp_packed", c_solo_pk)):
            got_c = reps[r][label]["launches"]
            flash = reps[r][label]["flash_calls"]
            unet_heads = {q[1] for q, _, _ in flash if q[3] != 512}
            vae = [q for q, _, _ in flash if q[3] == 512]
            ab_ok = main3(got_c) == main3(want) and got_c.get(
                "out_proj_packed", 0) == want.get("out_proj_packed", 0)
            ok = (ab_ok and unet_heads == {heads // 2} and vae and all(q[1] == 1 for q in vae)
                  and np.array_equal(imgs[r][label], imgs[0][label]))
            checks.append(ok)
            log(f"mesh (b) {label} rank {r}: C on {sorted(unet_heads)} of {heads} heads in the "
                f"UNet, the VAE's single head gathered (q {vae[0] if vae else None}); A/B/C/G "
                f"{main3(got_c)} G {got_c.get('out_proj_packed', 0)} vs one process "
                f"{main3(want)} G {want.get('out_proj_packed', 0)}; "
                f"{reps[r][label]['seconds']:.3f} s" + (" ok" if ok else " FAIL"))
    log(f"mesh (b) rank 0: C and G (no bias, a zero residual, as tp launches it) at the "
        f"shards' call shapes vs plain: max_abs_err "
        f"{reps[0]['flash_attention_err']:.4g} / {reps[0]['out_proj_packed_err']:.4g}")
    if not all(checks):
        raise AssertionError("mesh (b): rows, heads or launches are off")
    out["ranks"] = reps
    out["solo_launches"] = c_solo[0]
    out["solo_packed_launches"] = c_solo_pk
    out["mesh_launches"] = {k: {"1x1": c_mesh.get(k, 0),
                                **{f"{label}_rank{r}": reps[r][label]["launches"].get(k, 0)
                                   for label in ("dp", "tp", "tp_packed") for r in range(2)}}
                            for k in MESH_KERNELS}
    return out


# ----------------------------------- fidelity and the presets no card ran --

FID_STEPS = 25             # check_int8's pipeline gate at tiny-sd (the tool's default)
XL_STEPS = 10              # the SDXL int8, sdxl-inpaint and SDXL ControlNet images (cut from 25)
# A/B/C per UNet step, read from the configs (the recorded calls decide):
# sd21 has sd15's topology (22 resnets, 3 upsamplers, 16 transformer blocks)
# at head dim 64, but at 768x768 its deepest level's map is 12 x 12, no
# multiple of 8, so that level's 7 resnets (down 2, mid 2, up 3) take the
# op path, not the slab; an SDXL ControlNet's encoder copy 8 resnets and
# 4 + 20 + 10 transformer blocks
SD21_STEP = {"conv3x3_slab": 30, "conv3x3_slab_upsample": 3, "flash_attention": 16}
XL_CN_STEP = {"conv3x3_slab": 16, "conv3x3_slab_upsample": 0, "flash_attention": 34}


def gate_values(values, gates):
    """Each ``(name, gate, "lt"|"gt")`` of ``gates`` held on ``values``
    (``tools.verdict``): logs them and fails on any that does not hold."""
    from sdtpu_torch.tools import verdict

    res = verdict(values, gates, 4, {})
    log("  " + ", ".join(f"{name} {values[name]:.4f} ({'<' if d == 'lt' else '>'} {gate})"
                         for name, gate, d in gates) + (" ok" if res["pass"] else " FAIL"))
    if not res["pass"]:
        raise AssertionError(f"gates failed: {res}")


def same_shapes(a, b) -> bool:
    """The same dict/list structure with the same shapes and dtypes."""
    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a) == sorted(b) and all(
            same_shapes(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(same_shapes, a, b))
    return tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype


def unet_resnets(params) -> int:
    """The UNet's resnets, each two slab convs a step."""
    n = sum(len(b["resnets"]) for b in params.get("down_blocks", []) + params["up_blocks"])
    return n + (len(params["mid_block"]["resnets"]) if "mid_block" in params else 0)


def fidelity_phase(torch, np, gen, xl_params, xl_held, int8_held, launch_counts,
                   reset_launch_counts):
    """Phase 20: ``device_precision`` and ``check_int8`` at tiny-sd 512x512
    through the ported tools' functions, gated; ``sd21`` at 768x768;
    ``sdxl`` in int8 (kernel D at SDXL's shapes, ``check_int8``'s gates 2b
    and 3, gate 2 measured); ``sdxl-inpaint`` and one ControlNet at 1024x1024 on phase
    16's tree (``xl_params``).  Every request's launches held to its
    recorded calls, every new A/B/C call configuration (beyond
    ``xl_held``) and D call configuration (beyond phase 8's ``int8_held``)
    held to its plain version."""
    from sdtpu_torch import StableDiffusionPipeline
    from sdtpu_torch.config import get_preset
    from sdtpu_torch.models.controlnet import (
        controlnet_cond_embed,
        controlnet_forward,
        init_cond_embedding,
        init_controlnet,
    )
    from sdtpu_torch.models.unet import unet_forward
    from sdtpu_torch.ops import init_conv2d
    from sdtpu_torch.tools import check_int8, device_precision
    from sdtpu_torch.tools import no_tf32
    from sdtpu_torch.utils import hostrng

    out = {"shapes_held": {}}
    t_phase = time.perf_counter()
    cuda = torch.device("cuda")
    held = set(xl_held)

    # (a) device_precision at tiny-sd 512x512: bf16 through A/B/C against
    # float32 on the library route, per stage
    t0 = time.perf_counter()
    res = device_precision.run("tiny-sd", 64, cuda)
    out["device_precision"] = dict(res, s=time.perf_counter() - t0)
    log(f"device_precision (tiny-sd, 64x64 latents): {out['device_precision']['s']:.1f} s, "
        f"pass {res['pass']}")
    gate_values(res, device_precision.GATES)
    torch.cuda.empty_cache()

    # (b) check_int8 at tiny-sd 512x512, FID_STEPS steps
    t0 = time.perf_counter()
    res = check_int8.run(check_int8.parse_args(["--steps", str(FID_STEPS)]), cuda)
    out["check_int8"] = dict(res, s=time.perf_counter() - t0)
    log(f"check_int8 (tiny-sd 512x512, {FID_STEPS} steps): {out['check_int8']['s']:.1f} s, "
        f"pass {res['pass']} (control: {res['control_path']})")
    gate_values(res, check_int8.GATES)
    torch.cuda.empty_cache()

    # (c) sd21 at 768x768: v-prediction, head dim 64, the OpenCLIP ViT-H encoder
    t0 = time.perf_counter()
    sd21 = StableDiffusionPipeline.from_random("sd21", seed=0, device="cuda")
    torch.cuda.synchronize()
    fr_s = time.perf_counter() - t0
    ids = np.random.default_rng(20).integers(1, 49408, (2, 77))
    kw = dict(token_ids=ids, num_inference_steps=STEPS, seed=40, image_size=768)
    calls = request_calls(torch, sd21, kw, STEPS)
    predicted = {k: STEPS * v + VAE_DECODE[k] for k, v in SD21_STEP.items()}
    t0 = time.perf_counter()
    sd21.generate(**kw)
    warm_s = time.perf_counter() - t0
    img, sec, counts, peak = held_run(torch, "sd21", lambda: sd21.generate(**kw), calls,
                                      launch_counts, reset_launch_counts, predicted)
    check_image("sd21", img, 768)
    log(f"sd21 (768x768, {STEPS} DDPM steps, v-prediction, CFG 7.5, UNet batch 2): "
        f"from_random {fr_s:.3f} s on the host, warm-up {warm_s:.3f} s, {sec:.4f} s/image, "
        f"peak memory above the tree {peak / 2**30:.3f} GiB")
    out["shapes_held"]["sd21"] = hold_shapes(torch, gen, "sd21 768x768", calls, held)
    ucfg = sd21.config.unet
    lat = torch.randn((2, 96, 96, 4), generator=gen, device="cuda")
    ctx = torch.randn((2, 77, ucfg.cross_attention_dim), generator=gen, device="cuda")
    ts = torch.full((2,), 501.0, device="cuda")
    with torch.inference_mode():
        k_out = unet_forward(lat.bfloat16(), ts, ctx.bfloat16(), sd21.params["unet"],
                             ucfg).float()
        with routed(**plain_routes()):
            p_out = unet_forward(lat.bfloat16(), ts, ctx.bfloat16(), sd21.params["unet"],
                                 ucfg).float()
            f_out = unet_forward(lat, ts, ctx, to_dtype(sd21.params["unet"], torch.float32),
                                 ucfg).float()
    out["sd21"] = {"from_random_s": fr_s, "s_per_image": sec, "peak_bytes": peak,
                   "launches": counts, "predicted": predicted,
                   "attention_shapes": sorted([list(q), lk] for q, lk in
                                              calls["flash_attention_packed"]),
                   **judge_rel(torch, "sd21 unet_forward b2 96x96", k_out, p_out, f_out)}
    del sd21, k_out, p_out, f_out
    torch.cuda.empty_cache()

    # (d) sdxl in int8 on the int8 gate's weights (drawn on the card in phase
    # 16's shapes: norm scales ones, biases zeros)
    xcfg = get_preset("sdxl")
    t0 = time.perf_counter()
    gate = card_normal_tree(torch, xl_params, 1234, norms=True)
    qpipe = StableDiffusionPipeline(xcfg, gate, device="cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    qpipe.quantize_int8(transformer=True, vae=True)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    log(f"sdxl int8: the gate's weights drawn on the card in {draw_s:.3f} s; "
        f"quantize_int8(transformer=True, vae=True) {quant_s:.3f} s on the host")
    xids = np.random.default_rng(21).integers(1, 49408, (2, 77))
    qkw = dict(token_ids=xids, num_inference_steps=XL_STEPS, seed=40, image_size=1024)
    qcalls = request_calls(torch, qpipe, qkw, XL_STEPS)
    n_unet, n_vae = unet_resnets(qpipe.params["unet"]), unet_resnets(qpipe.params["vae_decoder"])
    d_expected = 2 * n_unet * XL_STEPS + 2 * n_vae
    img, sec, qcounts, peak = held_run(torch, f"sdxl int8 ({XL_STEPS} steps)",
                                       lambda: qpipe.generate(**qkw), qcalls, launch_counts,
                                       reset_launch_counts)
    check_image("sdxl int8", img, 1024)
    log(f"sdxl int8: {n_unet} UNet resnets x 2 convs x {XL_STEPS} steps + {n_vae} VAE resnets "
        f"x 2 convs = {d_expected} int8 slab convs; launched {qcounts['conv3x3_slab_int8']}; "
        f"{sec:.4f} s/image, peak memory above the trees {peak / 2**30:.3f} GiB")
    if qcounts["conv3x3_slab_int8"] != d_expected or qcounts["conv3x3_slab"] != 0:
        raise AssertionError("sdxl int8: not every resnet conv ran kernel D")
    out["sdxl_int8"] = {"draw_s": draw_s, "quantize_s": quant_s, "s_per_image": sec,
                        "peak_bytes": peak, "launches": qcounts, "d_expected": d_expected,
                        "configs": []}
    # kernel D at every call configuration phase 8 did not run
    for (x_shape, co, _, res, _, stats, quant), n in sorted(qcalls["conv3x3_slab"].items()):
        if not quant or (x_shape, co, res, stats) in int8_held:
            continue
        c = int8_case(torch, gen, x_shape, co, res, stats)
        cost = int8_conv_cost(x_shape, co, res=res, stats=stats)
        b_ms, b_by = bound_ms(cost, PEAK_INT8_OPS)
        desc = f"x={x_shape} co={co} res={int(res)} st={int(stats)} S={c['splits']}"
        log(f"time conv3x3_slab_int8 {desc} x{n}/image: kernel {c['ms']:.4f} ms, plain "
            f"{c['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); float counterparts "
            f"(not the same function): kernel A {c['kernel_A_ms']:.4f} ms, cuDNN bf16 "
            f"{c['cudnn_ms']:.4f} ms")
        out["sdxl_int8"]["configs"].append(
            {"config": desc, "per_image": n, "ms": c["ms"], "plain_ms": c["plain_ms"],
             "bound_ms": b_ms, "bound_by": b_by, "kernel_A_ms": c["kernel_A_ms"],
             "cudnn_ms": c["cudnn_ms"], "max_abs_err": c["err"], "device_ms": c["device"]})
        int8_held.add((x_shape, co, res, stats))
    per_image = {k: sum(r["per_image"] * r[k] for r in out["sdxl_int8"]["configs"])
                 for k in ("ms", "plain_ms", "bound_ms", "kernel_A_ms", "cudnn_ms")}
    log(f"sdxl int8: kernel D over its {len(out['sdxl_int8']['configs'])} new call "
        f"configurations per image: {json.dumps(per_image)}")
    out["sdxl_int8"]["per_image"] = per_image
    # check_int8's gates at SDXL's shapes (UNet b2 128x128 with the
    # add-embedding, a 1024x1024 decode, XL_STEPS-step images) on the tool's
    # own int8 tree: quantize_pipeline_int8 at its defaults (the UNet's
    # convs; gate 3's int8 image keeps the float VAE)
    qparams, tparams = check_int8.quantized(gate), qpipe.params
    del qpipe
    host = np.random.default_rng(1234)
    added = {"text_embeds": torch.randn((2, 1280), generator=gen, device="cuda").bfloat16(),
             "time_ids": torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * 2, device="cuda")}
    state = host.bit_generator.state
    values = {"unet_forward_rel_int8_vs_bf16": check_int8.unet_gate(
        xcfg, gate, qparams, host, latent=128, added_cond=added)}
    # beside gate 2, the same forward's yardsticks: the bf16 kernels against
    # float32 on the library route, the plain route's int8 against its bf16,
    # the transformer=True tree of the image above, and int8 in one part's
    # resnets alone
    host.bit_generator.state = state
    lat = torch.from_numpy(host.standard_normal((2, 128, 128, 4))).to("cuda", torch.bfloat16)
    ctx = torch.from_numpy(host.standard_normal((2, 77, 2048))).to("cuda", torch.bfloat16)
    ts = torch.full((2,), 500.0, device="cuda")

    def fwd(unet, dt=torch.bfloat16, **kw):
        a = {"text_embeds": added["text_embeds"].to(dt), "time_ids": added["time_ids"]}
        with torch.inference_mode():
            return unet_forward(lat.to(dt), ts, ctx.to(dt), unet, xcfg.unet, added_cond=a,
                                **kw).float()

    u16 = fwd(gate["unet"])
    with no_tf32():
        control = rel_l2(torch, u16, fwd(to_dtype(gate["unet"], torch.float32), torch.float32,
                                         attention_impl="xla", conv_impl="xla"))
    with routed(**plain_routes()):
        plain = rel_l2(torch, fwd(qparams["unet"]), fwd(gate["unet"]))
    t_rel = rel_l2(torch, fwd(tparams["unet"]), u16)
    split = {part: rel_l2(torch, fwd(dict(gate["unet"], **{part: qparams["unet"][part]})), u16)
             for part in ("down_blocks", "mid_block", "up_blocks")}
    values["vae_decode_psnr_db_int8_vs_bf16"] = check_int8.vae_gate(xcfg, gate, host,
                                                                    image_size=1024)
    trees = {"bf16": gate, "int8": dict(qparams, vae_decoder=gate["vae_decoder"])}
    del qparams
    p = check_int8.pipeline_gate(xcfg, trees, host, steps=XL_STEPS, image_size=1024,
                                 device=cuda)
    del trees
    values["psnr_margin_db_vs_chaos_control"] = (p["pipeline_psnr_db_int8_vs_bf16"]
                                                 - p["control_psnr_db_bf16_vs_f32"])
    # the served tree (transformer=True, the int8 VAE): its margin, printed
    served = check_int8.pipeline_gate(xcfg, {"bf16": gate, "int8": tparams}, host,
                                      steps=XL_STEPS, image_size=1024, device=cuda)
    del tparams
    served_margin = (served["pipeline_psnr_db_int8_vs_bf16"]
                     - served["control_psnr_db_bf16_vs_f32"])
    log(f"sdxl check_int8 (UNet b2 128x128, 1024x1024 decode, {XL_STEPS}-step images "
        f"{p['seconds']}): pipeline PSNR int8-vs-bf16 {p['pipeline_psnr_db_int8_vs_bf16']:.2f} "
        f"dB, control bf16-vs-f32 {p['control_psnr_db_bf16_vs_f32']:.2f} dB "
        f"({check_int8.CONTROL_PATH})")
    name, gate2, _ = check_int8.GATES[1]
    log(f"sdxl gate 2, measured, not gated (open: PERF.md section 6), the JAX tool's gate "
        f"{gate2}: {name} {values[name]:.4f}; the same forward's bf16 kernels vs float32 "
        f"{control:.4f}, the plain route's int8 vs bf16 {plain:.4f}, transformer=True's int8 "
        f"vs bf16 {t_rel:.4f}; int8 in one part's resnets alone: "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    log(f"sdxl served int8 tree (transformer=True, int8 VAE), {XL_STEPS}-step images "
        f"{served['seconds']}: pipeline PSNR int8-vs-bf16 "
        f"{served['pipeline_psnr_db_int8_vs_bf16']:.2f} dB, control "
        f"{served['control_psnr_db_bf16_vs_f32']:.2f} dB, margin {served_margin:.4f} dB "
        "(printed, not gated: gate 3 holds the tool's own tree)")
    out["sdxl_int8"]["gates"] = dict(values, **{k: p[k] for k in (
        "pipeline_psnr_db_int8_vs_bf16", "control_psnr_db_bf16_vs_f32", "seconds")},
        bf16_vs_f32=control, plain_int8_vs_bf16=plain, transformer_int8_vs_bf16=t_rel,
        int8_in_one_part=split, served_margin_db=served_margin,
        served={k: served[k] for k in ("pipeline_psnr_db_int8_vs_bf16",
                                       "control_psnr_db_bf16_vs_f32", "seconds")})
    gate_values(values, check_int8.GATES[2:])
    del gate
    torch.cuda.empty_cache()

    # (e) sdxl-inpaint: phase 16's tree with a 9-channel conv_in drawn from
    # init_unet's own key for it (= from_random("sdxl-inpaint"), leaf for leaf)
    icfg = get_preset("sdxl-inpaint")
    k_unet = hostrng.split(hostrng.ensure_key(0), 5)[1]
    conv_in = tree_to(init_conv2d(hostrng.split(k_unet, 256)[0], icfg.unet.in_channels,
                                  icfg.unet.block_out_channels[0], 3, dtype=icfg.param_dtype),
                      "cuda")
    inp = StableDiffusionPipeline(icfg, dict(xl_params, unet=dict(xl_params["unet"],
                                                                  conv_in=conv_in)),
                                  device="cuda")
    rng = np.random.default_rng(22)
    init = rng.integers(0, 256, (1024, 1024, 3), dtype=np.uint8)
    mask = np.zeros((1024, 1024), np.uint8)
    mask[:, 512:] = 255
    ikw = dict(token_ids=xids, num_inference_steps=XL_STEPS, seed=40, image_size=1024,
               init_image=init, mask_image=mask, strength=1.0)
    img, sec, counts, expected, icalls, peak = counted(torch, lambda: inp.generate(**ikw),
                                                       launch_counts, reset_launch_counts)
    hold_counts("sdxl-inpaint", counts, expected)
    check_image("sdxl-inpaint", img, 1024)
    log(f"sdxl-inpaint (1024x1024, {XL_STEPS} DDPM steps, strength 1.0, mask, CFG 7.5, UNet "
        f"batch 2, 9 channels): {sec:.4f} s/image, peak memory above the trees "
        f"{peak / 2**30:.3f} GiB")
    out["sdxl-inpaint"] = {"s_per_image": sec, "peak_bytes": peak, "launches": counts}
    out["shapes_held"]["sdxl-inpaint"] = hold_shapes(torch, gen, "sdxl-inpaint", icalls, held)
    del inp, conv_in
    torch.cuda.empty_cache()

    # (f) one ControlNet at 1024x1024: the encoder half is phase 16's UNet
    # leaves (diffusers' ControlNetModel.from_unet), checked key by key
    # against init_controlnet's shapes; the cond embedding drawn from its
    # key, its conv_out and the zero convs drawn on the card
    with hostrng.shapes_only():
        cn_shapes = init_controlnet(1, xcfg.unet, dtype=xcfg.param_dtype)
    copied = [k for k in cn_shapes if k in xl_params["unet"]]
    bad = [k for k in copied if not same_shapes(cn_shapes[k], xl_params["unet"][k])]
    log(f"sdxl controlnet: encoder keys {copied} from the UNet"
        + (f"; shapes differ at {bad} FAIL" if bad else ", shapes and dtypes as init_controlnet's"))
    if bad:
        raise AssertionError(f"the SDXL ControlNet's encoder keys {bad} differ")
    cn = dict(cn_shapes, **{k: xl_params["unet"][k] for k in copied})
    cn["cond_embedding"] = tree_to(init_cond_embedding(
        hostrng.split(hostrng.ensure_key(1))[1], xcfg.unet.block_out_channels[0],
        dtype=xcfg.param_dtype), "cuda")
    cn = nonzero_controlnet(torch, cn, 201)
    xl = StableDiffusionPipeline(xcfg, xl_params, device="cuda").load_controlnet(cn)
    ctrl = rng.integers(0, 256, (1024, 1024, 3), dtype=np.uint8)
    ckw = dict(token_ids=xids, num_inference_steps=XL_STEPS, seed=40, image_size=1024,
               control_image=ctrl)
    predicted = {k: XL_STEPS * (PREDICTED_STEP["sdxl"][k] + XL_CN_STEP[k]) + VAE_DECODE[k]
                 for k in XL_CN_STEP}
    img, sec, counts, expected, ccalls, peak = counted(torch, lambda: xl.generate(**ckw),
                                                       launch_counts, reset_launch_counts)
    hold_counts("sdxl controlnet", counts, expected)
    main_counts = {k: counts[k] for k in predicted}
    log(f"sdxl controlnet A/B/C {main_counts}; predicted from the configs {predicted}: "
        + ("agree" if main_counts == predicted else "DIFFER (the recorded calls decide)"))
    check_image("sdxl controlnet", img, 1024)
    log(f"sdxl controlnet (1024x1024, {XL_STEPS} DDPM steps, CFG 7.5, UNet and ControlNet "
        f"batch 2): {sec:.4f} s/image, peak memory above the trees {peak / 2**30:.3f} GiB")
    out["sdxl controlnet"] = {"s_per_image": sec, "peak_bytes": peak, "launches": counts,
                              "predicted": predicted}
    ucfg = xcfg.unet
    lat = torch.randn((2, 128, 128, 4), generator=gen, device="cuda")
    ctx = torch.randn((2, 77, ucfg.cross_attention_dim), generator=gen, device="cuda")
    cond = torch.rand((2, 1024, 1024, 3), generator=gen, device="cuda")
    ts = torch.full((2,), 501.0, device="cuda")
    added = {"text_embeds": torch.randn((2, 1280), generator=gen, device="cuda"),
             "time_ids": torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * 2, device="cuda")}

    def step(unet, net, dt):
        a = {"text_embeds": added["text_embeds"].to(dt), "time_ids": added["time_ids"]}
        emb = controlnet_cond_embed(cond.to(dt), net["cond_embedding"])
        res = controlnet_forward(lat.to(dt), ts, ctx.to(dt), emb, net, ucfg,
                                 conditioning_scale=0.8, added_cond=a)
        flat = torch.cat([r.float().flatten() for r in res["down"] + [res["mid"]]])
        return flat, unet_forward(lat.to(dt), ts, ctx.to(dt), unet, ucfg, control=res,
                                  added_cond=a).float()

    with torch.inference_mode():
        k_res, k_out = step(xl_params["unet"], cn, torch.bfloat16)
        with routed(**plain_routes()):
            p_res, p_out = step(xl_params["unet"], cn, torch.bfloat16)
            f_res, f_out = step(to_dtype(xl_params["unet"], torch.float32),
                                to_dtype(cn, torch.float32), torch.float32)
    out["sdxl controlnet"]["residuals"] = judge_rel(
        torch, "sdxl controlnet residuals of one step (b2 128x128)", k_res, p_res, f_res)
    out["sdxl controlnet"]["unet_control"] = judge_rel(
        torch, "sdxl unet_forward b2 128x128 with the residuals", k_out, p_out, f_out)
    del k_res, p_res, f_res, k_out, p_out, f_out, xl, cn
    torch.cuda.empty_cache()
    out["shapes_held"]["sdxl controlnet"] = hold_shapes(torch, gen, "sdxl controlnet", ccalls,
                                                        held)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 20: {out['phase_s']:.1f} s; A/B/C call configurations held to their plain "
        f"versions beyond phase 16's: {out['shapes_held']}")
    return out


# ------------------------------------------------------------ last tools --

LAST_TOOL_CHAIN = 2  # phase 21's chains and repeats per timed call


def chain_expected(torch, fn, launch_counts):
    """The launches of one ``fn()`` from its recorded kernel calls
    (:func:`record_calls`, :func:`expected_launches`, G and its split-K
    reductions), the zero counts dropped."""
    calls = record_calls(torch, fn)
    expected = expected_launches(calls, launch_counts)
    expected["out_proj_packed"] = sum(calls["out_proj_packed"].values())
    expected.update(out_proj_sub_counts(calls))
    return Counter({k: n for k, n in expected.items() if n})


def held_tool(torch, mod, argv, expected, launch_counts, reset_launch_counts):
    """``mod.main(argv)`` with the counts zeroed just before it and read just
    after, held to ``expected`` (the calls it returns where None)."""
    tool = mod.__name__.rsplit(".", 1)[1]
    log(f"tool: python -m sdtpu_torch.tools.{tool} {' '.join(argv)}")
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = mod.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {k: n for k, n in launch_counts.items() if n}
    want = {k: n for k, n in (res if expected is None else expected).items() if n}
    log(f"tool {tool}: {secs:.1f} s; launches {counts}, calls of each wrapper {want}"
        + (" ok" if counts == want else " FAIL"))
    if counts != want or not counts:
        raise AssertionError(f"{tool}: launches {counts} != its calls {want}")
    return {"tool": tool, "argv": argv, "s": secs, "launches": counts}


def last_tools_phase(torch, np, gen, host_params, ids, trace_dir, launch_counts,
                     reset_launch_counts, e2e_expected):
    """Phase 21: the last tools' ``main()`` at a chain of LAST_TOOL_CHAIN, each
    one's launches held to its calls (the A/B chains' to one recorded chain
    per variant times its runs); C under every plan it takes at the probes'
    shapes against its plain version; ``CONV_STATS_CHAIN`` off against on
    (a full-width tiny-sd UNet forward and VAE decode through the kernels,
    then one 512x512 image each with its launches)."""
    import importlib

    import sdtpu_torch.kernels.conv2d as conv_kernels
    import sdtpu_torch.kernels.flash_attention as fa
    from sdtpu_torch import StableDiffusionPipeline
    from sdtpu_torch.config import get_preset
    from sdtpu_torch.models.unet import unet_forward
    from sdtpu_torch.models.vae import vae_decode
    from sdtpu_torch.tools import (
        ab_conv_stats,
        ab_flash_nq,
        ab_packed_proj,
        ab_slab_grid,
        ab_unet,
        by_rows,
        probe_flash_blocks,
        probe_flash_int8,
        probe_head_packing,
        probe_out_proj,
        probe_slab_halo,
        swapped,
    )
    from sdtpu_torch.tools.probe_flash_vpu import qkv_inputs

    t_phase = time.perf_counter()
    cuda = torch.device("cuda")
    chain = str(LAST_TOOL_CHAIN)
    out = {"tools": []}

    # (a) the probes, each holding its own variants to their plain versions
    for mod, argv in ((probe_slab_halo, [chain]), (probe_out_proj, [chain]),
                      (probe_flash_blocks, [chain]), (probe_flash_int8, [chain]),
                      (probe_head_packing, ["--chain", chain, "--out", trace_dir]),
                      (ab_slab_grid, [chain])):
        out["tools"].append(held_tool(torch, mod, argv, None, launch_counts,
                                      reset_launch_counts))
        torch.cuda.empty_cache()

    # (b) the A/B chains: one chain of each variant recorded, times its runs
    config = get_preset("tiny-sd")
    with torch.inference_mode():
        unet_fn = ab_conv_stats.unet_case("tiny-sd", 512, LAST_TOOL_CHAIN, cuda)
        vae_fn = ab_conv_stats.vae_case(512, LAST_TOOL_CHAIN, cuda)
        plain_fn = ab_unet.make_chain(config, *ab_unet.chain_inputs(config, 512, cuda),
                                      attn="flash", conv="gemm", hoist=False,
                                      chain=LAST_TOOL_CHAIN)

        def ab_expected(fn, wrap, runs):
            total = Counter()
            for on in (False, True):
                total.update(chain_expected(torch, wrap(fn, on), launch_counts))
            return Counter({k: n * runs for k, n in total.items()})

        runs = 1 + ab_conv_stats.REPEATS
        nq_names = ["plan", "bq=64", "bq=128", "plan"]
        nq_expected = Counter()
        for name in nq_names:
            with swapped(fa, "plan_flash", ab_flash_nq.plan_rule(name, fa.plan_flash)):
                one = chain_expected(torch, plain_fn, launch_counts)
            nq_expected.update({k: n * (1 + ab_flash_nq.TIMED) for k, n in one.items()})
        cases = ((ab_conv_stats, ["tiny-sd", "512", chain],
                  ab_expected(unet_fn, ab_conv_stats.with_chaining, runs)),
                 (ab_conv_stats, ["--vae", "512", chain],
                  ab_expected(vae_fn, ab_conv_stats.with_chaining, runs)),
                 (ab_packed_proj, ["tiny-sd", "512", chain],
                  ab_expected(unet_fn, ab_packed_proj.with_packed,
                              1 + ab_packed_proj.REPEATS)),
                 (ab_flash_nq, ["tiny-sd", "512", chain] + nq_names, nq_expected))
        del unet_fn, vae_fn, plain_fn
    for mod, argv, expected in cases:
        out["tools"].append(held_tool(torch, mod, argv, expected, launch_counts,
                                      reset_launch_counts))
    if importlib.import_module("sdtpu_torch.ops.attention")._PACKED_OUT_PROJ \
            or not conv_kernels.CONV_STATS_CHAIN or fa.plan_flash.__name__ != "plan_flash":
        raise AssertionError("a tool left its switch or plan swapped")
    tools_s = time.perf_counter() - t_phase

    # (c) C under every plan it takes at the probes' shapes, against its plain version
    shapes = [(b, h, l, d, l) for _, b, h, l, d in probe_flash_blocks.SHAPES]
    shapes += [(b, h, l, d, l) for _, b, h, l, d in probe_flash_int8.SHAPES]
    for _, b, h, l, d, g in probe_head_packing.CASES:
        shapes += [(b, h, l, d, l), (b, h // g, l, g * d, g * l)]
    plans_held = 0
    for b, h, l, d, lk in shapes:
        q, _, _ = qkv_inputs(b, h, l, d)
        k, v, _ = qkv_inputs(b, h, lk, d, seed=1)
        want = by_rows(fa.flash_attention_plain, q, k, v)
        for plan in fa.flash_plans(b * h, l, lk, d):
            with swapped(fa, "plan_flash", lambda *_, p=plan: p):
                judge_probe(torch, "flash_attention", f"plan {plan} q={(b, h, l, d)} lk={lk}",
                            fa.flash_attention_packed(q, k, v), want)
            plans_held += 1
        del q, k, v, want
        torch.cuda.empty_cache()
    checks_s = time.perf_counter() - t_phase - tools_s

    # (d) CONV_STATS_CHAIN off against on at full width: one UNet forward and
    # one VAE decode through the kernels, beside the plain route's
    # bf16-vs-f32 difference (phase 4's rule); then one image each
    params = tree_to(host_params, "cuda")
    lat = torch.randn((2, 64, 64, 4), generator=gen, device="cuda")
    ctx = torch.randn((2, 77, 768), generator=gen, device="cuda")
    ts = torch.full((2,), 501.0, device="cuda")
    dec_in = torch.randn((1, 64, 64, 4), generator=gen, device="cuda")

    def both(p, dt):
        return (unet_forward(lat.to(dt), ts, ctx.to(dt), p["unet"], config.unet).float(),
                vae_decode(dec_in.to(dt), p["vae_decoder"], config.vae).float())

    res = {}
    with torch.inference_mode():
        outs = {}
        for on in (False, True):
            with swapped(conv_kernels, "CONV_STATS_CHAIN", on):
                outs[on] = both(params, torch.bfloat16)
        with routed(**plain_routes()):
            p16 = both(params, torch.bfloat16)
            p32 = both({k: to_dtype(params[k], torch.float32) for k in ("unet", "vae_decoder")},
                       torch.float32)
    for i, what in enumerate(("unet_forward", "vae_decode")):
        d_oo = rel_l2(torch, outs[False][i], outs[True][i])
        d_pf = rel_l2(torch, p16[i], p32[i])
        finite = bool(torch.isfinite(outs[False][i]).all())
        ok = finite and d_oo <= max(2.0 * d_pf, 1e-2)
        log(f"conv stats chain off vs on, {what} (kernels, bf16): rel L2 {d_oo:.4g}; plain "
            f"bf16-vs-f32 {d_pf:.4g}; finite {finite}; tol max(2x bf16-vs-f32, 1e-2)"
            + (" ok" if ok else " FAIL"))
        res[what] = {"off_vs_on": d_oo, "plain_bf16_vs_f32": d_pf}
        if not ok:
            raise AssertionError(f"CONV_STATS_CHAIN off moves the {what} beyond the bf16 yardstick")
    del outs, p16, p32
    pipe = StableDiffusionPipeline(config, params, device="cuda")
    images = {}
    for on in (False, True):
        with swapped(conv_kernels, "CONV_STATS_CHAIN", on):
            counts, e2e = run_image(torch, np, pipe, ids,
                                    f"conv stats chain {'on' if on else 'off'}", launch_counts,
                                    reset_launch_counts)
        images["on" if on else "off"] = e2e
        if counts != e2e_expected:
            raise AssertionError(f"CONV_STATS_CHAIN={on}: launches {counts} != {e2e_expected}")
    log(f"conv stats chain: s/image off {images['off']['s_per_image']:.4f}, on "
        f"{images['on']['s_per_image']:.4f}; launches equal (the bf16 image's); the two "
        "images are not compared (a rounding change moves the seed-0 image by levels)")
    res["images"] = images
    del pipe, params
    torch.cuda.empty_cache()
    out.update(conv_stats=res, plans_held=plans_held, tools_s=tools_s, checks_s=checks_s,
               phase_s=time.perf_counter() - t_phase)
    log(f"phase 21: {out['phase_s']:.1f} s (tools {tools_s:.1f} s, {plans_held} plan checks "
        f"{checks_s:.1f} s, conv stats chain {out['phase_s'] - tools_s - checks_s:.1f} s)")
    return out


CAPTURE_IDLE_TOL = 0.1  # capture_trace's idle share against the bf16 image's, absolute


def stages_phase(torch, pipe, ids, trace_dir):
    """``tools/profile_stages`` at tiny-sd 512; one profiler trace of a warm
    bf16 image split into device-busy and idle time by stage (and, for
    comparison, the library route's image summarised the same way), each
    read back from its ``trace.json`` by ``tools/summarize_trace``; the
    StageTimer split of the same request; then ``tools/capture_trace``'s
    trace of the bench's workload (2 pipelined images) summarized and split
    the same way, its categories those of the bf16 image and its idle share
    within ``CAPTURE_IDLE_TOL`` of it."""
    from sdtpu_torch import StableDiffusionPipeline
    from sdtpu_torch.tools import capture_trace, profile_stages, summarize_trace
    from sdtpu_torch.utils import profiling

    t_phase = time.perf_counter()
    out = {"profile_stages": profile_stages.main(["tiny-sd", "512", "--steps", str(STEPS),
                                                  "--n", "5"])}
    kw = dict(token_ids=ids, num_inference_steps=STEPS, seed=40, image_size=512)
    lib = StableDiffusionPipeline(pipe.config.replace(attention_impl="xla", conv_impl="xla"),
                                  pipe.params, device="cuda")
    for route, p in (("library", lib), ("bf16", pipe)):
        p.generate(**kw)
        torch.cuda.synchronize()
        with profiling.trace(f"{trace_dir}/{route}"):
            t0 = time.perf_counter()
            p.generate(**kw)
            wall = time.perf_counter() - t0
        split = trace_split(summarize_trace.load_trace(f"{trace_dir}/{route}"), wall)
        out[f"trace_{route}"] = split
        log(f"trace of one {route} image ({trace_dir}/{route}/trace.json): wall "
            f"{split['wall_ms']:.1f} ms, window {split['window_ms']:.1f} ms, device busy "
            f"{split['device_busy_ms']:.1f} ms (union of {split['device_events']} device "
            f"activities), idle share {split['idle_share']:.4f}")
        log(f"trace {route} device ms by kind: " + ", ".join(
            f"{k} {v['ms']:.1f} (x{v['count']})" for k, v in split["device_ms_by_kind"].items()))
    log("trace host stage ms: " + ", ".join(f"{n} {v:.1f}"
                                            for n, v in split["host_stage_ms"].items()))
    for op in split["top_device_ops"]:
        log(f"trace device op {op['total_ms']:9.3f} ms x{op['count']:5d} {op['name'][:110]}")
    for g in split["longest_idle_gaps"]:
        log(f"trace idle gap {g['ms']:8.3f} ms at +{g['at_ms']:.1f} ms, host in {g['stage']}")
    timer = profiling.StageTimer()
    with timer.record():
        pipe.generate(**kw)
    log("StageTimer (each stage ended by a device sync):\n" + timer.report())
    out["stage_timer_ms"] = {k: v * 1e3 for k, v in timer.totals.items()}
    out["phase_s_before_capture"] = time.perf_counter() - t_phase

    # capture_trace at tiny-sd 512 with 1 repeat (2 pipelined images), then
    # summarize_trace on its stored file: the unet_step window's self time
    # and the split of the whole trace
    t0 = time.perf_counter()
    argv = ["--preset", "tiny-sd", "--image-size", "512", "--repeats", "1",
            "--out", f"{trace_dir}/capture"]
    log(f"tool: python -m sdtpu_torch.tools.capture_trace {' '.join(argv)}")
    path = capture_trace.main(argv)
    capture_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    events = summarize_trace.load_trace(path)
    res = summarize_trace.summarize(events, top=10, steps=2 * STEPS)
    cap = trace_split(events, 0.0)
    summary_s = time.perf_counter() - t0
    bf16 = out["trace_bf16"]
    d_idle = abs(cap["idle_share"] - bf16["idle_share"])
    same = set(cap["device_ms_by_kind"]) == set(bf16["device_ms_by_kind"])
    log(f"capture_trace: {capture_s:.1f} s; summarize_trace {summary_s:.1f} s; the unet_step "
        f"window's device self ms {sum(res['device'][0].values()):.1f} and host self ms "
        f"{sum(res['host'][0].values()):.1f} over {res['spans']} steps")
    log(f"capture_trace split: window {cap['window_ms']:.1f} ms, device busy "
        f"{cap['device_busy_ms']:.1f} ms ({cap['device_events']} device activities), idle share "
        f"{cap['idle_share']:.4f} against the bf16 image's {bf16['idle_share']:.4f} (|delta| "
        f"{d_idle:.4f}, tol {CAPTURE_IDLE_TOL}); device ms by kind: " + ", ".join(
            f"{k} {v['ms']:.1f} (x{v['count']})" for k, v in cap["device_ms_by_kind"].items())
        + f"; the bf16 image's kinds: {same}" + (" ok" if same and d_idle <= CAPTURE_IDLE_TOL
                                                  else " FAIL"))
    if not same or d_idle > CAPTURE_IDLE_TOL or res["spans"] != 2 * STEPS:
        raise AssertionError("capture_trace's split is not the bf16 image's")
    out["capture"] = {"split": cap, "s": capture_s, "summary_s": summary_s,
                      "window_device_ms": sum(res["device"][0].values()),
                      "window_host_ms": sum(res["host"][0].values()),
                      "device_by_kind": res["device_by_kind"]}
    out["capture_phase_s"] = capture_s + summary_s
    log(f"phase 13: capture_trace and summarize_trace {out['capture_phase_s']:.1f} s")
    return out


if __name__ == "__main__":
    sys.exit(main())
