"""An N x M grid of samples for qualitative comparison, seeds across the
columns and prompts down the rows: the counterpart of the JAX package's
``tools/generate_grid.py``, the evaluation workflow for real checkpoints::

    python -m sdtpu_torch.tools.generate_grid --model-dir /path/to/tiny-sd \\
        --prompts "a cat" "a dog" --seeds 0 1 2 3 --steps 25 --out grid.png [--device cuda]

``--model-dir`` is loaded by ``StableDiffusionPipeline.from_pretrained(dir,
preset=, device=)``; without it the preset's ``from_random`` weights are
used (seed 0: structured noise).  Each prompt is one ``generate_batch`` of
``len(seeds)`` rows with the seeds (``--sampler``, default ``dpm++``,
``--cfg-scale``, ``--image-size``), so that each tile is that seed's row of
the batch; the grid is written by ``utils/image.save_png``.  A pipeline
without a tokenizer takes the JAX tool's token ids: uniform draws from
``np.random.default_rng(abs(hash(prompt)) % 2**32)``.  Python salts
``hash`` of a ``str`` per process (``PYTHONHASHSEED``), so those ids, and
the grid, differ from process to process unless ``PYTHONHASHSEED`` is
fixed; the port reproduces this (ROADMAP Queue C).  On the CPU pass
``--device cpu``; without a card ``--device cuda`` exits non-zero.
``main()`` returns the grid, (rows x H, columns x W, 3) uint8.
"""

from __future__ import annotations

import argparse


def prompt_ids(prompt: str, vocab_size: int, max_length: int, rows: int):
    """The JAX tool's ids for a pipeline without a tokenizer: one row of
    ``max_length`` draws from ``[0, vocab_size)`` seeded by the prompt's
    (per-process salted) ``hash``, tiled to ``rows`` rows."""
    import numpy as np

    rng = np.random.default_rng(abs(hash(prompt)) % 2**32)
    return np.tile(rng.integers(0, vocab_size, (1, max_length)), (rows, 1))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model-dir", default=None)
    ap.add_argument("--preset", default="tiny-sd")
    ap.add_argument("--prompts", nargs="+", default=["a cat flying a spaceship"])
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2, 3])
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--sampler", default="dpm++")
    ap.add_argument("--cfg-scale", type=float, default=7.5)
    ap.add_argument("--out", default="grid.png")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np

    from sdtpu_torch import StableDiffusionPipeline
    from sdtpu_torch.tools import card_line, device_arg
    from sdtpu_torch.utils.image import save_png

    device = device_arg("generate_grid", args.device)
    if device.type == "cuda":
        print(card_line(), flush=True)
    if args.model_dir:
        pipe = StableDiffusionPipeline.from_pretrained(args.model_dir, preset=args.preset,
                                                       device=device)
    else:
        print("no --model-dir: random weights (structured noise output)", flush=True)
        pipe = StableDiffusionPipeline.from_random(args.preset, device=device)

    rows = []
    for prompt in args.prompts:
        token_ids = None
        if pipe.tokenizer is None:
            clip = pipe.config.clip
            token_ids = prompt_ids(prompt, clip.vocab_size, clip.max_length, len(args.seeds))
        imgs = pipe.generate_batch(
            [prompt] * len(args.seeds), seeds=args.seeds, num_inference_steps=args.steps,
            image_size=args.image_size, sampler=args.sampler, cfg_scale=args.cfg_scale,
            token_ids=token_ids)
        rows.append(np.concatenate(list(imgs), axis=1))  # seeds across the columns
    grid = np.concatenate(rows, axis=0)  # prompts down the rows
    save_png(grid, args.out)
    print(f"wrote {args.out}: {len(args.prompts)}x{len(args.seeds)} grid "
          f"({grid.shape[1]}x{grid.shape[0]})", flush=True)
    return grid


if __name__ == "__main__":
    main()
