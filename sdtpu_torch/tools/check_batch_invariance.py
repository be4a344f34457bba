"""Batch-invariance gate of the serving path, the counterpart of the JAX
package's ``tools/check_batch_invariance.py``::

    python -m sdtpu_torch.tools.check_batch_invariance [--preset tiny-sd] [--steps 4]
        [--batch 8] [--image-size 512] [--sampler euler] [--rows 0 3 7]
        [--max-level 1] [--max-frac 0.03] [--bitwise] [--device cuda]

The serving engine promises that a request's image does not depend on the
batch it ran in: per-request keys and per-row uncond rows make the math
row-independent.  What remains is the device's numerics: on a card the
slab conv's split-K plan (``plan_conv3x3_split``) and the libraries'
kernels depend on the batch, so a batched row may differ from its solo run
by rounding.  The gate passes while the drift stays inside the JAX tool's
envelope:

    PASS  <=>  max |level diff| <= --max-level  AND
               mismatched fraction <= --max-frac, per row

``--bitwise`` makes it strict.  The preset runs at full width with
random weights (0.04 x standard normals drawn by numpy from seed 1234 in
the JAX tool's leaf order; zeros would hide the numerics under test): one
``generate_batch`` of ``--batch`` rows with per-request seeds, then each
``--rows`` row alone with its seed; the uint8 images are compared.  Prints
one JSON line; exits 0 when within the threshold.  On the card by default
(it exits non-zero without one); ``--device cpu`` is for the tests.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="tiny-sd")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--sampler", default="euler")
    ap.add_argument("--rows", type=int, nargs="*", default=[0, 3, 7],
                    help="which batch rows to run again alone")
    ap.add_argument("--max-level", type=int, default=1,
                    help="PASS threshold: max |uint8 level diff| per value")
    ap.add_argument("--max-frac", type=float, default=0.03,
                    help="PASS threshold: max fraction of differing values")
    ap.add_argument("--bitwise", action="store_true", help="strict: any mismatch fails")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def normal_tree(shapes, rng, device, scale: float = 0.04):
    """``scale`` x standard normals of each leaf's shape, drawn in float32
    by ``rng`` in the order jax's tree functions visit the leaves (dict
    keys sorted), rounded to the leaf's dtype, then scaled in it."""
    import numpy as np
    import torch

    from sdtpu_torch.tools import map_jax_order

    def draw(_, s):
        d = torch.from_numpy(rng.standard_normal(tuple(s.shape), dtype=np.float32))
        return d.to(device).to(s.dtype) * scale

    return map_jax_order(draw, shapes)


def row_gap(solo, batched) -> dict:
    """The uint8 values that differ between a row's solo and batched
    images: their count, their share, the largest level difference."""
    import numpy as np

    diff = int((solo != batched).sum())
    worst = int(np.abs(solo.astype(np.int32) - batched.astype(np.int32)).max())
    return {"mismatched_pixels": diff, "mismatched_frac": diff / solo.size,
            "max_level_diff": worst}


def gate_pipeline(preset: str, device):
    """The gate's pipeline: ``preset`` at full width with :func:`normal_tree`
    weights from numpy seed 1234 (the JAX tool's)."""
    import numpy as np

    from sdtpu_torch.config import get_preset
    from sdtpu_torch.pipeline.pipeline import StableDiffusionPipeline
    from sdtpu_torch.tools import shapes_tree

    config = get_preset(preset)
    return StableDiffusionPipeline(config, normal_tree(shapes_tree(config),
                                                       np.random.default_rng(1234), device),
                                   device=device)


def run_gate(pipe, args) -> dict:
    """One batch of ``args.batch`` rows, then each of ``args.rows`` alone,
    through ``pipe``; prints the JSON line and returns it as a dict."""
    import numpy as np
    import torch

    config = pipe.config
    rng = np.random.default_rng(7)
    ids = rng.integers(1, config.clip.vocab_size, (args.batch, config.clip.max_length))
    seeds = list(range(100, 100 + args.batch))
    kw = dict(num_inference_steps=args.steps, image_size=args.image_size,
              sampler=args.sampler, cfg=True)
    t0 = time.perf_counter()
    coalesced = pipe.generate_batch(["bench"] * args.batch, token_ids=ids, seeds=seeds, **kw)
    print(f"coalesced batch in {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    max_level, max_frac = (0, 0.0) if args.bitwise else (args.max_level, args.max_frac)
    rows = []
    for r in args.rows:
        solo = pipe.generate_batch(["bench"], token_ids=ids[r:r + 1], seeds=[seeds[r]], **kw)
        gap = row_gap(solo[0], coalesced[r])
        ok = gap["max_level_diff"] <= max_level and gap["mismatched_frac"] <= max_frac
        rows.append({"row": r, **gap, "mismatched_frac": round(gap["mismatched_frac"], 5),
                     "pass": ok})
        print(f"row {r}: {gap['mismatched_pixels']} mismatched uint8 values "
              f"({gap['mismatched_frac']:.2%}, max level diff {gap['max_level_diff']}) -> "
              f"{'PASS' if ok else 'FAIL'}", file=sys.stderr)
    device = pipe.device
    result = {
        "check": "serving batch-invariance (solo vs coalesced, thresholded)",
        "preset": args.preset, "steps": args.steps, "batch": args.batch,
        "size": args.image_size, "sampler": args.sampler,
        "backend": device.type,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "max_level_gate": max_level, "max_frac_gate": max_frac, "rows": rows,
        "bitwise_identical": all(m["mismatched_pixels"] == 0 for m in rows),
        "pass": all(m["pass"] for m in rows),
    }
    print(json.dumps(result))
    return result


def main(argv=None) -> dict:
    """Run the gate; prints the JSON line and returns it as a dict."""
    args = parse_args(argv)

    import torch

    from sdtpu_torch.tools import require_cuda

    device = torch.device(args.device)
    if device.type == "cuda":
        require_cuda("check_batch_invariance")
    t0 = time.perf_counter()
    pipe = gate_pipeline(args.preset, device)
    print(f"params in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    return run_gate(pipe, args)


if __name__ == "__main__":
    sys.exit(0 if main()["pass"] else 1)
