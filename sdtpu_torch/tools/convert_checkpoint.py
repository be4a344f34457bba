"""Convert a local diffusers-layout checkpoint directory into the port's
converted-tree cache, once; later loads (``utils/weights.py:load_converted``)
skip the state-dict mapping.

Counterpart of ``tools/convert_checkpoint.py`` (which writes an orbax
cache): the tree is loaded by ``load_pipeline_params`` for ``--preset`` in
``--dtype`` and written by ``save_converted`` as one safetensors file.
Offline; runs on the card unless ``--device cpu`` is given::

    python -m sdtpu_torch.tools.convert_checkpoint /path/to/segmind-tiny-sd \\
        --preset tiny-sd --out /path/to/cache.safetensors [--dtype bf16] [--device cpu]

It exits non-zero when asked for ``cuda`` on a machine without a card.
"""

from __future__ import annotations

import argparse
import sys

import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model_dir")
    ap.add_argument("--preset", default="tiny-sd")
    ap.add_argument("--out", required=True)
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("convert_checkpoint: --device cuda, but torch.cuda.is_available() is False",
              file=sys.stderr)
        raise SystemExit(2)

    from sdtpu_torch.config import get_preset
    from sdtpu_torch.utils.weights import load_pipeline_params, save_converted

    config = get_preset(args.preset)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    params = load_pipeline_params(args.model_dir, config, dtype=dtype, device=args.device)
    nbytes = save_converted(params, args.out)
    print(f"converted {args.model_dir} ({args.preset}, {args.dtype}) -> {args.out} "
          f"({nbytes} bytes)")
    return {"out": args.out, "bytes": nbytes}


if __name__ == "__main__":
    main()
