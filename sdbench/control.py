"""The readings a cell's correctness limits are set from, in one process:

    python -m sdbench.control --workload NAME --seeds 12 --control-seeds 3 --seconds 6

For each seed, as a run does at the cell's own load (a shorter window):
weights from the seed, the warm-up, the window, the seed's sample of the
finished requests and the float32 reference's images of them; the
program's readings (``check.READINGS``, each at the sample's worst image).
On the first ``--control-seeds`` seeds, the same requests give the
controls' readings against the same reference images: the program's own
int8 path (``quantize_int8(transformer=True, vae=True)``, sent through the
kind's entry again; ``int8``) and the reference computed with fp8 operands
(``fp8``).  One JSON line per seed, then a summary line: per number, the
program's largest reading and each control's least; a limit lies above
the one and below the other.  Needs a card.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

from sdbench import spec


def seed_readings(cell, seed: int, seconds: float, control: bool, device="cuda") -> dict:
    import torch

    from sdbench import check, drive, traffic
    from sdbench.trace import Tracer
    from sdbench.weights import pipeline_params
    from sdtpu_torch import StableDiffusionPipeline

    cfg, mix = cell.config, cell.traffic
    kind = traffic.kind(mix)
    pconfig = spec.pipeline_config(cfg)
    params = pipeline_params(pconfig, seed, device)
    pipe = StableDiffusionPipeline(pconfig, params, device=device)
    inputs = drive.Inputs(seed, mix, cfg)
    kind.warm(pipe, cfg, mix, inputs)
    window = kind.run(pipe, cfg, mix, inputs, seconds, Tracer(False))
    recs = check.sample(window.records, seed, cell.check["sample"])
    refs = check.references(recs, params, cfg, per_row=kind.PER_ROW, device=device)
    names = check.READINGS
    out = {"seed": seed, "requests": len(window.records), "sample": len(recs),
           "program": check.readings([r.image for r in recs], refs, names)}
    if control:
        pipe.quantize_int8(transformer=True, vae=True)
        images = kind.call(pipe, cfg, mix, [r.req for r in recs]).cpu().numpy()
        out["int8"] = check.readings(list(images), refs, names)
        fp8 = check.references(recs, params, cfg, per_row=kind.PER_ROW, device=device,
                               lowp="fp8")
        out["fp8"] = check.readings(fp8, refs, names)
    del pipe, params
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("control readings need a CUDA card", file=sys.stderr)
        return 2
    rows = []
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        r = seed_readings(cell, seed, args.seconds, k < args.control_seeds)
        rows.append(r)
        print(json.dumps(r), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows)}
    for name in rows[0]["program"]:
        summary[name] = {"program_max": max(r["program"][name] for r in rows)}
        for key in ("int8", "fp8"):
            vals = [r[key][name] for r in rows if key in r]
            if vals:
                summary[name][f"{key}_min"] = min(vals)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
