"""``generate`` of one request (with ``init_image``, its image at the mix's
``strength``), in a closed loop of ``in_flight`` device requests
(``drive.run_closed``)."""

from __future__ import annotations

from sdbench import drive

PER_ROW = False


def call(pipe, cfg, mix, reqs):
    import torch

    kw = drive.gen_kwargs(cfg)
    outs = [pipe.generate("", token_ids=r["ids"][None], seed=r["seed"], output="device",
                          **({"init_image": r["image"], "strength": r["strength"]}
                             if "image" in r else {}), **kw) for r in reqs]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def warm(pipe, cfg, mix, inputs) -> None:
    drive.warm_closed(lambda reqs: call(pipe, cfg, mix, reqs), mix, inputs)


def run(pipe, cfg, mix, inputs, seconds, tracer) -> drive.Window:
    return drive.run_closed(lambda reqs: call(pipe, cfg, mix, reqs), mix, inputs, seconds,
                            tracer)
