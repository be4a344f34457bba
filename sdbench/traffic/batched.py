"""``generate_batch`` of ``batch`` requests, each row with its own seed and,
with ``init_image``, its own image at the mix's ``strength``, in a closed
loop of ``in_flight`` device requests (``drive.run_closed``)."""

from __future__ import annotations

import numpy as np

from sdbench import drive

PER_ROW = True


def call(pipe, cfg, mix, reqs):
    kw = drive.gen_kwargs(cfg)
    if "image" in reqs[0]:
        kw.update(init_images=[r["image"] for r in reqs], strength=reqs[0]["strength"])
    return pipe.generate_batch([""] * len(reqs), token_ids=np.stack([r["ids"] for r in reqs]),
                               seeds=[r["seed"] for r in reqs], output="device", **kw)


def warm(pipe, cfg, mix, inputs) -> None:
    drive.warm_closed(lambda reqs: call(pipe, cfg, mix, reqs), mix, inputs)


def run(pipe, cfg, mix, inputs, seconds, tracer) -> drive.Window:
    return drive.run_closed(lambda reqs: call(pipe, cfg, mix, reqs), mix, inputs, seconds,
                            tracer)
