"""What a cell is, found by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic mix (``sdbench/traffic/<name>.json``) and
its own file (``sdbench/workloads/<name>.json``: the sample and the limits
of its correctness check).  Nothing here knows a cell, a configuration or a
mix by name."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file as run
    traffic: dict         # the traffic mix's parameters
    check: dict           # the cell's sample size and limits
    end_to_end: list      # the BENCHMARK.json metrics the cell reports with --trace 0
    per_layer: list       # ... and with --trace 1


def _reports(metric: dict, cell: str, end_to_end: dict) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in end_to_end if "moves" in metric else True


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    here = root / "sdbench"
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json").read_text())
    check = json.loads((here / "workloads" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, {})]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic, check=check,
                end_to_end=e2e, per_layer=per_layer)


def guided(cfg: dict) -> bool:
    """Whether a configuration runs classifier-free guidance: a
    ``cfg_scale`` above 1 (each image then takes a conditional and an
    unconditional row through the text encoders and the UNet)."""
    return cfg["cfg_scale"] > 1.0


def unet_rows(cfg: dict, images: int) -> int:
    """The rows the text encoders and each UNet step take for ``images``
    images."""
    return images * (2 if guided(cfg) else 1)


def pipeline_config(cfg: dict):
    """The program's ``PipelineConfig`` built from a configuration file."""
    import torch

    from sdtpu_torch.config import (CLIPConfig, PipelineConfig, SchedulerConfig, UNetConfig,
                                    VAEConfig)

    def make(cls, d):
        if d is None:
            return None
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})

    dtype = getattr(torch, cfg["dtype"])
    return PipelineConfig(
        name=cfg["name"], clip=make(CLIPConfig, cfg.get("clip")),
        clip_2=make(CLIPConfig, cfg.get("clip_2")), unet=make(UNetConfig, cfg["unet"]),
        vae=make(VAEConfig, cfg["vae"]), scheduler=make(SchedulerConfig, cfg["scheduler"]),
        default_image_size=cfg["image_size"], default_steps=cfg["steps"],
        default_sampler=cfg["sampler"], default_cfg=guided(cfg), default_cfg_scale=cfg["cfg_scale"],
        compute_dtype=dtype, param_dtype=dtype)
