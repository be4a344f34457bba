"""Textual-inversion embeddings: new concept tokens as learned rows of the
CLIP token-embedding table.

Counterpart of ``sdtpu/utils/textual_inversion.py``.  A file carries one or
more learned vectors for a placeholder token (``<cat-toy>``); loading
appends them as new rows of the token table(s) and returns their ids,
which the pipeline registers with its tokenizer.  The lookup is a gather
(``ops/embedding.py``), so a grown table is only a new shape.

Layouts (detected):

* **diffusers** ``learned_embeds.safetensors``: ``{token: (n, hidden)}``
  (the key is the placeholder);
* **sd-scripts / A1111**: ``{"emb_params": (n, hidden)}`` (the caller names
  the placeholder with ``token=``);
* **SDXL dual-encoder**: ``{"clip_l": (n, 768), "clip_g": (n, 1280)}``
  (both tables grow and share the ids, as both encoders take the same
  ids).

A grown table keeps its dtype and device (float32 under a bf16
``param_dtype``, ``models/clip.py``); it is a new tensor, never the old one
written in place.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from sdtpu_torch.utils.lora import _copy_containers, host_f32


def _rows(emb) -> np.ndarray:
    a = host_f32(emb)
    if a.ndim == 1:
        a = a[None, :]
    if a.ndim != 2:
        raise ValueError(f"embedding must be (n, hidden), got {a.shape}")
    return a


def _append_rows(clip_params: dict, rows: np.ndarray) -> int:
    table = clip_params["token_embedding"]["weight"]
    if rows.shape[1] != table.shape[1]:
        raise ValueError(
            f"embedding dim {rows.shape[1]} != encoder dim {table.shape[1]}"
        )
    first_id = table.shape[0]
    new_rows = torch.from_numpy(rows).to(table.device).to(table.dtype)
    clip_params["token_embedding"]["weight"] = torch.cat([table, new_rows])
    return first_id


def parse_textual_inversion(sd: Mapping, *, token: Optional[str] = None) -> list:
    """Normalize a textual-inversion state dict to
    ``[(placeholder, clip_l_rows, clip_g_rows_or_None), ...]`` (float32
    numpy rows)."""
    keys = set(sd.keys())
    if keys == {"clip_l", "clip_g"}:
        if token is None:
            raise ValueError(
                "dual-encoder textual inversion needs token=\"<name>\""
            )
        return [(token, _rows(sd["clip_l"]), _rows(sd["clip_g"]))]
    if "emb_params" in keys:
        if token is None:
            raise ValueError(
                "emb_params-layout textual inversion needs token=\"<name>\""
            )
        return [(token, _rows(sd["emb_params"]), None)]
    out = []
    for k, v in sd.items():
        if k.startswith("string_to_"):  # A1111 .pt metadata keys
            continue
        out.append((token or k, _rows(v), None))
    if not out:
        raise ValueError(f"no embeddings found (keys: {sorted(keys)})")
    return out


def apply_textual_inversion(params: dict, sd: Mapping, *,
                            token: Optional[str] = None) -> Tuple[dict, dict]:
    """Append the file's vectors to the CLIP table(s).

    Returns ``(new_params, {placeholder: [new token ids]})``; the input tree
    is not modified (containers copied, every leaf but the grown tables
    shared).  A bigG-only tree (the SDXL refiner) grows ``clip_2`` alone,
    from a dual-encoder file's G rows."""
    new = _copy_containers(params)
    registered: dict = {}
    for placeholder, rows_l, rows_g in parse_textual_inversion(sd, token=token):
        if "clip" not in new:
            rows = rows_g if rows_g is not None else rows_l
            first = _append_rows(new["clip_2"], rows)
            registered[placeholder] = list(range(first, first + rows.shape[0]))
            continue
        first = _append_rows(new["clip"], rows_l)
        ids = list(range(first, first + rows_l.shape[0]))
        if rows_g is not None:
            if "clip_2" not in new:
                raise ValueError(
                    "dual-encoder embedding but the pipeline has one "
                    "text encoder"
                )
            first_g = _append_rows(new["clip_2"], rows_g)
            if first_g != first:
                raise ValueError(
                    "clip_l/clip_g tables out of sync: new ids "
                    f"{first} vs {first_g} (load the same inversions in "
                    "the same order for both encoders)"
                )
        elif "clip_2" in new:
            raise ValueError(
                "single-encoder embedding on a dual-encoder (SDXL) "
                "pipeline — provide {clip_l, clip_g}"
            )
        registered[placeholder] = ids
    return new, registered
