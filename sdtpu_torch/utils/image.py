"""Image conversion between [-1, 1] floats and uint8, and 8-bit PNG files
read and written with the standard library."""

from __future__ import annotations

import numpy as np
import torch


def to_uint8(images):
    """(-1, 1) float images -> clamped, rounded (half to even) uint8.  A
    tensor stays a tensor on its device; anything else becomes numpy."""
    if isinstance(images, torch.Tensor):
        arr = (images.float() + 1.0) * 127.5
        return torch.clamp(torch.round(arr), 0, 255).to(torch.uint8)
    arr = (np.asarray(images, dtype=np.float32) + 1.0) * 127.5
    return np.clip(np.round(arr), 0, 255).astype(np.uint8)


def from_uint8(images) -> np.ndarray:
    """uint8 [0, 255] -> float32 (-1, 1)."""
    return np.asarray(images, dtype=np.float32) / 127.5 - 1.0


def psnr(a, b, *, data_range: float = 2.0) -> float:
    """Peak signal-to-noise ratio in dB (range 2.0 for [-1, 1] images), in
    float64 on the host."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def bilinear_resize(images, height: int, width: int) -> np.ndarray:
    """Bilinear resize of a (B, H, W, C) float batch on the host, with
    half-pixel centres: ``jax.image.resize(..., "bilinear")`` for an
    upscale; a downscale samples two taps without its antialias filter.
    A copy of ``sdtpu/utils/image.py:bilinear_resize`` (the hires fix's
    upscale between its passes)."""
    arr = np.asarray(images, dtype=np.float32)
    b, h, w, c = arr.shape
    if (h, w) == (height, width):
        return arr

    def axis_weights(n_in, n_out):
        # src = (dst + 0.5) * n_in / n_out - 0.5, clamped into [0, n_in - 1]
        # before the floor, so that edge samples extend the border
        src = (np.arange(n_out, dtype=np.float64) + 0.5) * n_in / n_out - 0.5
        src = np.clip(src, 0.0, n_in - 1)
        lo = np.floor(src).astype(np.int64)
        hi = np.minimum(lo + 1, n_in - 1)
        frac = (src - lo).astype(np.float32)
        return lo, hi, frac

    ylo, yhi, yf = axis_weights(h, height)
    xlo, xhi, xf = axis_weights(w, width)
    top, bot = arr[:, ylo], arr[:, yhi]
    rows = top + (bot - top) * yf[None, :, None, None]
    left, right = rows[:, :, xlo], rows[:, :, xhi]
    return left + (right - left) * xf[None, None, :, None]


# -- PNG, with the standard library (the card's machine has no PIL) ---------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> channels: grey, RGB, RGBA


def _chunk(kind: bytes, data: bytes) -> bytes:
    import struct
    import zlib

    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_png(image, path: str) -> None:
    """Write an 8-bit PNG: (H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA
    uint8 (a float image in [-1, 1] is converted; of a batch, the first
    image), every row with filter 0."""
    import struct
    import zlib

    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    if arr.ndim == 4:
        arr = arr[0]
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[:, :, 0]
    colour = {2: 0, 3: {3: 2, 4: 6}.get(arr.shape[-1])}.get(arr.ndim)
    if colour is None:
        raise ValueError(f"save_png takes (H, W), (H, W, 3) or (H, W, 4); got {arr.shape}")
    h, w = arr.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (none, sub, up, average, Paeth)."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        start = y * (stride + 1)
        ftype = raw[start]
        line = np.frombuffer(raw, np.uint8, stride, start + 1).astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # sub: a running sum per byte of the pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # average, Paeth: each byte needs its left neighbour
            cur = bytearray(stride)
            up = prev.tolist()
            vals = line.tolist()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if ftype == 3:
                    pred = (a + up[x]) >> 1
                else:
                    b, c = up[x], up[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
                cur[x] = (vals[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8).astype(np.int32)
        else:
            raise ValueError(f"PNG: unknown row filter {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit, non-interlaced grey, RGB or RGBA PNG: (H, W), (H, W,
    3) or (H, W, 4) uint8.  Any other PNG, a bad chunk checksum or a file
    that is no PNG raises ValueError."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(_PNG_SIGNATURE), None, []
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: the {kind!r} chunk fails its checksum")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, _compression, _filter, interlace = header
    if depth != 8:
        raise ValueError(f"{path}: bit depth {depth}; only 8-bit PNGs are read")
    if colour not in _PNG_CHANNELS:
        raise ValueError(f"{path}: colour type {colour}; only grey (0), RGB (2) and RGBA (6) "
                         "PNGs are read")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not read")
    ch = _PNG_CHANNELS[colour]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    return pixels.reshape(h, w) if ch == 1 else pixels.reshape(h, w, ch)


def load_image(path: str) -> np.ndarray:
    """A PNG as (H, W, 3) uint8 RGB: grey repeated, alpha dropped."""
    arr = read_png(path)
    if arr.ndim == 2:
        return np.repeat(arr[:, :, None], 3, axis=-1)
    return arr[:, :, :3]
