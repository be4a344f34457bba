"""Reading ``.safetensors`` files into torch tensors.

Counterpart of ``sdtpu/utils/native_safetensors.py``: ctypes over the C++
mmap reader of ``native/safetensors_reader.cpp``.  The library (with the
tokenizer of ``native/tokenizer.cpp``, ``tokenizer/native.py``) builds on
first use with ``g++`` and ``native/Makefile``'s flags into
``build/libsdtpu_native-<hash>.so`` at the repository root (gitignored;
``native/`` itself is left as it is).  A failed build raises with the
compiler's output: nothing switches readers quietly.

``NativeSafetensors`` gives zero-copy views into the mapped file (valid
while it is open); ``load(path)`` owned copies.  BF16 comes through
``torch.frombuffer(..., dtype=torch.bfloat16)``.  ``PlainSafetensors`` is
the same interface in Python (the 8-byte header length, the JSON header,
``torch.frombuffer`` over an ``mmap``), which the tests hold the native
reader against.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import mmap
import os
import struct
import subprocess
import threading
from typing import Dict, List

import torch

from sdtpu_torch.kernels._build import BUILD_DIR

NATIVE_DIR = os.path.join(os.path.dirname(BUILD_DIR), "native")
NATIVE_SOURCES = ("tokenizer.cpp", "safetensors_reader.cpp")
# native/Makefile's CXXFLAGS, plus -shared as its link line
CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra"]

DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    """``build/libsdtpu_native-<hash>.so``; the hash is of the sources and
    the flags, so an edited source is rebuilt."""
    digest = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for name in NATIVE_SOURCES:
        with open(os.path.join(NATIVE_DIR, name), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libsdtpu_native-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the native library unless an up-to-date one exists; returns
    its path.  Raises with the compiler's output if the build fails."""
    path = library_path()
    if os.path.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    # a per-process temporary name: test workers may build at once
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-shared", "-o", tmp,
           *(os.path.join(NATIVE_DIR, n) for n in NATIVE_SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"native library build failed: {' '.join(cmd)}: {e}") from None
    if proc.returncode != 0:
        raise RuntimeError(f"native library build failed (exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def load_library() -> ctypes.CDLL:
    """The native library, built on first use, with its C signatures."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.sdtpu_st_open.restype = ctypes.c_void_p
        lib.sdtpu_st_open.argtypes = [ctypes.c_char_p]
        lib.sdtpu_st_count.restype = ctypes.c_int64
        lib.sdtpu_st_count.argtypes = [ctypes.c_void_p]
        lib.sdtpu_st_name.restype = ctypes.c_char_p
        lib.sdtpu_st_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.sdtpu_st_info.restype = ctypes.c_void_p
        lib.sdtpu_st_info.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_int64),
                                      ctypes.POINTER(ctypes.c_int64)]
        lib.sdtpu_st_nbytes.restype = ctypes.c_int64
        lib.sdtpu_st_nbytes.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.sdtpu_st_close.argtypes = [ctypes.c_void_p]
        lib.sdtpu_tokenizer_create.restype = ctypes.c_void_p
        lib.sdtpu_tokenizer_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.sdtpu_tokenizer_destroy.argtypes = [ctypes.c_void_p]
        lib.sdtpu_tokenizer_encode.restype = ctypes.c_int64
        lib.sdtpu_tokenizer_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                               ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        _lib = lib
        return lib


def _torch_dtype(name: str) -> torch.dtype:
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported safetensors dtype {name!r}") from None


def _view(buf, dtype_name: str, shape) -> torch.Tensor:
    """A tensor over a buffer of raw bytes (no copy)."""
    dtype = _torch_dtype(dtype_name)
    if len(buf) == 0:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(buf, dtype=torch.uint8).view(dtype).reshape(shape)


class _Reader:
    def state_dict(self) -> Dict[str, torch.Tensor]:
        """Every tensor as a view (valid while the reader is open)."""
        return {k: self.tensor(k) for k in self.keys()}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeSafetensors(_Reader):
    """A .safetensors file opened by the native reader."""

    def __init__(self, path: str):
        self._lib = load_library()
        handle = self._lib.sdtpu_st_open(os.fsencode(path))
        if not handle:
            raise OSError(f"cannot open safetensors file: {path}")
        self._handle = ctypes.c_void_p(handle)

    def keys(self) -> List[str]:
        n = self._lib.sdtpu_st_count(self._handle)
        return [self._lib.sdtpu_st_name(self._handle, i).decode() for i in range(n)]

    def tensor(self, name: str) -> torch.Tensor:
        """A zero-copy view (valid while this reader is open)."""
        dtype_buf = ctypes.create_string_buffer(16)
        shape = (ctypes.c_int64 * 8)()
        ndim = ctypes.c_int64()
        ptr = self._lib.sdtpu_st_info(self._handle, name.encode(), dtype_buf, shape,
                                      ctypes.byref(ndim))
        if not ptr:
            raise KeyError(name)
        nbytes = self._lib.sdtpu_st_nbytes(self._handle, name.encode())
        raw = (ctypes.c_uint8 * nbytes).from_address(ptr)
        return _view(raw, dtype_buf.value.decode(), tuple(shape[i] for i in range(ndim.value)))

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.sdtpu_st_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class PlainSafetensors(_Reader):
    """The same file read in Python: the little-endian u64 header length,
    the JSON header, tensors by ``torch.frombuffer`` over a copy-on-write
    ``mmap`` (writable, so torch takes it without a warning)."""

    def __init__(self, path: str):
        self._file = open(path, "rb")
        self._map = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_COPY)
        (n,) = struct.unpack("<Q", self._map[:8])
        header = json.loads(bytes(self._map[8:8 + n]))
        header.pop("__metadata__", None)
        self._header = header
        self._start = 8 + n

    def keys(self) -> List[str]:
        return list(self._header)

    def tensor(self, name: str) -> torch.Tensor:
        info = self._header[name]
        begin, end = info["data_offsets"]
        buf = memoryview(self._map)[self._start + begin:self._start + end]
        return _view(buf, info["dtype"], tuple(info["shape"]))

    def close(self) -> None:
        if self._map is not None:
            self._map.close()
            self._file.close()
            self._map = None


def _load(reader_cls, path: str) -> Dict[str, torch.Tensor]:
    out = {}
    with reader_cls(path) as f:
        for k in f.keys():
            view = f.tensor(k)
            out[k] = view.clone()
            del view
    return out


def load(path: str) -> Dict[str, torch.Tensor]:
    """Owned copies of every tensor, by the native reader (the counterpart
    of ``safetensors.numpy.load_file``)."""
    return _load(NativeSafetensors, path)


def load_plain(path: str) -> Dict[str, torch.Tensor]:
    """Owned copies of every tensor, by the plain reader."""
    return _load(PlainSafetensors, path)
