"""Build the port's CUDA sources on first use and load them with ctypes.

Each ``sdtpu_torch/csrc/<name>.cu`` compiles on its own into
``build/lib<name>-<hash>.so`` at the repository root (listed in
``.gitignore``) with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

The hash is of the source text and of every header in ``csrc/`` (the
``.cuh`` files the sources include), so an edited source or header is
rebuilt and a stale library is never loaded.  The sources expose a plain C interface: every
pointer and the stream pass as ``c_void_p``, and each launch function
returns the launch's ``cudaError_t``, which the Python wrapper raises on.
Nothing here runs at import: the package imports on a machine without
``nvcc``, and only a wrapper called on a CUDA tensor builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC_DIR)), "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: dict = {}


def find_nvcc() -> str:
    """nvcc from ``$CUDA_HOME/bin``, then ``PATH``, then ``/usr/local/cuda/bin``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels of sdtpu_torch cannot be built"
    )


def sources() -> list:
    return sorted(n[:-3] for n in os.listdir(CSRC_DIR) if n.endswith(".cu"))


def _lib_path(name: str) -> str:
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for n in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, n), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names=None, *, ptxas_verbose: bool = False) -> dict:
    """Compile every named source that has no up-to-date library, one nvcc
    process per source, all started together.  Returns ``{name: (seconds,
    compiler output)}`` for the sources built.  Raises if any build fails."""
    names = sources() if names is None else list(names)
    todo = [n for n in names if not os.path.isfile(_lib_path(n))]
    if not todo:
        return {}
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    # per-process temporary names: test workers may build the same source at
    # once, and os.replace makes whichever finishes last the library
    tmp = {n: f"{_lib_path(n)}.{os.getpid()}.tmp" for n in todo}
    t0 = time.perf_counter()
    for n in todo:
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose else []),
               "-o", tmp[n], os.path.join(CSRC_DIR, n + ".cu")]
        procs[n] = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    report, failed = {}, []
    for n, p in procs.items():
        log, _ = p.communicate()
        report[n] = (time.perf_counter() - t0, log)
        if p.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {p.returncode}):\n{log}")
        else:
            os.replace(tmp[n], _lib_path(n))
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
