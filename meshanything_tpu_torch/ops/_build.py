"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``meshanything_tpu_torch/_build/`` and loaded with ``ctypes``. The file
name carries a hash of the source, of the ``csrc`` files it includes and
of the flags, so an edited source is rebuilt and a stale library is
never loaded. Nothing is built when the package is imported.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: str
    built: bool            # compiled by this call (False: found in BUILD_DIR)
    seconds: float         # compile time, 0 when found
    log: str               # nvcc / ptxas output of the build


_loaded: dict[str, KernelLibrary] = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, $PATH, or the default toolkit location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and /usr/local/cuda/bin): "
        "the CUDA kernels are built from meshanything_tpu_torch/csrc at first use")


def _source_with_includes(path: str, seen: set) -> bytes:
    """The bytes of ``path`` and, after them, of every ``csrc`` file it
    includes with ``#include "..."`` (each once)."""
    seen.add(path)
    with open(path, "rb") as fh:
        source = fh.read()
    for included in re.findall(rb'^\s*#include\s+"([^"]+)"', source, flags=re.M):
        inc = os.path.join(CSRC_DIR, included.decode())
        if inc not in seen and os.path.isfile(inc):
            source += _source_with_includes(inc, seen)
    return source


def load(name: str) -> KernelLibrary:
    """Build ``csrc/<name>.cu`` if needed and load it (once per process)."""
    if name in _loaded:
        return _loaded[name]
    src = os.path.join(CSRC_DIR, name + ".cu")
    source = _source_with_includes(src, set())
    key = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"{name}-{key}.so")
    built, seconds, log = False, 0.0, ""
    if not os.path.exists(so_path):
        nvcc = find_nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src}:\n{log}")
        os.replace(tmp, so_path)  # atomic: a concurrent loader sees all or nothing
        built = True
    lib = KernelLibrary(ctypes.CDLL(so_path), so_path, built, seconds, log)
    _loaded[name] = lib
    return lib
