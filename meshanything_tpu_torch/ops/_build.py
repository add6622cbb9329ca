"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library and loaded
with ``ctypes``. Nothing is built when the package is imported.

Where the library goes: the ahead-of-time store when one is set
(``runtime/aot.py``: ``--aot_dir``), else the build directory
(``runtime/compile_cache.py``: ``$MESHANYTHING_COMPILE_CACHE``), else
``meshanything_tpu_torch/_build/``. The file name carries a key: a hash
of the source, of the ``csrc`` files it includes, of the flags, and of
the toolchain the library is built for (the device's compute capability,
``nvcc --version`` and ``torch.version.cuda``), so an edited source or
another toolkit or card is rebuilt and a stale library is never loaded.
Writes are atomic. A stored library that fails to load is rebuilt from
``csrc/`` (and said so on stderr as ``[aot] ...``): the same kernel,
never a fallback to the plain version.

``nvcc --version`` is read once per nvcc binary and kept beside the
libraries (keyed by the binary's path, size and time), so a process that
finds every library runs no nvcc at all.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# set by runtime/compile_cache.py::enable and runtime/aot.py::use_store
build_dir: Optional[str] = None
store_dir: Optional[str] = None


@dataclasses.dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: str
    built: bool            # compiled by this call (False: found on disk)
    seconds: float         # compile time, 0 when found
    log: str               # nvcc / ptxas output of the build


_loaded: dict[str, KernelLibrary] = {}
_stored: set = set()        # (name, store) pairs the store is known to hold


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


def _log(msg: str) -> None:
    print(f"[aot] {msg}", file=sys.stderr, flush=True)


def target_dir() -> str:
    """Where libraries are looked for and built: the store, the build
    directory, or the package's ``_build``."""
    return store_dir or build_dir or BUILD_DIR


def _tmp_name(path: str) -> str:
    return f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"


def _write_atomic(path: str, data: bytes) -> None:
    tmp = _tmp_name(path)
    with open(tmp, "wb") as fh:
        fh.write(data)
    os.replace(tmp, path)   # a concurrent reader sees all or nothing


def nvcc_version(nvcc: str, cache_dir: str) -> str:
    """``nvcc --version`` of the binary, kept in ``cache_dir`` under its
    path, size and modification time (so it is run once per binary)."""
    st = os.stat(nvcc)
    ident = f"{os.path.realpath(nvcc)}:{st.st_size}:{st.st_mtime_ns}"
    cached = os.path.join(cache_dir,
                          f"nvcc-version-{hashlib.sha256(ident.encode()).hexdigest()[:16]}.txt")
    if os.path.exists(cached):
        with open(cached) as fh:
            return fh.read()
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True).stdout
    os.makedirs(cache_dir, exist_ok=True)
    _write_atomic(cached, out.encode())
    return out


def toolchain(cache_dir: str) -> dict:
    """What a library is built for: the current device's compute
    capability, the nvcc binary's version and torch's CUDA version."""
    import torch

    return {"capability": tuple(torch.cuda.get_device_capability()),
            "nvcc": nvcc_version(find_nvcc(), cache_dir),
            "torch_cuda": torch.version.cuda}


def library_key(source: bytes, tools: dict) -> str:
    """The library's key: the source (with its includes), the flags and
    the toolchain (``toolchain``)."""
    h = hashlib.sha256(source)
    h.update(" ".join(NVCC_FLAGS).encode())
    for name in ("capability", "nvcc", "torch_cuda"):
        h.update(b"\0" + name.encode() + b"=" + repr(tools[name]).encode())
    return h.hexdigest()[:16]


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


def _compile(src: str, out: str) -> tuple[float, str]:
    """nvcc ``src`` into ``out`` (atomically) -> (seconds, log); raises
    on a failed build."""
    tmp = _tmp_name(out)
    t0 = time.perf_counter()
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {src}:\n{log}")
    os.replace(tmp, out)
    return seconds, log


_open = ctypes.CDLL


def library_path(name: str, directory: Optional[str] = None) -> str:
    """The path that ``load(name)`` reads or builds in ``directory``
    (default ``target_dir()``)."""
    directory = directory or target_dir()
    source = _source_with_includes(os.path.join(CSRC_DIR, name + ".cu"), set())
    return os.path.join(directory, f"{name}-{library_key(source, toolchain(directory))}.so")


def _copy_into_store(name: str, lib: KernelLibrary) -> None:
    """Put a library loaded before the store was set into the store."""
    dst = os.path.join(store_dir, os.path.basename(lib.path))
    if not os.path.exists(dst):
        os.makedirs(store_dir, exist_ok=True)
        with open(lib.path, "rb") as fh:
            _write_atomic(dst, fh.read())
        _log(f"copied {name} into {store_dir}")
    _stored.add((name, store_dir))


def load(name: str) -> KernelLibrary:
    """Build ``csrc/<name>.cu`` if needed and load it (once per process).
    A library loaded earlier from elsewhere is copied into a store set
    since, so that the store holds every library the process ran."""
    if name in _loaded:
        lib = _loaded[name]
        if store_dir and (name, store_dir) not in _stored:
            _copy_into_store(name, lib)
        return lib
    directory = target_dir()
    src = os.path.join(CSRC_DIR, name + ".cu")
    os.makedirs(directory, exist_ok=True)
    so_path = library_path(name, directory)
    built, seconds, log, handle = False, 0.0, "", None
    if os.path.exists(so_path):
        try:
            handle = _open(so_path)
        except OSError as e:
            _log(f"stored library {so_path} failed to load ({e}); rebuilding it from {src}")
            os.remove(so_path)
    if handle is None:
        seconds, log = _compile(src, so_path)
        built = True
        handle = _open(so_path)
    if store_dir:
        _stored.add((name, store_dir))
        _log(f"{'built' if built else 'found'} {name} in {directory}"
             + (f" ({seconds:.1f} s)" if built else ""))
    lib = KernelLibrary(handle, so_path, built, seconds, log)
    _loaded[name] = lib
    return lib
