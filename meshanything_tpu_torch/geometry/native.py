"""Build and load the port's native geometry library,
``meshanything_tpu_torch/native/geom.cpp`` (``udf_grid``: the unsigned
distance field of the ``--mc`` / ``X-MC`` preprocessing).

At first use the source is compiled with ``g++`` into a shared library under ``meshanything_tpu_torch/_build/``, with the
flags of the JAX package's ``native/build.sh`` (a pinned x86-64-v3 ISA
and no build id, so that a rebuild is byte-identical on any host), and
loaded with ctypes. The file name carries a hash of the source and the
flags, as ``ops/_build.py`` names the CUDA modules, so an edited source
is rebuilt and a stale library is never loaded. A build that fails
raises: the caller does not fall back to the NumPy path silently.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from meshanything_tpu_torch.ops._build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "native", "geom.cpp")
GXX_FLAGS = ("-O3", "-march=x86-64-v3", "-shared", "-fPIC", "-pthread",
             "-Wl,--build-id=none")

_lib = None
_lock = threading.Lock()


def find_gxx() -> str:
    """``g++`` on ``$PATH``."""
    gxx = shutil.which("g++")
    if not gxx:
        raise RuntimeError("g++ not found on $PATH: the native geometry library is built from "
                           "meshanything_tpu_torch/native/geom.cpp at first use")
    return gxx


def library_path() -> str:
    """Where the library of the current source and flags lives."""
    with open(SOURCE, "rb") as fh:
        source = fh.read()
    key = hashlib.sha256(source + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"geom-{key}.so")


def load() -> ctypes.CDLL:
    """Build the library if needed and load it (once a process)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            src_dir = os.path.dirname(SOURCE)
            proc = subprocess.run([find_gxx(), *GXX_FLAGS, f"-ffile-prefix-map={src_dir}=.",
                                   "-o", tmp, SOURCE], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build {SOURCE}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)     # atomic: a concurrent loader sees all or nothing
        lib = ctypes.CDLL(path)
        lib.udf_grid.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,     # vertices, nv
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,      # faces, nf
            ctypes.c_int,                                      # grid size
            ctypes.c_double, ctypes.c_double,                  # grid lo, spacing
            ctypes.POINTER(ctypes.c_float),                    # out field
        ]
        lib.udf_grid.restype = None
        _lib = lib
        return lib
