"""Where the kernel libraries are built: the counterpart of the JAX
package's ``runtime/compile_cache.py::enable`` (which points JAX's
persistent compilation cache at a directory).

What the port compiles is its CUDA kernels (``ops/_build.py``). The CLI
and serving call ``enable()`` at start, as the JAX entry points do:
``$MESHANYTHING_COMPILE_CACHE``, when set, names the directory that the
libraries are built into and looked for in; unset, they stay in
``meshanything_tpu_torch/_build/``. An ahead-of-time store
(``runtime/aot.py``, ``--aot_dir``) takes precedence over both.
"""
from __future__ import annotations

import os
from typing import Optional

from meshanything_tpu_torch.ops import _build


def enable(cache_dir: Optional[str] = None) -> str:
    """Set the build directory (``cache_dir``, else
    ``$MESHANYTHING_COMPILE_CACHE``, else the package's ``_build``) and
    return it."""
    cache_dir = cache_dir or os.environ.get("MESHANYTHING_COMPILE_CACHE")
    if not cache_dir:
        _build.build_dir = None
        return _build.BUILD_DIR
    cache_dir = os.path.abspath(os.path.expanduser(cache_dir))
    os.makedirs(cache_dir, exist_ok=True)
    _build.build_dir = cache_dir
    return cache_dir
