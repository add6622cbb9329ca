"""The ahead-of-time store of the port: the counterpart of the JAX
package's ``runtime/aot.py::AotStore``.

JAX serializes each compiled program, so that a second process loads it
instead of compiling. On the card, what a second process can reuse is
the built kernel libraries: a CUDA graph does not outlive its process
(``PhaseRunner`` keeps its graphs across the requests of one process).
So the store is a directory of libraries. While it is set,
``ops/_build.py::load`` looks for each library there and builds into it
(keyed by source, flags, compute capability, ``nvcc --version`` and
``torch.version.cuda``), and a stored library that fails to load is
rebuilt and logged on stderr as ``[aot] ...``.

    AotStore("aot")                              # --aot_dir aot
    build(libraries_for("pallas_int8", 8, torch.bfloat16, 64))

``PhaseRunner(aot_dir=)`` sets the store; ``PhaseRunner.precompile``
builds the libraries of its tier (``libraries_for``) and captures its
decode graphs. The store is process-wide: the last one set wins.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import torch

from meshanything_tpu_torch.ops import _build


def libraries_for(attn: str, lookahead: "int | str", dtype: torch.dtype,
                  head_dim: int) -> tuple:
    """The kernel libraries (``csrc/<name>.cu``) that a decode of the
    tier launches: K1 (exact), K2/K3 (int8/int4 caches), K4 (any window:
    the tensor-core file or the f32 one, as ``mq_kernel_for`` routes the
    cache and query dtypes) or K5 (``attn="megakernel"``), and, beside
    each but K5, the residual add and post-LN (``add_layer_norm``); in
    bf16 also the few-row product kernel (``gemv``: the layer matrices,
    the codebook projection and lm_head; beside K5 the last two)."""
    from meshanything_tpu_torch.ops.decode_attention import mq_kernel_for

    products = ("gemv",) if dtype == torch.bfloat16 else ()
    if attn == "megakernel":
        return ("megakernel", *products)
    if lookahead:
        cache = {"pallas_int8": torch.int8, "pallas_int4": torch.int32}.get(attn, dtype)
        route = mq_kernel_for(cache, head_dim, dtype)
        attention = "decode_attention_window" if route != "tile_split" else "decode_attention_fast"
    else:
        attention = "decode_attention" if attn == "pallas" else "decode_attention_quant"
    return (attention, "add_layer_norm", *products)


def build(names: Sequence[str]) -> list:
    """Load (build where missing) each library, one nvcc a source, all
    at once -> their ``KernelLibrary`` records."""
    names = list(dict.fromkeys(names))
    if not names:
        return []
    with ThreadPoolExecutor(len(names)) as pool:
        return list(pool.map(_build.load, names))


class AotStore:
    """A directory of kernel libraries, made the process's store."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(os.path.expanduser(directory))
        os.makedirs(self.directory, exist_ok=True)
        _build.store_dir = self.directory

    def stored(self) -> list:
        """The library files the store holds."""
        return sorted(n for n in os.listdir(self.directory) if n.endswith(".so"))
