"""A minimal PNG encoder (a JAX-free copy of ``write_png`` from
``meshanything_tpu/utils/io.py``): zlib and struct, no image library.
The wireframe previews (``runtime/render.py``) write through it.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(rgb: np.ndarray, path: str) -> str:
    """Minimal RGB8 PNG encoder (replaces PIL in savemeshtes2)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError("write_png expects (H, W, 3) uint8")
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))
    with open(path, "wb") as fh:
        fh.write(data)
    return path
