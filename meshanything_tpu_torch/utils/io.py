"""IO helpers and textured mesh export: a JAX-free copy of
``meshanything_tpu/utils/io.py`` (the reference's graphics/IO tier):

  * michelangelo/utils/io.py:11-48 — mkdir / npy_loads / npz_loads /
    json_loads / load_json / write_json / extract_tar;
  * ``write_png`` — a minimal PNG encoder (zlib and struct, no image
    library), through which the wireframe previews (``runtime/render.py``)
    and the texture of ``save_textured_obj`` are written;
  * graphics/primitives/mesh.py:27-64 savemeshtes2 — OBJ with UVs + MTL +
    texture PNG (``save_textured_obj``);
  * graphics/primitives/mesh.py:67-111 MeshOutput — the export dispatcher
    (textured / vertex-colored / plain).
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import struct
import tarfile
import zlib
from typing import Optional

import numpy as np
import numpy.lib.format


def mkdir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def npy_loads(data: bytes) -> np.ndarray:
    return np.lib.format.read_array(io.BytesIO(data))


def npz_loads(data: bytes):
    return np.load(io.BytesIO(data))


def json_loads(data):
    return json.loads(data)


def load_json(filepath: str):
    with open(filepath, "r") as f:
        return json.load(f)


def write_json(filepath: str, data) -> None:
    with open(filepath, "w") as f:
        json.dump(data, f, indent=2)


def extract_tar(tar_path: str, tar_cache_folder: str):
    with tarfile.open(tar_path, "r") as tar:
        tar.extractall(path=tar_cache_folder)
    return sorted(os.listdir(tar_cache_folder))


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


def save_textured_obj(vertices: np.ndarray, uvs: np.ndarray, faces: np.ndarray,
                      face_tex_idx: np.ndarray, tex_map: np.ndarray, fname: str) -> None:
    """savemeshtes2 (mesh.py:27-64): OBJ with vt records + a sidecar .mtl
    naming a PNG texture written next to it."""
    fol, na = os.path.split(fname)
    na, _ = os.path.splitext(na)
    fol = fol or "."

    with open(os.path.join(fol, f"{na}.mtl"), "w") as fid:
        fid.write("newmtl material_0\n")
        fid.write("Kd 1 1 1\nKa 0 0 0\nKs 0.4 0.4 0.4\nNs 10\nillum 2\n")
        fid.write(f"map_Kd {na}.png\n")

    with open(fname, "w") as fid:
        fid.write(f"mtllib {na}.mtl\n")
        for p in np.asarray(vertices, float):
            fid.write(f"v {p[0]:f} {p[1]:f} {p[2]:f}\n")
        for p in np.asarray(uvs, float):
            fid.write(f"vt {p[0]:f} {p[1]:f}\n")
        fid.write("usemtl material_0\n")
        for f, ft in zip(np.asarray(faces, np.int64) + 1, np.asarray(face_tex_idx, np.int64) + 1):
            fid.write(f"f {f[0]}/{ft[0]} {f[1]}/{ft[1]} {f[2]}/{ft[2]}\n")

    write_png(tex_map, os.path.join(fol, f"{na}.png"))


@dataclasses.dataclass
class MeshOutput:
    """MeshOutput (mesh.py:67-111): export dispatch across textured,
    vertex-colored and plain meshes."""

    mesh_v: np.ndarray
    mesh_f: np.ndarray
    vertex_colors: Optional[np.ndarray] = None
    uvs: Optional[np.ndarray] = None
    mesh_tex_idx: Optional[np.ndarray] = None
    tex_map: Optional[np.ndarray] = None

    def contain_uv_texture(self) -> bool:
        return (self.uvs is not None and self.mesh_tex_idx is not None
                and self.tex_map is not None)

    def contain_vertex_colors(self) -> bool:
        return self.vertex_colors is not None

    def export(self, fname: str) -> None:
        from meshanything_tpu_torch.geometry.obj_io import Mesh, save_obj

        if self.contain_uv_texture():
            save_textured_obj(self.mesh_v, self.uvs, self.mesh_f, self.mesh_tex_idx,
                              self.tex_map, fname)
        elif self.contain_vertex_colors():
            vc = np.asarray(self.vertex_colors)
            if vc.shape[-1] == 3:
                vc = np.concatenate([vc, np.full((*vc.shape[:-1], 1), 255)], axis=-1)
            save_obj(Mesh(self.mesh_v, self.mesh_f, vertex_colors=vc.astype(np.uint8)), fname)
        else:
            save_obj(Mesh(self.mesh_v, self.mesh_f), fname)
