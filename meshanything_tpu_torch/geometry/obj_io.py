"""Mesh file IO for the port: OBJ / PLY / STL / OFF / GLB loading, format
sniffing and OBJ export.

A JAX-free copy of ``meshanything_tpu/geometry/obj_io.py``, identical in
behaviour. The port cannot import the original:
``meshanything_tpu/__init__.py`` imports its ``config.py``, which imports
``jax.numpy``.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray  # (V, 3) float64
    faces: np.ndarray     # (F, 3) int64 (triangulated)
    face_colors: Optional[np.ndarray] = None    # (F, 4) uint8
    vertex_colors: Optional[np.ndarray] = None  # (V, 4) uint8

    @property
    def face_normals(self) -> np.ndarray:
        v = self.vertices
        f = self.faces
        n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        return n / np.where(norm > 1e-20, norm, 1.0)

    @property
    def face_areas(self) -> np.ndarray:
        v = self.vertices
        f = self.faces
        n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        return 0.5 * np.linalg.norm(n, axis=-1)


def _triangulate(poly: list) -> list:
    """Fan-triangulate a polygon index list (trimesh does the same for quads+)."""
    return [[poly[0], poly[i], poly[i + 1]] for i in range(1, len(poly) - 1)]


def load_obj(path: str) -> Mesh:
    vertices = []
    faces = []
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                vertices.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    # formats: v, v/vt, v/vt/vn, v//vn
                    s = tok.split("/")[0]
                    i = int(s)
                    # OBJ is 1-based; negative indices are relative
                    idx.append(i - 1 if i > 0 else len(vertices) + i)
                if len(idx) >= 3:
                    faces.extend(_triangulate(idx))
    return Mesh(
        vertices=np.asarray(vertices, dtype=np.float64),
        faces=np.asarray(faces, dtype=np.int64).reshape(-1, 3),
    )


def _ply_dtype(name: str):
    return {
        "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
        "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
        "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
        "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    }[name]


def load_ply(path: str) -> Mesh:
    with open(path, "rb") as fh:
        magic = fh.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # list of (name, count, [(prop_kind, ...)])
        while True:
            line = fh.readline().decode("ascii", errors="replace").strip()
            if line.startswith("comment") or line.startswith("obj_info"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                elements.append([name, int(cnt), []])
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    elements[-1][2].append(("list", _ply_dtype(parts[2]), _ply_dtype(parts[3]), parts[4]))
                else:
                    elements[-1][2].append(("scalar", _ply_dtype(parts[1]), parts[2]))
            elif line == "end_header":
                break
        endian = "<" if fmt == "binary_little_endian" else ">"
        vertices, faces = None, []
        if fmt == "ascii":
            for name, cnt, props in elements:
                rows = [fh.readline().split() for _ in range(cnt)]
                if name == "vertex":
                    pidx = {p[-1]: i for i, p in enumerate(props)}
                    vertices = np.array(
                        [[float(r[pidx["x"]]), float(r[pidx["y"]]), float(r[pidx["z"]])] for r in rows]
                    )
                elif name == "face":
                    for r in rows:
                        n = int(r[0])
                        faces.extend(_triangulate([int(x) for x in r[1:1 + n]]))
        else:
            for name, cnt, props in elements:
                if name == "vertex" and all(p[0] == "scalar" for p in props):
                    dt = np.dtype([(p[2], endian + p[1]) for p in props])
                    data = np.frombuffer(fh.read(dt.itemsize * cnt), dtype=dt)
                    vertices = np.stack([data["x"], data["y"], data["z"]], axis=-1).astype(np.float64)
                elif name == "face":
                    for _ in range(cnt):
                        for p in props:
                            if p[0] == "list":
                                cdt = np.dtype(endian + p[1])
                                n = int(np.frombuffer(fh.read(cdt.itemsize), dtype=cdt)[0])
                                idt = np.dtype(endian + p[2])
                                idx = np.frombuffer(fh.read(idt.itemsize * n), dtype=idt)
                                if p[3] in ("vertex_indices", "vertex_index"):
                                    faces.extend(_triangulate([int(x) for x in idx]))
                            else:
                                fh.read(np.dtype(endian + p[1]).itemsize)
                else:
                    # skip unknown fixed-size element
                    if all(p[0] == "scalar" for p in props):
                        row = sum(np.dtype(endian + p[1]).itemsize for p in props)
                        fh.read(row * cnt)
        if vertices is None:
            raise ValueError(f"{path}: PLY has no vertex element")
    return Mesh(vertices=vertices, faces=np.asarray(faces, dtype=np.int64).reshape(-1, 3))


def load_stl(path: str) -> Mesh:
    """STL, binary or ascii. Binary: 80-byte header, uint32 count,
    50-byte triangle records. Some binary files start with 'solid', so
    the record-count arithmetic decides, not the header text. Vertices
    are per-triangle in STL; duplicates are kept (the postprocess merge
    collapses them, geometry/postprocess.py)."""
    with open(path, "rb") as fh:
        data = fh.read()
    is_binary = True
    if data[:5].lower() == b"solid":
        # some binary exporters also start the 80-byte header with
        # 'solid'; the record-size arithmetic decides. Trailing bytes
        # are tolerated (trimesh-style >=), not required to match
        if len(data) >= 84:
            (count,) = struct.unpack_from("<I", data, 80)
            is_binary = count > 0 and len(data) >= 84 + 50 * count
        else:
            is_binary = False
    if is_binary:
        (count,) = struct.unpack_from("<I", data, 80)
        rec = np.frombuffer(data, dtype=np.uint8, count=50 * count, offset=84)
        rec = rec.reshape(count, 50)
        tri = rec[:, 12:48].copy().view("<f4").reshape(count, 3, 3)
        vertices = tri.reshape(-1, 3).astype(np.float64)
    else:
        coords = []
        for line in data.decode("ascii", errors="replace").splitlines():
            parts = line.split()
            if parts[:1] == ["vertex"]:
                coords.append([float(parts[1]), float(parts[2]), float(parts[3])])
        vertices = np.asarray(coords, dtype=np.float64)
    faces = np.arange(len(vertices), dtype=np.int64).reshape(-1, 3)
    return Mesh(vertices=vertices, faces=faces)


def load_off(path: str) -> Mesh:
    """OFF (Object File Format): 'OFF' header (counts may share the
    header line), nV nF nE, vertex rows, then 'n i0 i1 ...' face rows
    (fan-triangulated like every other polygon here)."""
    with open(path, "r", errors="replace") as fh:
        tokens = []
        for line in fh:
            hash_at = line.find("#")
            if hash_at >= 0:
                line = line[:hash_at]
            tokens.extend(line.split())
    if not tokens or tokens[0].upper() != "OFF":
        # COFF/NOFF/STOFF carry extra per-vertex fields this parser does
        # not model — refuse clearly instead of corrupting coordinates
        raise ValueError(f"{path}: not a plain OFF file "
                         f"(header {tokens[0][:8] if tokens else ''!r})")
    pos = 1
    nv, nf = int(tokens[pos]), int(tokens[pos + 1])
    pos += 3  # skip edge count
    vertices = np.asarray(tokens[pos:pos + 3 * nv], dtype=np.float64).reshape(nv, 3)
    pos += 3 * nv
    faces = []
    for _ in range(nf):
        n = int(tokens[pos])
        poly = [int(t) for t in tokens[pos + 1: pos + 1 + n]]
        pos += 1 + n
        faces.extend(_triangulate(poly))
    return Mesh(vertices=vertices, faces=np.asarray(faces, np.int64).reshape(-1, 3))


def _glb_accessor(js: dict, blob: bytes, idx: int) -> np.ndarray:
    acc = js["accessors"][idx]
    bv = js["bufferViews"][acc["bufferView"]]
    comp = {5120: "i1", 5121: "u1", 5122: "i2", 5123: "u2",
            5125: "u4", 5126: "f4"}[acc["componentType"]]
    ncomp = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4}[acc["type"]]
    itemsize = np.dtype(comp).itemsize * ncomp
    stride = bv.get("byteStride") or itemsize
    start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
    count = acc["count"]
    if stride == itemsize:
        arr = np.frombuffer(blob, dtype="<" + comp, count=count * ncomp,
                            offset=start)
    else:  # interleaved attributes
        raw = np.frombuffer(blob, np.uint8, offset=start,
                            count=stride * (count - 1) + itemsize)
        gather = (np.arange(count)[:, None] * stride
                  + np.arange(itemsize)[None, :])
        arr = raw[gather].copy().view("<" + comp)
    return arr.reshape(count, ncomp)


def _glb_node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T  # column-major
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] = np.diag(node["scale"])
    if "rotation" in node:  # quaternion x, y, z, w
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        m[:3, :3] = r @ m[:3, :3]
    if "translation" in node:
        m[:3, 3] = node["translation"]
    return m


def load_glb(path: str) -> Mesh:
    """Binary glTF 2.0: JSON + BIN chunks; all triangle primitives of
    every scene node are concatenated with node TRS/matrix transforms
    applied (the observable behavior of trimesh's Scene dump for the
    single-object exports the reference pipeline consumes)."""
    import json as _json

    with open(path, "rb") as fh:
        data = fh.read()
    magic, _version, length = struct.unpack_from("<4sII", data, 0)
    if magic != b"glTF":
        raise ValueError(f"{path}: not a GLB file")
    off, js, blob = 12, None, b""
    while off + 8 <= min(length, len(data)):
        clen, ctype = struct.unpack_from("<I4s", data, off)
        off += 8
        chunk = data[off: off + clen]
        off += clen
        if ctype == b"JSON":
            js = _json.loads(chunk.decode("utf-8"))
        elif ctype == b"BIN\x00":
            blob = chunk
    if js is None:
        raise ValueError(f"{path}: GLB has no JSON chunk")

    all_v, all_f, base = [], [], 0

    def emit_mesh(mesh_idx: int, matrix: np.ndarray):
        nonlocal base
        for prim in js["meshes"][mesh_idx]["primitives"]:
            if prim.get("mode", 4) != 4:  # triangles only
                continue
            pos = _glb_accessor(js, blob, prim["attributes"]["POSITION"]).astype(np.float64)
            pos = pos @ matrix[:3, :3].T + matrix[:3, 3]
            if "indices" in prim:
                idx = _glb_accessor(js, blob, prim["indices"]).reshape(-1).astype(np.int64)
            else:
                idx = np.arange(len(pos), dtype=np.int64)
            all_v.append(pos)
            all_f.append(idx.reshape(-1, 3) + base)
            base += len(pos)

    def walk(node_idx: int, parent: np.ndarray):
        node = js["nodes"][node_idx]
        m = parent @ _glb_node_matrix(node)
        if "mesh" in node:
            emit_mesh(node["mesh"], m)
        for child in node.get("children", []):
            walk(child, m)

    scenes = js.get("scenes")
    if scenes:
        scene = scenes[js.get("scene", 0)]
        for root in scene.get("nodes", []):
            walk(root, np.eye(4))
    if not all_v:  # no scene graph: dump raw meshes
        for i in range(len(js.get("meshes", []))):
            emit_mesh(i, np.eye(4))
    if not all_v:
        raise ValueError(f"{path}: GLB contains no triangle primitives")
    return Mesh(vertices=np.concatenate(all_v),
                faces=np.concatenate(all_f).astype(np.int64))


def detect_mesh_format(data: bytes) -> str:
    """Sniff a mesh format from raw bytes -> extension ('obj', 'ply',
    'stl', 'off', 'glb'). Used by serving for uploads that carry no
    filename (the HTTP body is just bytes)."""
    head = data[:512]
    if head[:4] == b"glTF":
        return "glb"
    if head[:3] == b"ply":
        return "ply"
    stripped = head.lstrip()
    first = stripped.split(None, 1)[0].upper() if stripped else b""
    if first.endswith(b"OFF") and len(first) <= 6:
        # OFF family incl. COFF/NOFF/STOFF — route to load_off, which
        # refuses the variants with a clear message instead of letting
        # the obj parser corrupt the data
        return "off"
    if stripped[:5].lower() == b"solid":
        return "stl"
    # binary STL: 80-byte header + uint32 count covering the file size
    # (trailing padding tolerated, matching load_stl)
    if len(data) >= 84 + 50:
        (count,) = struct.unpack_from("<I", data, 80)
        if count > 0 and len(data) >= 84 + 50 * count:
            return "stl"
    return "obj"


def load_mesh(path: str) -> Mesh:
    """Load a mesh: .obj / .ply / .stl / .off / .glb — the formats
    trimesh.load accepts in the reference driver (main.py:33)."""
    lower = path.lower()
    if lower.endswith(".obj"):
        return load_obj(path)
    if lower.endswith(".ply"):
        return load_ply(path)
    if lower.endswith(".stl"):
        return load_stl(path)
    if lower.endswith(".off"):
        return load_off(path)
    if lower.endswith(".glb"):
        return load_glb(path)
    raise ValueError(f"unsupported mesh format: {path}")


def save_obj(mesh: Mesh, path: str) -> None:
    """Export OBJ with optional colors.

    The reference exports via trimesh (main.py:170-174; app.py:116-127,
    144-171 sets orange vertex colors); trimesh writes vertex colors into
    OBJ as the 'v x y z r g b' extension (0-1 floats) — replicated here
    when vertex_colors is set. Face colors have no OBJ record; they go to
    a comment header.
    """
    v = np.asarray(mesh.vertices, dtype=np.float64)
    f = np.asarray(mesh.faces, dtype=np.int64)
    lines = []
    if mesh.face_colors is not None and len(mesh.face_colors):
        c = np.asarray(mesh.face_colors[0], dtype=np.int64)
        lines.append(f"# face_color {c[0]} {c[1]} {c[2]} {c[3]}")
    if mesh.vertex_colors is not None and len(mesh.vertex_colors):
        vc = np.asarray(mesh.vertex_colors, dtype=np.float64)[:, :3] / 255.0
        for p, c in zip(v, vc):
            lines.append(
                f"v {p[0]:.8f} {p[1]:.8f} {p[2]:.8f} {c[0]:.4f} {c[1]:.4f} {c[2]:.4f}"
            )
    else:
        for p in v:
            lines.append(f"v {p[0]:.8f} {p[1]:.8f} {p[2]:.8f}")
    for tri in f + 1:
        lines.append(f"f {tri[0]} {tri[1]} {tri[2]}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
