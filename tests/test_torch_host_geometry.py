"""Host geometry of the PyTorch port against the JAX package's: the STL,
OFF and GLB loaders with format sniffing, the app's normalization, the
PNG encoder and the wireframe renderer, marching tetrahedra, the
distance field (the port's own g++ build of ``native/geom.cpp`` against
its NumPy path and against the JAX package's) and the watertighting of
``--mc``.

Tolerances: everything equal to the JAX package's bit for bit (the same
source and flags build both native libraries); the native distance field
equal to the NumPy path to 1e-6 wherever it is exact (within one grid
spacing of the surface, which holds the marching level 2/size), and on
the same side of the level everywhere (the two fill the far field
differently).
"""
import json
import struct

import numpy as np
import pytest

from meshanything_tpu import geometry as jgeo
from meshanything_tpu.geometry import marching as jmarching
from meshanything_tpu.geometry import obj_io as jobj
from meshanything_tpu.geometry import sdf as jsdf
from meshanything_tpu.runtime import render as jrender
from meshanything_tpu.utils import io as jio
from meshanything_tpu_torch import geometry as geo
from meshanything_tpu_torch.geometry import marching, native, obj_io, sdf
from meshanything_tpu_torch.runtime import render
from meshanything_tpu_torch.utils import io


def _cube():
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                  [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], dtype=np.float64)
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                  [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]],
                 dtype=np.int64)
    return v, f


def _sphere(n_lat=8, n_lon=12, radius=0.8):
    """A closed UV sphere: poles plus n_lat - 1 rings."""
    rings = [[0.0, 0.0, radius]]
    for i in range(1, n_lat):
        th = np.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * np.pi * j / n_lon
            rings.append([radius * np.sin(th) * np.cos(ph), radius * np.sin(th) * np.sin(ph),
                          radius * np.cos(th)])
    rings.append([0.0, 0.0, -radius])
    v = np.asarray(rings)
    south = len(v) - 1
    f = []
    for j in range(n_lon):
        f.append([0, 1 + j, 1 + (j + 1) % n_lon])
        base = 1 + (n_lat - 2) * n_lon
        f.append([south, base + (j + 1) % n_lon, base + j])
    for i in range(n_lat - 2):
        for j in range(n_lon):
            a, b = 1 + i * n_lon + j, 1 + i * n_lon + (j + 1) % n_lon
            c, d = a + n_lon, b + n_lon
            f += [[a, c, b], [b, c, d]]
    return v, np.asarray(f, np.int64)


def _stl_binary(v, f, header=b"\x00" * 80):
    tri = v[f].astype(np.float32)
    out = header + struct.pack("<I", len(tri))
    for t in tri:
        out += struct.pack("<3f", 0, 0, 0) + t.tobytes() + b"\x00\x00"
    return out


def _stl_ascii(v, f):
    lines = ["solid cube"]
    for t in v[f]:
        lines += ["facet normal 0 0 0", "outer loop"]
        lines += [f"vertex {float(x)!r} {float(y)!r} {float(z)!r}" for x, y, z in t]
        lines += ["endloop", "endfacet"]
    return ("\n".join(lines + ["endsolid cube"]) + "\n").encode()


def _off(v, f):
    quads = "4 0 3 2 1\n4 4 5 6 7\n"               # two quads: fan-triangulated
    tris = "".join(f"3 {a} {b} {c}\n" for a, b, c in f[4:])
    text = f"OFF # a cube\n8 {2 + len(f) - 4} 0\n" + "".join(
        f"{x} {y} {z}\n" for x, y, z in v) + quads + tris
    return text.encode()


def _glb(v, f, interleaved: bool):
    """Binary glTF: a root node (scale, rotation, translation) with a
    child (matrix) holding the mesh; positions optionally interleaved
    with a second attribute (byteStride)."""
    pos = v.astype(np.float32)
    idx = f.astype(np.uint16).ravel()
    if interleaved:
        inter = np.concatenate([pos, np.ones_like(pos)], axis=1)    # POSITION + filler
        pos_bytes, stride = inter.tobytes(), 24
    else:
        pos_bytes, stride = pos.tobytes(), None
    idx_bytes = idx.tobytes()
    idx_off = len(pos_bytes)
    blob = pos_bytes + idx_bytes + b"\x00" * ((-len(pos_bytes + idx_bytes)) % 4)
    view0 = {"buffer": 0, "byteOffset": 0, "byteLength": len(pos_bytes)}
    if stride:
        view0["byteStride"] = stride
    js = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"children": [1], "scale": [2.0, 1.0, 0.5],
                   "rotation": [0.0, 0.0, np.sin(0.3), np.cos(0.3)],
                   "translation": [0.1, -0.2, 0.3]},
                  {"mesh": 0, "matrix": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0.5, 0, 0, 1]}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "indices": 1}]}],
        "accessors": [{"bufferView": 0, "componentType": 5126, "count": len(pos),
                       "type": "VEC3"},
                      {"bufferView": 1, "componentType": 5123, "count": len(idx),
                       "type": "SCALAR"}],
        "bufferViews": [view0, {"buffer": 0, "byteOffset": idx_off,
                                "byteLength": len(idx_bytes)}],
        "buffers": [{"byteLength": len(blob)}],
    }
    jbytes = json.dumps(js).encode()
    jbytes += b" " * ((-len(jbytes)) % 4)
    body = (struct.pack("<I4s", len(jbytes), b"JSON") + jbytes
            + struct.pack("<I4s", len(blob), b"BIN\x00") + blob)
    return struct.pack("<4sII", b"glTF", 2, 12 + len(body)) + body


FIXTURES = {
    "stl_binary": ("stl", lambda v, f: _stl_binary(v, f)),
    # a binary STL whose header starts with "solid": the size decides
    "stl_binary_solid_header": ("stl", lambda v, f: _stl_binary(v, f, b"solid" + b"\x00" * 75)),
    "stl_ascii": ("stl", _stl_ascii),
    "off": ("off", _off),
    "glb": ("glb", lambda v, f: _glb(v, f, interleaved=False)),
    "glb_interleaved": ("glb", lambda v, f: _glb(v, f, interleaved=True)),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_loaders_and_format_sniffing_match_jax(tmp_path, name):
    fmt, write = FIXTURES[name]
    data = write(*_cube())
    assert obj_io.detect_mesh_format(data) == jobj.detect_mesh_format(data) == fmt
    path = tmp_path / f"mesh.{fmt}"
    path.write_bytes(data)
    mine, ref = geo.load_mesh(str(path)), jgeo.load_mesh(str(path))
    np.testing.assert_array_equal(mine.vertices, ref.vertices)
    np.testing.assert_array_equal(mine.faces, ref.faces)
    assert len(mine.faces) == 12 and mine.faces.max() < len(mine.vertices)


@pytest.mark.parametrize("data,fmt", [
    (b"v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n", "obj"),
    (b"ply\nformat ascii 1.0\n", "ply"),
    (b"COFF\n3 1 0\n", "off"),
    (b"\x00" * 84 + b"\x01" * 10, "obj"),              # too short for its STL count
])
def test_format_sniffing_of_other_bodies_matches_jax(data, fmt):
    assert obj_io.detect_mesh_format(data) == jobj.detect_mesh_format(data) == fmt


@pytest.mark.parametrize("bad", [
    ("mesh.off", b"COFF\n3 1 0\n0 0 0 1 1 1 1\n"),      # refused: per-vertex colours
    ("mesh.glb", b"glTF" + struct.pack("<II", 2, 12)),   # no JSON chunk
    ("mesh.glb", b"glXF" + struct.pack("<II", 2, 12)),   # not a GLB
])
def test_loaders_refuse_what_jax_refuses(tmp_path, bad):
    name, data = bad
    path = tmp_path / name
    path.write_bytes(data)
    with pytest.raises(ValueError) as mine:
        geo.load_mesh(str(path))
    with pytest.raises(ValueError) as ref:
        jgeo.load_mesh(str(path))
    assert str(mine.value) == str(ref.value)


def test_truncated_binary_stl_raises_as_jax(tmp_path):
    """A truncated upload raises struct.error (under its 84-byte head) or
    ValueError (short of its records), which the server maps to a 400."""
    data = _stl_binary(*_cube())
    for cut, error in ((83, struct.error), (84 + 50 * 5, ValueError)):
        path = tmp_path / f"cut{cut}.stl"
        path.write_bytes(data[:cut])
        for load in (geo.load_mesh, jgeo.load_mesh):
            with pytest.raises(error):
                load(str(path))


def test_app_and_watertight_normalization_match_jax():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(50, 3)) * [2.0, 0.5, 1.0] + [3.0, -1.0, 0.2]
    pc = rng.normal(size=(200, 3)) * 0.7 + [3.0, -1.0, 0.2]
    for mine, ref in zip(geo.normalize_mesh_app(v, pc), jgeo.normalize_mesh_app(v, pc)):
        np.testing.assert_array_equal(mine, ref)
    mine, ref = geo.normalize_vertices(v), jgeo.normalize_vertices(v)
    np.testing.assert_array_equal(mine[0], ref[0])
    assert (mine[1] == ref[1]).all() and mine[2] == ref[2]


def test_write_png_and_wireframe_render_give_jaxs_bytes(tmp_path):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, size=(7, 5, 3), dtype=np.uint8)
    a, b = tmp_path / "a.png", tmp_path / "b.png"
    io.write_png(img, str(a))
    jio.write_png(img, str(b))
    assert a.read_bytes() == b.read_bytes() and a.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(ValueError, match="expects"):
        io.write_png(img[..., :2], str(a))
    # a sphere and a triangle soup of big overlapping faces (the hierarchical path)
    sv, sf = _sphere()
    soup = rng.uniform(-1, 1, size=(60, 3, 3))
    for k, (v, f) in enumerate([(sv, sf), (soup.reshape(-1, 3), np.arange(180).reshape(-1, 3)),
                                (np.zeros((0, 3)), np.zeros((0, 3), np.int64))]):
        a, b = tmp_path / f"r{k}.png", tmp_path / f"j{k}.png"
        render.wireframe_render(v, f, str(a), dpi=24)
        jrender.wireframe_render(v, f, str(b), dpi=24)
        assert a.read_bytes() == b.read_bytes(), k


def test_marching_tetrahedra_matches_jax():
    g = np.linspace(-1, 1, 20)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    field = np.sqrt(x ** 2 + (1.3 * y) ** 2 + z ** 2) + 0.05 * np.sin(5 * x)
    for level in (0.5, 0.9):
        mv, mf = marching.marching_tetrahedra(field, level)
        jv, jf = jmarching.marching_tetrahedra(field, level)
        np.testing.assert_array_equal(mv, jv)
        np.testing.assert_array_equal(mf, jf)
        assert len(mf) > 0
    empty_v, empty_f = marching.marching_tetrahedra(field, 10.0)
    assert empty_v.shape == (0, 3) and empty_f.shape == (0, 3)


@pytest.mark.parametrize("shape", ["cube", "sphere"])
def test_udf_grid_native_against_numpy_and_jax(shape):
    v, f = _cube() if shape == "cube" else _sphere()
    v = v - v.mean(axis=0)
    size = 32
    spacing = 2.0 / (size - 1)
    mine = sdf.udf_grid(v, f, size=size)
    plain = sdf.udf_grid(v, f, size=size, native=False)
    np.testing.assert_array_equal(mine, jsdf.udf_grid(v, f, size=size))
    exact = mine <= spacing
    assert exact.sum() > 100
    np.testing.assert_allclose(mine[exact], plain[exact], rtol=0, atol=1e-6)
    # beyond the exact shell both are approximate but on the same side of the level
    level = 2.0 / size
    np.testing.assert_array_equal(mine <= level, plain <= level)


@pytest.mark.parametrize("shape", ["cube", "sphere"])
def test_export_to_watertight_matches_jax(shape):
    v, f = _cube() if shape == "cube" else _sphere()
    mine = sdf.export_to_watertight(geo.Mesh(v, f), octree_depth=5)
    ref = jsdf.export_to_watertight(jgeo.Mesh(v, f), octree_depth=5)
    np.testing.assert_array_equal(mine.vertices, ref.vertices)
    np.testing.assert_array_equal(mine.faces, ref.faces)
    # the shell hugs the input within the level (|d| = 2/32 of the 0.9-scaled box)
    lo, hi = v.min(axis=0), v.max(axis=0)
    assert (mine.vertices.min(axis=0) < lo).all() and (mine.vertices.max(axis=0) > hi).all()


def test_native_build_is_keyed_by_source_and_a_failed_build_raises(tmp_path, monkeypatch):
    lib = native.load()
    assert native.load() is lib
    built = native.library_path()
    assert built.endswith(".so") and lib._name == built
    broken = tmp_path / "geom.cpp"
    broken.write_text(open(native.SOURCE).read() + "\nthis is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", str(broken))
    monkeypatch.setattr(native, "_lib", None)
    assert native.library_path() != built            # an edited source is rebuilt
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        sdf.udf_grid(*_cube(), size=8)            # no silent fall back to NumPy
