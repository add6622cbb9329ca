"""Mesh -> distance field -> watertight mesh (the ``--mc`` / ``X-MC`` path):
a JAX-free copy of ``meshanything_tpu/geometry/sdf.py``.

Equivalent of export_to_watertight (mesh_to_pc.py:13-40): normalize to a
0.9-scaled unit cube, compute a distance field on a 2**octree_depth
grid, extract the |d| = 2/size level set, rescale back.

The reference runs marching cubes on ``np.abs(sdf)``: only the
*unsigned* distance matters for the extracted shell, so this computes
exact point-to-triangle distances. The native C++ kernel
(``native/geom.cpp``, built by ``geometry/native.py`` at first use) does
the heavy loop with a uniform-grid spatial index and is the default; a
build that fails raises. The vectorized NumPy path (``native=False``) is
its plain version, which the tests hold it against.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from meshanything_tpu_torch.geometry import native as native_lib
from meshanything_tpu_torch.geometry.marching import marching_tetrahedra
from meshanything_tpu_torch.geometry.normalize import normalize_vertices
from meshanything_tpu_torch.geometry.obj_io import Mesh


def _point_triangle_distance_np(points: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """Exact distance from P points to T triangles -> (P, T).

    Standard Ericson closest-point-on-triangle, vectorized.
    points: (P, 3); tri: (T, 3, 3).
    """
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]       # (T, 3)
    ab = b - a
    ac = c - a
    p = points[:, None, :]                          # (P, 1, 3)
    ap = p - a[None]

    d1 = np.einsum("tj,ptj->pt", ab, ap)
    d2 = np.einsum("tj,ptj->pt", ac, ap)
    bp = p - b[None]
    d3 = np.einsum("tj,ptj->pt", ab, bp)
    d4 = np.einsum("tj,ptj->pt", ac, bp)
    cp = p - c[None]
    d5 = np.einsum("tj,ptj->pt", ab, cp)
    d6 = np.einsum("tj,ptj->pt", ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom_tri = va + vb + vc
    v = np.where(denom_tri != 0, vb / np.where(denom_tri == 0, 1, denom_tri), 0.0)
    w = np.where(denom_tri != 0, vc / np.where(denom_tri == 0, 1, denom_tri), 0.0)
    closest = a[None] + v[..., None] * ab[None] + w[..., None] * ac[None]

    # edge/vertex regions override the face projection
    t_ab = np.clip(np.where(d1 - d3 != 0, d1 / np.where(d1 - d3 == 0, 1, d1 - d3), 0), 0, 1)
    t_ac = np.clip(np.where(d2 - d6 != 0, d2 / np.where(d2 - d6 == 0, 1, d2 - d6), 0), 0, 1)
    t_bc_num = d4 - d3
    t_bc_den = (d4 - d3) + (d5 - d6)
    t_bc = np.clip(np.where(t_bc_den != 0, t_bc_num / np.where(t_bc_den == 0, 1, t_bc_den), 0), 0, 1)

    on_ab = a[None] + t_ab[..., None] * ab[None]
    on_ac = a[None] + t_ac[..., None] * ac[None]
    on_bc = b[None] + t_bc[..., None] * (c - b)[None]

    reg_a = (d1 <= 0) & (d2 <= 0)
    reg_b = (d3 >= 0) & (d4 <= d3)
    reg_c = (d6 >= 0) & (d5 <= d6)
    reg_ab = (~reg_a & ~reg_b & ~reg_c) & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    reg_ac = (~reg_a & ~reg_b & ~reg_c & ~reg_ab) & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    reg_bc = (~reg_a & ~reg_b & ~reg_c & ~reg_ab & ~reg_ac) & (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    closest = np.where(reg_bc[..., None], on_bc, closest)
    closest = np.where(reg_ac[..., None], on_ac, closest)
    closest = np.where(reg_ab[..., None], on_ab, closest)
    closest = np.where(reg_c[..., None], c[None] * np.ones_like(closest), closest)
    closest = np.where(reg_b[..., None], b[None] * np.ones_like(closest), closest)
    closest = np.where(reg_a[..., None], a[None] * np.ones_like(closest), closest)

    return np.linalg.norm(p - closest, axis=-1)


def udf_grid(
    vertices: np.ndarray,
    faces: np.ndarray,
    size: int = 128,
    lo: float = -1.0,
    hi: float = 1.0,
    band: Optional[float] = None,
    native: bool = True,
) -> np.ndarray:
    """Unsigned distance field of the mesh on a size^3 grid over
    [lo, hi]^3. Distances are exact within ``band`` of the surface and
    approximate beyond (marching only needs the narrow band): the native
    kernel fills the far field by Chamfer sweeps, the NumPy path
    (``native=False``) by the distance to the nearest triangle centre.
    """
    spacing = (hi - lo) / (size - 1)
    if band is None:
        band = 6.0 * spacing

    if native:
        lib = native_lib.load()
        v = np.ascontiguousarray(vertices, dtype=np.float64)
        f = np.ascontiguousarray(faces, dtype=np.int64)
        out = np.empty(size * size * size, dtype=np.float32)
        lib.udf_grid(
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(v),
            f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(f),
            size, lo, spacing,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out.reshape(size, size, size)

    # NumPy path: exact in a narrow band via a coarse bucket prefilter
    axes = lo + spacing * np.arange(size)
    gx, gy, gz = np.meshgrid(axes, axes, axes, indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)

    tri = vertices[faces]  # (T, 3, 3)
    centers = tri.mean(axis=1)
    radii = np.linalg.norm(tri - centers[:, None], axis=-1).max(axis=1)

    from scipy.spatial import cKDTree

    tree = cKDTree(centers)
    dist_center, _ = tree.query(pts, k=1)
    field = np.full(len(pts), np.inf)

    near = dist_center <= band + radii.max()
    near_idx = np.nonzero(near)[0]
    # chunk to bound memory: (P_chunk x T) distance matrices
    chunk = max(1, int(4e7 // max(1, len(tri))))
    for s in range(0, len(near_idx), chunk):
        sel = near_idx[s:s + chunk]
        d = _point_triangle_distance_np(pts[sel], tri)
        field[sel] = d.min(axis=1)
    far = ~near
    field[far] = dist_center[far]  # approximate far-field (clamped later)
    return field.reshape(size, size, size).astype(np.float32)


def export_to_watertight(mesh: Mesh, octree_depth: int = 7) -> Mesh:
    """mesh_to_pc.py:13-40 semantics: 0.9-scale normalize, distance
    field on a 2**depth grid over [-1, 1]^3, |d| = 2/size isosurface,
    rescale to original coordinates."""
    size = 2 ** octree_depth
    level = 2.0 / size

    scaled, center, factor = normalize_vertices(mesh.vertices)
    field = udf_grid(scaled, mesh.faces, size=size, lo=-1.0, hi=1.0)

    verts, faces = marching_tetrahedra(field, level)
    if len(faces) == 0:
        raise ValueError("marching produced no surface — empty input mesh?")

    # grid index -> [-1, 1] -> original frame (mesh_to_pc.py:35-36)
    verts = verts / (size - 1) * 2.0 - 1.0
    verts = verts / factor + center

    # marching_tetrahedra output is consistently outward-oriented by
    # construction (like skimage's), so no normal repair is needed here —
    # the reference doesn't fix normals on the marched shell either
    # (mesh_to_pc.py:32-40), and a BFS over a 128^3 isosurface's ~1e5-1e6
    # faces would dominate the whole --mc path.
    return Mesh(vertices=verts, faces=faces)
