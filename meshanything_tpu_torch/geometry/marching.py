"""Isosurface extraction via vectorized marching tetrahedra (a JAX-free
copy of ``meshanything_tpu/geometry/marching.py``).

Replaces skimage.measure.marching_cubes in the watertighting path
(mesh_to_pc.py:32). The reference extracts the |sdf| = 2/size level set
— a thin offset shell whose exact triangulation scheme is irrelevant
downstream because it is immediately re-sampled into a point cloud
(mesh_to_pc.py:51). Marching tetrahedra is table-light and fully
vectorizable in NumPy, and produces a closed surface for any scalar
field.

Orientation: every emitted triangle is wound so its normal points from
the inside region (field > level) toward the outside, checked
vectorially against the tetrahedron's inside-corner centroid at
emission time. The surface is therefore consistently outward-oriented
by construction — matching skimage's gradient-oriented output — and
needs NO downstream BFS repair (the round-1 fix_normals pass on a 128^3
isosurface was a multi-minute pure-Python trap)."""
from __future__ import annotations

import numpy as np

# Freudenthal 6-tetrahedron decomposition of the unit cube around the
# main diagonal (corner 0 -> corner 7). Corner c has offset bits
# (x=c&1, y=(c>>1)&1, z=(c>>2)&1).
_TETS = np.array([
    [0, 1, 3, 7],
    [0, 1, 5, 7],
    [0, 2, 3, 7],
    [0, 2, 6, 7],
    [0, 4, 5, 7],
    [0, 4, 6, 7],
], dtype=np.int64)

# Per-case triangulation for a tetrahedron, keyed by the 4-bit "inside"
# mask of its corners. Each triangle is 3 crossed edges (a, b) with a
# inside-to-outside crossing. Topologically verified: single-corner
# cases emit the 3 edges incident to that corner; two-corner cases
# split the crossing quad along a diagonal.
_CASE_TRIS = {
    1: [[(0, 1), (0, 2), (0, 3)]],
    2: [[(0, 1), (1, 3), (1, 2)]],
    3: [[(0, 2), (0, 3), (1, 3)], [(0, 2), (1, 3), (1, 2)]],
    4: [[(0, 2), (1, 2), (2, 3)]],
    5: [[(0, 1), (2, 3), (0, 3)], [(0, 1), (1, 2), (2, 3)]],
    6: [[(0, 1), (0, 2), (2, 3)], [(0, 1), (2, 3), (1, 3)]],
    7: [[(0, 3), (1, 3), (2, 3)]],
    8: [[(0, 3), (2, 3), (1, 3)]],
    9: [[(0, 1), (2, 3), (0, 2)], [(0, 1), (1, 3), (2, 3)]],
    10: [[(0, 1), (2, 3), (1, 2)], [(0, 1), (0, 3), (2, 3)]],
    11: [[(0, 2), (2, 3), (1, 2)]],
    12: [[(0, 2), (1, 3), (0, 3)], [(0, 2), (1, 2), (1, 3)]],
    13: [[(0, 1), (1, 2), (1, 3)]],
    14: [[(0, 1), (0, 3), (0, 2)]],
}


def marching_tetrahedra(field: np.ndarray, level: float):
    """Extract the ``field == level`` isosurface.

    field: (nx, ny, nz) scalar grid. Returns (vertices (V, 3) in grid
    index coordinates, faces (F, 3) int64), vertices deduplicated per
    crossed grid edge so the surface is closed.
    """
    f = np.asarray(field, dtype=np.float64) - level
    nx, ny, nz = f.shape
    cx, cy, cz = nx - 1, ny - 1, nz - 1

    def gid_to_xyz(g):
        z = g % nz
        y = (g // nz) % ny
        x = g // (nz * ny)
        return np.stack([x, y, z], axis=-1).astype(np.float64)

    corners = np.arange(8)
    offs = np.stack([corners & 1, (corners >> 1) & 1, (corners >> 2) & 1], axis=-1)

    # Active-cell mask FIRST, on contiguous full-grid ops (8 shifted-view
    # adds into one (cx,cy,cz) count), THEN gather the 8 corners only for
    # the active cells. The level set is a thin shell, so active cells
    # are ~0.5% of the grid — materializing dense (cx,cy,cz,8) corner
    # value/gid tensors (the round-1 layout) cost ~30 s/mesh at 128^3 on
    # one host core before any geometry was computed.
    sign_u8 = (f > 0).astype(np.uint8)
    cnt = np.zeros((cx, cy, cz), dtype=np.uint8)
    for ox, oy, oz in offs:
        cnt += sign_u8[ox:ox + cx, oy:oy + cy, oz:oz + cz]
    aidx = np.nonzero(((cnt > 0) & (cnt < 8)).ravel())[0]

    ax = aidx // (cy * cz)
    rem = aidx % (cy * cz)
    ay = rem // cz
    az = rem % cz
    corner_gids = np.stack(
        [((ax + ox) * ny + (ay + oy)) * nz + (az + oz) for ox, oy, oz in offs],
        axis=1)                                        # (A, 8)
    corner_vals = f.ravel()[corner_gids]               # (A, 8)

    # accumulate (M, 3) triangle blocks of (gid_a, gid_b, t) per corner
    ga_blocks, gb_blocks, t_blocks = [], [], []
    for tet in _TETS:
        tv = corner_vals[:, tet]
        tg = corner_gids[:, tet]
        inside = tv > 0
        case = (inside[:, 0].astype(np.int64)
                | inside[:, 1].astype(np.int64) << 1
                | inside[:, 2].astype(np.int64) << 2
                | inside[:, 3].astype(np.int64) << 3)
        for case_id, tris in _CASE_TRIS.items():
            m = np.nonzero(case == case_id)[0]
            if len(m) == 0:
                continue
            inside_corners = [i for i in range(4) if (case_id >> i) & 1]
            centroid_in = gid_to_xyz(tg[m][:, inside_corners]).mean(axis=1)  # (M, 3)
            for tri in tris:
                ga = np.stack([tg[m, a] for (a, b) in tri], axis=1)   # (M, 3)
                gb = np.stack([tg[m, b] for (a, b) in tri], axis=1)
                tt = np.stack(
                    [tv[m, a] / (tv[m, a] - tv[m, b]) for (a, b) in tri], axis=1
                )
                # orient outward: normal must point away from the inside
                # corners' centroid
                pa = gid_to_xyz(ga)
                pb = gid_to_xyz(gb)
                pts = pa + tt[..., None] * (pb - pa)                  # (M, 3, 3)
                normal = np.cross(pts[:, 1] - pts[:, 0], pts[:, 2] - pts[:, 0])
                outward = pts.mean(axis=1) - centroid_in
                flip = np.einsum("ij,ij->i", normal, outward) < 0
                ga[flip] = ga[flip][:, ::-1]
                gb[flip] = gb[flip][:, ::-1]
                tt[flip] = tt[flip][:, ::-1]
                ga_blocks.append(ga)
                gb_blocks.append(gb)
                t_blocks.append(tt)

    if not ga_blocks:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)

    flat_ga = np.concatenate(ga_blocks).ravel()
    flat_gb = np.concatenate(gb_blocks).ravel()
    flat_t = np.concatenate(t_blocks).ravel()
    lo = np.minimum(flat_ga, flat_gb)
    hi = np.maximum(flat_ga, flat_gb)
    t_canon = np.where(flat_ga <= flat_gb, flat_t, 1.0 - flat_t)

    keys = lo * (nx * ny * nz) + hi
    uniq, first_idx, inv = np.unique(keys, return_index=True, return_inverse=True)

    plo = gid_to_xyz(lo[first_idx])
    phi = gid_to_xyz(hi[first_idx])
    vertices = plo + t_canon[first_idx][:, None] * (phi - plo)

    faces = inv.reshape(-1, 3)
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return vertices, faces[ok]
