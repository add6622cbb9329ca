"""Wireframe preview renders (reference app.py:27-92): a JAX-free copy of
``meshanything_tpu/runtime/render.py``, two backends behind one API:

* ``backend="numpy"`` (default): a vectorized software rasterizer — an
  orthographic projection at the reference's two views, painter's-
  algorithm fill in the reference's brownish-yellow with black edges,
  written straight to PNG (``utils/io.py::write_png``, no image library).
* ``backend="matplotlib"``: the reference-exact Poly3DCollection path
  (y/z swap, (0.8, 0.5, 0.2) faces, black 0.5 edges, views (90, 20) and
  (270, 20) side by side). matplotlib is imported when this backend is
  asked for; where it is not installed (the H100 machine has none) the
  call raises ImportError naming the backend, and never falls back to the
  numpy renderer.

Both produce the same composition: the y/z-swapped mesh, two views side
by side, centered on the mesh bounds.
"""
from __future__ import annotations

import numpy as np

FACE_RGB = np.array([0.8, 0.5, 0.2])   # brownish yellow (app.py:51)
BG_RGB = np.array([1.0, 1.0, 1.0])


def _view_rotation(azim_deg: float, elev_deg: float) -> np.ndarray:
    """Rotation matching matplotlib's view_init camera: azimuth about
    +z then elevation; the camera looks down -x of the rotated frame,
    screen x = rotated y, screen y = rotated z."""
    az = np.deg2rad(azim_deg)
    el = np.deg2rad(elev_deg)
    ca, sa = np.cos(az), np.sin(az)
    ce, se = np.cos(el), np.sin(el)
    rot_z = np.array([[ca, sa, 0.0], [-sa, ca, 0.0], [0.0, 0.0, 1.0]])
    rot_y = np.array([[ce, 0.0, se], [0.0, 1.0, 0.0], [-se, 0.0, ce]])
    return rot_y @ rot_z


def _rasterize_view(tri: np.ndarray, azim: float, elev: float,
                    size: int) -> np.ndarray:
    """Painter's-algorithm fill + edge darkening for one view — fully
    vectorized: faces are bucketed by bounding-box size, every bucket
    emits its candidate pixels (barycentric inside-test + edge distance)
    in bulk, and ONE fancy assignment sorted by paint order resolves
    overlaps (NumPy fancy assignment is last-write-wins, so sorting the
    candidate pixels back-to-front IS the painter's algorithm).

    tri: (F, 3, 3) world-space triangles (already y/z swapped and
    bounds-normalized to [-0.5, 0.5]^3). Returns (size, size, 3) f32.
    """
    img = np.tile(BG_RGB, (size * size, 1)).astype(np.float32)
    if not len(tri):
        return img.reshape(size, size, 3)

    rot = _view_rotation(azim, elev)
    cam = (tri.reshape(-1, 3) @ rot.T).astype(np.float32)  # (F*3, 3)
    depth = cam[:, 0].reshape(-1, 3)                      # camera looks down -x
    # screen coords in pixels, small margin, y up -> row down
    margin = 0.05
    xy = cam[:, 1:].reshape(-1, 3, 2)
    px = ((xy[..., 0] + 0.5) * (1 - 2 * margin) + margin) * (size - 1)
    py = (1.0 - ((xy[..., 1] + 0.5) * (1 - 2 * margin) + margin)) * (size - 1)

    # FRONT-to-back processing with first-write-wins occlusion: the
    # equivalent of the painter's algorithm, but overdraw-bounded — a
    # face whose bbox is already fully painted is skipped outright.
    # (A back-to-front global sort is elegant but degenerates on
    # "triangle soup" output from untrained weights: 800 canvas-sized
    # faces emit ~3e8 candidate pixels and swap the host. Measured in the JAX
    # package's serving: 80-226 s per preview; this formulation renders the same
    # soup in under a second.)
    order = np.argsort(-depth.mean(axis=1))               # front first

    # lambert-ish modulation keeps large flat regions readable
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nn = np.linalg.norm(n, axis=1)
    nn[nn == 0] = 1.0
    shade = (0.72 + 0.28 * np.abs((n @ rot.T)[:, 0] / nn)).astype(np.float32)
    colors = FACE_RGB[None].astype(np.float32) * shade[:, None]  # (F, 3)

    edge_px = np.float32(max(1.0, size / 600.0))          # ~0.5pt at dpi 120

    # integer bounding boxes, clipped to the canvas
    ix0 = np.clip(np.floor(px.min(axis=1)), 0, size - 1).astype(np.int64)
    iy0 = np.clip(np.floor(py.min(axis=1)), 0, size - 1).astype(np.int64)
    ix1 = np.clip(np.ceil(px.max(axis=1)), 0, size - 1).astype(np.int64)
    iy1 = np.clip(np.ceil(py.max(axis=1)), 0, size - 1).astype(np.int64)
    bw = ix1 - ix0 + 1
    bh = iy1 - iy0 + 1

    ax_, ay = px[:, 0], py[:, 0]
    bx, by = px[:, 1], py[:, 1]
    cx, cy = px[:, 2], py[:, 2]
    den = (by - cy) * (ax_ - cx) + (cx - bx) * (ay - cy)   # 2*signed area
    valid = (np.abs(den) > 1e-12) & (bw > 0) & (bh > 0) \
        & (px.max(axis=1) >= 0) & (px.min(axis=1) <= size - 1) \
        & (py.max(axis=1) >= 0) & (py.min(axis=1) <= size - 1)
    # edge "heights": dist-to-edge = barycentric * opposite height
    h0 = np.abs(den) / np.maximum(np.hypot(bx - cx, by - cy), 1e-12)
    h1 = np.abs(den) / np.maximum(np.hypot(cx - ax_, cy - ay), 1e-12)
    h2 = np.abs(den) / np.maximum(np.hypot(ax_ - bx, ay - by), 1e-12)

    order = order[valid[order]]
    written = np.zeros(size * size, np.bool_)
    written2d = written.reshape(size, size)
    area = (bw * bh)[order]
    # chunk faces (front-to-back) so each slab's candidate pixels stay
    # memory-bounded; slabs are resolved in order, and `written` masks
    # out pixels owned by nearer faces from earlier slabs
    budget = 4_000_000
    cuts = np.searchsorted(np.cumsum(area), np.arange(1, 64) * budget)
    start = 0
    for stop in list(cuts[cuts > 0]) + [len(order)]:
        stop = min(int(stop), len(order))
        if stop <= start:
            continue
        chunk = order[start:stop]
        start = stop
        # occlusion skip: drop faces whose bbox is already fully painted
        keep = np.asarray([f for f in chunk
                           if not written2d[iy0[f]:iy1[f] + 1,
                                            ix0[f]:ix1[f] + 1].all()])
        if not len(keep):
            continue
        # coarse 8x8-block coverage map for the hierarchical big-face
        # path: block True = every pixel painted by an earlier slab
        # (out-of-canvas padding counts as painted — bboxes never reach it)
        nb = -(-size // 8)
        padw = np.ones((nb * 8, nb * 8), np.bool_)
        padw[:size, :size] = written2d
        cov = padw.reshape(nb, 8, nb, 8).all(axis=(1, 3))
        # chunk position = priority (front-most first)
        pos_of = {int(f): i for i, f in enumerate(keep)}

        pix_parts, prio_parts, col_parts = [], [], []
        side = np.maximum(bw[keep], bh[keep])
        lo = 0
        for hi in (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2 * size):
            sel = keep[(side > lo) & (side <= hi)]
            big = lo >= 64
            lo = hi
            if not len(sel):
                continue
            k = min(hi, size)
            off = np.arange(k)
            gx = (ix0[sel, None, None] + off[None, None, :]).astype(np.int32)
            gy = (iy0[sel, None, None] + off[None, :, None]).astype(np.int32)
            inb = (gx <= ix1[sel, None, None].astype(np.int32)) \
                & (gy <= iy1[sel, None, None].astype(np.int32))
            if big:
                # hierarchical: test 8x8 BLOCKS first (64x fewer
                # candidates), keeping only blocks that are (a) not
                # fully painted by nearer slabs and (b) conservatively
                # intersecting the triangle; then expand survivors to
                # pixels. The triangle-soup case (800 canvas-sized
                # faces, ~1e8 raw candidates) collapses to the visible
                # fringe blocks.
                bx0 = ix0[sel] // 8
                by0 = iy0[sel] // 8
                bx1 = np.minimum(ix1[sel] // 8, nb - 1)
                by1 = np.minimum(iy1[sel] // 8, nb - 1)
                kb = int(max(np.maximum(bx1 - bx0, by1 - by0).max() + 1, 1))
                boff = np.arange(kb)
                bgx = (bx0[:, None, None] + boff[None, None, :]).astype(np.int32)
                bgy = (by0[:, None, None] + boff[None, :, None]).astype(np.int32)
                binb = (bgx <= bx1[:, None, None]) & (bgy <= by1[:, None, None])
                bgxc = np.minimum(bgx, nb - 1)
                bgyc = np.minimum(bgy, nb - 1)
                alive = binb & ~cov[bgyc, bgxc]
                # conservative triangle test at block centers with a
                # block-radius slack on the pixel-space edge distances
                ccx = bgx.astype(np.float32) * 8 + 3.5
                ccy = bgy.astype(np.float32) * 8 + 3.5
                d = den[sel, None, None]
                w0 = ((by - cy)[sel, None, None] * (ccx - cx[sel, None, None])
                      + (cx - bx)[sel, None, None] * (ccy - cy[sel, None, None])) / d
                w1 = ((cy - ay)[sel, None, None] * (ccx - cx[sel, None, None])
                      + (ax_ - cx)[sel, None, None] * (ccy - cy[sel, None, None])) / d
                w2 = 1.0 - w0 - w1
                slack = np.float32(8.0)  # > block half-diagonal (~5.66)
                alive &= (w0 * h0[sel, None, None] >= -slack) \
                    & (w1 * h1[sel, None, None] >= -slack) \
                    & (w2 * h2[sel, None, None] >= -slack)
                bfidx, brows, bcols = np.nonzero(alive)
                if not len(bfidx):
                    continue
                # expand surviving blocks to pixels: (Nb, 8, 8)
                po = np.arange(8)
                gxp = (bgx[bfidx, np.zeros_like(bcols), bcols] * 8)[:, None, None] \
                    + po[None, None, :]
                gyp = (bgy[bfidx, brows, np.zeros_like(brows)] * 8)[:, None, None] \
                    + po[None, :, None]
                f_b = sel[bfidx]
                inb_p = (gxp >= ix0[f_b, None, None]) & (gxp <= ix1[f_b, None, None]) \
                    & (gyp >= iy0[f_b, None, None]) & (gyp <= iy1[f_b, None, None])
                pixp = gyp * np.int64(size) + gxp
                alive_p = inb_p & ~written[np.minimum(pixp, size * size - 1)]
                nzi, nzr, nzc = np.nonzero(alive_p)
                if not len(nzi):
                    continue
                gxf = gxp[nzi, np.zeros_like(nzc), nzc].astype(np.float32)
                gyf = gyp[nzi, nzr, np.zeros_like(nzr)].astype(np.float32)
                f_ = f_b[nzi]
                d = den[f_]
                w0 = ((by - cy)[f_] * (gxf - cx[f_]) + (cx - bx)[f_] * (gyf - cy[f_])) / d
                w1 = ((cy - ay)[f_] * (gxf - cx[f_]) + (ax_ - cx)[f_] * (gyf - cy[f_])) / d
                w2 = 1.0 - w0 - w1
                inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
                if not inside.any():
                    continue
                f_, gxf, gyf = f_[inside], gxf[inside], gyf[inside]
                w0, w1, w2 = w0[inside], w1[inside], w2[inside]
                dist = np.minimum(np.minimum(w0 * h0[f_], w1 * h1[f_]), w2 * h2[f_])
                pix_parts.append(gyf.astype(np.int64) * size + gxf.astype(np.int64))
                on_edge = dist < edge_px
                col = colors[f_]
                col[on_edge] = 0.0
                col_parts.append(col)
                cpos = np.asarray([pos_of[int(f)] for f in f_])
                prio_parts.append(2 * cpos + (~on_edge))
                continue
            gxf = gx.astype(np.float32)
            gyf = gy.astype(np.float32)
            d = den[sel, None, None]
            w0 = ((by - cy)[sel, None, None] * (gxf - cx[sel, None, None])
                  + (cx - bx)[sel, None, None] * (gyf - cy[sel, None, None])) / d
            w1 = ((cy - ay)[sel, None, None] * (gxf - cx[sel, None, None])
                  + (ax_ - cx)[sel, None, None] * (gyf - cy[sel, None, None])) / d
            w2 = 1.0 - w0 - w1
            inside = inb & (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
            if not inside.any():
                continue
            dist = np.minimum(
                np.minimum(w0 * h0[sel, None, None], w1 * h1[sel, None, None]),
                w2 * h2[sel, None, None],
            )
            fidx, rows, cols = np.nonzero(inside)
            pix_parts.append((gy[fidx, rows, np.zeros_like(rows)].astype(np.int64) * size
                              + gx[fidx, np.zeros_like(cols), cols]))
            on_edge = dist[fidx, rows, cols] < edge_px
            col = colors[sel[fidx]]
            col[on_edge] = 0.0
            col_parts.append(col)
            cpos = np.asarray([pos_of[int(f)] for f in sel])[fidx]
            # edges take priority over the same face's fill
            prio_parts.append(2 * cpos + (~on_edge))
        if not pix_parts:
            continue
        pix = np.concatenate(pix_parts)
        col = np.concatenate(col_parts)
        prio = np.concatenate(prio_parts)
        # first-write-wins: nearer faces have priority. NumPy fancy
        # assignment is last-write-wins, so write in REVERSE priority
        # order, masking out pixels owned by earlier (nearer) slabs.
        rev = np.argsort(-prio, kind="stable")
        pix, col = pix[rev], col[rev]
        fresh = ~written[pix]
        pix, col = pix[fresh], col[fresh]
        img[pix] = col
        written[pix] = True
    return img.reshape(size, size, 3)


def _render_numpy(vertices: np.ndarray, faces: np.ndarray, out_path: str,
                  views, size: int) -> str:
    from meshanything_tpu_torch.utils.io import write_png

    tri = vertices[faces] if len(faces) else np.zeros((0, 3, 3))
    panels = [_rasterize_view(tri, azim, elev, size) for azim, elev in views]
    img = np.concatenate(panels, axis=1)
    return write_png((np.clip(img, 0, 1) * 255).astype(np.uint8), out_path)


def _render_matplotlib(vertices, faces, out_path, views, dpi):
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("wireframe_render(backend='matplotlib') needs matplotlib, which "
                          "is not installed; backend='numpy' needs nothing") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    tri = vertices[faces] if len(faces) else np.zeros((0, 3, 3))
    fig = plt.figure(figsize=(5 * len(views), 5))
    for i, (azim, elev) in enumerate(views):
        ax = fig.add_subplot(1, len(views), i + 1, projection="3d")
        ax.set_axis_off()
        ax.add_collection3d(Poly3DCollection(
            tri,
            facecolors=(0.8, 0.5, 0.2, 1.0),
            edgecolors="k",
            linewidths=0.5,
        ))
        ax.set_xlim(-0.5, 0.5)
        ax.set_ylim(-0.5, 0.5)
        ax.set_zlim(-0.5, 0.5)
        ax.view_init(elev=elev, azim=azim)
    fig.tight_layout(pad=0)
    fig.savefig(out_path, dpi=dpi, bbox_inches="tight", pad_inches=0)
    plt.close(fig)
    return out_path


def wireframe_render(vertices: np.ndarray, faces: np.ndarray, out_path: str,
                     views=((90, 20), (270, 20)), dpi: int = 120,
                     backend: str = "numpy") -> str:
    """Render the two-view wireframe preview PNG (app.py:27-92 parity:
    y/z swap, brownish-yellow faces, black edges, views (90,20) and
    (270,20) side by side, centered on the mesh bounds)."""
    vertices = np.asarray(vertices, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    # the reference renders with y and z swapped (app.py:31)
    if len(vertices):
        vertices = vertices[:, [0, 2, 1]]
        lo = vertices.min(axis=0)
        hi = vertices.max(axis=0)
        center = (lo + hi) / 2.0
        scale = max((hi - lo).max(), 1e-12)
        vertices = (vertices - center) / scale            # [-0.5, 0.5]^3
    if backend == "matplotlib":
        return _render_matplotlib(vertices, faces, out_path, views, dpi)
    if backend != "numpy":
        raise ValueError(f"backend {backend!r}: 'numpy' or 'matplotlib'")
    size = int(5 * dpi)                                   # 5in panels at dpi
    return _render_numpy(vertices, faces, out_path, views, size)
