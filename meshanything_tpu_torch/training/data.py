"""VAE training data pipeline: surface + occupancy query sampling (a
numpy copy of ``meshanything_tpu/training/data.py`` over the port's own
geometry modules).

The reference vendors (but never wires up) a webdataset-style pipeline
for training the Michelangelo VAE — surface/volume/near-surface point
sampling and axis-scale augmentation
(michelangelo/data/transforms.py:85-232, SURVEY.md §2.2). This module
provides working equivalents so the VAE loss in training/losses.py is
trainable end-to-end from raw meshes:

  * sample_training_points: surface pc+normals, uniform volume queries,
    near-surface queries, and inside/outside occupancy labels
    (even-odd ray-parity test, vectorized Möller-Trumbore);
  * axis_scale_augment: per-axis random scaling with renormalization
    (transforms.py:201 semantics).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from meshanything_tpu_torch.geometry.obj_io import Mesh
from meshanything_tpu_torch.geometry.sample import sample_surface_with_normals


class VAEBatch(NamedTuple):
    surface: np.ndarray       # (n_surface, 6) points+normals
    queries: np.ndarray       # (n_vol + n_near, 3)
    occupancy: np.ndarray     # (n_vol + n_near,) float32 in {0, 1}


def ray_parity_inside(points: np.ndarray, vertices: np.ndarray, faces: np.ndarray,
                      chunk: int = 2048) -> np.ndarray:
    """Inside/outside test by ray-crossing parity.

    Vectorized Möller-Trumbore over (points x triangles); exact for
    watertight meshes. O(P*F) — fine for training-batch sizes; pair
    with geometry/sdf.py's spatial index if this becomes hot.

    The ray direction is a fixed generic (irrational-slope) vector so
    rays from grid-aligned query points don't graze triangle edges or
    the shared diagonals of axis-aligned quads (an axis-aligned +x ray
    from the cube center double-counts the face diagonal).
    """
    tri = vertices[faces].astype(np.float64)        # (F, 3, 3)
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    e1 = v1 - v0
    e2 = v2 - v0
    d = np.array([0.5773502691896258, 0.21132486540518713, 0.7886751345948129])
    d = d / np.linalg.norm(d)

    # constant per-triangle terms for a fixed direction
    h = np.cross(d, e2)                             # (F, 3)
    a = np.einsum("fj,fj->f", e1, h)                # (F,)
    ok = np.abs(a) > 1e-12
    inv_a = np.where(ok, 1.0 / np.where(ok, a, 1.0), 0.0)

    inside = np.zeros(len(points), dtype=bool)
    for start in range(0, len(points), chunk):
        p = points[start:start + chunk].astype(np.float64)   # (P, 3)
        s = p[:, None, :] - v0[None]                          # (P, F, 3)
        u = np.einsum("pfj,fj->pf", s, h) * inv_a[None]
        q = np.cross(s, e1[None])                             # (P, F, 3)
        v = q @ d * inv_a[None]
        t = np.einsum("pfj,fj->pf", q, e2) * inv_a[None]
        hit = (
            ok[None]
            & (u >= 0) & (u <= 1)
            & (v >= 0) & (u + v <= 1)
            & (t > 1e-9)
        )
        inside[start:start + chunk] = (hit.sum(axis=1) % 2) == 1
    return inside


def sample_training_points(
    mesh: Mesh,
    *,
    n_surface: int = 4096,
    n_vol: int = 1024,
    n_near: int = 1024,
    near_std: float = 0.02,
    bounds: float = 1.05,
    rng: np.random.Generator | None = None,
) -> VAEBatch:
    """One VAE training sample from a watertight mesh (the reference's
    RandomSample vol/near split, transforms.py:85-130)."""
    if rng is None:
        rng = np.random.default_rng()

    surface = sample_surface_with_normals(mesh.vertices, mesh.faces, n_surface, rng)

    vol = rng.uniform(-bounds, bounds, size=(n_vol, 3))
    anchors = sample_surface_with_normals(mesh.vertices, mesh.faces, n_near, rng)[:, :3]
    near = anchors.astype(np.float64) + rng.normal(scale=near_std, size=(n_near, 3))

    queries = np.concatenate([vol, near], axis=0)
    occupancy = ray_parity_inside(queries, np.asarray(mesh.vertices), np.asarray(mesh.faces))
    return VAEBatch(
        surface=surface.astype(np.float32),
        queries=queries.astype(np.float32),
        occupancy=occupancy.astype(np.float32),
    )


def axis_scale_augment(
    surface: np.ndarray,
    queries: np.ndarray,
    *,
    scale_range=(0.75, 1.25),
    rng: np.random.Generator | None = None,
):
    """Per-axis random scaling of positions, renormalized to the unit
    box, with normals rescaled and re-unit-normalized
    (transforms.py:201-232 semantics)."""
    if rng is None:
        rng = np.random.default_rng()
    s = rng.uniform(*scale_range, size=(3,))

    pos = surface[:, :3] * s
    q = queries * s
    # renormalize so the SURFACE keeps its original max half-extent (the
    # reference normalizes by the shape, not by the query box — volume
    # queries near the bounds would otherwise dominate the factor)
    extent = np.abs(pos).max()
    orig = np.abs(surface[:, :3]).max()
    factor = orig / max(extent, 1e-12)
    pos = pos * factor
    q = q * factor

    # normals transform with the inverse scale, then re-normalize
    n = surface[:, 3:] / s
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)

    return np.concatenate([pos, n], axis=-1).astype(np.float32), q.astype(np.float32)
