"""Point-cloud and mesh normalization: the CLI's (main.py:45-58), the
app's mesh-bbox variant (app.py:105-133) and the watertighting
pre-normalization (mesh_to_pc.py:6-11).

JAX-free copies of ``normalize_pc_cli``, ``normalize_mesh_app``,
``normalize_vertices``, ``discretize`` and ``undiscretize`` from ``meshanything_tpu/geometry/normalize.py``:
the port cannot import the JAX package, whose ``__init__`` imports
``jax.numpy``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def normalize_pc_cli(pc_normal: np.ndarray, scale: float = 0.9995) -> np.ndarray:
    """CLI-path normalization (main.py:45-58).

    Center coords at the bbox midpoint, scale so max |coord| == 0.9995,
    assert unit normals, return float16 (N, 6).
    """
    pc_coor = pc_normal[:, :3].astype(np.float64)
    normals = pc_normal[:, 3:]
    bounds_lo = pc_coor.min(axis=0)
    bounds_hi = pc_coor.max(axis=0)
    pc_coor = pc_coor - (bounds_lo + bounds_hi)[None, :] / 2
    pc_coor = pc_coor / np.abs(pc_coor).max() * scale
    if not (np.linalg.norm(np.asarray(normals, dtype=np.float64), axis=-1) > 0.99).all():
        raise ValueError("normals should be unit vectors")
    return np.concatenate([pc_coor, normals], axis=-1).astype(np.float16)


def normalize_mesh_app(
    vertices: np.ndarray, pc_coor: np.ndarray, scale: float = 0.9995
) -> Tuple[np.ndarray, np.ndarray]:
    """App-path normalization (app.py:108-114,130).

    Both the display mesh and the sampled point cloud are centered on the
    *mesh* bbox midpoint and scaled by the max bbox extent; then the pc is
    rescaled so max |coord| == 0.9995.
    """
    vertices = np.asarray(vertices, dtype=np.float64)
    pc_coor = np.asarray(pc_coor, dtype=np.float64)
    bounds = np.array([vertices.min(axis=0), vertices.max(axis=0)])
    center = (bounds[0] + bounds[1]) / 2
    extent = (bounds[1] - bounds[0]).max()
    vertices = (vertices - center) / extent
    pc_coor = (pc_coor - center) / extent
    pc_coor = pc_coor / np.abs(pc_coor).max() * scale
    return vertices, pc_coor


def normalize_vertices(vertices: np.ndarray, scale: float = 0.9):
    """Watertighting normalization (mesh_to_pc.py:6-11).

    Returns (scaled_vertices, center, scale_factor) such that
    scaled = (v - center) * scale_factor and the result spans 2*scale.
    """
    vertices = np.asarray(vertices, dtype=np.float64)
    bbmin, bbmax = vertices.min(0), vertices.max(0)
    center = (bbmin + bbmax) * 0.5
    factor = 2.0 * scale / (bbmax - bbmin).max()
    return (vertices - center) * factor, center, factor


def discretize(t: np.ndarray, low: float = -0.5, high: float = 0.5,
               num_discrete: int = 128) -> np.ndarray:
    """Continuous coords in [low, high) -> bins 0..num_discrete-1 (floor
    quantization, the inverse of ``undiscretize``; the reference ships only
    the inverse, meshanything.py:214-223)."""
    t = (np.asarray(t, dtype=np.float64) - low) / (high - low)
    t = t * num_discrete
    return np.clip(t.astype(np.int64), 0, num_discrete - 1)


def undiscretize(t: np.ndarray, low: float = -0.5, high: float = 0.5,
                 num_discrete: int = 128) -> np.ndarray:
    """Bins -> continuous coords (meshanything.py:214-223): t/N*(high-low)+low."""
    t = np.asarray(t, dtype=np.float32)
    t = t / num_discrete
    return t * (high - low) + low
