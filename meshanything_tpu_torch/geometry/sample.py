"""Area-weighted surface sampling with face normals: the port of
``meshanything_tpu/geometry/sample.py``. ``sample_surface_with_normals`` is
the numpy host version; ``sample_surface_torch`` the on-device one (JAX's
``sample_surface_jax``).

Equivalent of trimesh's ``mesh.sample(n, return_index=True)`` +
``mesh.face_normals[face_idx]`` (mesh_to_pc.py:51-52).
"""
from __future__ import annotations

import numpy as np
import torch


def _uniform_barycentric(u: np.ndarray, v: np.ndarray):
    """Map two uniforms to barycentric coords uniform over the triangle."""
    # standard sqrt trick (same distribution trimesh uses)
    su = np.sqrt(u)
    a = 1.0 - su
    b = su * (1.0 - v)
    c = su * v
    return a, b, c


def sample_surface_with_normals(
    vertices: np.ndarray,
    faces: np.ndarray,
    num_samples: int = 4096,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Returns (num_samples, 6) float16 points+normals (mesh_to_pc.py:42-57)."""
    if rng is None:
        rng = np.random.default_rng()
    vertices = np.asarray(vertices, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)

    tri = vertices[faces]                      # (F, 3, 3)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    areas = 0.5 * np.linalg.norm(n, axis=-1)
    total = areas.sum()
    if total <= 0:
        raise ValueError("mesh has zero surface area")
    probs = areas / total
    face_idx = rng.choice(len(faces), size=num_samples, p=probs)

    u = rng.random(num_samples)
    v = rng.random(num_samples)
    a, b, c = _uniform_barycentric(u, v)
    t = tri[face_idx]
    points = a[:, None] * t[:, 0] + b[:, None] * t[:, 1] + c[:, None] * t[:, 2]

    normals = n[face_idx]
    norm = np.linalg.norm(normals, axis=-1, keepdims=True)
    normals = normals / np.where(norm > 1e-20, norm, 1.0)

    return np.concatenate([points, normals], axis=-1).astype(np.float16)


def sample_surface_torch(generator: torch.Generator, vertices: torch.Tensor,
                         faces: torch.Tensor, num_samples: int = 4096) -> torch.Tensor:
    """(num_samples, 6) points + unit face normals on the tensors' device:
    faces drawn by area (a degenerate face has weight 0), points by the
    sqrt barycentric map of two uniforms, all draws from ``generator``.
    The same distribution as ``sample_surface_with_normals``, not the same
    values."""
    tri = vertices[faces]                      # (F, 3, 3)
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    areas = 0.5 * torch.linalg.norm(n, dim=-1)
    face_idx = torch.multinomial(areas, num_samples, replacement=True, generator=generator)
    u, v = torch.rand((2, num_samples), generator=generator, device=vertices.device,
                      dtype=vertices.dtype)
    su = torch.sqrt(u)
    a, b, c = 1.0 - su, su * (1.0 - v), su * v
    t = tri[face_idx]
    points = a[:, None] * t[:, 0] + b[:, None] * t[:, 1] + c[:, None] * t[:, 2]
    normals = n[face_idx]
    norm = torch.linalg.norm(normals, dim=-1, keepdim=True)
    normals = normals / torch.where(norm > 1e-20, norm, torch.ones_like(norm))
    return torch.cat([points, normals], dim=-1)
