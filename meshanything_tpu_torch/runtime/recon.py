"""VAE occupancy reconstruction: latents -> mesh (the port of
``meshanything_tpu/runtime/recon.py``).

The reference's ``extract_geometry`` (michelangelo/models/tsal/
inference_utils.py:13-80), reached through
``AlignedShapeAsLatentPLModule.recon`` / ``latent2mesh``
(asl_pl_module.py:159-196): the geo decoder's occupancy logits over a
dense grid, queried in chunks on the latents' device, then the zero
isosurface marched on the host.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from meshanything_tpu_torch.config import PerceiverConfig
from meshanything_tpu_torch.geometry.marching import marching_tetrahedra
from meshanything_tpu_torch.geometry.obj_io import Mesh
from meshanything_tpu_torch.models import perceiver as per_mod


def generate_dense_grid_points(bbox_min: np.ndarray, bbox_max: np.ndarray,
                               octree_depth: int) -> Tuple[np.ndarray, np.ndarray, list]:
    """The reference grid (graphics/primitives/volume.py:6-20):
    (2^depth + 1) points per axis, ``ij`` indexing."""
    length = bbox_max - bbox_min
    num_cells = 2 ** octree_depth
    axes = [np.linspace(bbox_min[i], bbox_max[i], num_cells + 1) for i in range(3)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    return grid.reshape(-1, 3), length, [num_cells + 1] * 3


@torch.no_grad()
def occupancy_logits(perceiver: per_mod.Perceiver, cfg: PerceiverConfig, latents: torch.Tensor,
                     xyz: np.ndarray, num_chunks: int = 10000) -> np.ndarray:
    """The geo decoder's logits (B, P) in f32 on the host for the grid
    points ``xyz`` (P, 3), queried ``num_chunks`` points at a time on the
    latents' device (each chunk goes through ``query_geometry``'s blocks of
    ``QUERY_BLOCK``). JAX pads the last chunk to keep one jit shape; each
    query attends to the latents alone, so the logits are the same
    without the pad."""
    b = latents.shape[0]
    points = torch.from_numpy(xyz).to(device=latents.device, dtype=latents.dtype)
    parts = [per_mod.query_geometry(perceiver, cfg,
                                    points[i:i + num_chunks][None].expand(b, -1, -1), latents)
             for i in range(0, len(xyz), num_chunks)]
    return torch.cat(parts, dim=1).float().cpu().numpy()


def meshes_from_logits(logits: np.ndarray, grid_size: list, bbox_min: np.ndarray,
                       bbox_max: np.ndarray) -> List[Optional[Mesh]]:
    """The zero level set of each row's field, in the grid's coordinates:
    None where no surface crosses, or where marching raises ValueError or
    RuntimeError (inference_utils.py:13-80)."""
    meshes = []
    n = grid_size[0] - 1
    for row in logits:
        try:
            verts, faces = marching_tetrahedra(row.reshape(grid_size), 0.0)
        except (ValueError, RuntimeError):
            meshes.append(None)
            continue
        if len(faces) == 0:
            meshes.append(None)
            continue
        meshes.append(Mesh(vertices=bbox_min + verts / n * (bbox_max - bbox_min), faces=faces))
    return meshes


def grid(bounds: float, octree_depth: int):
    """(xyz, grid_size, bbox_min, bbox_max) of the cube [-bounds, bounds]^3."""
    bbox_min, bbox_max = np.array([-bounds] * 3), np.array([bounds] * 3)
    xyz, _, grid_size = generate_dense_grid_points(bbox_min, bbox_max, octree_depth)
    return xyz, grid_size, bbox_min, bbox_max


def extract_geometry(perceiver: per_mod.Perceiver, cfg: PerceiverConfig, latents: torch.Tensor, *,
                     bounds: float = 1.1, octree_depth: int = 7,
                     num_chunks: int = 10000) -> List[Optional[Mesh]]:
    """Decoded latents (B, num_latents, width) -> a Mesh or None a row."""
    xyz, grid_size, bbox_min, bbox_max = grid(bounds, octree_depth)
    logits = occupancy_logits(perceiver, cfg, latents, xyz, num_chunks)
    return meshes_from_logits(logits, grid_size, bbox_min, bbox_max)


@torch.no_grad()
def reconstruct_from_pc(perceiver: per_mod.Perceiver, cfg: PerceiverConfig,
                        pc_normal: torch.Tensor, **kw) -> List[Optional[Mesh]]:
    """The whole VAE round trip (asl_pl_module.py:159-179): encode -> KL
    mode -> decode -> occupancy -> mesh."""
    latents = per_mod.encode_latents(perceiver, cfg, pc_normal)
    decoded = per_mod.decode_latents(perceiver, cfg,
                                     per_mod.encode_kl_mode(perceiver, latents[:, 1:]))
    return extract_geometry(perceiver, cfg, decoded, **kw)
