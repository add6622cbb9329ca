"""The Michelangelo VAE entry point of the PyTorch port (the port of
``meshanything_tpu/miche_cli.py``; the reference's secondary CLI,
MeshAnything/miche/encode.py:8-40): load a surface point cloud,
subsample 4096 points, flip position z (encode.py:30; positions only,
normals untouched), encode to shape latents, and either save the KL
latents or reconstruct a mesh through the occupancy decoder.

  python -m meshanything_tpu_torch.miche_cli --input surface.npz --out recon.obj
  python -m meshanything_tpu_torch.miche_cli --input points.npy --encode-only --out latents.npy

Input formats: .npz with 'points' (N, 3) + 'normals' (N, 3) arrays (the
reference's format, encode.py:10-12) or a combined (N, 6) 'surface' key,
or a raw (N, 6) .npy. The weights are the perceiver of the reference
checkpoint (``--pretrained_weights``) or seeded random ones
(``--random_weights``, seed 0 as in JAX). ``--device cuda`` (the default)
needs a card and never falls back to the CPU; ``--device cpu`` asks for
the CPU.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

PERCEIVER_PREFIX = "point_encoder.model.shape_model."


def get_args(argv=None):
    p = argparse.ArgumentParser("miche (PyTorch port)")
    p.add_argument("--input", required=True,
                   help=".npz (points+normals or surface keys) or .npy point cloud")
    p.add_argument("--out", required=True, help="output .obj (recon) or .npy (latents)")
    p.add_argument("--encode-only", action="store_true",
                   help="write KL latents instead of reconstructing")
    p.add_argument("--octree_depth", default=7, type=int)
    p.add_argument("--num_chunks", default=10000, type=int)
    p.add_argument("--bounds", default=1.1, type=float)
    p.add_argument("--num_points", default=4096, type=int,
                   help="subsample size (encode.py:15)")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--random_weights", action="store_true")
    p.add_argument("--pretrained_weights", default="MeshAnything_350m.pth")
    p.add_argument("--flip_z", action=argparse.BooleanOptionalAction, default=True,
                   help="flip position z as the reference does (encode.py:30); "
                        "--no-flip_z for inputs already in model convention")
    p.add_argument("--device", default="cuda", type=str)
    return p.parse_args(argv)


def load_surface(path: str, num_points: int = 4096, seed: int = 0) -> np.ndarray:
    """-> (num_points, 6) float32, subsampled by ``default_rng(seed).choice``
    as JAX subsamples (encode.py:8-21)."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            if "points" in data and "normals" in data:
                surface = np.concatenate(
                    [np.asarray(data["points"]), np.asarray(data["normals"])], axis=-1
                )
            elif "surface" in data:
                surface = np.asarray(data["surface"])
            else:
                raise ValueError(
                    f"{path}: expected 'points'+'normals' or 'surface' keys, got {list(data.keys())}"
                )
    else:
        surface = np.load(path)
    if surface.ndim == 3:
        surface = surface[0]
    if surface.ndim != 2 or surface.shape[-1] < 6:
        raise ValueError(f"{path}: need (N, >=6) xyz+normals, got {surface.shape}")
    surface = surface[:, :6].astype(np.float32)
    if surface.shape[0] < num_points:
        raise ValueError(f"{path}: need at least {num_points} points, got {surface.shape[0]}")
    rng = np.random.default_rng(seed)
    idx = rng.choice(surface.shape[0], num_points, replace=False)
    return surface[idx]


def load_perceiver(args, cfg, device):
    """The f32 perceiver on ``device``: seeded random weights (seed 0), or
    the reference checkpoint's ``point_encoder.model.shape_model.*``."""
    import torch

    from meshanything_tpu_torch.runtime import checkpoint as ckpt

    if args.random_weights:
        return ckpt.init_random_perceiver(cfg, torch.Generator(device=device).manual_seed(0))
    if not os.path.exists(args.pretrained_weights):
        raise FileNotFoundError(
            f"{args.pretrained_weights} not found; use --random_weights for a smoke run")
    tree = ckpt.convert_perceiver(ckpt.load_safetensors(args.pretrained_weights), cfg,
                                  PERCEIVER_PREFIX)
    return ckpt.perceiver_from_jax_numpy(tree, cfg, device=device, dtype=torch.float32)


def run(args, perceiver, cfg) -> dict:
    """Encode ``args.input`` with ``perceiver`` (on its device) and write
    the latents or the reconstruction; returns the run's record (for a
    reconstruction: faces, the fenced query seconds and the marching
    seconds)."""
    import torch

    from meshanything_tpu_torch.geometry import save_obj
    from meshanything_tpu_torch.models import perceiver as per_mod
    from meshanything_tpu_torch.runtime import recon

    device = perceiver.query.device
    surface = load_surface(args.input, args.num_points, args.seed)
    if args.flip_z:
        surface = surface.copy()
        surface[:, 2] *= -1        # encode.py:30: position z only
    with torch.no_grad():
        latents = per_mod.encode_latents(perceiver, cfg, torch.from_numpy(surface)[None].to(device))
        kl = per_mod.encode_kl_mode(perceiver, latents[:, 1:])
        if args.encode_only:
            np.save(args.out, kl.cpu().numpy())
            print(f"latents {tuple(kl.shape)} -> {args.out}")
            return {"out": args.out, "latents_shape": list(kl.shape)}
        decoded = per_mod.decode_latents(perceiver, cfg, kl)
    xyz, grid_size, bbox_min, bbox_max = recon.grid(args.bounds, args.octree_depth)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    logits = recon.occupancy_logits(perceiver, cfg, decoded, xyz, args.num_chunks)  # on the host
    query_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    meshes = recon.meshes_from_logits(logits, grid_size, bbox_min, bbox_max)
    march_s = time.perf_counter() - t0
    if meshes[0] is None:
        raise RuntimeError("no surface crossed the occupancy level (random weights?)")
    save_obj(meshes[0], args.out)
    print(f"reconstructed {len(meshes[0].faces)} faces -> {args.out}")
    return {"out": args.out, "faces": len(meshes[0].faces), "queries": len(xyz),
            "query_s": query_s, "march_s": march_s}


def main(argv=None) -> dict:
    from meshanything_tpu_torch.cli import resolve_device
    from meshanything_tpu_torch.config import PerceiverConfig

    args = get_args(argv)
    cfg = PerceiverConfig()
    perceiver = load_perceiver(args, cfg, resolve_device(args.device))
    return run(args, perceiver, cfg)


if __name__ == "__main__":
    main()
