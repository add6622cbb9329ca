"""Top-level MeshAnything composition (the port of
``meshanything_tpu/models/meshanything.py``): perceiver -> condition ->
autoregressive decode -> codebook gather -> noise-resistant detokenizer.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from meshanything_tpu_torch.config import MeshAnythingConfig
from meshanything_tpu_torch.models import lookahead as la_mod
from meshanything_tpu_torch.models import nrd as nrd_mod
from meshanything_tpu_torch.models import perceiver as per_mod
from meshanything_tpu_torch.models import shape_opt as opt_mod
from meshanything_tpu_torch.models.layers import lin


class MeshAnything(nn.Module):
    """All weights of the model, one attribute per subtree of the JAX
    parameter tree (``init_meshanything_params``)."""

    def __init__(self, cfg: MeshAnythingConfig, device=None, dtype=None):
        super().__init__()
        f = {"device": device, "dtype": dtype}
        self.perceiver = per_mod.Perceiver(cfg.perceiver, **f)
        self.opt = opt_mod.ShapeOPT(cfg.opt, **f)
        self.nrd = nrd_mod.NRD(cfg.nrd, **f)
        self.cond_head_proj = nn.Linear(cfg.opt.cond_dim, cfg.opt.hidden_size, **f)
        self.cond_proj = nn.Linear(cfg.opt.cond_dim * 2, cfg.opt.hidden_size, **f)


def process_point_feature(m: MeshAnything, cfg: MeshAnythingConfig,
                          point_feature: torch.Tensor) -> torch.Tensor:
    """Condition builder (meshanything.py:125-132): token 0 from the shape
    embed, tokens 1.. from [latents || VAE-decoded latents]."""
    head = lin(point_feature[:, :1], m.cond_head_proj)
    shape_latents = per_mod.to_shape_latents(m.perceiver, cfg.perceiver, point_feature[:, 1:])
    rest = lin(torch.cat([point_feature[:, 1:], shape_latents], dim=-1), m.cond_proj)
    return torch.cat([head, rest], dim=1)


def get_codes(m: MeshAnything, cfg: MeshAnythingConfig, indices: torch.Tensor) -> torch.Tensor:
    """Codebook gather + residual-quantizer sum (meshanything.py:178-212):
    (B, T) ids with pad -1 -> (B, T/3, codebook_dim)."""
    b, t = indices.shape
    idx = indices.reshape(b, t // cfg.num_quantizers, cfg.num_quantizers)
    mask = idx == -1
    codes = m.opt.codebook[idx.masked_fill(mask, 0)]
    return codes.masked_fill(mask[..., None], 0.0).sum(dim=2)


def token_postprocess(cfg: MeshAnythingConfig, raw_tokens: torch.Tensor) -> torch.Tensor:
    """Strip the predicted bos and the final slot, map special ids to -1,
    shift the rest down by 3 (meshanything.py:163-172)."""
    out = raw_tokens[:, 1:-1]
    return torch.where(out < 3, -1, out - 3)


class GenerateOutput(NamedTuple):
    face_coords: torch.Tensor   # (B, n_max_triangles, 3, 3) f32, NaN padding
    token_ids: torch.Tensor     # (B, generate_length) raw generated stream


def encode(m: MeshAnything, cfg: MeshAnythingConfig, pc_normal: torch.Tensor):
    """Encode phase: (point features, condition embeddings)."""
    point_feature = per_mod.encode_latents(m.perceiver, cfg.perceiver,
                                           pc_normal.to(cfg.activation_dtype))
    return point_feature, process_point_feature(m, cfg, point_feature)


def detokenize(m: MeshAnything, cfg: MeshAnythingConfig, raw_tokens: torch.Tensor,
               point_feature: torch.Tensor) -> torch.Tensor:
    """Detok phase: raw token stream -> (B, n_max_triangles, 3, 3) coords."""
    ids = token_postprocess(cfg, raw_tokens)
    codes = get_codes(m, cfg, ids).to(cfg.activation_dtype)
    return nrd_mod.decode_faces(m.nrd, cfg.nrd, ids, codes, point_feature)


def generate(m: MeshAnything, cfg: MeshAnythingConfig, pc_normal: torch.Tensor, *,
             sampling: bool = False, generator: Optional[torch.Generator] = None,
             bucket: int = 512, attn: str = "pallas", lookahead: int = 0,
             wq: bool = False) -> GenerateOutput:
    """Full inference pass (meshanything.py:134-176) on (B, N, 6)
    normalized points+normals. ``lookahead`` > 0 decodes with Jacobi
    windows of that width (``models/lookahead.py``; with ``sampling``,
    speculative sampling); ``attn`` picks the cache tier, or "megakernel"
    for one K5 launch a step (single-token loop only), and ``wq`` the
    int8 layer matrices (``models/shape_opt.py``)."""
    point_feature, cond = encode(m, cfg, pc_normal)
    kw = dict(max_new_tokens=cfg.generate_length, sampling=sampling, generator=generator,
              bucket=bucket, attn=attn, wq=wq)
    if lookahead > 0:
        raw = la_mod.generate_lookahead(m.opt, cfg.opt, cond, window=lookahead, **kw)
    else:
        raw = opt_mod.generate(m.opt, cfg.opt, cond, **kw)
    return GenerateOutput(detokenize(m, cfg, raw, point_feature), raw)
