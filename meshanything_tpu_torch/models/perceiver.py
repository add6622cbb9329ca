"""Michelangelo aligned shape-latent perceiver (the port of
``meshanything_tpu/models/perceiver.py``).

  encode_latents:   points+normals --Fourier--> input_proj --cross-attn
                    (257 queries)--> self-attn stack --> ln_post
  to_shape_latents: latents[1:] --pre_kl--> Gaussian mode --post_kl-->
                    self-attn stack

  query_geometry:   query points --Fourier--> query_proj --cross-attn
                    (decoded latents)--> ln_post --> occupancy logit

Attention uses the dual-sqrt scaling with an f32 softmax.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from meshanything_tpu_torch.config import PerceiverConfig
from meshanything_tpu_torch.models.layers import (
    CrossAttentionBlock,
    SelfAttentionBlock,
    lin,
    ln,
)


def fourier_embed(x: torch.Tensor, num_freqs: int = 8, include_pi: bool = False) -> torch.Tensor:
    """[..., d] -> [..., d*(2*num_freqs+1)] as [x, sin(xf), cos(xf)], all
    frequencies of one input dim contiguous (embedder.py:87-105)."""
    freqs = 2.0 ** torch.arange(num_freqs, dtype=torch.float32, device=x.device)
    if include_pi:
        freqs = freqs * math.pi
    emb = (x[..., None] * freqs.to(x.dtype)).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(emb), torch.cos(emb)], dim=-1)


class GeoDecoder(nn.Module):
    """Weights of the cross-attention occupancy decoder
    (sal_perceiver.py:115-159)."""

    def __init__(self, cfg: PerceiverConfig, device=None, dtype=None):
        super().__init__()
        f = {"device": device, "dtype": dtype}
        w = cfg.width
        self.query_proj = nn.Linear(cfg.fourier_dim, w, **f)
        self.cross = CrossAttentionBlock(w, cfg.heads, qkv_bias=cfg.qkv_bias,
                                         ln_eps=cfg.ln_eps, **f)
        self.ln_post = nn.LayerNorm(w, eps=cfg.ln_eps, **f)
        self.output_proj = nn.Linear(w, 1, **f)


class Perceiver(nn.Module):
    def __init__(self, cfg: PerceiverConfig, device=None, dtype=None):
        super().__init__()
        f = {"device": device, "dtype": dtype}
        w = cfg.width

        def stack(n):
            return nn.ModuleList(
                SelfAttentionBlock(w, cfg.heads, qkv_bias=cfg.qkv_bias, ln_eps=cfg.ln_eps,
                                   dual_sqrt_scale=True, **f) for _ in range(n))

        self.query = nn.Parameter(torch.empty(cfg.total_latents, w, **f))
        self.input_proj = nn.Linear(cfg.fourier_dim + cfg.point_feats, w, **f)
        self.cross_attn = CrossAttentionBlock(w, cfg.heads, qkv_bias=cfg.qkv_bias,
                                              ln_eps=cfg.ln_eps, **f)
        self.encoder = stack(cfg.num_encoder_layers)
        self.ln_post = nn.LayerNorm(w, eps=cfg.ln_eps, **f)
        self.pre_kl = nn.Linear(w, 2 * cfg.embed_dim, **f)
        self.post_kl = nn.Linear(cfg.embed_dim, w, **f)
        self.transformer = stack(cfg.num_decoder_layers)
        self.geo_decoder = GeoDecoder(cfg, **f)


def encode_latents(p: Perceiver, cfg: PerceiverConfig, pc_normal: torch.Tensor) -> torch.Tensor:
    """(B, N, 6) points+normals -> (B, 1+num_latents, width) latents
    (asl_pl_module.py:145-157)."""
    pc, feats = pc_normal[..., 0:3], pc_normal[..., 3:6]
    data = torch.cat([fourier_embed(pc, cfg.num_freqs, cfg.include_pi), feats], dim=-1)
    data = lin(data, p.input_proj)
    query = p.query.to(data.dtype).expand(pc.shape[0], *p.query.shape)
    x = p.cross_attn(query, data)
    for block in p.encoder:
        x = block(x)
    if cfg.use_ln_post:
        x = ln(x, p.ln_post)
    return x


def encode_kl_mode(p: Perceiver, latents: torch.Tensor) -> torch.Tensor:
    """pre_kl -> DiagonalGaussian mode, the mean half (sal_perceiver.py:383-396)."""
    mean, _logvar = lin(latents, p.pre_kl).chunk(2, dim=-1)
    return mean


def encode_kl_sample(p: Perceiver, latents: torch.Tensor,
                     generator: torch.Generator) -> torch.Tensor:
    """pre_kl -> a draw of the DiagonalGaussian (distributions.py:36-45):
    logvar clamped to [-30, 20], mean + std * N(0, 1) from ``generator``."""
    mean, logvar = lin(latents, p.pre_kl).chunk(2, dim=-1)
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    noise = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
    return mean + std * noise


def decode_latents(p: Perceiver, cfg: PerceiverConfig, kl_embed: torch.Tensor) -> torch.Tensor:
    """post_kl + the self-attention stack (sal_perceiver.py:273-275)."""
    x = lin(kl_embed, p.post_kl)
    for block in p.transformer:
        x = block(x)
    return x


def to_shape_latents(p: Perceiver, cfg: PerceiverConfig, latents: torch.Tensor) -> torch.Tensor:
    """Deterministic VAE round-trip of the latent tokens (asl_pl_module.py:182-185)."""
    return decode_latents(p, cfg, encode_kl_mode(p, latents))


# queries a cross-attention call takes at once: its f32 scores are
# (B, heads, QUERY_BLOCK, 257), ~50 MB a row at the full width
QUERY_BLOCK = 4096


def query_geometry(p: Perceiver, cfg: PerceiverConfig, queries: torch.Tensor,
                   latents: torch.Tensor) -> torch.Tensor:
    """Occupancy logits (B, P) of (B, P, 3) query points against decoded
    latents (CrossAttentionDecoder, sal_perceiver.py:115-159). Each query
    attends to the latents alone, so the queries go through the
    cross-attention in blocks of QUERY_BLOCK (JAX's blockwise attention,
    the same math)."""
    g = p.geo_decoder
    q = lin(fourier_embed(queries, cfg.num_freqs, cfg.include_pi), g.query_proj)
    x = torch.cat([g.cross(q[:, i:i + QUERY_BLOCK], latents)
                   for i in range(0, q.shape[1], QUERY_BLOCK)], dim=1)
    return lin(ln(x, g.ln_post), g.output_proj)[..., 0]
