"""Noise-resistant decoder: discrete face tokens -> continuous coords
(the port of ``meshanything_tpu/models/nrd.py``).

A bidirectional BERT encoder over [257 condition tokens || nf face
embeddings], then a 9x128-bin coordinate head, argmax and undiscretize.
The BERT layers use LN eps 1e-12; ``point_layernorm`` and ``layernorm``
are plain nn.LayerNorm with eps 1e-5. Masked faces come out NaN.
"""
from __future__ import annotations

import torch
from torch import nn

from meshanything_tpu_torch.config import NRDConfig
from meshanything_tpu_torch.models.layers import attention, col_lin, gelu, lin, ln, row_lin


class BertLayer(nn.Module):
    """One HF BERT post-LN encoder layer, bidirectional, no mask."""

    def __init__(self, cfg: NRDConfig, device=None, dtype=None):
        super().__init__()
        f = {"device": device, "dtype": dtype}
        d, i = cfg.hidden_size, cfg.intermediate_size
        self.num_heads = cfg.num_heads
        self.tp_group = None            # the model group of a tensor-parallel shard
        self.qkv = nn.Linear(d, 3 * d, **f)
        self.attn_out = nn.Linear(d, d, **f)
        self.ln_attn = nn.LayerNorm(d, eps=cfg.ln_eps, **f)
        self.fc1 = nn.Linear(d, i, **f)
        self.fc2 = nn.Linear(i, d, **f)
        self.ln_ffn = nn.LayerNorm(d, eps=cfg.ln_eps, **f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        h, g = self.num_heads, self.tp_group
        q, k, v = (t.reshape(b, n, h, -1) for t in col_lin(x, self.qkv, g).chunk(3, dim=-1))
        o = attention(q, k, v).reshape(b, n, -1)
        x = ln(x + row_lin(o, self.attn_out, g), self.ln_attn)
        return ln(x + row_lin(gelu(col_lin(x, self.fc1, g)), self.fc2, g), self.ln_ffn)


class NRD(nn.Module):
    def __init__(self, cfg: NRDConfig, device=None, dtype=None):
        super().__init__()
        f = {"device": device, "dtype": dtype}
        d = cfg.hidden_size
        self.pos_embedding = nn.Parameter(torch.empty(cfg.max_faces_pos, d, **f))
        self.layernorm = nn.LayerNorm(d, eps=1e-5, **f)
        self.point_layernorm = nn.LayerNorm(d, eps=1e-5, **f)
        self.point_pe = nn.Parameter(torch.empty(cfg.cond_length, d, **f))
        self.cond_proj = nn.Linear(cfg.cond_dim, d, **f)
        self.cond_head_proj = nn.Linear(cfg.cond_dim, d, **f)
        self.project_down_codebook = nn.Linear(cfg.codebook_dim * 3, d, **f)
        self.to_coor_logits = nn.Linear(d, cfg.discrete_num * 9, **f)
        self.encoder = nn.ModuleList(BertLayer(cfg, **f) for _ in range(cfg.num_layers))


def process_point_feature(p: NRD, cfg: NRDConfig, point_feature: torch.Tensor) -> torch.Tensor:
    """NRD's own condition projection (meshanything.py:42-48)."""
    head = lin(point_feature[:, :1], p.cond_head_proj)
    rest = lin(point_feature[:, 1:], p.cond_proj)
    x = torch.cat([head, rest], dim=1)
    x = x + p.point_pe[: x.shape[1]].to(x.dtype)
    return ln(x, p.point_layernorm)


def decode_faces(p: NRD, cfg: NRDConfig, token_ids: torch.Tensor, code_embeds: torch.Tensor,
                 point_feature: torch.Tensor) -> torch.Tensor:
    """(B, nf*9) ids, (B, nf*3, codebook_dim) summed codes, (B, 257, width)
    perceiver features -> (B, nf, 3, 3) f32 coords, NaN on masked faces
    (meshanything.py:50-80)."""
    b = token_ids.shape[0]
    token_ids = token_ids.reshape(b, -1)
    nf = token_ids.shape[1] // 9

    cond = process_point_feature(p, cfg, point_feature)
    face_embeds = lin(code_embeds.reshape(b, nf, 3 * cfg.codebook_dim), p.project_down_codebook)
    face_mask = (token_ids.reshape(b, nf, 9) != cfg.pad_id).all(dim=-1)      # (B, nf)
    face_embeds = face_embeds.masked_fill(~face_mask[..., None], 0.0)
    face_embeds = face_embeds + p.pos_embedding[:nf].to(face_embeds.dtype)
    face_embeds = ln(face_embeds, p.layernorm)

    x = torch.cat([cond, face_embeds], dim=1)
    for layer in p.encoder:
        x = layer(x)
    decoded = x[:, cond.shape[1]:].masked_fill(~face_mask[..., None], 0.0)

    logits = lin(decoded, p.to_coor_logits).reshape(b, nf, 9, cfg.discrete_num)
    bins = torch.argmax(logits, dim=-1)
    coords = (bins.float() / cfg.discrete_num - 0.5).reshape(b, nf, 3, 3)
    return coords.masked_fill(~face_mask[..., None, None], float("nan"))
