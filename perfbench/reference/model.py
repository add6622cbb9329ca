"""The plain reference of MeshAnything: float32 PyTorch, written from the
model's description (arXiv:2406.10163 and the MeshAnything repository's
``main.py`` path), with no kernel, cache or batching, and nothing imported
from the program under test.

  encode:    points + normals -> Fourier features -> the Michelangelo
             perceiver (cross-attention of 257 queries, 8 self-attention
             blocks, ln_post) -> the condition: token 0 from the shape
             embed, tokens 1.. from [latents || the VAE's decoded latents]
  decoder:   run teacher-forced over [condition || served tokens] by
             the configuration's decoder family
             (``perfbench/decoders/<decoder>.py``, ``decoder_logits``)
  detok:     the noise-resistant decoder: a 6-layer BERT over
             [condition || face embeddings] -> 9 x 128 coordinate logits

Parameters are a dict of name -> float32 tensor under the names of the
program's state dict (``param_spec`` lists them from the configuration
and the decoder family; the weights come from the benchmark's own
generator). Attention runs in blocks of query rows, so a 7,459-position
pass fits beside nothing else. The primitives (``ln``, ``linear``,
``attend``, ``heads``) are the decoder families' too.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
QUERY_BLOCK = 512          # query rows an attention block takes


# ---------------------------------------------------------------------------
# parameters


class Spec(list):
    """(name, shape, kind, std) of parameters, in the order they are drawn.
    kind: "linear" (std given), "bias", "ln_weight", "ln_bias", "table"."""

    def linear(self, name: str, d_in: int, d_out: int, std: float, bias: bool = True) -> None:
        self.append((f"{name}.weight", (d_out, d_in), "linear", std))
        if bias:
            self.append((f"{name}.bias", (d_out,), "bias", 0.0))

    def norm(self, name: str, d: int) -> None:
        self.append((f"{name}.weight", (d,), "ln_weight", 0.0))
        self.append((f"{name}.bias", (d,), "ln_bias", 0.0))

    def table(self, name: str, shape) -> None:
        self.append((name, tuple(shape), "table", 0.0))


def param_spec(model: dict, decoder) -> List[Tuple[str, tuple, str, float]]:
    """Every parameter of the model, in a fixed order: the perceiver's, the
    decoder family's (``decoder.param_spec``), the detokenizer's, then the
    condition's projections into the decoder's width."""
    p, n = model["perceiver"], model["nrd"]
    spec = Spec()
    w = p["width"]
    ps = p["init_scale"] * math.sqrt(1.0 / w)
    fourier = 3 * (2 * p["num_freqs"] + 1)
    qb = p["qkv_bias"]

    def cross(prefix):
        spec.norm(f"{prefix}.ln_q", w)
        spec.norm(f"{prefix}.ln_kv", w)
        spec.linear(f"{prefix}.q", w, w, ps, qb)
        spec.linear(f"{prefix}.kv", w, 2 * w, ps, qb)
        spec.linear(f"{prefix}.proj", w, w, ps)
        spec.norm(f"{prefix}.ln_mlp", w)
        spec.linear(f"{prefix}.fc", w, 4 * w, ps)
        spec.linear(f"{prefix}.fc_out", 4 * w, w, ps)

    def block(prefix):
        spec.norm(f"{prefix}.ln1", w)
        spec.linear(f"{prefix}.qkv", w, 3 * w, ps, qb)
        spec.linear(f"{prefix}.proj", w, w, ps)
        spec.norm(f"{prefix}.ln2", w)
        spec.linear(f"{prefix}.fc", w, 4 * w, ps)
        spec.linear(f"{prefix}.fc_out", 4 * w, w, ps)

    spec.table("perceiver.query", (p["num_latents"] + 1, w))
    spec.linear("perceiver.input_proj", fourier + p["point_feats"], w, ps)
    cross("perceiver.cross_attn")
    for i in range(p["num_encoder_layers"]):
        block(f"perceiver.encoder.{i}")
    spec.norm("perceiver.ln_post", w)
    spec.linear("perceiver.pre_kl", w, 2 * p["embed_dim"], ps)
    spec.linear("perceiver.post_kl", p["embed_dim"], w, ps)
    for i in range(p["num_decoder_layers"]):
        block(f"perceiver.transformer.{i}")
    spec.linear("perceiver.geo_decoder.query_proj", fourier, w, ps)
    cross("perceiver.geo_decoder.cross")
    spec.norm("perceiver.geo_decoder.ln_post", w)
    spec.linear("perceiver.geo_decoder.output_proj", w, 1, ps)

    spec.extend(decoder.param_spec(model))

    h = n["hidden_size"]
    spec.table("nrd.pos_embedding", (n["max_faces_pos"], h))
    spec.norm("nrd.layernorm", h)
    spec.norm("nrd.point_layernorm", h)
    spec.table("nrd.point_pe", (n["cond_length"], h))
    spec.linear("nrd.cond_proj", n["cond_dim"], h, 0.02)
    spec.linear("nrd.cond_head_proj", n["cond_dim"], h, 0.02)
    spec.linear("nrd.project_down_codebook", n["codebook_dim"] * 3, h, 0.02)
    spec.linear("nrd.to_coor_logits", h, n["discrete_num"] * 9, 0.02)
    for i in range(n["num_layers"]):
        q = f"nrd.encoder.{i}"
        spec.linear(f"{q}.qkv", h, 3 * h, 0.02)
        spec.linear(f"{q}.attn_out", h, h, 0.02)
        spec.norm(f"{q}.ln_attn", h)
        spec.linear(f"{q}.fc1", h, n["intermediate_size"], 0.02)
        spec.linear(f"{q}.fc2", n["intermediate_size"], h, 0.02)
        spec.norm(f"{q}.ln_ffn", h)
    face = decoder.interface(model)
    spec.linear("cond_head_proj", face["cond_dim"], face["hidden_size"], 0.02)
    spec.linear("cond_proj", face["cond_dim"] * 2, face["hidden_size"], 0.02)
    return list(spec)


# ---------------------------------------------------------------------------
# primitives


def ln(x, W: Params, name: str, eps: float):
    return F.layer_norm(x, (x.shape[-1],), W[f"{name}.weight"], W[f"{name}.bias"], eps)


def linear(x, W: Params, name: str):
    w, b = W[f"{name}.weight"], W.get(f"{name}.bias")
    y = x @ w.T
    return y if b is None else y + b


def attend(q, k, v, scale_q: float, scale_k: float = 1.0, causal_offset: Optional[int] = None):
    """softmax(q k^T) v per head over (N, H, D) tensors, in blocks of query
    rows. causal_offset: query i sees keys [0, causal_offset + i]."""
    out = []
    kk = (k * scale_k).permute(1, 2, 0)               # (H, D, S)
    vv = v.permute(1, 0, 2)                           # (H, S, D)
    for i in range(0, q.shape[0], QUERY_BLOCK):
        qb = (q[i:i + QUERY_BLOCK] * scale_q).permute(1, 0, 2)   # (H, n, D)
        s = qb @ kk
        if causal_offset is not None:
            rows = torch.arange(i, i + qb.shape[1], device=q.device)[:, None] + causal_offset
            s = s.masked_fill(torch.arange(k.shape[0], device=q.device)[None, :] > rows,
                              float("-inf"))
        out.append((torch.softmax(s, dim=-1) @ vv).permute(1, 0, 2))
    return torch.cat(out)


def heads(x, h):
    return x.reshape(x.shape[0], h, -1)


# ---------------------------------------------------------------------------
# encode


def _fourier(x, num_freqs: int, include_pi: bool):
    freqs = 2.0 ** torch.arange(num_freqs, dtype=torch.float32, device=x.device)
    if include_pi:
        freqs = freqs * math.pi
    emb = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(emb), torch.cos(emb)], dim=-1)


def _dual_sqrt(q, k, v):
    s = 1.0 / math.sqrt(math.sqrt(q.shape[-1]))
    return attend(q, k, v, s, s)


def _perceiver_block(x, W, name, h, eps):
    q, k, v = linear(ln(x, W, f"{name}.ln1", eps), W, f"{name}.qkv").chunk(3, dim=-1)
    x = x + linear(_dual_sqrt(heads(q, h), heads(k, h), heads(v, h)).flatten(1), W,
                   f"{name}.proj")
    return x + linear(F.gelu(linear(ln(x, W, f"{name}.ln2", eps), W, f"{name}.fc")),
                      W, f"{name}.fc_out")


def encode(W: Params, model: dict, pc_normal: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 6) points and normals -> (point features (257, width), the
    decoder's condition (257, hidden))."""
    p = model["perceiver"]
    h, eps = p["heads"], p["ln_eps"]
    data = torch.cat([_fourier(pc_normal[:, :3], p["num_freqs"], p["include_pi"]),
                      pc_normal[:, 3:6]], dim=-1)
    data = linear(data, W, "perceiver.input_proj")
    x = W["perceiver.query"]
    c = "perceiver.cross_attn"
    q = linear(ln(x, W, f"{c}.ln_q", eps), W, f"{c}.q")
    k, v = linear(ln(data, W, f"{c}.ln_kv", eps), W, f"{c}.kv").chunk(2, dim=-1)
    x = x + linear(_dual_sqrt(heads(q, h), heads(k, h), heads(v, h)).flatten(1), W,
                   f"{c}.proj")
    x = x + linear(F.gelu(linear(ln(x, W, f"{c}.ln_mlp", eps), W, f"{c}.fc")), W,
                   f"{c}.fc_out")
    for i in range(p["num_encoder_layers"]):
        x = _perceiver_block(x, W, f"perceiver.encoder.{i}", h, eps)
    if p["use_ln_post"]:
        x = ln(x, W, "perceiver.ln_post", eps)
    pf = x
    mean = linear(pf[1:], W, "perceiver.pre_kl")[:, :p["embed_dim"]]   # the mode
    y = linear(mean, W, "perceiver.post_kl")
    for i in range(p["num_decoder_layers"]):
        y = _perceiver_block(y, W, f"perceiver.transformer.{i}", h, eps)
    cond = torch.cat([linear(pf[:1], W, "cond_head_proj"),
                      linear(torch.cat([pf[1:], y], dim=-1), W, "cond_proj")])
    return pf, cond


# ---------------------------------------------------------------------------
# the detokenizer


def detok_logits(W: Params, model: dict, point_feature: torch.Tensor, tokens: torch.Tensor,
                 codebook: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The served stream (T,) -> (coordinate logits (faces, 9, bins),
    face mask (faces,)): the stream without its first and last slot, ids
    under 3 masked, the rest less 3; each face's three summed rows of the
    decoder's codebook (the parameter ``codebook``) a vertex, the BERT over
    [condition || faces]."""
    n = model["nrd"]
    nq = model["num_quantizers"]
    ids = tokens[1:-1]
    ids = torch.where(ids < 3, -1, ids - 3)
    nf = ids.shape[0] // 9
    idx = ids.reshape(-1, nq)
    masked = idx == -1
    table = W[codebook]
    codes = table[idx.masked_fill(masked, 0).clamp_max(table.shape[0] - 1)]
    codes = codes.masked_fill(masked[..., None], 0.0).sum(dim=1)          # (nf * 3, dim)
    face_mask = (ids.reshape(nf, 9) != -1).all(dim=-1)
    faces = linear(codes.reshape(nf, -1), W, "nrd.project_down_codebook")
    faces = faces.masked_fill(~face_mask[:, None], 0.0) + W["nrd.pos_embedding"][:nf]
    faces = ln(faces, W, "nrd.layernorm", 1e-5)
    cond = torch.cat([linear(point_feature[:1], W, "nrd.cond_head_proj"),
                      linear(point_feature[1:], W, "nrd.cond_proj")])
    cond = ln(cond + W["nrd.point_pe"][:cond.shape[0]], W, "nrd.point_layernorm", 1e-5)
    x = torch.cat([cond, faces])
    h, eps = n["num_heads"], n["ln_eps"]
    scale = 1.0 / math.sqrt(n["hidden_size"] // h)
    for i in range(n["num_layers"]):
        q_ = f"nrd.encoder.{i}"
        q, k, v = (heads(y, h) for y in linear(x, W, f"{q_}.qkv").chunk(3, dim=-1))
        x = ln(x + linear(attend(q, k, v, scale).flatten(1), W, f"{q_}.attn_out"), W,
               f"{q_}.ln_attn", eps)
        x = ln(x + linear(F.gelu(linear(x, W, f"{q_}.fc1")), W, f"{q_}.fc2"), W,
               f"{q_}.ln_ffn", eps)
    decoded = x[cond.shape[0]:].masked_fill(~face_mask[:, None], 0.0)
    logits = linear(decoded, W, "nrd.to_coor_logits")
    return logits.reshape(nf, 9, n["discrete_num"]), face_mask
