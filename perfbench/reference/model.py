"""The plain reference of MeshAnything: float32 PyTorch, written from the
model's description (arXiv:2406.10163 and the MeshAnything repository's
``main.py`` path), with no kernel, cache or batching, and nothing imported
from the program under test.

  encode:    points + normals -> Fourier features -> the Michelangelo
             perceiver (cross-attention of 257 queries, 8 self-attention
             blocks, ln_post) -> the condition: token 0 from the shape
             embed, tokens 1.. from [latents || the VAE's decoded latents]
  decoder:   the OPT-350M shape decoder run teacher-forced over
             [condition || served tokens]: post-LN blocks, ReLU MLP, the
             hybrid token embedding (3 special rows, else the codebook row
             through ``input_layer``), the face-phase embedding, learned
             positions with OPT's offset of 2
  detok:     the noise-resistant decoder: a 6-layer BERT over
             [condition || face embeddings] -> 9 x 128 coordinate logits

Parameters are a dict of name -> float32 tensor under the names of the
program's state dict (``param_spec`` lists them from the configuration;
the weights come from the benchmark's own generator). Attention runs in
blocks of query rows, so a 7,459-position pass fits beside nothing else.

``decoder_logits`` can hand each layer's key and value rows to a probe,
which is how the comparison reads the program's KV cache against them.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
QUERY_BLOCK = 512          # query rows an attention block takes


# ---------------------------------------------------------------------------
# parameters


def param_spec(model: dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, kind, std) of every parameter, in a fixed order.
    kind: "linear" (std given), "bias", "ln_weight", "ln_bias", "table"."""
    p, o, n = model["perceiver"], model["opt"], model["nrd"]
    spec: list = []

    def linear(name, d_in, d_out, std, bias=True):
        spec.append((f"{name}.weight", (d_out, d_in), "linear", std))
        if bias:
            spec.append((f"{name}.bias", (d_out,), "bias", 0.0))

    def norm(name, d):
        spec.append((f"{name}.weight", (d,), "ln_weight", 0.0))
        spec.append((f"{name}.bias", (d,), "ln_bias", 0.0))

    def table(name, shape):
        spec.append((name, tuple(shape), "table", 0.0))

    w = p["width"]
    ps = p["init_scale"] * math.sqrt(1.0 / w)
    fourier = 3 * (2 * p["num_freqs"] + 1)
    qb = p["qkv_bias"]

    def cross(prefix):
        norm(f"{prefix}.ln_q", w)
        norm(f"{prefix}.ln_kv", w)
        linear(f"{prefix}.q", w, w, ps, qb)
        linear(f"{prefix}.kv", w, 2 * w, ps, qb)
        linear(f"{prefix}.proj", w, w, ps)
        norm(f"{prefix}.ln_mlp", w)
        linear(f"{prefix}.fc", w, 4 * w, ps)
        linear(f"{prefix}.fc_out", 4 * w, w, ps)

    def block(prefix):
        norm(f"{prefix}.ln1", w)
        linear(f"{prefix}.qkv", w, 3 * w, ps, qb)
        linear(f"{prefix}.proj", w, w, ps)
        norm(f"{prefix}.ln2", w)
        linear(f"{prefix}.fc", w, 4 * w, ps)
        linear(f"{prefix}.fc_out", 4 * w, w, ps)

    table("perceiver.query", (p["num_latents"] + 1, w))
    linear("perceiver.input_proj", fourier + p["point_feats"], w, ps)
    cross("perceiver.cross_attn")
    for i in range(p["num_encoder_layers"]):
        block(f"perceiver.encoder.{i}")
    norm("perceiver.ln_post", w)
    linear("perceiver.pre_kl", w, 2 * p["embed_dim"], ps)
    linear("perceiver.post_kl", p["embed_dim"], w, ps)
    for i in range(p["num_decoder_layers"]):
        block(f"perceiver.transformer.{i}")
    linear("perceiver.geo_decoder.query_proj", fourier, w, ps)
    cross("perceiver.geo_decoder.cross")
    norm("perceiver.geo_decoder.ln_post", w)
    linear("perceiver.geo_decoder.output_proj", w, 1, ps)

    d = o["hidden_size"]
    table("opt.extra_embeds", (3, d))
    linear("opt.input_layer", o["codebook_dim"], d, 0.02)
    table("opt.embed_positions", (o["max_positions"] + o["pos_offset"], d))
    table("opt.face_positions", (o["face_per_token"] + 3, d))
    table("opt.cond_embed", (2, d))
    table("opt.codebook", (o["codebook_size"], o["codebook_dim"]))
    for i in range(o["num_layers"]):
        q = f"opt.layers.{i}"
        linear(f"{q}.qkv", d, 3 * d, 0.02)
        linear(f"{q}.out", d, d, 0.02)
        norm(f"{q}.ln_attn", d)
        linear(f"{q}.fc1", d, o["ffn_dim"], 0.02)
        linear(f"{q}.fc2", o["ffn_dim"], d, 0.02)
        norm(f"{q}.ln_ffn", d)
    linear("opt.lm_head", d, o["vocab_size"], 0.02, bias=False)

    h = n["hidden_size"]
    table("nrd.pos_embedding", (n["max_faces_pos"], h))
    norm("nrd.layernorm", h)
    norm("nrd.point_layernorm", h)
    table("nrd.point_pe", (n["cond_length"], h))
    linear("nrd.cond_proj", n["cond_dim"], h, 0.02)
    linear("nrd.cond_head_proj", n["cond_dim"], h, 0.02)
    linear("nrd.project_down_codebook", n["codebook_dim"] * 3, h, 0.02)
    linear("nrd.to_coor_logits", h, n["discrete_num"] * 9, 0.02)
    for i in range(n["num_layers"]):
        q = f"nrd.encoder.{i}"
        linear(f"{q}.qkv", h, 3 * h, 0.02)
        linear(f"{q}.attn_out", h, h, 0.02)
        norm(f"{q}.ln_attn", h)
        linear(f"{q}.fc1", h, n["intermediate_size"], 0.02)
        linear(f"{q}.fc2", n["intermediate_size"], h, 0.02)
        norm(f"{q}.ln_ffn", h)
    linear("cond_head_proj", o["cond_dim"], d, 0.02)
    linear("cond_proj", o["cond_dim"] * 2, d, 0.02)
    return spec


# ---------------------------------------------------------------------------
# primitives


def _ln(x, W: Params, name: str, eps: float):
    return F.layer_norm(x, (x.shape[-1],), W[f"{name}.weight"], W[f"{name}.bias"], eps)


def _linear(x, W: Params, name: str):
    w, b = W[f"{name}.weight"], W.get(f"{name}.bias")
    y = x @ w.T
    return y if b is None else y + b


def _attend(q, k, v, scale_q: float, scale_k: float = 1.0, causal_offset: Optional[int] = None):
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


def _heads(x, h):
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
    return _attend(q, k, v, s, s)


def _perceiver_block(x, W, name, h, eps):
    q, k, v = _linear(_ln(x, W, f"{name}.ln1", eps), W, f"{name}.qkv").chunk(3, dim=-1)
    x = x + _linear(_dual_sqrt(_heads(q, h), _heads(k, h), _heads(v, h)).flatten(1), W,
                    f"{name}.proj")
    return x + _linear(F.gelu(_linear(_ln(x, W, f"{name}.ln2", eps), W, f"{name}.fc")),
                       W, f"{name}.fc_out")


def encode(W: Params, model: dict, pc_normal: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 6) points and normals -> (point features (257, width), the
    decoder's condition (257, hidden))."""
    p = model["perceiver"]
    h, eps = p["heads"], p["ln_eps"]
    data = torch.cat([_fourier(pc_normal[:, :3], p["num_freqs"], p["include_pi"]),
                      pc_normal[:, 3:6]], dim=-1)
    data = _linear(data, W, "perceiver.input_proj")
    x = W["perceiver.query"]
    c = "perceiver.cross_attn"
    q = _linear(_ln(x, W, f"{c}.ln_q", eps), W, f"{c}.q")
    k, v = _linear(_ln(data, W, f"{c}.ln_kv", eps), W, f"{c}.kv").chunk(2, dim=-1)
    x = x + _linear(_dual_sqrt(_heads(q, h), _heads(k, h), _heads(v, h)).flatten(1), W,
                    f"{c}.proj")
    x = x + _linear(F.gelu(_linear(_ln(x, W, f"{c}.ln_mlp", eps), W, f"{c}.fc")), W,
                    f"{c}.fc_out")
    for i in range(p["num_encoder_layers"]):
        x = _perceiver_block(x, W, f"perceiver.encoder.{i}", h, eps)
    if p["use_ln_post"]:
        x = _ln(x, W, "perceiver.ln_post", eps)
    pf = x
    mean = _linear(pf[1:], W, "perceiver.pre_kl")[:, :p["embed_dim"]]   # the mode
    y = _linear(mean, W, "perceiver.post_kl")
    for i in range(p["num_decoder_layers"]):
        y = _perceiver_block(y, W, f"perceiver.transformer.{i}", h, eps)
    cond = torch.cat([_linear(pf[:1], W, "cond_head_proj"),
                      _linear(torch.cat([pf[1:], y], dim=-1), W, "cond_proj")])
    return pf, cond


# ---------------------------------------------------------------------------
# the decoder, teacher-forced


def decoder_logits(W: Params, model: dict, cond: torch.Tensor, tokens: torch.Tensor,
                   kv_probe: Optional[Callable[[int, torch.Tensor, torch.Tensor], None]] = None
                   ) -> torch.Tensor:
    """Logits (T, vocab) that predict each of the T served tokens: the
    prefill's last position for tokens[0], then each decode position over
    [condition || tokens[:T-1]]. ``kv_probe(layer, k, v)``, where given,
    receives each layer's key and value rows (C + T - 1, hidden), the
    rows a decode cache holds once the last token is chosen."""
    o = model["opt"]
    c, t = cond.shape[0], tokens.shape[0]
    d, h, eps = o["hidden_size"], o["num_heads"], o["ln_eps"]
    fed = tokens[:t - 1]
    gen = torch.arange(t - 1, device=tokens.device)
    code = W["opt.codebook"][(fed - 3).clamp(0, o["codebook_size"] - 1)]
    tok = torch.where((fed < 3)[:, None], W["opt.extra_embeds"][fed.clamp(0, 2)],
                      _linear(code, W, "opt.input_layer"))
    phase = torch.where(fed < 3, fed, (gen - 1) % o["face_per_token"] + 3)
    tok = tok + W["opt.face_positions"][phase] + W["opt.cond_embed"][1]
    x = torch.cat([cond + W["opt.cond_embed"][0], tok])
    n = x.shape[0]
    x = x + W["opt.embed_positions"][o["pos_offset"]:o["pos_offset"] + n]
    scale = 1.0 / math.sqrt(d // h)
    for i in range(o["num_layers"]):
        q_ = f"opt.layers.{i}"
        q, k, v = _linear(x, W, f"{q_}.qkv").chunk(3, dim=-1)
        if kv_probe is not None:
            kv_probe(i, k, v)
        att = _attend(_heads(q, h), _heads(k, h), _heads(v, h), scale, causal_offset=0)
        x = _ln(x + _linear(att.flatten(1), W, f"{q_}.out"), W, f"{q_}.ln_attn", eps)
        x = _ln(x + _linear(F.relu(_linear(x, W, f"{q_}.fc1")), W, f"{q_}.fc2"), W,
                f"{q_}.ln_ffn", eps)
    return _linear(x[c - 1:], W, "opt.lm_head")


# ---------------------------------------------------------------------------
# the detokenizer


def detok_logits(W: Params, model: dict, point_feature: torch.Tensor,
                 tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The served stream (T,) -> (coordinate logits (faces, 9, bins),
    face mask (faces,)): the stream without its first and last slot, ids
    under 3 masked, the rest less 3; each face's three summed codebook
    rows a vertex, the BERT over [condition || faces]."""
    o, n = model["opt"], model["nrd"]
    nq = model["num_quantizers"]
    ids = tokens[1:-1]
    ids = torch.where(ids < 3, -1, ids - 3)
    nf = ids.shape[0] // 9
    idx = ids.reshape(-1, nq)
    masked = idx == -1
    codes = W["opt.codebook"][idx.masked_fill(masked, 0).clamp_max(o["codebook_size"] - 1)]
    codes = codes.masked_fill(masked[..., None], 0.0).sum(dim=1)          # (nf * 3, dim)
    face_mask = (ids.reshape(nf, 9) != -1).all(dim=-1)
    faces = _linear(codes.reshape(nf, -1), W, "nrd.project_down_codebook")
    faces = faces.masked_fill(~face_mask[:, None], 0.0) + W["nrd.pos_embedding"][:nf]
    faces = _ln(faces, W, "nrd.layernorm", 1e-5)
    cond = torch.cat([_linear(point_feature[:1], W, "nrd.cond_head_proj"),
                      _linear(point_feature[1:], W, "nrd.cond_proj")])
    cond = _ln(cond + W["nrd.point_pe"][:cond.shape[0]], W, "nrd.point_layernorm", 1e-5)
    x = torch.cat([cond, faces])
    h, eps = n["num_heads"], n["ln_eps"]
    scale = 1.0 / math.sqrt(n["hidden_size"] // h)
    for i in range(n["num_layers"]):
        q_ = f"nrd.encoder.{i}"
        q, k, v = (_heads(y, h) for y in _linear(x, W, f"{q_}.qkv").chunk(3, dim=-1))
        x = _ln(x + _linear(_attend(q, k, v, scale).flatten(1), W, f"{q_}.attn_out"), W,
                f"{q_}.ln_attn", eps)
        x = _ln(x + _linear(F.gelu(_linear(x, W, f"{q_}.fc1")), W, f"{q_}.fc2"), W,
                f"{q_}.ln_ffn", eps)
    decoded = x[cond.shape[0]:].masked_fill(~face_mask[:, None], 0.0)
    logits = _linear(decoded, W, "nrd.to_coor_logits")
    return logits.reshape(nf, 9, n["discrete_num"]), face_mask
