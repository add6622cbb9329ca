"""The Moonlight decoder family: Moonlight-16B-A3B (DeepSeek-V3's block:
multi-head latent attention, one dense layer, then mixture-of-experts
layers of 64 routed experts, top 6, beside 2 shared ones) as MeshAnything's
shape decoder. A configuration names it with ``"decoder": "moonlight"``;
its sizes are the configuration's ``model["moonlight"]``, under the names
of the port's ``MoonlightConfig``.

The functions every family module gives (``perfbench/README.md``, "Adding
a decoder family"). The reference is written from the published model
(``modeling_deepseek.py`` of https://huggingface.co/moonshotai/Moonlight-16B-A3B,
``DeepseekV3Attention``, ``DeepseekV3MoE``, ``MoEGate`` with ``noaux_tc``),
float32, non-absorbed attention over the whole [condition || tokens]
sequence, each expert's tokens gathered and every expert computed in its
own product; nothing is imported from the program outside ``program``.
Departures from the published model, all MeshAnything's interface, which
the port keeps: the hybrid token embedding through the codebook in place
of the 163,840-row text table, the face-phase and condition markers, and
rotary positions counted over the 257 condition slots.

Routing replay. On random weights the sixth and seventh of 64 scores lie
close, so bf16 rounding alone makes the program choose otherwise than a
float32 pass at some positions and layers, each such choice moves the
residual stream by several percent, and the widest logit gap then says
nothing of the kernels. So where the sample carries the program's routing
record (``read_cache``: the latent cache's row of the last request, with
each position's chosen ids beside it), the reference runs the program's
choices, weighted by its own float32 scores, after holding each choice to
its own router: every served expert's score plus bias must lie within
``ROUTE_TOL`` of the reference's sixth best at that position and layer,
or the comparison raises (and the run is not correct). A router that
chooses otherwise (a softmax, no bias) fails there; an expert or attention
kernel that computes wrong (a dropped slot, no shared experts) fails the
logit gap, or moves later layers' choices past the tolerance.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

from perfbench.counts import BF16, Work, cache_rows_read
from perfbench.reference.model import Params, Spec, attend, linear

FP32 = 4
# the std of the router's correction bias: the size of the gap between an
# expert chosen sixth and the one left seventh (sigmoid scores spread by
# about 0.2 at the published width), so the bias changes some tokens'
# choices and the comparison sees choosing by score plus bias apart from
# weighting by the score alone
BIAS_STD = 0.05
# the widest shortfall of a served choice's score plus bias below the
# reference's sixth best that the comparison takes for rounding: the
# program reads 0.018-0.026 on the card, its W8A8 control 0.082-0.113 and a
# router without the bias 0.222 (PERF.md §2)
ROUTE_TOL = 0.05


def program(model: dict, device):
    """(the port's ``MeshAnythingConfig``, its ``MeshAnything`` with the
    Moonlight decoder on ``device`` in the configuration's dtype,
    parameters uninitialised)."""
    from meshanything_tpu_torch import config as pc
    from meshanything_tpu_torch.models.meshanything import MeshAnything

    top = {k: v for k, v in model.items() if k not in ("perceiver", "moonlight", "nrd")}
    cfg = pc.MeshAnythingConfig(perceiver=pc.PerceiverConfig(**model["perceiver"]),
                                opt=pc.MoonlightConfig(**model["moonlight"]),
                                nrd=pc.NRDConfig(**model["nrd"]), **top)
    net = MeshAnything(cfg, device="meta", dtype=cfg.activation_dtype).to_empty(device=device)
    return cfg, net


def interface(model: dict) -> dict:
    o = model["moonlight"]
    return {"eos": o["eos_token_id"], "eos_row": "opt.lm_head.weight",
            "cond_length": o["cond_length"], "vocab_size": o["vocab_size"],
            "codebook": "opt.codebook", "cond_dim": o["cond_dim"],
            "hidden_size": o["hidden_size"]}


def _is_moe(o: dict, layer: int) -> bool:
    return layer >= o["first_k_dense_replace"]


def param_spec(model: dict) -> list:
    """The decoder's (name, shape, kind, std) entries, in draw order; RMSNorm
    weights 1, the routed experts as the kernel's stacked tensors."""
    o = model["moonlight"]
    spec = Spec()
    d, h, r = o["hidden_size"], o["num_heads"], o["kv_lora_rank"]
    nope, rd, vd = o["qk_nope_head_dim"], o["qk_rope_head_dim"], o["v_head_dim"]
    e, i_w = o["n_routed_experts"], o["moe_intermediate_size"]

    def norm(name, width):
        spec.append((f"{name}.weight", (width,), "ln_weight", 0.0))

    def mlp(name, width):
        spec.linear(f"{name}.gate_proj", d, width, 0.02, bias=False)
        spec.linear(f"{name}.up_proj", d, width, 0.02, bias=False)
        spec.linear(f"{name}.down_proj", width, d, 0.02, bias=False)

    spec.table("opt.extra_embeds", (3, d))
    spec.linear("opt.input_layer", o["codebook_dim"], d, 0.02)
    spec.table("opt.face_positions", (o["face_per_token"] + 3, d))
    spec.table("opt.cond_embed", (2, d))
    spec.table("opt.codebook", (o["codebook_size"], o["codebook_dim"]))
    for i in range(o["num_layers"]):
        q = f"opt.layers.{i}"
        norm(f"{q}.input_layernorm", d)
        spec.linear(f"{q}.self_attn.q_proj", d, h * (nope + rd), 0.02, bias=False)
        spec.linear(f"{q}.self_attn.kv_a_proj_with_mqa", d, r + rd, 0.02, bias=False)
        norm(f"{q}.self_attn.kv_a_layernorm", r)
        spec.linear(f"{q}.self_attn.kv_b_proj", r, h * (nope + vd), 0.02, bias=False)
        spec.linear(f"{q}.self_attn.o_proj", h * vd, d, 0.02, bias=False)
        norm(f"{q}.post_attention_layernorm", d)
        if not _is_moe(o, i):
            mlp(f"{q}.mlp", o["intermediate_size"])
            continue
        spec.linear(f"{q}.mlp.gate", d, e, 0.02, bias=False)
        spec.append((f"{q}.mlp.gate.e_score_correction_bias", (e,), "linear", BIAS_STD))
        spec.append((f"{q}.mlp.experts.gate", (e, i_w, d), "linear", 0.02))
        spec.append((f"{q}.mlp.experts.up", (e, i_w, d), "linear", 0.02))
        spec.append((f"{q}.mlp.experts.down", (e, d, i_w), "linear", 0.02))
        mlp(f"{q}.mlp.shared_experts", i_w * o["n_shared_experts"])
    norm("opt.norm", d)
    spec.linear("opt.lm_head", d, o["vocab_size"], 0.02, bias=False)
    return list(spec)


# ---------------------------------------------------------------------------
# the plain reference, teacher-forced


def rms(x: torch.Tensor, W: Params, name: str, eps: float) -> torch.Tensor:
    """DeepseekV3RMSNorm in float32."""
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * W[f"{name}.weight"]


def rotary(o: dict, n: int, device) -> tuple:
    """DeepseekV3RotaryEmbedding's cos and sin (n, rope_dim) for positions
    [0, n): the inverse frequencies and angles in float32, each frequency
    twice (halves)."""
    dim = o["qk_rope_head_dim"]
    inv_freq = 1.0 / (o["rope_theta"] ** (torch.arange(0, dim, 2, device=device).float() / dim))
    freqs = torch.outer(torch.arange(n, device=device).float(), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``apply_rotary_pos_emb`` on x (n, ..., D) with cos, sin (n, D): the
    interleaved pairs gathered into halves, then x * cos + rotate_half(x)
    * sin."""
    shape = x.shape
    x = x.reshape(*shape[:-1], shape[-1] // 2, 2).transpose(-1, -2).reshape(shape)
    half = shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    view = (shape[0],) + (1,) * (len(shape) - 2) + (shape[-1],)
    return x * cos.view(view) + rotated * sin.view(view)


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor):
    """DeepseekV3MLP on x (n, d) with (out, in) matrices."""
    return (F.silu(x @ gate.T) * (x @ up.T)) @ down.T


def served_shortfall(choice: torch.Tensor, ids: torch.Tensor) -> float:
    """How far the served ids (m, K) lie below the reference's own choice
    (m, E) of score plus bias: the widest, over positions, of the K-th
    best less the lowest served one (0 where they are the reference's top
    K); infinite where a position's ids repeat or leave the table."""
    k = ids.shape[1]
    if ids.numel() and (ids.min() < 0 or ids.max() >= choice.shape[1]
                        or (ids.sort(dim=1).values.diff(dim=1) == 0).any()):
        return float("inf")
    kth = choice.topk(k, dim=-1).values[:, -1]
    return float((kth - choice.gather(1, ids).min(dim=1).values).clamp(min=0).max()) \
        if ids.numel() else 0.0


def route(o: dict, W: Params, name: str, x: torch.Tensor,
          served: Optional[torch.Tensor] = None) -> tuple:
    """MoEGate with ``noaux_tc`` over one group: (ids (n, K), weights (n, K)).
    ``served`` (m, K), the program's choices of the first m rows, replaces
    the reference's own there once ``served_shortfall`` admits it."""
    scores = torch.sigmoid(x @ W[f"{name}.gate.weight"].T)
    choice = scores + W[f"{name}.gate.e_score_correction_bias"]
    ids = torch.topk(choice, o["num_experts_per_tok"], dim=-1).indices
    if served is not None:
        m = min(served.shape[0], ids.shape[0])
        served = served[:m].to(ids)
        short = served_shortfall(choice[:m], served)
        if not short <= ROUTE_TOL:
            raise ValueError(f"{name}: the program's chosen experts lie {short:.4g} below the "
                             f"reference's own choice (score plus bias), past {ROUTE_TOL}")
        ids = torch.cat([served, ids[m:]])
    weights = scores.gather(1, ids)
    if o["norm_topk_prob"]:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    return ids, weights * o["routed_scaling_factor"]


def moe(o: dict, W: Params, name: str, x: torch.Tensor,
        served: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DeepseekV3MoE: every expert computed on the tokens routed to it (one
    product each), weighted into the token's slot of that choice, the
    slots summed, plus the shared experts (``served``: see ``route``)."""
    ids, weights = route(o, W, name, x, served)
    slots = torch.zeros(ids.shape + (x.shape[-1],), device=x.device)
    gate, up, down = (W[f"{name}.experts.{m}"] for m in ("gate", "up", "down"))
    for e in range(o["n_routed_experts"]):
        tok, k = (ids == e).nonzero(as_tuple=True)
        if len(tok):
            slots[tok, k] = swiglu(x[tok], gate[e], up[e], down[e]) * weights[tok, k, None]
    s = f"{name}.shared_experts"
    return slots.sum(dim=1) + swiglu(x, *(W[f"{s}.{m}.weight"]
                                         for m in ("gate_proj", "up_proj", "down_proj")))


def decoder_logits(W: Params, model: dict, cond: torch.Tensor, tokens: torch.Tensor,
                   cache_probe: Optional[Callable[[int, List[tuple]], None]] = None
                   ) -> torch.Tensor:
    """Logits (T, vocab) that predict each of the T served tokens over
    [condition || tokens[:T-1]] (the prefill's last position for tokens[0]):
    MeshAnything's embedding (3 special rows, else the codebook row through
    ``input_layer``; the face phase; ``cond_embed``), then the published
    decoder, causal, with rotary positions from 0 at the condition's first
    row. ``cache_probe(layer, [(latent,), (k_pe,)])`` receives each layer's
    normalised latent and rotated shared key (C + T - 1 rows each), the
    rows a latent cache holds once the last token is chosen; where the
    program's cache it holds carries the routing record (``read_cache``),
    the MoE layers run the program's choices (the module's text)."""
    o = model["moonlight"]
    c, t = cond.shape[0], tokens.shape[0]
    h, eps = o["num_heads"], o["rms_norm_eps"]
    r, nope, rd, vd = o["kv_lora_rank"], o["qk_nope_head_dim"], o["qk_rope_head_dim"], \
        o["v_head_dim"]
    fed = tokens[:t - 1]
    gen = torch.arange(t - 1, device=tokens.device)
    code = W["opt.codebook"][(fed - 3).clamp(0, o["codebook_size"] - 1)]
    tok = torch.where((fed < 3)[:, None], W["opt.extra_embeds"][fed.clamp(0, 2)],
                      linear(code, W, "opt.input_layer"))
    phase = torch.where(fed < 3, fed, (gen - 1) % o["face_per_token"] + 3)
    tok = tok + W["opt.face_positions"][phase] + W["opt.cond_embed"][1]
    x = torch.cat([cond + W["opt.cond_embed"][0], tok])
    n = x.shape[0]
    cos, sin = rotary(o, n, x.device)
    scale = (nope + rd) ** -0.5
    served = getattr(getattr(cache_probe, "cache", None), "routes", None)
    for i in range(o["num_layers"]):
        q_ = f"opt.layers.{i}"
        a = f"{q_}.self_attn"
        y = rms(x, W, f"{q_}.input_layernorm", eps)
        q = linear(y, W, f"{a}.q_proj").view(n, h, nope + rd)
        kv_a = linear(y, W, f"{a}.kv_a_proj_with_mqa")
        latent = rms(kv_a[:, :r], W, f"{a}.kv_a_layernorm", eps)
        k_pe = apply_rotary(kv_a[:, r:], cos, sin)
        if cache_probe is not None:
            cache_probe(i, [(latent,), (k_pe,)])
        kv = linear(latent, W, f"{a}.kv_b_proj").view(n, h, nope + vd)
        query = torch.cat([q[..., :nope], apply_rotary(q[..., nope:], cos, sin)], dim=-1)
        key = torch.cat([kv[..., :nope], k_pe[:, None].expand(n, h, rd)], dim=-1)
        att = attend(query, key, kv[..., nope:], scale, causal_offset=0)
        x = x + linear(att.flatten(1), W, f"{a}.o_proj")
        y = rms(x, W, f"{q_}.post_attention_layernorm", eps)
        if _is_moe(o, i):
            j = i - o["first_k_dense_replace"]
            x = x + moe(o, W, f"{q_}.mlp", y, None if served is None else served[j].to(x.device))
        else:
            x = x + swiglu(y, *(W[f"{q_}.mlp.{m}.weight"]
                                for m in ("gate_proj", "up_proj", "down_proj")))
    return linear(rms(x[c - 1:], W, "opt.norm", eps), W, "opt.lm_head")


# ---------------------------------------------------------------------------
# the program's cache


class ProgramCache(list):
    """``read_cache``'s two groups, with the routing record beside them:
    ``routes`` (MoE layers, n, K) int64, each position's chosen ids."""
    routes: Optional[torch.Tensor] = None


def read_cache(state, row: int, n: int) -> ProgramCache:
    """Positions [0, n) of batch row ``row`` of the state's latent cache (L,
    B, S, W), as stored, on the host, in two groups: the latent's first
    ``state.latent`` values and the rotated key's rest, each {"values":
    (1, L, n, width), "scales": None}; and of its routing record."""
    kv = state.kv
    if not isinstance(kv, torch.Tensor) or kv.dim() != 4:
        raise ValueError("the state holds no latent cache (L, B, S, W)")
    if getattr(state, "routes", None) is None:
        raise ValueError("the state holds no routing record")
    rows = torch.stack([kv[layer, row, :n].cpu() for layer in range(kv.shape[0])])[None]
    out = ProgramCache([{"values": rows[..., :state.latent], "scales": None},
                        {"values": rows[..., state.latent:], "scales": None}])
    out.routes = state.routes[:, row, :n].long().cpu()
    return out


# ---------------------------------------------------------------------------
# counts: bf16 weights and latent cache, one token a step


def _linear_work(d_in: int, d_out: int, rows: int, bias: bool = False) -> Work:
    return Work(d_in * d_out * BF16 + (d_out * BF16 if bias else 0)
                + rows * (d_in + d_out) * BF16, 2 * rows * d_in * d_out)


def gemm_work(o: dict, rows: int) -> Work:
    """The step's dense-matrix products over ``rows`` token rows (cuBLAS):
    every layer's q_proj, kv_a_proj_with_mqa, the two halves of kv_b_proj
    (the query into the latent space and the latent output back), o_proj,
    the router (its f32 product counted at the bf16 weights' bytes), the
    dense layers' MLPs, then ``input_layer`` and ``lm_head``."""
    d, h, r = o["hidden_size"], o["num_heads"], o["kv_lora_rank"]
    nope, rd, vd = o["qk_nope_head_dim"], o["qk_rope_head_dim"], o["v_head_dim"]
    work = Work()
    for i in range(o["num_layers"]):
        work += _linear_work(d, h * (nope + rd), rows) + _linear_work(d, r + rd, rows)
        work += Work(h * r * (nope + vd) * BF16 + rows * h * (nope + 2 * r + vd) * BF16,
                     2 * rows * h * r * (nope + vd))
        work += _linear_work(h * vd, d, rows)
        if _is_moe(o, i):
            work += _linear_work(d, o["n_routed_experts"], rows)
        else:
            w = o["intermediate_size"]
            work += _linear_work(d, w, rows) * 2 + _linear_work(w, d, rows)
    work += _linear_work(o["codebook_dim"], d, rows, bias=True)
    return work + _linear_work(d, o["vocab_size"], rows)


def attention_call(o: dict, batch: int, rows: float) -> Work:
    """One latent-attention call of one layer: ``batch`` sequences, each
    reading ``rows`` cache rows of ``kv_lora_rank + qk_rope_head_dim``
    values and its heads' queries of that width, writing the heads'
    latent outputs; a logit of the width and a product of the latent a
    head and row."""
    h, r, w = o["num_heads"], o["kv_lora_rank"], o["kv_lora_rank"] + o["qk_rope_head_dim"]
    return Work(batch * (rows * w + h * w + h * r) * BF16, batch * 2 * rows * h * (w + r))


def experts_call(o: dict, batch: int) -> Work:
    """One expert-kernel call of one layer at B=1: the token's K chosen
    experts (distinct) and the shared experts, each matrix read once, the
    token's row read and the f32 output written; three products a slot.
    At B > 1 the distinct experts depend on the routing: not counted."""
    if batch != 1:
        raise ValueError("the experts' bytes are counted at B=1 alone: at B > 1 they depend on "
                         "how many distinct experts the rows chose")
    d, width = o["hidden_size"], o["moe_intermediate_size"]
    slots = o["num_experts_per_tok"] + o["n_shared_experts"]
    return Work(slots * 3 * width * d * BF16 + d * BF16 + d * FP32, slots * 6 * width * d)


def _moe_layers(o: dict) -> int:
    return o["num_layers"] - o["first_k_dense_replace"]


def step_work(o: dict, batch: int, rows: float) -> dict:
    """{"gemm", "attention", "experts"} of one step whose layers each read
    ``rows`` cache rows."""
    return {"gemm": gemm_work(o, batch),
            "attention": attention_call(o, batch, rows) * o["num_layers"],
            "experts": experts_call(o, batch) * _moe_layers(o)}


def prefill_work(o: dict, batch: int, c: int) -> Work:
    """The condition's causal pass: every weight read once (its tokens
    choose nearly every expert), each token's products through the active
    weights (K routed and the shared experts), causal attention over the
    heads' 192 + 128 widths, the cache rows written, the last position's
    lm_head."""
    d, h = o["hidden_size"], o["num_heads"]
    e, width = o["n_routed_experts"], o["moe_intermediate_size"]
    experts = _moe_layers(o) * (e + o["n_shared_experts"]) * 3 * width * d * BF16
    weights = gemm_work(o, 0).bytes + experts
    active = (gemm_work(o, 1).flops + experts_call(o, 1).flops * _moe_layers(o)) / 2
    qk, v = o["qk_nope_head_dim"] + o["qk_rope_head_dim"], o["v_head_dim"]
    attn = o["num_layers"] * batch * c * (c + 1) * h * (qk + v)
    written = o["num_layers"] * batch * c * (o["kv_lora_rank"] + o["qk_rope_head_dim"]) * BF16
    return Work(weights + written, 2 * batch * c * active + attn)


def decode_work(model: dict, batch: int, steps: int) -> Work:
    """The whole decode of one request as the runner's fenced ``decode_s``
    covers it: the prefill, then ``steps`` single-token steps."""
    o = model["moonlight"]
    c = o["cond_length"]
    mean_rows = cache_rows_read(c, 1, steps) / steps
    per = sum(step_work(o, batch, mean_rows).values(), Work())
    per += Work(o["num_layers"] * batch * (o["kv_lora_rank"] + o["qk_rope_head_dim"]) * BF16)
    return prefill_work(o, batch, c) + per * steps                # with the rows written


def slice_work(model: dict, batch: int, sl) -> dict:
    """{"gemm", "attention", "experts"}: Work of the steps of a traced slice
    (``devtrace.Slice``), pos0 .. pos1 - 1; the parts are the
    configuration's ``kernels`` groups."""
    o = model["moonlight"]
    c = o["cond_length"]
    s0, s1 = sl.pos0[0], sl.pos1[0]
    n = s1 - s0
    rows = cache_rows_read(c, s0, s1 - 1) / max(n, 1)
    return {k: w * n for k, w in step_work(o, batch, rows).items()}
