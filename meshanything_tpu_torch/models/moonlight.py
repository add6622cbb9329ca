"""The Moonlight decoder: Moonlight-16B-A3B (DeepSeek-V3's block,
``modeling_deepseek.py`` of the model's repository) as MeshAnything's
autoregressive mesh-token decoder. The JAX package has no such decoder; it
is the port's second one beside ``models/shape_opt.py``.

  * MeshAnything's interface (``models/decoding.py``): the hybrid token
    embedding (3 special rows, else the codebook row through
    ``input_layer``), the face-phase embedding, ``cond_embed[0]`` on the
    condition's rows and ``cond_embed[1]`` on the tokens' rows, an untied
    ``lm_head`` over the mesh vocabulary. Positions are rotary (RoPE,
    theta 50,000 on the 64-wide parts), counted over the condition's slots
    as OPT counts its learned ones: token gen_index sits at C + gen_index.
  * pre-RMSNorm blocks; multi-head latent attention (MLA) with no query
    compression: ``q_proj`` to 16 heads of 128 + 64, ``kv_a_proj_with_mqa``
    to a 512-wide latent (RMS-normalised by ``kv_a_layernorm``) and one
    64-wide rope key shared by the heads, ``kv_b_proj`` from the latent to
    each head's 128 + 128 key and value, softmax scale 192^-0.5; RoPE in
    DeepSeek-V3's layout (each interleaved pair rotated, the output in
    halves);
  * the first ``first_k_dense_replace`` layers a SiLU-gated MLP; the rest
    mixture-of-experts: a router in f32 (``sigmoid(logits)`` plus
    ``e_score_correction_bias`` chooses the top 6 of 64; the weights are
    the chosen sigmoid scores without the bias, normalised and scaled by
    ``routed_scaling_factor``), the routed experts stacked (gate, up (E, I,
    d), down (E, d, I)) and 2 shared experts as one MLP of width 2 I;
  * a final RMSNorm before ``lm_head``.

Execution. ``prefill`` runs the non-absorbed attention over the condition
(and a completion prompt) and writes the first rows of a preallocated
latent cache (L, B, S, 576): for each layer and position the normalised
latent and the rotated shared key (``kv_lora_rank + qk_rope_head_dim``
values). Its experts run as an eager loop over the experts the tokens
chose. Beside the cache, a routing record (MoE layers, B, S, K) int32
holds each position's chosen expert ids, written by the prefill and, in
the step, by the expert kernel itself: what a comparison reads back to
hold a float32 reference to the same choices (``perfbench``'s moonlight
family). The decode step (``step_body``) runs the absorbed attention: each
head's no-rope query multiplied into the latent space by ``kv_b_proj``'s
K half, the latent kernel over the cache (``ops/latent_attention.py``),
its output mapped back by the V half; its router is one launch
(``ops/router.py``) and its routed experts (and the shared ones as two
more slots) the expert kernel (``ops/experts.py``), which reads the
chosen ids on the device. The step reads every position from
``state.step_t`` on the device, so ``decoding.decode_segment`` replays it
as a CUDA graph on a card, as it does OPT's.

Tiers: the exact bf16 tier alone (``attn="pallas"``, or "auto"). ``wq``
runs the attention projections (``q_proj``, ``kv_a_proj_with_mqa``,
``o_proj``) and the dense and shared MLPs as W8A8 (``ops/wquant.py``),
the shared MLP then beside the expert kernel. There is no training pass,
lookahead, megakernel, int8/int4 cache or tensor parallelism for this
decoder: each raises (``check_tier``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from meshanything_tpu_torch.config import MoonlightConfig
from meshanything_tpu_torch.models import decoding
from meshanything_tpu_torch.models.layers import attention, lin
from meshanything_tpu_torch.ops import experts as experts_op
from meshanything_tpu_torch.ops import gemv as gemv_op
from meshanything_tpu_torch.ops import latent_attention as latent_op
from meshanything_tpu_torch.ops import router as router_op
from meshanything_tpu_torch.ops.experts import routed_experts
from meshanything_tpu_torch.ops.kvcache import padded_length
from meshanything_tpu_torch.ops.latent_attention import latent_attention
from meshanything_tpu_torch.ops.wquant import QuantizedLinear, _quantize_linear, lin_dispatch

# the launch counts a decode graph's ``capture`` span records
# (decode_graph.StepGraph): calls of the latent kernel (one a layer) and of
# the expert kernel (one a mixture-of-experts layer), two launches each, the
# few-row product kernel's (q, latent and output projections, the dense
# MLP, the codebook projection, lm_head) and the router kernel's (one a
# mixture-of-experts layer)
CAPTURE_COUNTERS = {"mla": lambda: latent_op.latent_attention.launches,
                    "moe": lambda: experts_op.routed_experts.launches,
                    "gemv": lambda: gemv_op.gemv.launches,
                    "router": lambda: router_op.route_topk.launches}
# csrc/<name>.cu a decode launches
LIBRARIES = ("latent_attention", "experts", "router")


def libraries(o: MoonlightConfig, attn: str, lookahead, dtype: torch.dtype) -> tuple:
    """The kernel libraries a decode launches: L1, X1 and the router R1,
    whatever the tier, and in bf16 the few-row product kernel."""
    return LIBRARIES + (("gemv",) if dtype == torch.bfloat16 else ())


def cache_bytes(o: MoonlightConfig, batch: int, s_max: int, int8: bool = False,
                int4: bool = False) -> int:
    """The latent cache (``cache_width`` bf16 values a layer and position)
    and the routing record (K int32 ids a MoE layer and position); the
    quantized tiers raise (``check_tier``)."""
    return (o.num_layers * batch * s_max * o.cache_width * 2
            + o.num_moe_layers * batch * s_max * o.num_experts_per_tok * 4)


def prefill_elems(o: MoonlightConfig, rows: int, positions: int, itemsize: int) -> int:
    """The prefill's largest transients, in elements of ``itemsize``: it
    writes the cache in place, and holds a layer's f32 expert slots (K + 4
    rows of d a token, with the shared MLP's and the sum) and its f32
    attention scores."""
    tokens = rows * positions
    return (4 * tokens * (o.num_experts_per_tok + 4) * o.hidden_size
            + 8 * o.num_heads * tokens * positions) // itemsize


def wq_sizes(o: MoonlightConfig) -> tuple:
    """(elements, output channels) of the ``wq`` tier's int8 matrices
    (``quantize_layers``): every layer's q_proj, kv_a_proj_with_mqa and
    o_proj, and its dense MLP or shared experts."""
    d, h = o.hidden_size, o.num_heads
    attn_out = (h * o.q_head_dim, o.cache_width, d)
    elems = chans = 0
    for layer in range(o.num_layers):
        width = (o.moe_intermediate_size * o.n_shared_experts if o.is_moe(layer)
                 else o.intermediate_size)
        elems += d * (sum(attn_out[:2]) + h * o.v_head_dim) + 3 * d * width
        chans += sum(attn_out) + 2 * width + d
    return elems, chans


def check_tier(attn: str = "pallas", lookahead=0) -> None:
    """Raise for what the Moonlight decoder does not have: any cache tier
    but the exact one, a lookahead window, the megakernel."""
    if decoding.resolve_attn(attn) != "pallas":
        raise ValueError(f"attn={attn!r}: the moonlight decoder runs the exact tier alone "
                         "(its latent cache has no int8/int4 form and no megakernel)")
    if lookahead:
        raise ValueError("lookahead decoding is not ported for the moonlight decoder")


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d, device=device, dtype=dtype))
        self.eps = eps


def rms_norm(x: torch.Tensor, m: RMSNorm) -> torch.Tensor:
    """DeepSeek-V3's RMSNorm, ``F.rms_norm`` on x with the weight: the
    statistics in f32, the result in x's dtype."""
    return F.rms_norm(x, (x.shape[-1],), m.weight, m.eps)


class MLP(nn.Module):
    """SiLU-gated MLP: down(silu(gate(x)) * up(x)), no biases."""

    def __init__(self, d: int, width: int, device=None, dtype=None):
        super().__init__()
        f = {"device": device, "dtype": dtype, "bias": False}
        self.gate_proj = nn.Linear(d, width, **f)
        self.up_proj = nn.Linear(d, width, **f)
        self.down_proj = nn.Linear(width, d, **f)


def mlp(x: torch.Tensor, m, lin_e=lin) -> torch.Tensor:
    """``MLP`` (or its ``QuantizedMLP``) on x, in x's dtype."""
    return lin_e(F.silu(lin_e(x, m.gate_proj)) * lin_e(x, m.up_proj), m.down_proj)


class Attention(nn.Module):
    def __init__(self, cfg: MoonlightConfig, device=None, dtype=None):
        super().__init__()
        f = {"device": device, "dtype": dtype, "bias": False}
        d, h = cfg.hidden_size, cfg.num_heads
        self.q_proj = nn.Linear(d, h * cfg.q_head_dim, **f)
        self.kv_a_proj_with_mqa = nn.Linear(d, cfg.cache_width, **f)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps, device, dtype)
        self.kv_b_proj = nn.Linear(cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                                   **f)
        self.o_proj = nn.Linear(h * cfg.v_head_dim, d, **f)


class Router(nn.Module):
    def __init__(self, cfg: MoonlightConfig, device=None, dtype=None):
        super().__init__()
        e = cfg.n_routed_experts
        self.weight = nn.Parameter(torch.empty(e, cfg.hidden_size, device=device, dtype=dtype))
        self.e_score_correction_bias = nn.Parameter(torch.empty(e, device=device, dtype=dtype))


class Experts(nn.Module):
    """The routed experts' matrices, stacked as the expert kernel reads them."""

    def __init__(self, cfg: MoonlightConfig, device=None, dtype=None):
        super().__init__()
        e, i, d = cfg.n_routed_experts, cfg.moe_intermediate_size, cfg.hidden_size
        f = {"device": device, "dtype": dtype}
        self.gate = nn.Parameter(torch.empty(e, i, d, **f))
        self.up = nn.Parameter(torch.empty(e, i, d, **f))
        self.down = nn.Parameter(torch.empty(e, d, i, **f))


class MoE(nn.Module):
    def __init__(self, cfg: MoonlightConfig, device=None, dtype=None):
        super().__init__()
        self.gate = Router(cfg, device, dtype)
        self.experts = Experts(cfg, device, dtype)
        self.shared_experts = MLP(cfg.hidden_size,
                                  cfg.moe_intermediate_size * cfg.n_shared_experts, device, dtype)


class MoonlightLayer(nn.Module):
    tp_group = None          # no tensor parallelism for this decoder

    def __init__(self, cfg: MoonlightConfig, layer: int, device=None, dtype=None):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device, dtype)
        self.self_attn = Attention(cfg, device, dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device, dtype)
        self.mlp = (MoE(cfg, device, dtype) if cfg.is_moe(layer)
                    else MLP(cfg.hidden_size, cfg.intermediate_size, device, dtype))


class MoonlightDecoder(nn.Module):
    """Every weight of the decoder; MeshAnything's ``opt`` slot holds it
    (``models/meshanything.py``)."""
    decoder = "moonlight"

    def __init__(self, cfg: MoonlightConfig, device=None, dtype=None):
        super().__init__()
        if cfg.n_group != 1 or cfg.topk_group != 1:
            raise ValueError("group-limited routing (n_group > 1) is not ported: Moonlight "
                             "routes over one group")
        f = {"device": device, "dtype": dtype}
        d = cfg.hidden_size
        self.extra_embeds = nn.Parameter(torch.empty(3, d, **f))
        self.input_layer = nn.Linear(cfg.codebook_dim, d, **f)
        self.face_positions = nn.Parameter(torch.empty(cfg.num_face_pos, d, **f))
        self.cond_embed = nn.Parameter(torch.empty(2, d, **f))
        self.codebook = nn.Parameter(torch.empty(cfg.codebook_size, cfg.codebook_dim, **f))
        self.layers = nn.ModuleList(MoonlightLayer(cfg, i, **f) for i in range(cfg.num_layers))
        self.norm = RMSNorm(d, cfg.rms_norm_eps, **f)
        self.lm_head = nn.Linear(d, cfg.vocab_size, bias=False, **f)


# ---------------------------------------------------------------------------
# rotary positions


_rope_tables: dict = {}


def rope_table(cfg: MoonlightConfig, device: torch.device) -> torch.Tensor:
    """(max_position_embeddings, rope_dim / 2) complex64 on ``device``: the
    unit rotation cos + i sin of each position and frequency, from f32
    inverse frequencies and angles as DeepSeek-V3 computes them; made once
    a device, outside any graph capture (the prefill makes it)."""
    key = (device.type, device.index, cfg.qk_rope_head_dim, cfg.rope_theta,
           cfg.max_position_embeddings)
    table = _rope_tables.get(key)
    if table is None:
        dim = cfg.qk_rope_head_dim
        inv_freq = 1.0 / (cfg.rope_theta ** (torch.arange(0, dim, 2, device=device).float() / dim))
        t = torch.arange(cfg.max_position_embeddings, device=device).float()
        freqs = torch.outer(t, inv_freq)
        table = _rope_tables[key] = torch.polar(torch.ones_like(freqs), freqs)
    return table


def rope(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3's rotation of x (..., n, D) at the positions of ``rot``
    (n, D / 2) complex (``rope_table``'s rows): each interleaved pair
    (x[2i], x[2i + 1]) rotated by its angle as one complex product, the
    output in halves ([rotated evens || rotated odds]); f32 arithmetic,
    x's dtype out."""
    half = x.shape[-1] // 2
    pairs = x.float().contiguous().view(*x.shape[:-1], half, 2)
    turned = torch.view_as_real(torch.view_as_complex(pairs) * rot)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    out.view(*x.shape[:-1], 2, half).copy_(turned.transpose(-1, -2))   # one copy, cast to x's
    return out


# ---------------------------------------------------------------------------
# routing


def route(gate: Router, cfg: MoonlightConfig, h: torch.Tensor) -> tuple:
    """(ids (T, K) int64, weights (T, K) f32) of tokens h (T, d): the
    published gate (``noaux_tc`` over one group): f32 logits, sigmoid
    scores, the top K of score plus correction bias (in order of that sum),
    weighted by the scores alone, normalised and scaled. One launch of the
    router kernel (``ops/router.py::route_topk``) where ``router_op.takes``
    holds (the decode step's 1 to 16 bf16 rows), else the plain version
    (``router_op.route_reference``: the prefill's rows, f32)."""
    k, bias = cfg.num_experts_per_tok, gate.e_score_correction_bias
    fn = router_op.route_topk if router_op.takes(h, gate.weight, bias, k) \
        else router_op.route_reference
    return fn(h, gate.weight, bias, k, norm=cfg.norm_topk_prob, scale=cfg.routed_scaling_factor)


def moe_prefill(m: MoE, cfg: MoonlightConfig, h: torch.Tensor,
                routes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The layer's experts on tokens h (B, n, d), an eager loop over the
    experts chosen: each (token, choice) product written to its own slot,
    the K slots summed in order with the shared MLP in f32, rounded once to
    h's dtype (no accumulation whose order a scatter would set). The ids
    go to ``routes`` (B, S, K) rows [0, n) when given."""
    b, n, d = h.shape
    h = h.reshape(b * n, d)
    ids, weights = route(m.gate, cfg, h)
    if routes is not None:
        routes[:, :n] = ids.view(b, n, -1)
    slots = torch.zeros(ids.shape + (h.shape[-1],), dtype=torch.float32, device=h.device)
    ex = m.experts
    for e in torch.unique(ids).tolist():
        tok, k = (ids == e).nonzero(as_tuple=True)
        x = h[tok]
        y = F.linear(F.silu(F.linear(x, ex.gate[e])) * F.linear(x, ex.up[e]), ex.down[e])
        slots[tok, k] = y.float() * weights[tok, k, None]
    return (slots.sum(dim=1) + mlp(h, m.shared_experts).float()).to(h.dtype).view(b, n, d)


# ---------------------------------------------------------------------------
# prefill


def _mla_full(layer: MoonlightLayer, cfg: MoonlightConfig, x: torch.Tensor, rot: torch.Tensor,
              cache: torch.Tensor, layer_idx: int) -> torch.Tensor:
    """The non-absorbed attention over all n positions of x (B, n, d)
    (causal), writing their latent-cache rows [0, n) of layer
    ``layer_idx``; returns o_proj's output (B, n, d)."""
    a = layer.self_attn
    b, n, _ = x.shape
    hn, nope, rd, vd, r = (cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                           cfg.v_head_dim, cfg.kv_lora_rank)
    q = lin(x, a.q_proj).view(b, n, hn, nope + rd)
    q_pe = rope(q[..., nope:].transpose(1, 2), rot).transpose(1, 2)
    kv_a = lin(x, a.kv_a_proj_with_mqa)
    latent = rms_norm(kv_a[..., :r], a.kv_a_layernorm)
    k_pe = rope(kv_a[..., r:], rot)                                       # (B, n, rd)
    cache[layer_idx, :, :n] = torch.cat([latent, k_pe], dim=-1)
    kv = lin(latent, a.kv_b_proj).view(b, n, hn, nope + vd)
    k = torch.cat([kv[..., :nope], k_pe[:, :, None].expand(b, n, hn, rd)], dim=-1)
    q = torch.cat([q[..., :nope], q_pe], dim=-1)
    v = kv[..., nope:]
    if n > 1024:
        o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                           v.transpose(1, 2), is_causal=True).transpose(1, 2)
    else:
        o = attention(q, k, v, causal=True)
    return lin(o.reshape(b, n, hn * vd), a.o_proj)


def prefill(p: MoonlightDecoder, cfg: MoonlightConfig, cond_embeds: torch.Tensor,
            cache: torch.Tensor, prompt_ids: Optional[torch.Tensor] = None,
            routes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal pass over the (B, C, d) condition and, when given, the prompt
    tokens (B, P) in stream order (mesh completion): writes rows [0, C + P)
    of every layer of ``cache`` (and of ``routes``, when given) in place and
    returns the last position's logits (B, vocab) f32."""
    dtype = cond_embeds.dtype
    x = cond_embeds + p.cond_embed[0].to(dtype)
    if prompt_ids is not None:
        x = torch.cat([x, decoding.embed_stream(p, cfg, prompt_ids, dtype)], dim=1)
    n = x.shape[1]
    rot = rope_table(cfg, x.device)[:n]
    for i, layer in enumerate(p.layers):
        x = x + _mla_full(layer, cfg, rms_norm(x, layer.input_layernorm), rot, cache, i)
        h = rms_norm(x, layer.post_attention_layernorm)
        if cfg.is_moe(i):
            y = moe_prefill(layer.mlp, cfg, h, None if routes is None
                            else routes[i - cfg.first_k_dense_replace])
        else:
            y = mlp(h, layer.mlp)
        x = x + y
    return lin(rms_norm(x[:, -1], p.norm), p.lm_head).float()


# ---------------------------------------------------------------------------
# decode


@dataclasses.dataclass
class MoonlightState(decoding.DecodeState):
    """``decoding.DecodeState`` with the latent cache (L, B, S, 576) as
    ``kv``, the expert kernel's per-expert token counter and the routing
    record."""
    # (MoE layers, E) int32 on the device: the decode's tokens each expert took
    expert_counts: Optional[torch.Tensor] = None
    # (MoE layers, B, S, K) int32 on the device: each position's chosen experts
    routes: Optional[torch.Tensor] = None
    latent: int = 0             # values of a cache row that are the latent (then the rope key)


def alloc_latent_cache(cfg: MoonlightConfig, batch: int, seq: int, dtype: torch.dtype,
                       chunk: int, device) -> torch.Tensor:
    return torch.zeros((cfg.num_layers, batch, padded_length(seq, chunk), cfg.cache_width),
                       dtype=dtype, device=device)


def init_decode_state(p: MoonlightDecoder, cfg: MoonlightConfig, cond_embeds: torch.Tensor, *,
                      max_new_tokens: int, sampling: bool = False, top_k: int = 50,
                      top_p: float = 0.95, temperature: float = 1.0, bucket: int = 512,
                      generator: Optional[torch.Generator] = None, attn: str = "pallas",
                      prompt_ids: Optional[torch.Tensor] = None,
                      into: Optional[MoonlightState] = None) -> MoonlightState:
    """This decoder's decode state: the latent cache (S padded to
    ``bucket``, or ``into``'s) and the routing record, prefilled, the
    expert counter, and the first token; ``into`` is refilled in place
    (``decode_graph.refill_state``)."""
    check_tier(attn)
    b, c, _ = cond_embeds.shape
    dev = cond_embeds.device
    prompt_ids, p_len = decoding.check_prompt(prompt_ids, max_new_tokens, dev)
    if c + max_new_tokens > cfg.max_position_embeddings:
        raise ValueError(f"{c} condition rows and {max_new_tokens} tokens pass the decoder's "
                         f"{cfg.max_position_embeddings} positions")
    cache = into.kv if into is not None else alloc_latent_cache(
        cfg, b, c + max_new_tokens, cond_embeds.dtype, bucket, dev)
    routes = into.routes if into is not None else torch.zeros(
        (cfg.num_moe_layers, b, cache.shape[2], cfg.num_experts_per_tok), dtype=torch.int32,
        device=dev)
    logits0 = prefill(p, cfg, cond_embeds, cache, prompt_ids, routes)
    first, tokens = decoding.first_tokens(cfg, logits0, max_new_tokens, prompt_ids,
                                          sampling=sampling, top_k=top_k, top_p=top_p,
                                          temperature=temperature, generator=generator)
    return MoonlightState.start(
        cfg, first, tokens, cache, p_len, into, generator=generator, attn="pallas",
        expert_counts=torch.zeros((cfg.num_moe_layers, cfg.n_routed_experts), dtype=torch.int32,
                                  device=dev), routes=routes, latent=cfg.kv_lora_rank)


class QuantizedMLP(NamedTuple):
    gate_proj: QuantizedLinear
    up_proj: QuantizedLinear
    down_proj: QuantizedLinear


class QuantizedLayer(NamedTuple):
    """The W8A8 matrices of one layer: the attention's projections, and the
    dense MLP or the shared experts."""
    q_proj: QuantizedLinear
    kv_a_proj_with_mqa: QuantizedLinear
    o_proj: QuantizedLinear
    mlp: QuantizedMLP


def quantize_layers(layers) -> list:
    """``wq``: the matrices of ``QuantizedLayer`` of every layer as int8."""
    out = []
    for layer in layers:
        a = layer.self_attn
        dense = getattr(layer.mlp, "shared_experts", layer.mlp)
        out.append(QuantizedLayer(
            *(_quantize_linear(getattr(a, n)) for n in ("q_proj", "kv_a_proj_with_mqa", "o_proj")),
            QuantizedMLP(*(_quantize_linear(getattr(dense, n))
                           for n in ("gate_proj", "up_proj", "down_proj")))))
    return out


def _attention_step(layer: MoonlightLayer, cfg: MoonlightConfig, state: MoonlightState,
                    layer_idx: int, h: torch.Tensor, write_pos: torch.Tensor,
                    cur_len: torch.Tensor, rot: torch.Tensor, mats, lin_e) -> torch.Tensor:
    """The absorbed attention of one token a row, h (B, d) the normed
    input: writes the row's latent and rotated key at ``write_pos`` and
    attends rows [0, cur_len) -> o_proj's output (B, d)."""
    a = layer.self_attn
    b = h.shape[0]
    hn, nope, rd, vd, r = (cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                           cfg.v_head_dim, cfg.kv_lora_rank)
    q = lin_e(h, mats.q_proj).view(b, hn, nope + rd)
    kv_a = lin_e(h, mats.kv_a_proj_with_mqa)
    row = torch.cat([rms_norm(kv_a[:, :r], a.kv_a_layernorm), rope(kv_a[:, r:], rot)], -1)
    state.kv[layer_idx].index_copy_(1, write_pos, row[:, None])
    w = a.kv_b_proj.weight.view(hn, nope + vd, r)
    q_latent = torch.bmm(q[..., :nope].transpose(0, 1), w[:, :nope])       # (H, B, r)
    query = torch.cat([q_latent.transpose(0, 1), rope(q[..., nope:], rot)], -1)
    o = latent_attention(query, state.kv, layer_idx, cur_len, scale=cfg.q_head_dim ** -0.5,
                         latent=r)                                           # (B, H, r)
    v = torch.bmm(o.transpose(0, 1), w[:, nope:].transpose(1, 2))           # (H, B, vd)
    return lin_e(v.transpose(0, 1).reshape(b, hn * vd), mats.o_proj)


@torch.no_grad()
def step_body(p: MoonlightDecoder, cfg: MoonlightConfig, state: MoonlightState, *,
              wq_layers: Optional[Sequence] = None, sampling: bool = False,
              top_k: int = 50, top_p: float = 0.95, temperature: float = 1.0,
              early_exit: bool = True) -> torch.Tensor:
    """One token for every row, every position read from ``state.step_t``
    on the device (what ``decoding.decode_segment`` asks of a step: a CUDA
    graph can capture it); returns the step's f32 logits (B, vocab).
    ``wq_layers`` (``quantize_layers``) runs the attention projections and
    the dense and shared MLPs as W8A8."""
    ids = state.last_token
    gen_index = state.step_t - 1
    dtype = p.cond_embed.dtype
    lin_e = lin_dispatch(wq_layers is not None)
    lin_a = lin_dispatch(False)     # the codebook projection and lm_head, never W8A8
    write_pos = (cfg.cond_length + gen_index).reshape(1)
    x = decoding.embed_ids(p, cfg, ids, gen_index, dtype, lin_a)
    rot = rope_table(cfg, x.device).index_select(0, write_pos)
    cur_len = (write_pos[0] + 1).to(torch.int32)
    for i, layer in enumerate(p.layers):
        attn_mats = layer.self_attn if wq_layers is None else wq_layers[i]
        h = rms_norm(x, layer.input_layernorm)
        x = x + _attention_step(layer, cfg, state, i, h, write_pos, cur_len, rot, attn_mats, lin_e)
        h = rms_norm(x, layer.post_attention_layernorm)
        if not cfg.is_moe(i):
            x = x + mlp(h, layer.mlp if wq_layers is None else wq_layers[i].mlp, lin_e)
            continue
        m = layer.mlp
        sel, weights = route(m.gate, cfg, h)
        sh = m.shared_experts
        y = routed_experts(h, sel, weights, m.experts.gate, m.experts.up, m.experts.down,
                           shared=None if wq_layers is not None else
                           (sh.gate_proj.weight, sh.up_proj.weight, sh.down_proj.weight),
                           counts=state.expert_counts, layer=i - cfg.first_k_dense_replace,
                           routes=state.routes, pos=write_pos)
        if wq_layers is not None:
            y = y + mlp(h, wq_layers[i].mlp, lin_e).float()
        x = x + y.to(dtype)
    logits = lin_a(rms_norm(x, p.norm), p.lm_head).float()
    decoding.advance(cfg, state, logits, sampling=sampling, top_k=top_k, top_p=top_p,
                     temperature=temperature, early_exit=early_exit)
    return logits


Decoder = MoonlightDecoder
