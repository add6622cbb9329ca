"""ShapeOPT: the OPT-350M-based autoregressive mesh-token decoder (the
port of ``meshanything_tpu/models/shape_opt.py``).

  * hybrid token embedding: ids {0,1,2} from a 3-row table, ids >= 3
    through a linear projection of the frozen codebook row;
  * learned absolute positions with OPT's +2 offset, counted over the
    257 condition slots;
  * face-phase embedding: generated coordinate token k gets id
    (k mod 9) + 3, special tokens keep their own id;
  * post-layernorm blocks, ReLU FFN, untied lm_head.

Execution: ``prefill`` runs the causal condition pass and writes the
first rows of a preallocated (2, L, B, S, H*D) cache; the decode loop
then runs one step per token. Each step writes its K/V row in place and
calls the attention kernel over exactly ``write_pos + 1`` rows:

  attn="pallas" (the exact tier; "auto" resolves to it): bf16/f32 cache,
      K1 (``ops.decode_attention``);
  attn="pallas_int8" / "pallas_int4": the quantized caches of
      ``ops/kvcache.py``; the step quantizes its new K/V row, writes the
      codes and scales at ``write_pos``, and calls K2 / K3. The prefill
      runs into a compact condition-length tensor that is quantized into
      the preallocated caches (a full-length bf16 cache never exists).
  attn="megakernel": the exact tier's cache and prefill; the whole layer
      stack of a step is one launch of K5 (``ops.megakernel``) on the
      layers packed once per decode loop, with K5's numerics (bf16
      weights, f32 residual stream); embedding, lm_head and sampling stay
      as in the other tiers. It does not compose with ``wq``.

Each layer's two residual adds and post-LNs (``OPTLayer.after_attention``)
are one kernel each in the decode step (``ops.add_layer_norm``, which has
no backward); the prefill and ``forward_full`` keep ``ln(x + y)``.

wq=True runs the four per-layer matrices of the decode loop as int8 W8A8
(``ops/wquant.py``); prefill, embeddings and lm_head stay in the
activation dtype.

The step reads every position from the state's device step counter
``step_t`` (the cache row it writes, the live length K1-K3 read on the
device, the token slot), and a step taken after every row has finished
leaves every state tensor as it is, as JAX's ``while_loop`` never takes
it. So a segment of the decode (``decode_segment``, JAX's) is a fixed
count of steps with no host read inside it: on the card one CUDA graph
of the step replayed (``runtime/decode_graph.py``), elsewhere the same
step run eagerly. The host reads the counter once a segment
(``decode_loop``: segments of ``sync_every`` steps). ``attn="megakernel"``
stays eager on the card: K5 takes the write position by value.

Tensor parallelism (``parallel/mesh.py::shard_params``): each layer holds
its rank's heads (``OPTLayer.num_heads``) and shards, and sums its out and
fc2 products over ``OPTLayer.tp_group``; the rank's cache is (2, L, B, S,
(H / tp) * D), and K1, K2, K3 and K4 run over its heads alone. Every tier
runs there and each rank computes what one process computes:

  * the int8/int4 caches quantize a row with the scale of all H*D
    columns, its amax taken over the group (``ops/kvcache.py``): one
    all-reduce a layer for K and V of a step, one for the whole prefill;
  * ``wq``: the row-parallel out and fc2 sum int32 accumulators over the
    group, their scales taken over it (``ops/wquant.py``), so the layer's
    products are one process's bit for bit;
  * ``attn="megakernel"``: K5 runs all layers in one launch, with no point
    between them for a sum, so, as GSPMD runs a Pallas call that has no
    partitioning rule, the decoder is gathered whole over the group once a
    generation (``whole_decoder``, kept in the decode state) and every rank
    runs the prefill and K5 on the full width as one process does. Its tokens are one process's bit for bit
    on the same condition, and it is no faster than one card.

The step with the collectives is captured into a CUDA graph under NCCL;
under gloo it runs eagerly (``graph=False``; a capture asked for raises).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from meshanything_tpu_torch.config import ShapeOPTConfig
from meshanything_tpu_torch.models.layers import attention, col_lin, lin, row_lin
from meshanything_tpu_torch.ops.add_layer_norm import add_layer_norm, add_layer_norm_reference
from meshanything_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_int4,
    decode_attention_int8,
)
from meshanything_tpu_torch.ops.kvcache import (
    QUANTIZED,
    alloc_kv_cache,
    alloc_quantized_cache,
    quantize_rows_for,
)
from meshanything_tpu_torch.ops.megakernel import (
    MegakernelLayers,
    decode_step_megakernel,
    pack_megakernel_layers,
)
from meshanything_tpu_torch.ops.sampling import sample_token
from meshanything_tpu_torch.ops.wquant import lin_dispatch, quantize_opt_layers
from meshanything_tpu_torch.parallel.collectives import capturable
from meshanything_tpu_torch.parallel.mesh import gather_module
from meshanything_tpu_torch.runtime import decode_graph, profiling

ATTN_MODES = ("pallas", "pallas_int8", "pallas_int4", "megakernel")
# the launch counts a decode graph's ``capture`` span records (decode_graph.StepGraph):
# the residual add and post-LN kernel's, two a layer in a step or a window forward
CAPTURE_COUNTERS = {"add_ln": lambda: add_layer_norm.launches}
# a cache: one (2, L, B, S, H*D) tensor, or (values, scales) when quantized
Cache = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


class OPTLayer(nn.Module):
    def __init__(self, cfg: ShapeOPTConfig, device=None, dtype=None):
        super().__init__()
        f = {"device": device, "dtype": dtype}
        d = cfg.hidden_size
        self.num_heads = cfg.num_heads     # the rank's heads under tensor parallelism
        self.tp_group = None               # the model group of a tensor-parallel shard
        self.qkv = nn.Linear(d, 3 * d, **f)
        self.out = nn.Linear(d, d, **f)
        self.ln_attn = nn.LayerNorm(d, eps=cfg.ln_eps, **f)
        self.fc1 = nn.Linear(d, cfg.ffn_dim, **f)
        self.fc2 = nn.Linear(cfg.ffn_dim, d, **f)
        self.ln_ffn = nn.LayerNorm(d, eps=cfg.ln_eps, **f)

    def after_attention(self, x: torch.Tensor, o: torch.Tensor, mats=None,
                        lin_e=lin, add_ln=add_layer_norm_reference) -> torch.Tensor:
        """Out projection, residual, post-LN, ReLU MLP, residual, post-LN
        (x is the layer input, o the merged attention heads). ``mats``
        holds the out/fc1/fc2 matrices (default: this layer's), applied
        with ``lin_e`` (``ops.wquant.lin_dispatch``). ``add_ln(x, y, m)``
        is each residual add and post-LN, ``ln(x + y, m)``: the decode
        step passes the kernel (``ops.add_layer_norm``), which has no
        backward."""
        mats = self if mats is None else mats
        g = self.tp_group
        x = add_ln(x, row_lin(o.to(x.dtype), mats.out, g, lin_e), self.ln_attn)
        return add_ln(x, row_lin(F.relu(col_lin(x, mats.fc1, g, lin_e)), mats.fc2, g, lin_e),
                      self.ln_ffn)


class ShapeOPT(nn.Module):
    decoder = "opt"

    def __init__(self, cfg: ShapeOPTConfig, device=None, dtype=None):
        super().__init__()
        f = {"device": device, "dtype": dtype}
        d = cfg.hidden_size
        self.extra_embeds = nn.Parameter(torch.empty(3, d, **f))
        self.input_layer = nn.Linear(cfg.codebook_dim, d, **f)
        self.embed_positions = nn.Parameter(torch.empty(cfg.max_positions + cfg.pos_offset, d, **f))
        self.face_positions = nn.Parameter(torch.empty(cfg.num_face_pos, d, **f))
        self.cond_embed = nn.Parameter(torch.empty(2, d, **f))
        self.codebook = nn.Parameter(torch.empty(cfg.codebook_size, cfg.codebook_dim, **f))
        self.layers = nn.ModuleList(OPTLayer(cfg, **f) for _ in range(cfg.num_layers))
        self.lm_head = nn.Linear(d, cfg.vocab_size, bias=False, **f)


# ---------------------------------------------------------------------------
# embedding


def embed_tokens(p: ShapeOPT, cfg: ShapeOPTConfig, ids: torch.Tensor) -> torch.Tensor:
    """Hybrid embedding (shape_opt.py:237-245 of the reference): special
    ids {0,1,2} hit extra_embeds, the rest project codebook[id-3] through
    input_layer. Returns the parameters' dtype."""
    special = p.extra_embeds[ids.clamp(0, 2)]
    code = p.codebook[(ids - 3).clamp(0, cfg.codebook_size - 1)]
    projected = lin(code.to(special.dtype), p.input_layer)
    return torch.where((ids < 3)[..., None], special, projected)


def face_phase_ids(ids: torch.Tensor, gen_index, face_per_token: int) -> torch.Tensor:
    """Face positional id of the token generated at ``gen_index`` (0 is
    the bos slot): specials keep their id, coordinates get
    ((gen_index - 1) mod 9) + 3."""
    phase = (gen_index - 1) % face_per_token + 3
    return torch.where(ids < 3, ids, phase)


def embed_stream(p: ShapeOPT, cfg: ShapeOPTConfig, token_ids: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """(B, T) ids in stream order (element 0 the bos slot) -> their
    embeddings in ``dtype`` as the decode step makes them: the hybrid
    embedding, the face phase of each generated index and cond_embed[1]
    (the caller adds the absolute positions, C + index)."""
    gen_index = torch.arange(token_ids.shape[1], device=token_ids.device)[None, :]
    tok = embed_tokens(p, cfg, token_ids).to(dtype)
    tok = tok + p.face_positions[face_phase_ids(token_ids, gen_index, cfg.face_per_token)].to(dtype)
    return tok + p.cond_embed[1].to(dtype)


# ---------------------------------------------------------------------------
# prefill and decode


def prefill(p: ShapeOPT, cfg: ShapeOPTConfig, cond_embeds: torch.Tensor,
            kv_cache: torch.Tensor) -> torch.Tensor:
    """Causal pass over the (B, C, d) condition embeddings. Writes rows
    [0, C) of every layer of ``kv_cache`` (2, L, B, S, H*D) in place and
    returns the last position's logits (B, vocab) in f32."""
    b, c, _ = cond_embeds.shape
    hd = cfg.head_dim
    x = cond_embeds + p.cond_embed[0].to(cond_embeds.dtype)
    x = x + p.embed_positions[cfg.pos_offset:cfg.pos_offset + c].to(x.dtype)
    for layer_idx, layer in enumerate(p.layers):
        h = layer.num_heads
        q, k, v = col_lin(x, layer.qkv, layer.tp_group).chunk(3, dim=-1)
        kv_cache[0, layer_idx, :, :c] = k
        kv_cache[1, layer_idx, :, :c] = v
        o = attention(q.reshape(b, c, h, hd), k.reshape(b, c, h, hd), v.reshape(b, c, h, hd),
                      causal=True)
        x = layer.after_attention(x, o.reshape(b, c, h * hd))
    return lin(x[:, -1], p.lm_head).float()


def _train_layer(layer: OPTLayer, x: torch.Tensor, block_q: int) -> torch.Tensor:
    """One decoder layer of the teacher-forcing pass (JAX
    ``_opt_layer_prefill(with_kv=False)``): causal self-attention over
    every position, then ``after_attention``."""
    b, n, _ = x.shape
    q, k, v = (y.reshape(b, n, layer.num_heads, -1)
               for y in col_lin(x, layer.qkv, layer.tp_group).chunk(3, dim=-1))
    if block_q:
        o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                           v.transpose(1, 2), is_causal=True).transpose(1, 2)
    else:
        o = attention(q, k, v, causal=True)
    return layer.after_attention(x, o.reshape(b, n, -1))


def forward_full(p: ShapeOPT, cfg: ShapeOPTConfig, cond_embeds: torch.Tensor,
                 token_ids: torch.Tensor, *, remat: bool = False,
                 block_q: int = 0) -> torch.Tensor:
    """Teacher-forcing pass over [condition || tokens] (JAX
    ``forward_full``) -> f32 logits (B, C + T, vocab) for every position.

    The tokens are embedded as the decode step embeds them
    (``embed_stream``) in the parameters' dtype, and joined to the
    condition in the promoted dtype, as JAX's concatenate promotes: with
    f32 weights the layers run in f32 whatever the condition's dtype. The
    logits are the lm-head product in that dtype, then f32.

    ``remat``: each layer under ``torch.utils.checkpoint`` (backward
    recomputes its activations instead of keeping all of them).
    ``block_q`` > 0: the causal attention is
    ``scaled_dot_product_attention`` instead of the dense f32 scores of
    ``attention``, which at 7,459 positions would hold ~3.6 GB a row a
    layer (JAX pads to its block there; the padded rows sit in the causal
    future of every real one, so nothing is padded here)."""
    cond_x = cond_embeds + p.cond_embed[0].to(cond_embeds.dtype)
    x = torch.cat([cond_x, embed_stream(p, cfg, token_ids, p.cond_embed.dtype)], dim=1)
    x = x + p.embed_positions[cfg.pos_offset:cfg.pos_offset + x.shape[1]].to(x.dtype)
    for layer in p.layers:
        if remat:
            x = checkpoint(_train_layer, layer, x, block_q, use_reentrant=False)
        else:
            x = _train_layer(layer, x, block_q)
    return lin(x, p.lm_head).float()


def resolve_attn(attn: str) -> str:
    """``"auto"`` is the exact tier; anything else must be ported."""
    attn = "pallas" if attn == "auto" else attn
    if attn not in ATTN_MODES:
        raise ValueError(f"attn={attn!r}: the port runs {ATTN_MODES} (and 'auto')")
    return attn


def whole_decoder(p: ShapeOPT) -> ShapeOPT:
    """The decoder that ``attn="megakernel"`` runs: ``p`` itself, or under
    a model group the full decoder gathered over it (every rank of the
    group calls this; ``parallel/mesh.py::gather_module``, bit-exact)."""
    group = p.layers[0].tp_group
    return p if group is None else gather_module(p, group, "opt.")


def check_capture(p: ShapeOPT) -> None:
    """Raise where a step would be captured with collectives that a CUDA
    graph cannot hold (a gloo model group): run such a decode with
    ``graph=False``."""
    if not capturable(p.layers[0].tp_group):
        raise ValueError("a CUDA-graph capture of a tensor-parallel step over gloo: gloo's "
                         "collectives cannot be captured; decode with graph=False (eager), "
                         "or one rank a card over NCCL")


def prefill_with_prompt(p: ShapeOPT, cfg: ShapeOPTConfig, cond_embeds: torch.Tensor,
                        token_ids: torch.Tensor, kv_cache: torch.Tensor) -> torch.Tensor:
    """Causal pass over [condition || prompt tokens] (JAX
    ``prefill_with_prompt``, the prefill of mesh completion): writes rows
    [0, C + P) of every layer of ``kv_cache`` in place and returns the
    last position's logits (B, vocab) in f32.

    ``token_ids`` (B, P) is in stream order: element 0 is the bos slot,
    as ``generate`` emits it. The embedding is the decode step's (face
    phase of the token's generated index, cond_embed[1], absolute
    position C + index), so decoding from this cache gives the stream of
    a generation whose first P steps had emitted the prompt. Up to 1,024
    rows the attention is the dense one of ``prefill``; past that
    ``scaled_dot_product_attention`` (JAX switches to its blockwise
    attention there: the dense f32 scores of a long completion prompt
    would take gigabytes a layer)."""
    b, c, _ = cond_embeds.shape
    t = token_ids.shape[1]
    hd = cfg.head_dim
    dtype = cond_embeds.dtype
    cond_x = cond_embeds + p.cond_embed[0].to(dtype)
    x = torch.cat([cond_x, embed_stream(p, cfg, token_ids, dtype)], dim=1)
    n = c + t
    x = x + p.embed_positions[cfg.pos_offset:cfg.pos_offset + n].to(dtype)
    for layer_idx, layer in enumerate(p.layers):
        h = layer.num_heads
        q, k, v = col_lin(x, layer.qkv, layer.tp_group).chunk(3, dim=-1)
        kv_cache[0, layer_idx, :, :n] = k
        kv_cache[1, layer_idx, :, :n] = v
        q, k, v = (y.reshape(b, n, h, hd) for y in (q, k, v))
        if n > 1024:
            o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                               v.transpose(1, 2), is_causal=True).transpose(1, 2)
        else:
            o = attention(q, k, v, causal=True)
        x = layer.after_attention(x, o.reshape(b, n, h * hd))
    return lin(x[:, -1], p.lm_head).float()


def prefill_cache(p: ShapeOPT, cfg: ShapeOPTConfig, cond_embeds: torch.Tensor, attn: str,
                  seq: int, bucket: int, prompt_ids: Optional[torch.Tensor] = None,
                  kv: Optional[Cache] = None) -> Tuple[torch.Tensor, Cache]:
    """Allocate the decode cache for ``seq`` rows (padded to ``bucket``),
    or take ``kv`` (a cache of a kept state: its rows past the prefill's
    are never read before a step writes them), and prefill it with the
    condition and, when given, the prompt -> (first logits (B, vocab)
    f32, cache). Quantized tiers prefill a compact (C + P)-row tensor and
    quantize it into rows [0, C + P) of the preallocated caches."""
    b, c, _ = cond_embeds.shape
    n = c + (0 if prompt_ids is None else prompt_ids.shape[1])
    n_layers, hd = cfg.num_layers, p.layers[0].num_heads * cfg.head_dim   # the rank's width

    def run_prefill(kv):
        if prompt_ids is None:
            return prefill(p, cfg, cond_embeds, kv)
        return prefill_with_prompt(p, cfg, cond_embeds, prompt_ids, kv)

    if attn not in QUANTIZED:
        if kv is None:
            kv = alloc_kv_cache(n_layers, b, seq, p.layers[0].num_heads, cfg.head_dim,
                                dtype=cond_embeds.dtype, chunk=bucket, device=cond_embeds.device)
        return run_prefill(kv), kv
    compact = torch.empty((2, n_layers, b, n, hd), dtype=cond_embeds.dtype,
                          device=cond_embeds.device)
    logits0 = run_prefill(compact)
    if kv is None:
        kv = alloc_quantized_cache(attn, n_layers, b, seq, hd, chunk=bucket,
                                   device=cond_embeds.device)
    values, scales = kv
    # every row of every layer in one call: one all-reduce under a model group
    codes, row_scales = quantize_rows_for(attn)(compact, p.layers[0].tp_group)
    values[:, :, :, :n] = codes
    scales[:, :, :, 0, :n] = row_scales[..., 0]
    return logits0, kv


def check_prompt(prompt_ids: Optional[torch.Tensor], max_new_tokens: int) -> int:
    """The prompt's length (0 without one); raises where it leaves no
    token to generate."""
    p_len = 0 if prompt_ids is None else prompt_ids.shape[1]
    if p_len >= max_new_tokens:
        raise ValueError(f"prompt length {p_len} must be < max_new_tokens={max_new_tokens}")
    return p_len


@dataclasses.dataclass
class DecodeState:
    # The tensors are written in place, never rebound: a captured step
    # replays over them.
    step: int                   # the host's copy of step_t: exact while a row is live,
    #                             read back from step_t at every segment's end
    step_t: torch.Tensor        # () int64 on the device: tokens generated so far (JAX's
    #                             ``step``; int64 because it indexes)
    tokens: torch.Tensor        # (B, gen_len) int64, eos-prefilled
    kv: Cache                   # written in place
    done: torch.Tensor          # (B,) bool: row emitted eos
    last_token: torch.Tensor    # (B,) int64: token fed to the next step
    generator: Optional[torch.Generator] = None  # sampling mode
    attn: str = "pallas"
    graph: Optional[decode_graph.StepGraph] = None   # the request's captured step (card only)
    # attn="megakernel": the decoder that the prefill ran on and K5 runs, under a model
    # group the whole one gathered (whole_decoder)
    decoder: Optional[ShapeOPT] = None


def init_decode_state(p: ShapeOPT, cfg: ShapeOPTConfig, cond_embeds: torch.Tensor, *,
                      max_new_tokens: int, sampling: bool = False, top_k: int = 50,
                      top_p: float = 0.95, temperature: float = 1.0, bucket: int = 512,
                      generator: Optional[torch.Generator] = None,
                      attn: str = "pallas",
                      prompt_ids: Optional[torch.Tensor] = None,
                      into: Optional[DecodeState] = None) -> DecodeState:
    """Allocate the cache (S padded to ``bucket``), prefill it, and take
    the first token. With ``prompt_ids`` (B, P) (JAX ``:499-570``) the
    prefill runs over [condition || prompt], the prompt is echoed into
    the token buffer, the first token goes to slot P and the decode goes
    on from step P + 1 (its cache row C + P).

    ``into``: a state made before with the same batch, length, bucket and
    tier (a kept state, with its captured graph): the prefill writes into
    its cache and every other tensor is set in place
    (``decode_graph.refill_state``), so that its graph replays the new
    request. Returns ``into`` then. ``attn="megakernel"`` under a model
    group prefills the whole decoder (``whole_decoder``, kept as
    ``state.decoder``) into a full-width cache."""
    attn = resolve_attn(attn)
    decoder = None
    if attn == "megakernel":
        p = decoder = whole_decoder(p)
    b, c, _ = cond_embeds.shape
    p_len = check_prompt(prompt_ids, max_new_tokens)
    if prompt_ids is not None:
        prompt_ids = prompt_ids.to(device=cond_embeds.device, dtype=torch.int64)
    if into is not None and into.attn != attn:
        raise ValueError(f"a state of attn={into.attn!r} refilled for attn={attn!r}")
    logits0, kv = prefill_cache(p, cfg, cond_embeds, attn, c + max_new_tokens, bucket,
                                prompt_ids, kv=None if into is None else into.kv)
    first = sample_token(logits0, sampling=sampling, top_k=top_k, top_p=top_p,
                         temperature=temperature, generator=generator)
    tokens = torch.full((b, max_new_tokens), cfg.eos_token_id, dtype=torch.int64,
                        device=cond_embeds.device)
    if p_len:
        tokens[:, :p_len] = prompt_ids
    tokens[:, p_len] = first
    state = DecodeState(step=p_len + 1,
                        step_t=torch.full((), p_len + 1, dtype=torch.int64, device=tokens.device),
                        tokens=tokens, kv=kv, done=first == cfg.eos_token_id, last_token=first,
                        generator=generator, attn=attn, decoder=decoder)
    return state if into is None else decode_graph.refill_state(into, state)


def _step_attention(state: DecodeState, layer_idx: int, write_pos: torch.Tensor,
                    cur_len: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, group=None) -> torch.Tensor:
    """Write the step's K/V row at ``write_pos`` ((1,) int64; quantized
    first in the int8/int4 tiers, with the scale over the model group
    ``group``) and attend over rows [0, cur_len) (``cur_len`` = write_pos
    + 1, a 0-d int32 tensor that K1-K3 read on the device; their grid is
    planned for the whole cache) -> (B, H, D)."""
    if state.attn == "pallas":
        state.kv[0, layer_idx].index_copy_(1, write_pos, k[:, None].to(state.kv.dtype))
        state.kv[1, layer_idx].index_copy_(1, write_pos, v[:, None].to(state.kv.dtype))
        return decode_attention(q, state.kv, layer_idx, cur_len)
    values, scales = state.kv
    # K and V in one call: one all-reduce of their amaxes under a model group
    codes, row_scale = quantize_rows_for(state.attn)(torch.stack([k, v]), group)
    for plane in range(2):
        values[plane, layer_idx].index_copy_(1, write_pos, codes[plane, :, None])
        scales[plane, layer_idx, :, 0].index_copy_(1, write_pos, row_scale[plane])
    kernel = decode_attention_int8 if state.attn == "pallas_int8" else decode_attention_int4
    return kernel(q, values, scales, layer_idx, cur_len)


@torch.no_grad()
def step_body(p: ShapeOPT, cfg: ShapeOPTConfig, state: DecodeState, *,
              wq_layers: Optional[Sequence] = None,
              mega_layers: Optional[MegakernelLayers] = None, sampling: bool = False,
              top_k: int = 50, top_p: float = 0.95, temperature: float = 1.0,
              early_exit: bool = True) -> torch.Tensor:
    """One token for every row, every position read from ``state.step_t``
    on the device: updates the state's tensors in place (cache row, token
    slot, flags, step_t) and returns the step's f32 logits (B, vocab). It
    leaves the host's ``state.step`` alone and reads nothing back, so a
    CUDA graph can capture it (``decode_segment``). It runs without grad
    (``ops.add_layer_norm`` has no backward). With ``early_exit`` a
    step taken after every row has finished changes no state tensor
    (JAX's ``cond_fn`` never takes it); without, finished rows emit pad
    to the end, as JAX's loop with ``early_exit=False`` does.

    ``wq_layers`` (``ops.wquant.quantize_opt_layers``) runs the layer
    matrices as W8A8; with ``attn="megakernel"`` the layer stack is one
    K5 launch on ``mega_layers`` (``ops.megakernel.pack_megakernel_layers``),
    which takes the write position by value from the host's ``state.step``."""
    ids = state.last_token
    gen_index = state.step_t - 1
    dtype = p.cond_embed.dtype
    hd = cfg.head_dim
    lin_e = lin_dispatch(wq_layers is not None)
    # the fed token was generated at gen_index and sits at absolute
    # position cond_length + gen_index
    write_pos = (cfg.cond_length + gen_index).reshape(1)
    x = embed_tokens(p, cfg, ids).to(dtype)
    x = x + p.face_positions[face_phase_ids(ids, gen_index, cfg.face_per_token)].to(dtype)
    x = x + p.cond_embed[1].to(dtype)
    x = x + p.embed_positions.index_select(0, write_pos + cfg.pos_offset).to(dtype)
    b = x.shape[0]
    if state.attn == "megakernel":
        pos = cfg.cond_length + state.step - 1
        x = decode_step_megakernel(x, mega_layers, state.kv, pos, pos + 1,
                                   num_heads=cfg.num_heads, ln_eps=cfg.ln_eps)
    else:
        cur_len = (write_pos[0] + 1).to(torch.int32)
        for layer_idx, layer in enumerate(p.layers):
            mats = layer if wq_layers is None else wq_layers[layer_idx]
            h = layer.num_heads
            q, k, v = col_lin(x, mats.qkv, layer.tp_group, lin_e).chunk(3, dim=-1)
            o = _step_attention(state, layer_idx, write_pos, cur_len,
                                q.reshape(b, h, hd).contiguous(), k, v, layer.tp_group)
            x = layer.after_attention(x, o.reshape(b, h * hd), mats, lin_e, add_layer_norm)
    logits = lin(x, p.lm_head).float()   # keeps the activation dtype's rounding
    advance(cfg, state, logits, sampling=sampling, top_k=top_k, top_p=top_p,
            temperature=temperature, early_exit=early_exit)
    return logits


def advance(cfg, state: DecodeState, logits: torch.Tensor, *, sampling: bool, top_k: int,
            top_p: float, temperature: float, early_exit: bool) -> None:
    """The end of a step, with no host read (every decoder's): the next
    token from the step's f32 logits (B, vocab), written to its slot, the
    flags and ``step_t`` advanced; with ``early_exit`` a step after every
    row has finished leaves them as they are."""
    next_token = sample_token(logits, sampling=sampling, top_k=top_k, top_p=top_p,
                              temperature=temperature, generator=state.generator)
    # finished rows emit pad (HF generate semantics, meshanything.py:150)
    next_token = torch.where(state.done, cfg.pad_token_id, next_token)
    slot = state.step_t.reshape(1)
    written, step = next_token, 1
    if early_exit:
        live = ~state.done.all()
        written = torch.where(live, next_token, state.tokens.index_select(1, slot)[:, 0])
        next_token = torch.where(live, next_token, state.last_token)
        step = live.long()
    state.tokens.index_copy_(1, slot, written[:, None])
    state.done.logical_or_(next_token == cfg.eos_token_id)
    state.last_token.copy_(next_token)
    state.step_t.add_(step)


def decode_step(p: ShapeOPT, cfg: ShapeOPTConfig, state: DecodeState, *, body=None,
                **step_kw) -> torch.Tensor:
    """``body`` (default ``step_body``) run eagerly, and the host's step
    counter advanced with it; returns the step's f32 logits (B, vocab)."""
    logits = (step_body if body is None else body)(p, cfg, state, **step_kw)
    state.step += 1
    return logits


def check_wq(attn: str, wq: bool) -> None:
    if wq and attn == "megakernel":
        raise ValueError("wq (int8 weights) does not compose with the megakernel path")


# ---------------------------------------------------------------------------
# what the runner asks of a decoder module (``meshanything.decoder_module``)
# beside its decode: ``Decoder``, ``check_tier``, ``libraries``,
# ``quantize_layers``, ``cache_bytes``, ``prefill_elems`` and ``wq_sizes``

Decoder = ShapeOPT
quantize_layers = quantize_opt_layers


def check_tier(attn: str = "pallas", lookahead=0) -> None:
    """OPT runs every tier: nothing to refuse here (the lookahead's and
    ``wq``'s own checks are ``lookahead.check_attn`` and ``check_wq``)."""


def libraries(o: ShapeOPTConfig, attn: str, lookahead, dtype: torch.dtype) -> tuple:
    """The kernel libraries a decode of the tier launches."""
    from meshanything_tpu_torch.runtime import aot

    return aot.libraries_for(attn, lookahead, dtype, o.head_dim)


def cache_bytes(o: ShapeOPTConfig, batch: int, s_max: int, int8: bool = False,
                int4: bool = False) -> int:
    """The K/V cache: K and V of ``hidden_size`` a layer and position, at
    two bytes an element (bf16), one (int8) or half a byte (int4)."""
    elems = 2 * o.num_layers * batch * s_max * o.hidden_size
    if int4:
        return elems // 2
    return elems * (1 if int8 else 2)


def prefill_elems(o: ShapeOPTConfig, rows: int, positions: int, itemsize: int) -> int:
    """The prefill's compact K/V rows of ``rows`` sequences of
    ``positions``, in elements."""
    return 2 * o.num_layers * rows * positions * o.hidden_size


def wq_sizes(o: ShapeOPTConfig) -> tuple:
    """(elements, output channels) of the ``wq`` tier's int8 matrices:
    every layer's QKV, out projection and FFN."""
    return (o.num_layers * (4 * o.hidden_size ** 2 + 2 * o.hidden_size * o.ffn_dim),
            o.num_layers * (6 * o.hidden_size + o.ffn_dim))


def decode_segment(p: ShapeOPT, cfg: ShapeOPTConfig, state: DecodeState, *,
                   max_new_tokens: int, until: Optional[int] = None, early_exit: bool = True,
                   wq_layers: Optional[Sequence] = None,
                   mega_layers: Optional[MegakernelLayers] = None, graph: bool = True,
                   sampling: bool = False, top_k: int = 50, top_p: float = 0.95,
                   temperature: float = 1.0, body=None,
                   counters=CAPTURE_COUNTERS) -> DecodeState:
    """JAX's ``decode_segment``: decode steps while the step is below
    ``max_new_tokens`` and, when given, below ``until``, and, with
    ``early_exit``, while some row is live. A step after every row has
    finished changes nothing, so the segment runs its bound's count of
    steps with no read inside it; at its end the host reads the device's
    step counter once into ``state.step`` (short of the bound: every row
    has finished), as JAX's host reads between segment dispatches.

    On the card (``graph``, any tier but the megakernel's) the steps are
    replays of one CUDA graph of ``step_body``, captured at the request's
    first segment after one eager step (``runtime/decode_graph.py``) and
    kept in ``state.graph``; a capture that fails raises. Elsewhere, and
    with ``graph=False`` (the eager comparison), the same step runs
    eagerly. Sampling with a generator that the installed torch cannot
    register with a graph runs eagerly, with a warning.

    The segment is a ``segment`` span (``runtime/profiling.py``): its
    device time covers the replays or eager steps (from after a capture),
    with its first step, the steps run, the host's launch time and its
    wait at the read as attributes.

    ``body`` is the decoder's step (default ``step_body``; the Moonlight
    decoder passes its own, ``models/moonlight.py``) and ``counters`` the
    launch counts its ``capture`` span records."""
    body = step_body if body is None else body
    bound = max_new_tokens if until is None else min(int(until), max_new_tokens)
    n = bound - state.step
    step_kw = dict(wq_layers=wq_layers, mega_layers=mega_layers, sampling=sampling, top_k=top_k,
                   top_p=top_p, temperature=temperature, early_exit=early_exit)
    device = state.tokens.device
    with profiling.span("segment", pos=state.step) as sp:
        ran = 0
        if n > 0 and decode_graph.use_graph(device, graph) and (state.attn != "megakernel") and (
                not sampling or decode_graph.generator_capturable()):
            key = (early_exit, sampling, top_k, top_p, temperature, id(wq_layers))
            if state.graph is None:
                check_capture(p)
                state.graph = decode_graph.StepGraph(
                    lambda: body(p, cfg, state, **step_kw), device,
                    generator=state.generator if sampling else None, key=key,
                    counters=counters)
                ran, n = 1, n - 1   # the warm-up before the capture was this segment's first step
                sp.set(captured=1)
            elif state.graph.key != key:
                raise ValueError("the segments of one request replay one captured step: "
                                 "the settings changed between segments")
            sp.device_begin(device)
            t0 = time.perf_counter_ns()
            state.graph.replay(n)
            ran += n
        else:
            sp.device_begin(device)
            t0 = time.perf_counter_ns()
            for _ in range(max(n, 0)):
                if device.type != "cuda" and early_exit and bool(state.done.all()):
                    break       # on the CPU the read costs nothing, the no-op steps do
                decode_step(p, cfg, state, body=body, **step_kw)
                ran += 1
        t1 = time.perf_counter_ns()
        sp.device_end()
        state.step = int(state.step_t)
        sp.set(steps=ran, launch_ns=t1 - t0, sync_ns=time.perf_counter_ns() - t1)
    return state


def decode_loop(p: ShapeOPT, cfg: ShapeOPTConfig, state: DecodeState, *, max_new_tokens: int,
                sync_every: int = 32, wq: bool = False, early_exit: bool = True,
                graph: bool = True, wq_layers: Optional[Sequence] = None,
                **sample_kw) -> DecodeState:
    """Decode until ``max_new_tokens`` or, with ``early_exit``, until
    every row is done: segments (``decode_segment``) of ``sync_every``
    steps, the host reading the step counter once after each, so the
    steps past the last live one are at most a segment's no-op replays
    and ``state.step`` ends where JAX's loop ends. With ``wq`` the layer
    matrices are quantized once, here (or given already quantized as
    ``wq_layers``, as a runner that keeps its graphs gives them), and with
    ``attn="megakernel"`` they are packed for K5 once, here (prefill ran
    on the originals), from the state's decoder (the whole one under a
    model group)."""
    check_wq(state.attn, wq)
    if wq and wq_layers is None:
        wq_layers = quantize_opt_layers(p.layers)
    mega_layers = None
    if state.attn == "megakernel":
        p = state.decoder
        mega_layers = pack_megakernel_layers(p.layers)
    while state.step < max_new_tokens:
        until = min(state.step + sync_every, max_new_tokens)
        state = decode_segment(p, cfg, state, max_new_tokens=max_new_tokens, until=until,
                               early_exit=early_exit, wq_layers=wq_layers,
                               mega_layers=mega_layers, graph=graph, **sample_kw)
        if state.step < until:
            break
    return state


def generate(p: ShapeOPT, cfg: ShapeOPTConfig, cond_embeds: torch.Tensor, *,
             max_new_tokens: int, sampling: bool = False, top_k: int = 50,
             top_p: float = 0.95, temperature: float = 1.0, bucket: int = 512,
             generator: Optional[torch.Generator] = None, attn: str = "pallas",
             wq: bool = False, prompt_ids: Optional[torch.Tensor] = None,
             graph: bool = True) -> torch.Tensor:
    """Autoregressive generation -> (B, max_new_tokens) int64, eos-filled
    past the stop point. Attention is K1, K2 or K3 on every step, or the
    whole layer stack is K5 (see the module docstring for ``attn`` and
    ``wq``; ``graph=False``: the eager loop on a card). ``prompt_ids`` (B, P): continue from a token prefix in
    stream order (element 0 the bos slot), prefilled in one causal pass
    (``prefill_with_prompt``) and echoed at the front of the output: mesh
    completion (``models/meshanything.py::complete``)."""
    kw = dict(sampling=sampling, top_k=top_k, top_p=top_p, temperature=temperature)
    state = init_decode_state(p, cfg, cond_embeds, max_new_tokens=max_new_tokens,
                              bucket=bucket, generator=generator, attn=attn,
                              prompt_ids=prompt_ids, **kw)
    return decode_loop(p, cfg, state, max_new_tokens=max_new_tokens, wq=wq, graph=graph,
                       **kw).tokens
