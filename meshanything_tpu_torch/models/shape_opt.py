"""ShapeOPT: the OPT-350M-based autoregressive mesh-token decoder (the
port of ``meshanything_tpu/models/shape_opt.py``), one decoder family of
``models/decoding.py``, which holds MeshAnything's token interface and the
decode driver:

  * learned absolute positions with OPT's +2 offset, counted over the
    257 condition slots;
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
      layers packed once a request, after the prefill (kept on the decode
      state), with K5's numerics (bf16 weights, f32 residual stream);
      embedding, lm_head and sampling stay as in the other tiers. It does
      not compose with ``wq``.

Each layer's two residual adds and post-LNs (``OPTLayer.after_attention``)
are one kernel each in the decode step (``ops.add_layer_norm``, which has
no backward); the prefill and ``forward_full`` keep ``ln(x + y)``. The
decode step's layer matrices, codebook projection and lm_head go through
``ops.wquant.lin_dispatch``, whose ``nn.Linear`` entry (``ops.gemv.lin``)
runs a product of 1 to 16 bf16 rows as one kernel with the bias and fc1's
ReLU in its epilogue, and any other through ``layers.linear``.

wq=True runs the four per-layer matrices of the decode loop as int8 W8A8
(``ops/wquant.py``); prefill, embeddings and lm_head stay in the
activation dtype.

The step reads every position from the state's device step counter
``step_t``, so the driver's segment replays it as one CUDA graph on the
card (``decoding.decode_segment``); ``attn="megakernel"`` stays eager
there: K5 takes the write position by value.

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

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from meshanything_tpu_torch.config import ShapeOPTConfig
from meshanything_tpu_torch.models.decoding import (
    Cache,
    DecodeState,
    advance,
    check_prompt,
    embed_ids,
    embed_stream,
    first_tokens,
    resolve_attn,
)
from meshanything_tpu_torch.models.layers import attention, col_lin, lin, row_lin
from meshanything_tpu_torch.ops import gemv as gemv_op
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
from meshanything_tpu_torch.ops.megakernel import decode_step_megakernel, pack_megakernel_layers
from meshanything_tpu_torch.ops.wquant import lin_dispatch, quantize_opt_layers
from meshanything_tpu_torch.parallel.mesh import gather_module

# the launch counts a decode graph's ``capture`` span records (decode_graph.StepGraph):
# the residual add and post-LN kernel's, two a layer in a step or a window forward,
# and the few-row product kernel's where it engages: four a layer, the codebook
# projection's and lm_head's
CAPTURE_COUNTERS = {"add_ln": lambda: add_layer_norm.launches,
                    "gemv": lambda: gemv_op.gemv.launches}


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
        with ``lin_e`` (``ops.wquant.lin_dispatch``), which also applies
        fc1's ReLU (the decode step's kernel in its epilogue). ``add_ln(x, y, m)``
        is each residual add and post-LN, ``ln(x + y, m)``: the decode
        step passes the kernel (``ops.add_layer_norm``), which has no
        backward."""
        mats = self if mats is None else mats
        g = self.tp_group
        x = add_ln(x, row_lin(o.to(x.dtype), mats.out, g, lin_e), self.ln_attn)
        return add_ln(x, row_lin(col_lin(x, mats.fc1, g, lin_e, relu=True), mats.fc2, g, lin_e),
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


def whole_decoder(p: ShapeOPT) -> ShapeOPT:
    """The decoder that ``attn="megakernel"`` runs: ``p`` itself, or under
    a model group the full decoder gathered over it (every rank of the
    group calls this; ``parallel/mesh.py::gather_module``, bit-exact)."""
    group = p.layers[0].tp_group
    return p if group is None else gather_module(p, group, "opt.")


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
    ``state.decoder``) into a full-width cache; its layers are packed for
    K5 after the prefill, kept as ``state.mega_layers``."""
    attn = resolve_attn(attn)
    decoder = None
    if attn == "megakernel":
        p = decoder = whole_decoder(p)
    c = cond_embeds.shape[1]
    prompt_ids, p_len = check_prompt(prompt_ids, max_new_tokens, cond_embeds.device)
    if into is not None and into.attn != attn:
        raise ValueError(f"a state of attn={into.attn!r} refilled for attn={attn!r}")
    logits0, kv = prefill_cache(p, cfg, cond_embeds, attn, c + max_new_tokens, bucket,
                                prompt_ids, kv=None if into is None else into.kv)
    first, tokens = first_tokens(cfg, logits0, max_new_tokens, prompt_ids, sampling=sampling,
                                 top_k=top_k, top_p=top_p, temperature=temperature,
                                 generator=generator)
    return DecodeState.start(
        cfg, first, tokens, kv, p_len, into, generator=generator, attn=attn, decoder=decoder,
        mega_layers=None if decoder is None else pack_megakernel_layers(p.layers))


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
              wq_layers: Optional[Sequence] = None, sampling: bool = False,
              top_k: int = 50, top_p: float = 0.95, temperature: float = 1.0,
              early_exit: bool = True) -> torch.Tensor:
    """One token for every row, every position read from ``state.step_t``
    on the device: updates the state's tensors in place (cache row, token
    slot, flags, step_t) and returns the step's f32 logits (B, vocab). It
    leaves the host's ``state.step`` alone and reads nothing back, so a
    CUDA graph can capture it (``decoding.decode_segment``). It runs
    without grad (``ops.add_layer_norm`` has no backward). With
    ``early_exit`` a step taken after every row has finished changes no
    state tensor (JAX's ``cond_fn`` never takes it); without, finished
    rows emit pad to the end, as JAX's loop with ``early_exit=False`` does.

    ``wq_layers`` (``ops.wquant.quantize_opt_layers``) runs the layer
    matrices as W8A8; with ``attn="megakernel"`` the step runs on the
    state's decoder and its layer stack is one K5 launch on
    ``state.mega_layers``, which takes the write position by value from
    the host's ``state.step``."""
    if state.attn == "megakernel":
        p = state.decoder
    ids = state.last_token
    gen_index = state.step_t - 1
    dtype = p.cond_embed.dtype
    hd = cfg.head_dim
    lin_e = lin_dispatch(wq_layers is not None)
    lin_a = lin_dispatch(False)     # the codebook projection and lm_head, never W8A8
    # the fed token was generated at gen_index and sits at absolute
    # position cond_length + gen_index
    write_pos = (cfg.cond_length + gen_index).reshape(1)
    x = embed_ids(p, cfg, ids, gen_index, dtype, lin_a)
    x = x + p.embed_positions.index_select(0, write_pos + cfg.pos_offset).to(dtype)
    b = x.shape[0]
    if state.attn == "megakernel":
        pos = cfg.cond_length + state.step - 1
        x = decode_step_megakernel(x, state.mega_layers, state.kv, pos, pos + 1,
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
    logits = lin_a(x, p.lm_head).float()   # keeps the activation dtype's rounding
    advance(cfg, state, logits, sampling=sampling, top_k=top_k, top_p=top_p,
            temperature=temperature, early_exit=early_exit)
    return logits


# ---------------------------------------------------------------------------
# the rest of what the driver and the runner ask of a decoder family
# (``decoding.family``)

Decoder = ShapeOPT
quantize_layers = quantize_opt_layers


def check_tier(attn: str = "pallas", lookahead=0) -> None:
    """OPT runs every tier: nothing to refuse here (the lookahead's and
    ``wq``'s own checks are ``lookahead.check_attn`` and
    ``decoding.check_wq``)."""


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
