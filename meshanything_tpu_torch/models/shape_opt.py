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

wq=True runs the four per-layer matrices of the decode loop as int8 W8A8
(``ops/wquant.py``); prefill, embeddings and lm_head stay in the
activation dtype.

The loop runs eagerly on the host and looks at the ``done`` flags only
every ``sync_every`` steps; in between, a step taken after every row has
finished leaves the token buffer untouched, so the stream is the one the
JAX package's early-exiting ``while_loop`` leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from meshanything_tpu_torch.config import ShapeOPTConfig
from meshanything_tpu_torch.models.layers import attention, lin, ln
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

ATTN_MODES = ("pallas", "pallas_int8", "pallas_int4", "megakernel")
# a cache: one (2, L, B, S, H*D) tensor, or (values, scales) when quantized
Cache = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


class OPTLayer(nn.Module):
    def __init__(self, cfg: ShapeOPTConfig, device=None, dtype=None):
        super().__init__()
        f = {"device": device, "dtype": dtype}
        d = cfg.hidden_size
        self.qkv = nn.Linear(d, 3 * d, **f)
        self.out = nn.Linear(d, d, **f)
        self.ln_attn = nn.LayerNorm(d, eps=cfg.ln_eps, **f)
        self.fc1 = nn.Linear(d, cfg.ffn_dim, **f)
        self.fc2 = nn.Linear(cfg.ffn_dim, d, **f)
        self.ln_ffn = nn.LayerNorm(d, eps=cfg.ln_eps, **f)

    def after_attention(self, x: torch.Tensor, o: torch.Tensor, mats=None,
                        lin_e=lin) -> torch.Tensor:
        """Out projection, residual, post-LN, ReLU MLP, residual, post-LN
        (x is the layer input, o the merged attention heads). ``mats``
        holds the out/fc1/fc2 matrices (default: this layer's), applied
        with ``lin_e`` (``ops.wquant.lin_dispatch``)."""
        mats = self if mats is None else mats
        x = ln(x + lin_e(o.to(x.dtype), mats.out), self.ln_attn)
        return ln(x + lin_e(F.relu(lin_e(x, mats.fc1)), mats.fc2), self.ln_ffn)


class ShapeOPT(nn.Module):
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


# ---------------------------------------------------------------------------
# prefill and decode


def prefill(p: ShapeOPT, cfg: ShapeOPTConfig, cond_embeds: torch.Tensor,
            kv_cache: torch.Tensor) -> torch.Tensor:
    """Causal pass over the (B, C, d) condition embeddings. Writes rows
    [0, C) of every layer of ``kv_cache`` (2, L, B, S, H*D) in place and
    returns the last position's logits (B, vocab) in f32."""
    b, c, d = cond_embeds.shape
    h, hd = cfg.num_heads, cfg.head_dim
    x = cond_embeds + p.cond_embed[0].to(cond_embeds.dtype)
    x = x + p.embed_positions[cfg.pos_offset:cfg.pos_offset + c].to(x.dtype)
    for layer_idx, layer in enumerate(p.layers):
        q, k, v = lin(x, layer.qkv).chunk(3, dim=-1)
        kv_cache[0, layer_idx, :, :c] = k
        kv_cache[1, layer_idx, :, :c] = v
        o = attention(q.reshape(b, c, h, hd), k.reshape(b, c, h, hd), v.reshape(b, c, h, hd),
                      causal=True)
        x = layer.after_attention(x, o.reshape(b, c, d))
    return lin(x[:, -1], p.lm_head).float()


def resolve_attn(attn: str) -> str:
    """``"auto"`` is the exact tier; anything else must be ported."""
    attn = "pallas" if attn == "auto" else attn
    if attn not in ATTN_MODES:
        raise ValueError(f"attn={attn!r}: the port runs {ATTN_MODES} (and 'auto')")
    return attn


def prefill_cache(p: ShapeOPT, cfg: ShapeOPTConfig, cond_embeds: torch.Tensor, attn: str,
                  seq: int, bucket: int) -> Tuple[torch.Tensor, Cache]:
    """Allocate the decode cache for ``seq`` rows (padded to ``bucket``)
    and prefill it -> (first logits (B, vocab) f32, cache). Quantized
    tiers prefill a compact condition-length tensor and quantize it into
    rows [0, C) of the preallocated caches."""
    b, c, _ = cond_embeds.shape
    n_layers, hd = cfg.num_layers, cfg.hidden_size
    if attn not in QUANTIZED:
        kv = alloc_kv_cache(n_layers, b, seq, cfg.num_heads, cfg.head_dim,
                            dtype=cond_embeds.dtype, chunk=bucket, device=cond_embeds.device)
        return prefill(p, cfg, cond_embeds, kv), kv
    compact = torch.empty((2, n_layers, b, c, hd), dtype=cond_embeds.dtype,
                          device=cond_embeds.device)
    logits0 = prefill(p, cfg, cond_embeds, compact)
    values, scales = alloc_quantized_cache(attn, n_layers, b, seq, hd, chunk=bucket,
                                           device=cond_embeds.device)
    codes, row_scales = quantize_rows_for(attn)(compact)
    values[:, :, :, :c] = codes
    scales[:, :, :, 0, :c] = row_scales[..., 0]
    return logits0, (values, scales)


@dataclasses.dataclass
class DecodeState:
    step: int                   # tokens generated so far (host counter)
    tokens: torch.Tensor        # (B, gen_len) int64, eos-prefilled
    kv: Cache                   # written in place
    done: torch.Tensor          # (B,) bool: row emitted eos
    last_token: torch.Tensor    # (B,) int64: token fed to the next step
    generator: Optional[torch.Generator] = None  # sampling mode
    attn: str = "pallas"


def init_decode_state(p: ShapeOPT, cfg: ShapeOPTConfig, cond_embeds: torch.Tensor, *,
                      max_new_tokens: int, sampling: bool = False, top_k: int = 50,
                      top_p: float = 0.95, temperature: float = 1.0, bucket: int = 512,
                      generator: Optional[torch.Generator] = None,
                      attn: str = "pallas") -> DecodeState:
    """Allocate the cache (S padded to ``bucket``), prefill it, and take
    the first token."""
    attn = resolve_attn(attn)
    b, c, _ = cond_embeds.shape
    logits0, kv = prefill_cache(p, cfg, cond_embeds, attn, c + max_new_tokens, bucket)
    first = sample_token(logits0, sampling=sampling, top_k=top_k, top_p=top_p,
                         temperature=temperature, generator=generator)
    tokens = torch.full((b, max_new_tokens), cfg.eos_token_id, dtype=torch.int64,
                        device=cond_embeds.device)
    tokens[:, 0] = first
    return DecodeState(step=1, tokens=tokens, kv=kv, done=first == cfg.eos_token_id,
                       last_token=first, generator=generator, attn=attn)


def _step_attention(state: DecodeState, layer_idx: int, write_pos: int, q: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Write the step's K/V row at ``write_pos`` (quantized first in the
    int8/int4 tiers) and attend over rows [0, write_pos] -> (B, H, D)."""
    if state.attn == "pallas":
        state.kv[0, layer_idx, :, write_pos] = k
        state.kv[1, layer_idx, :, write_pos] = v
        return decode_attention(q, state.kv, layer_idx, write_pos + 1)
    values, scales = state.kv
    qrows = quantize_rows_for(state.attn)
    for plane, rows in enumerate((k, v)):
        codes, row_scale = qrows(rows)
        values[plane, layer_idx, :, write_pos] = codes
        scales[plane, layer_idx, :, 0, write_pos] = row_scale[:, 0]
    kernel = decode_attention_int8 if state.attn == "pallas_int8" else decode_attention_int4
    return kernel(q, values, scales, layer_idx, write_pos + 1)


def decode_step(p: ShapeOPT, cfg: ShapeOPTConfig, state: DecodeState, *,
                wq_layers: Optional[Sequence] = None,
                mega_layers: Optional[MegakernelLayers] = None, sampling: bool = False,
                top_k: int = 50, top_p: float = 0.95, temperature: float = 1.0) -> torch.Tensor:
    """One token for every row; updates ``state`` in place (cache row,
    token buffer, flags) and returns the step's f32 logits (B, vocab).
    ``wq_layers`` (``ops.wquant.quantize_opt_layers``) runs the layer
    matrices as W8A8; with ``attn="megakernel"`` the layer stack is one
    K5 launch on ``mega_layers`` (``ops.megakernel.pack_megakernel_layers``)."""
    ids = state.last_token
    gen_index = state.step - 1
    dtype = p.cond_embed.dtype
    h, hd = cfg.num_heads, cfg.head_dim
    lin_e = lin_dispatch(wq_layers is not None)
    # the fed token was generated at gen_index and sits at absolute
    # position cond_length + gen_index
    write_pos = cfg.cond_length + gen_index
    x = embed_tokens(p, cfg, ids).to(dtype)
    x = x + p.face_positions[face_phase_ids(ids, gen_index, cfg.face_per_token)].to(dtype)
    x = x + p.cond_embed[1].to(dtype)
    x = x + p.embed_positions[write_pos + cfg.pos_offset].to(dtype)
    b = x.shape[0]
    if state.attn == "megakernel":
        x = decode_step_megakernel(x, mega_layers, state.kv, write_pos, write_pos + 1,
                                   num_heads=h, ln_eps=cfg.ln_eps)
    else:
        for layer_idx, layer in enumerate(p.layers):
            mats = layer if wq_layers is None else wq_layers[layer_idx]
            q, k, v = lin_e(x, mats.qkv).chunk(3, dim=-1)
            o = _step_attention(state, layer_idx, write_pos, q.reshape(b, h, hd).contiguous(),
                                k, v)
            x = layer.after_attention(x, o.reshape(b, h * hd), mats, lin_e)
    logits = lin(x, p.lm_head).float()   # keeps the activation dtype's rounding

    next_token = sample_token(logits, sampling=sampling, top_k=top_k, top_p=top_p,
                              temperature=temperature, generator=state.generator)
    # finished rows emit pad (HF generate semantics, meshanything.py:150)
    next_token = torch.where(state.done, cfg.pad_token_id, next_token)
    # a step after every row finished is one the JAX loop never takes:
    # it must leave the eos-prefilled buffer as it is
    slot = state.tokens[:, state.step]
    state.tokens[:, state.step] = torch.where(state.done.all(), slot, next_token)
    state.done |= next_token == cfg.eos_token_id
    state.last_token = next_token
    state.step += 1
    return logits


def check_wq(attn: str, wq: bool) -> None:
    if wq and attn == "megakernel":
        raise ValueError("wq (int8 weights) does not compose with the megakernel path")


def decode_loop(p: ShapeOPT, cfg: ShapeOPTConfig, state: DecodeState, *, max_new_tokens: int,
                sync_every: int = 64, wq: bool = False, **sample_kw) -> DecodeState:
    """Decode until ``max_new_tokens`` or until every row is done. The
    host reads the ``done`` flags every ``sync_every`` steps only. With
    ``wq`` the layer matrices are quantized once, here, and with
    ``attn="megakernel"`` they are packed for K5 once, here (prefill ran
    on the originals)."""
    check_wq(state.attn, wq)
    wq_layers = quantize_opt_layers(p.layers) if wq else None
    mega_layers = pack_megakernel_layers(p.layers) if state.attn == "megakernel" else None
    while state.step < max_new_tokens:
        if (state.step - 1) % sync_every == 0 and bool(state.done.all()):
            break
        decode_step(p, cfg, state, wq_layers=wq_layers, mega_layers=mega_layers, **sample_kw)
    return state


def generate(p: ShapeOPT, cfg: ShapeOPTConfig, cond_embeds: torch.Tensor, *,
             max_new_tokens: int, sampling: bool = False, top_k: int = 50,
             top_p: float = 0.95, temperature: float = 1.0, bucket: int = 512,
             generator: Optional[torch.Generator] = None, attn: str = "pallas",
             wq: bool = False) -> torch.Tensor:
    """Autoregressive generation -> (B, max_new_tokens) int64, eos-filled
    past the stop point. Attention is K1, K2 or K3 on every step, or the
    whole layer stack is K5 (see the module docstring for ``attn`` and
    ``wq``)."""
    kw = dict(sampling=sampling, top_k=top_k, top_p=top_p, temperature=temperature)
    state = init_decode_state(p, cfg, cond_embeds, max_new_tokens=max_new_tokens,
                              bucket=bucket, generator=generator, attn=attn, **kw)
    return decode_loop(p, cfg, state, max_new_tokens=max_new_tokens, wq=wq, **kw).tokens
