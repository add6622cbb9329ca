"""Lookahead (Jacobi) decoding: several tokens per forward, exactly the
greedy stream (the port of ``meshanything_tpu/models/lookahead.py``).

Each forward runs a W-token window [last confirmed token, g_1 .. g_{W-1}]
through the decoder and accepts the longest run of guesses that match
the model's own greedy predictions; the next guesses are the window's
trailing predictions. In exact arithmetic the stream is the step-by-step
greedy one (tested in f32 against the port's single-token decode and
against the JAX package).

Fused window append: in every layer the window's K/V rows go to K4
(``ops.decode_attention_mq``) as one extra causal tile, quantized first in
the int8/int4 tiers; the kernel's cache sweep covers only the confirmed
rows [0, write_start); after the last layer all layers' window rows are
written into the cache at once. ``write_start = cond_length + steps - 1``
per row.

The host loop reads the rows' live flags before every forward, so the
forwards it runs are exactly the JAX ``while_loop``'s iterations.

Sampling is speculative sampling against the deterministic draft chain
of the window's guesses (``_speculative_accept``), with a
``torch.Generator``: it keeps the step-by-step top-k/top-p distribution,
not the JAX package's draws.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from meshanything_tpu_torch.config import ShapeOPTConfig
from meshanything_tpu_torch.models.layers import lin
from meshanything_tpu_torch.models.shape_opt import (
    Cache,
    ShapeOPT,
    embed_tokens,
    face_phase_ids,
    prefill_cache,
    resolve_attn,
)
from meshanything_tpu_torch.ops.decode_attention import decode_attention_mq
from meshanything_tpu_torch.ops.kvcache import QUANTIZED, quantize_rows_for
from meshanything_tpu_torch.ops.sampling import sample_token, top_k_filter, top_p_filter
from meshanything_tpu_torch.ops.wquant import lin_dispatch, quantize_opt_layers


@dataclasses.dataclass
class LookaheadState:
    steps: torch.Tensor         # (B,) int64: tokens generated per row
    tokens: torch.Tensor        # (B, gen_len + buf_window) int64, eos-prefilled
    kv: Cache                   # written in place
    done: torch.Tensor          # (B,) bool
    window: torch.Tensor        # (B, W) int64: w_0 = last confirmed, rest guesses
    iters: int                  # window forwards run
    attn: str
    generator: Optional[torch.Generator] = None   # speculative sampling only


def _gumbel_argmax(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """A categorical draw per row of (..., V) logits (-inf excluded)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device).clamp_min(1e-20)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _speculative_accept(generator: Optional[torch.Generator], logits: torch.Tensor,
                        window: torch.Tensor, top_k: int, top_p: float):
    """Exact speculative sampling against the deterministic draft chain
    window[:, 1:]: position i's draft g is accepted with probability
    p_i(g) under the warped distribution; at the first rejection the
    token is drawn from p_i without g, renormalized; when every draft
    survives a fresh token is drawn at the last position.

    Returns (emitted (B, W), valid through index n_acc; n_acc (B,))."""
    b, w, _ = logits.shape
    warped = top_p_filter(top_k_filter(logits.float(), top_k), top_p)
    probs = torch.softmax(warped, dim=-1)
    g = window[:, 1:]
    pg = torch.gather(probs[:, :-1], -1, g[..., None])[..., 0]
    u = torch.rand(pg.shape, generator=generator, device=logits.device)
    n_acc = torch.cumprod((u < pg).long(), dim=-1).sum(dim=-1)            # (B,) in [0, W-1]
    fresh = _gumbel_argmax(warped[:, -1], generator)
    if w > 1:
        residual = _gumbel_argmax(warped[:, :-1].scatter(-1, g[..., None], float("-inf")),
                                  generator)
        at = torch.clamp(n_acc, max=w - 2)[:, None]
        stop = torch.where(n_acc < w - 1, torch.gather(residual, 1, at)[:, 0], fresh)
    else:
        stop = fresh
    drafts = torch.cat([g, fresh[:, None]], dim=1)
    idx = torch.arange(w, device=logits.device)[None, :]
    return torch.where(idx < n_acc[:, None], drafts, stop[:, None]), n_acc


def _window_attention(state: LookaheadState, layer_idx: int, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, base: torch.Tensor):
    """K4 over the confirmed rows plus the window tile -> (o (B, W, H, D),
    the rows to append: K, V[, K scales, V scales]). ``base`` is the
    forward's write_start as int32."""
    if state.attn in QUANTIZED:
        qrows = quantize_rows_for(state.attn)
        values, scales = state.kv
        (kq, ks), (vq, vs) = qrows(k), qrows(v)           # (B, W, packed), (B, W, 1)
        o = decode_attention_mq(q, values, scales, layer_idx, base, kq, vq,
                                ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous())
        return o, (kq, vq, ks[..., 0], vs[..., 0])
    kd = k.to(state.kv.dtype).contiguous()
    vd = v.to(state.kv.dtype).contiguous()
    return decode_attention_mq(q, state.kv, None, layer_idx, base, kd, vd), (kd, vd)


def _append_window(state: LookaheadState, rows: list, write_start: torch.Tensor) -> None:
    """Write every layer's window rows at [write_start[b], +W) at once."""
    b, w = state.window.shape
    bi = torch.arange(b, device=write_start.device)[:, None]
    pos = write_start[:, None] + torch.arange(w, device=write_start.device)[None, :]
    stacked = [torch.stack(plane) for plane in zip(*rows)]    # each (L, B, W[, packed])
    if state.attn in QUANTIZED:
        values, scales = state.kv
        values[:, :, bi, pos] = torch.stack(stacked[:2])       # (2, L, B, W, packed)
        scales[:, :, :, 0][:, :, bi, pos] = torch.stack(stacked[2:])
    else:
        state.kv[:, :, bi, pos] = torch.stack(stacked)


def _window_step(p: ShapeOPT, cfg: ShapeOPTConfig, state: LookaheadState, *,
                 max_new_tokens: int, wq_layers: Optional[Sequence] = None,
                 sampling: bool = False, top_k: int = 50, top_p: float = 0.95) -> None:
    """One W-token forward and its acceptance; updates ``state`` in place."""
    lin_e = lin_dispatch(wq_layers is not None)
    b, w = state.window.shape
    dtype = p.cond_embed.dtype
    h, hd, d_model = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    dev = state.window.device
    idx_w = torch.arange(w, device=dev)[None, :]

    ids = state.window
    gen_idx = (state.steps - 1)[:, None] + idx_w                       # (B, W)
    x = embed_tokens(p, cfg, ids).to(dtype)
    x = x + p.face_positions[face_phase_ids(ids, gen_idx, cfg.face_per_token)].to(dtype)
    x = x + p.cond_embed[1].to(dtype)
    x = x + p.embed_positions[cfg.cond_length + gen_idx + cfg.pos_offset].to(dtype)
    write_start = cfg.cond_length + state.steps - 1                    # (B,)
    base = write_start.to(torch.int32)          # once a forward, for the 24 calls of K4

    rows = []
    for layer_idx, layer in enumerate(p.layers):
        mats = layer if wq_layers is None else wq_layers[layer_idx]
        q, k, v = lin_e(x, mats.qkv).chunk(3, dim=-1)                  # (B, W, d)
        o, appended = _window_attention(state, layer_idx, q.reshape(b, w, h, hd).contiguous(),
                                        k, v, base)
        rows.append(appended)
        x = layer.after_attention(x, o.reshape(b, w, d_model), mats, lin_e)
    _append_window(state, rows, write_start)

    logits = lin(x, p.lm_head).float()                                  # (B, W, V)
    preds = torch.argmax(logits, dim=-1)
    if sampling:
        emitted, n_acc = _speculative_accept(state.generator, logits, state.window, top_k, top_p)
        accepted = n_acc + 1
    else:
        # the longest run of guesses that match the predictions
        emitted = preds
        hits = (state.window[:, 1:] == preds[:, :-1]).long()
        accepted = 1 + torch.cumprod(hits, dim=-1).sum(dim=-1)
    # cut at the first emitted eos (inclusive)
    is_eos = emitted == cfg.eos_token_id
    first_eos = torch.argmax(is_eos.long(), dim=-1)
    has_eos = is_eos.any(dim=-1)
    accepted = torch.where(has_eos, torch.minimum(accepted, first_eos + 1), accepted)
    # freeze rows that are done or out of budget: their base stays put
    frozen = state.done | (state.steps >= max_new_tokens)
    accepted = torch.minimum(accepted, (max_new_tokens - state.steps).clamp_min(0))
    accepted = torch.where(frozen, 0, accepted)

    fill = torch.where(idx_w < accepted[:, None], emitted, cfg.eos_token_id)
    state.tokens[torch.arange(b, device=dev)[:, None], state.steps[:, None] + idx_w] = fill
    state.done = state.done | (has_eos & (first_eos < accepted))

    # next window: the last accepted token, then the predictions rolled
    # left by `accepted`
    last = torch.gather(emitted, 1, (accepted - 1).clamp_min(0)[:, None])[:, 0]
    last = torch.where(frozen, state.window[:, 0], last)
    guesses = torch.gather(preds, 1, (idx_w + accepted[:, None]) % w)
    state.window = torch.cat([last[:, None], guesses[:, :w - 1]], dim=1)
    state.steps = state.steps + accepted
    state.iters += 1


def resize_window(state: LookaheadState, new_w: int) -> LookaheadState:
    """The state at another window width: narrowing drops guesses,
    widening pads them with zeros (guesses are only proposals). Every
    other field is width-independent, provided the state was made with
    ``buf_window`` >= the widest window."""
    b, w = state.window.shape
    if new_w == w:
        return state
    if new_w < w:
        win = state.window[:, :new_w]
    else:
        win = torch.cat([state.window, state.window.new_zeros((b, new_w - w))], dim=1)
    return dataclasses.replace(state, window=win)


def check_attn(attn: str) -> None:
    """Raise for a cache tier the window loop does not run."""
    if attn == "megakernel":
        raise NotImplementedError(
            "lookahead with attn='megakernel' is not ported: the window loop has no "
            "megakernel path (JAX runs its XLA tier there, which the port does not have)")


def init_lookahead_state(p: ShapeOPT, cfg: ShapeOPTConfig, cond_embeds: torch.Tensor, *,
                         max_new_tokens: int, window: int = 8, bucket: int = 512,
                         attn: str = "pallas", sampling: bool = False, top_k: int = 50,
                         top_p: float = 0.95, generator: Optional[torch.Generator] = None,
                         buf_window: Optional[int] = None) -> LookaheadState:
    """Prefill and first token. ``buf_window`` (>= window, default the
    window) sizes the token buffer's scratch tail and the cache padding
    for the widest window the state will be resized to."""
    attn = resolve_attn(attn)
    check_attn(attn)
    bw = window if buf_window is None else buf_window
    if bw < window:
        raise ValueError(f"buf_window={bw} must be >= window={window}")
    b, c, _ = cond_embeds.shape
    dev = cond_embeds.device
    logits0, kv = prefill_cache(p, cfg, cond_embeds, attn, c + max_new_tokens + bw, bucket)
    first = (sample_token(logits0, sampling=True, top_k=top_k, top_p=top_p, generator=generator)
             if sampling else torch.argmax(logits0, dim=-1))
    tokens = torch.full((b, max_new_tokens + bw), cfg.eos_token_id, dtype=torch.int64, device=dev)
    tokens[:, 0] = first
    win = torch.zeros((b, window), dtype=torch.int64, device=dev)
    win[:, 0] = first
    return LookaheadState(steps=torch.ones(b, dtype=torch.int64, device=dev), tokens=tokens,
                          kv=kv, done=first == cfg.eos_token_id, window=win, iters=0, attn=attn,
                          generator=generator)


def lookahead_segment(p: ShapeOPT, cfg: ShapeOPTConfig, state: LookaheadState, *,
                      max_new_tokens: int, wq_layers: Optional[Sequence] = None,
                      until_iters: Optional[int] = None, sampling: bool = False,
                      top_k: int = 50, top_p: float = 0.95) -> LookaheadState:
    """Window forwards while any row is live, and at most until
    ``state.iters == until_iters``."""
    while until_iters is None or state.iters < until_iters:
        if not bool(((state.steps < max_new_tokens) & ~state.done).any()):
            break
        _window_step(p, cfg, state, max_new_tokens=max_new_tokens, wq_layers=wq_layers,
                     sampling=sampling, top_k=top_k, top_p=top_p)
    return state


def run_adaptive_controller(state: LookaheadState, seg_fn: Callable, *, windows=(8, 16),
                            check_iters: int = 64, max_new_tokens: int,
                            trace: Optional[list] = None) -> LookaheadState:
    """Acceptance-adaptive window: ``seg_fn(state, until_iters, window)``
    runs one bounded segment at that width. After each, the controller
    reads the counters and switches with hysteresis: up when the small
    window saturates (mean acceptance >= W_small - 1), down when the big
    one's falls below 0.6 * W_big. ``trace`` receives (iters, window,
    acceptance) tuples. The state must have buf_window >= max(windows)."""
    small, big = windows
    w_cur = small
    prev_iters, prev_tok = state.iters, int(state.steps.sum())
    bound = prev_iters
    while True:
        bound += check_iters
        state = seg_fn(state, bound, w_cur)
        steps, done = state.steps.cpu(), state.done.cpu()
        n_live = int(((~done) & (steps < max_new_tokens)).sum())
        di = state.iters - prev_iters
        if di > 0:
            acc = (int(steps.sum()) - prev_tok) / (di * max(n_live, 1))
            if w_cur == small and acc >= small - 1.0:
                w_cur = big
                state = resize_window(state, big)
            elif w_cur == big and acc < 0.6 * big:
                w_cur = small
                state = resize_window(state, small)
            if trace is not None:
                trace.append((state.iters, w_cur, float(acc)))
        prev_iters, prev_tok = state.iters, int(steps.sum())
        if n_live == 0 or bound > 4 * max_new_tokens:   # the bound is defensive only
            return state


def generate_lookahead(p: ShapeOPT, cfg: ShapeOPTConfig, cond_embeds: torch.Tensor, *,
                       max_new_tokens: int, window: int = 8, bucket: int = 512,
                       attn: str = "pallas", wq: bool = False, sampling: bool = False,
                       top_k: int = 50, top_p: float = 0.95,
                       generator: Optional[torch.Generator] = None,
                       return_stats: bool = False):
    """Generation with lookahead -> (B, max_new_tokens) int64; with
    ``return_stats`` also {"iterations": window forwards, "emitted":
    (B,) tokens per row}. Greedy output is the step-by-step greedy
    stream. ``wq`` quantizes the layer matrices for the window forwards
    (the prefill runs on the originals)."""
    state = init_lookahead_state(p, cfg, cond_embeds, max_new_tokens=max_new_tokens,
                                 window=window, bucket=bucket, attn=attn, sampling=sampling,
                                 top_k=top_k, top_p=top_p, generator=generator)
    state = lookahead_segment(p, cfg, state, max_new_tokens=max_new_tokens,
                              wq_layers=quantize_opt_layers(p.layers) if wq else None,
                              sampling=sampling, top_k=top_k, top_p=top_p)
    tokens = state.tokens[:, :max_new_tokens]
    if return_stats:
        return tokens, {"iterations": state.iters, "emitted": state.steps}
    return tokens
