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

A forward with no live row changes no state tensor (it may still write
cache rows at the frozen bases, as JAX's frozen rows do) and counts no
iteration (``iters_t`` on the device, JAX's ``iters``), so the forwards
past the last live one are no-ops and a segment (``lookahead_segment``)
reads the live flags once every few forwards. On the card each forward
is a replay of a CUDA graph captured for the window's width
(``runtime/decode_graph.py``); elsewhere the same forward runs eagerly.

Under tensor parallelism (``parallel/mesh.py``) a forward runs the rank's
heads over its cache columns (K4 over (H / tp) * D) and sums the out and
fc2 products over the model group (``OPTLayer.after_attention``); in the
int8/int4 tiers the window's K/V rows take their scales over the group
(one all-reduce a layer for the window's (2, B, W) amaxes), and ``wq``
sums the row-parallel products' int32 accumulators over it
(``ops/wquant.py``), so a rank computes what one process computes.

Sampling is speculative sampling against the deterministic draft chain
of the window's guesses (``_speculative_accept``), with a
``torch.Generator``: it keeps the step-by-step top-k/top-p distribution,
not the JAX package's draws.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import torch

from meshanything_tpu_torch.config import ShapeOPTConfig
from meshanything_tpu_torch.models.decoding import (
    Cache,
    check_capture,
    check_prompt,
    embed_ids,
    first_tokens,
    resolve_attn,
)
from meshanything_tpu_torch.models.layers import col_lin
from meshanything_tpu_torch.models.shape_opt import CAPTURE_COUNTERS, ShapeOPT, prefill_cache
from meshanything_tpu_torch.ops.add_layer_norm import add_layer_norm
from meshanything_tpu_torch.ops.decode_attention import decode_attention_mq
from meshanything_tpu_torch.ops.kvcache import QUANTIZED, quantize_rows_for
from meshanything_tpu_torch.ops.sampling import top_k_filter, top_p_filter
from meshanything_tpu_torch.ops.wquant import lin_dispatch, quantize_opt_layers
from meshanything_tpu_torch.runtime import decode_graph, profiling

# forwards between the host's reads of the live flags on the card (a
# forward past the last live one changes nothing, so up to CHECK_EVERY - 1
# of them may run at the end of the decode)
CHECK_EVERY = 16


@dataclasses.dataclass
class LookaheadState:
    # The tensors are written in place, never rebound (a captured forward
    # replays over them); ``resize_window`` gives a state with another
    # window tensor and the same others.
    steps: torch.Tensor         # (B,) int64: tokens generated per row
    tokens: torch.Tensor        # (B, gen_len + buf_window) int64, eos-prefilled
    kv: Cache                   # written in place
    done: torch.Tensor          # (B,) bool
    window: torch.Tensor        # (B, W) int64: w_0 = last confirmed, rest guesses
    iters: int                  # the host's copy of iters_t, read at each segment's end
    iters_t: torch.Tensor       # () int64 on the device: forwards with a live row (JAX's iters)
    attn: str
    generator: Optional[torch.Generator] = None   # speculative sampling only
    graphs: dict = dataclasses.field(default_factory=dict)   # width -> captured forward (card)


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
                      v: torch.Tensor, base: torch.Tensor, group=None):
    """K4 over the confirmed rows plus the window tile -> (o (B, W, H, D),
    the rows to append: K, V[, K scales, V scales]). ``base`` is the
    forward's write_start as int32; ``group`` the layer's model group,
    over which a quantized row's scale is taken."""
    if state.attn in QUANTIZED:
        values, scales = state.kv
        # K and V in one call: one all-reduce of their amaxes under a model group
        codes, row_scales = quantize_rows_for(state.attn)(torch.stack([k, v]), group)
        (kq, vq), (ks, vs) = codes, row_scales            # (B, W, packed), (B, W, 1)
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


@torch.no_grad()
def _window_step(p: ShapeOPT, cfg: ShapeOPTConfig, state: LookaheadState, *,
                 max_new_tokens: int, wq_layers: Optional[Sequence] = None,
                 sampling: bool = False, top_k: int = 50, top_p: float = 0.95,
                 max_accept: Optional[int] = None) -> None:
    """One W-token forward and its acceptance; updates the state's tensors
    in place and reads nothing back (a CUDA graph captures it). With no
    live row it changes nothing but cache rows at the frozen bases.
    ``max_accept`` caps the tokens a row accepts in the forward. It runs
    without grad, as ``step_body`` does."""
    lin_e = lin_dispatch(wq_layers is not None)
    lin_a = lin_dispatch(False)     # the codebook projection and lm_head, never W8A8
    b, w = state.window.shape
    dtype = p.cond_embed.dtype
    hd = cfg.head_dim
    dev = state.window.device
    idx_w = torch.arange(w, device=dev)[None, :]

    ids = state.window
    gen_idx = (state.steps - 1)[:, None] + idx_w                       # (B, W)
    x = embed_ids(p, cfg, ids, gen_idx, dtype, lin_a)
    x = x + p.embed_positions[cfg.cond_length + gen_idx + cfg.pos_offset].to(dtype)
    write_start = cfg.cond_length + state.steps - 1                    # (B,)
    base = write_start.to(torch.int32)          # once a forward, for the 24 calls of K4

    rows = []
    for layer_idx, layer in enumerate(p.layers):
        mats = layer if wq_layers is None else wq_layers[layer_idx]
        h = layer.num_heads                                             # the rank's heads
        q, k, v = col_lin(x, mats.qkv, layer.tp_group, lin_e).chunk(3, dim=-1)   # (B, W, h*hd)
        o, appended = _window_attention(state, layer_idx, q.reshape(b, w, h, hd).contiguous(),
                                        k, v, base, layer.tp_group)
        rows.append(appended)
        x = layer.after_attention(x, o.reshape(b, w, h * hd), mats, lin_e, add_layer_norm)
    _append_window(state, rows, write_start)

    logits = lin_a(x, p.lm_head).float()                                # (B, W, V)
    preds = torch.argmax(logits, dim=-1)
    if sampling:
        emitted, n_acc = _speculative_accept(state.generator, logits, state.window, top_k, top_p)
        accepted = n_acc + 1
    else:
        # the longest run of guesses that match the predictions
        emitted = preds
        hits = (state.window[:, 1:] == preds[:, :-1]).long()
        accepted = 1 + torch.cumprod(hits, dim=-1).sum(dim=-1)
    if max_accept is not None:
        # a prefix of an accepted run is itself accepted (each of its tokens
        # is the greedy prediction over confirmed context), so the stream
        # is unchanged: only the forwards it takes grow (JAX :318-325)
        accepted = torch.clamp(accepted, max=max_accept)
    # cut at the first emitted eos (inclusive)
    is_eos = emitted == cfg.eos_token_id
    first_eos = torch.argmax(is_eos.long(), dim=-1)
    has_eos = is_eos.any(dim=-1)
    accepted = torch.where(has_eos, torch.minimum(accepted, first_eos + 1), accepted)
    # freeze rows that are done or out of budget: their base stays put
    frozen = state.done | (state.steps >= max_new_tokens)
    accepted = torch.minimum(accepted, (max_new_tokens - state.steps).clamp_min(0))
    accepted = torch.where(frozen, 0, accepted)

    live = ~frozen.all()        # JAX's cond_fn: a forward runs while some row is live
    fill = torch.where(idx_w < accepted[:, None], emitted, cfg.eos_token_id)
    state.tokens[torch.arange(b, device=dev)[:, None], state.steps[:, None] + idx_w] = fill
    state.done.logical_or_(has_eos & (first_eos < accepted))

    # next window: the last accepted token, then the predictions rolled
    # left by `accepted`
    last = torch.gather(emitted, 1, (accepted - 1).clamp_min(0)[:, None])[:, 0]
    last = torch.where(frozen, state.window[:, 0], last)
    guesses = torch.gather(preds, 1, (idx_w + accepted[:, None]) % w)
    window = torch.cat([last[:, None], guesses[:, :w - 1]], dim=1)
    state.window.copy_(torch.where(live, window, state.window))
    state.steps.add_(accepted)
    state.iters_t.add_(live.long())


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
                         buf_window: Optional[int] = None,
                         prompt_ids: Optional[torch.Tensor] = None,
                         into: Optional[LookaheadState] = None) -> LookaheadState:
    """Prefill and first token. ``buf_window`` (>= window, default the
    window) sizes the token buffer's scratch tail and the cache padding
    for the widest window the state will be resized to. With
    ``prompt_ids`` (B, P) (JAX ``:447-533``) the prefill runs over
    [condition || prompt], the prompt is echoed into the token buffer and
    every row starts at step P + 1.

    ``into``: a state made before by this function with the same
    arguments but the condition, prompt and generator (a kept state, with
    its graphs a width): the prefill writes into its cache and every
    other tensor is set in place (``decode_graph.refill_state``; the
    window at ``window``'s width), and ``into`` is returned."""
    attn = resolve_attn(attn)
    check_attn(attn)
    bw = window if buf_window is None else buf_window
    if bw < window:
        raise ValueError(f"buf_window={bw} must be >= window={window}")
    b, c, _ = cond_embeds.shape
    dev = cond_embeds.device
    prompt_ids, p_len = check_prompt(prompt_ids, max_new_tokens, dev)
    if into is not None and into.attn != attn:
        raise ValueError(f"a state of attn={into.attn!r} refilled for attn={attn!r}")
    logits0, kv = prefill_cache(p, cfg, cond_embeds, attn, c + max_new_tokens + bw, bucket,
                                prompt_ids, kv=None if into is None else into.kv)
    first, tokens = first_tokens(cfg, logits0, max_new_tokens + bw, prompt_ids,
                                 sampling=sampling, top_k=top_k, top_p=top_p, generator=generator)
    win = torch.zeros((b, window), dtype=torch.int64, device=dev)
    win[:, 0] = first
    state = LookaheadState(steps=torch.full((b,), p_len + 1, dtype=torch.int64, device=dev),
                           tokens=tokens, kv=kv, done=first == cfg.eos_token_id, window=win,
                           iters=0, iters_t=torch.zeros((), dtype=torch.int64, device=dev),
                           attn=attn, generator=generator)
    return state if into is None else decode_graph.refill_state(into, state)


def _read_counters(state: LookaheadState, max_new_tokens: int) -> tuple[int, bool]:
    """(forwards counted, some row live): one read from the device."""
    live = ((state.steps < max_new_tokens) & ~state.done).any()
    iters, any_live = torch.stack([state.iters_t, live.long()]).tolist()
    return iters, bool(any_live)


def lookahead_segment(p: ShapeOPT, cfg: ShapeOPTConfig, state: LookaheadState, *,
                      max_new_tokens: int, wq_layers: Optional[Sequence] = None,
                      until_iters: Optional[int] = None, sampling: bool = False,
                      top_k: int = 50, top_p: float = 0.95, max_accept: Optional[int] = None,
                      graph: bool = True) -> LookaheadState:
    """JAX's ``lookahead_segment``: window forwards while some row is live
    and, when given, while ``state.iters < until_iters``. The host reads
    the live flags and the forward count once every ``CHECK_EVERY``
    forwards (every forward on the CPU, where a read costs nothing); the
    forwards run past the last live one change nothing and count nothing.
    ``max_accept`` caps each forward's acceptance (``_window_step``).

    On the card (``graph``) each forward is a replay of the CUDA graph
    captured, after one eager forward, for the window's width and kept in
    ``state.graphs``; a capture that fails raises. With ``graph=False``
    (the eager comparison) and on the CPU the forward runs eagerly.
    Speculative sampling with a generator that the installed torch cannot
    register with a graph runs eagerly, with a warning.

    The forwards between two reads are a ``segment`` span
    (``runtime/profiling.py``), as ``decoding.decode_segment`` records
    one: ``pos`` its first forward, ``steps`` its forwards."""
    def forward():
        _window_step(p, cfg, state, max_new_tokens=max_new_tokens, wq_layers=wq_layers,
                     sampling=sampling, top_k=top_k, top_p=top_p, max_accept=max_accept)

    device = state.tokens.device
    use_graph = decode_graph.use_graph(device, graph) and (
        not sampling or decode_graph.generator_capturable())
    state.iters, live = _read_counters(state, max_new_tokens)
    while live and (until_iters is None or state.iters < until_iters):
        n = CHECK_EVERY if use_graph or state.tokens.is_cuda else 1
        if until_iters is not None:
            n = min(n, until_iters - state.iters)
        with profiling.span("segment", pos=state.iters, steps=n) as sp:
            if not use_graph:
                sp.device_begin(device)
                t0 = time.perf_counter_ns()
                for _ in range(n):
                    forward()
            else:
                w = state.window.shape[1]
                key = (max_new_tokens, sampling, top_k, top_p, max_accept, id(wq_layers))
                g, warm = state.graphs.get(w), 0
                if g is None:
                    check_capture(p)
                    g = decode_graph.StepGraph(forward, device, key=key,
                                               generator=state.generator if sampling else None,
                                               counters=CAPTURE_COUNTERS)
                    g.window = state.window        # the window tensor the graph reads and writes
                    state.graphs[w] = g
                    warm = 1    # the warm-up before the capture was the first of these forwards
                    sp.set(captured=1)
                elif g.key != key:
                    raise ValueError("the segments of one request replay one captured forward a "
                                     "width: the settings changed between segments")
                sp.device_begin(device)
                t0 = time.perf_counter_ns()
                if state.window is not g.window:   # resized since: move the window into the graph's
                    g.window.copy_(state.window)
                    state.window = g.window
                g.replay(n - warm)
            t1 = time.perf_counter_ns()
            sp.device_end()
            state.iters, live = _read_counters(state, max_new_tokens)
            sp.set(launch_ns=t1 - t0, sync_ns=time.perf_counter_ns() - t1)
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
    prev_iters, prev_tok = state.iters, int(state.steps.sum())   # iters: read by the segment
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
                       return_stats: bool = False,
                       prompt_ids: Optional[torch.Tensor] = None,
                       max_accept: Optional[int] = None, graph: bool = True):
    """Generation with lookahead -> (B, max_new_tokens) int64; with
    ``return_stats`` also {"iterations": window forwards, "emitted":
    (B,) tokens per row past the prompt}. Greedy output is the
    step-by-step greedy stream. ``wq`` quantizes the layer matrices for
    the window forwards (the prefill runs on the originals).
    ``prompt_ids`` (B, P): continue from a token prefix (see
    ``decoding.generate``), echoed at the front of the output.
    ``max_accept`` caps the tokens a row accepts per forward, greedy only:
    a measurement knob that keeps the stream and lowers the acceptance.
    ``graph=False``: the eager loop on a card."""
    if max_accept is not None and sampling:
        # the accept/residual draws are spent before a cap could cut the
        # run: the cut stream would lose the step-by-step distribution
        raise ValueError("max_accept is a greedy-mode measurement knob; "
                         "it does not preserve the sampling distribution")
    state = init_lookahead_state(p, cfg, cond_embeds, max_new_tokens=max_new_tokens,
                                 window=window, bucket=bucket, attn=attn, sampling=sampling,
                                 top_k=top_k, top_p=top_p, generator=generator,
                                 prompt_ids=prompt_ids)
    state = lookahead_segment(p, cfg, state, max_new_tokens=max_new_tokens,
                              wq_layers=quantize_opt_layers(p.layers) if wq else None,
                              sampling=sampling, top_k=top_k, top_p=top_p,
                              max_accept=max_accept, graph=graph)
    tokens = state.tokens[:, :max_new_tokens]
    if return_stats:
        p_len = 0 if prompt_ids is None else prompt_ids.shape[1]
        return tokens, {"iterations": state.iters, "emitted": state.steps - p_len}
    return tokens
