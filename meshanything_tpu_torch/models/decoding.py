"""MeshAnything's decode, the same for every shape decoder (OPT's,
``models/shape_opt.py``, and Moonlight's, ``models/moonlight.py``): the
token interface, the decode state and the driver.

A decoder family is a module that gives what differs between decoders:
``Decoder`` (the weights), ``init_decode_state`` (its cache, its prefill
and its state), ``step_body`` (one step), ``CAPTURE_COUNTERS`` (the launch
counts a graph's ``capture`` span records), ``check_tier`` (raises for a
tier it has not), ``libraries`` (the kernel libraries a decode launches),
``quantize_layers`` (``wq``), and ``cache_bytes``, ``prefill_elems`` and
``wq_sizes`` (the memory budget, ``runtime/phases.py``). ``family(cfg)``
finds it by the config's ``decoder`` name. The driver reads a family's
``step_body``, ``CAPTURE_COUNTERS`` and ``quantize_layers`` from its
module when it is called, so a stand-in set on the module is what runs.

A step reads every position from the state's device step counter
``step_t`` (the cache row it writes, the live length the attention kernels
read on the device, the token slot), and a step taken after every row has
finished leaves every state tensor as it is, as JAX's ``while_loop`` never
takes it. So a segment of the decode (``decode_segment``, JAX's) is a fixed
count of steps with no host read inside it: on the card one CUDA graph of
the step replayed (``runtime/decode_graph.py``), elsewhere the same step
run eagerly. The host reads the counter once a segment (``decode_loop``:
segments of ``sync_every`` steps). OPT's ``attn="megakernel"`` stays eager
on the card: K5 takes the write position by value.
"""
from __future__ import annotations

import dataclasses
import importlib
import time
from typing import Optional, Sequence, Tuple, Union

import torch

from meshanything_tpu_torch.models.layers import lin
from meshanything_tpu_torch.ops.megakernel import MegakernelLayers
from meshanything_tpu_torch.ops.sampling import sample_token
from meshanything_tpu_torch.parallel.collectives import capturable
from meshanything_tpu_torch.runtime import decode_graph, profiling

ATTN_MODES = ("pallas", "pallas_int8", "pallas_int4", "megakernel")
# the decoder families: a config's ``decoder`` name -> its module in models/
FAMILIES = {"opt": "shape_opt", "moonlight": "moonlight"}
# a cache: one tensor, or (values, scales) when quantized
Cache = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def family(cfg):
    """The module of the decoder family that ``cfg.decoder`` names, imported
    when asked for: the families import this module."""
    return importlib.import_module(f"meshanything_tpu_torch.models.{FAMILIES[cfg.decoder]}")


# ---------------------------------------------------------------------------
# the token interface


def embed_tokens(p, cfg, ids: torch.Tensor, lin_e=lin) -> torch.Tensor:
    """Hybrid embedding (shape_opt.py:237-245 of the reference): special
    ids {0,1,2} hit extra_embeds, the rest project codebook[id-3] through
    input_layer (with ``lin_e``: the decode steps pass their entry).
    Returns the parameters' dtype."""
    special = p.extra_embeds[ids.clamp(0, 2)]
    code = p.codebook[(ids - 3).clamp(0, cfg.codebook_size - 1)]
    projected = lin_e(code.to(special.dtype), p.input_layer)
    return torch.where((ids < 3)[..., None], special, projected)


def face_phase_ids(ids: torch.Tensor, gen_index, face_per_token: int) -> torch.Tensor:
    """Face positional id of the token generated at ``gen_index`` (0 is
    the bos slot): specials keep their id, coordinates get
    ((gen_index - 1) mod 9) + 3."""
    phase = (gen_index - 1) % face_per_token + 3
    return torch.where(ids < 3, ids, phase)


def embed_ids(p, cfg, ids: torch.Tensor, gen_index, dtype: torch.dtype,
              lin_e=lin) -> torch.Tensor:
    """Ids generated at ``gen_index`` (broadcast against ``ids``) -> their
    embeddings in ``dtype`` as every decoder's step makes them: the hybrid
    embedding (its projection through ``lin_e``), the face phase and
    cond_embed[1], added in that order (the caller adds the position)."""
    x = embed_tokens(p, cfg, ids, lin_e).to(dtype)
    x = x + p.face_positions[face_phase_ids(ids, gen_index, cfg.face_per_token)].to(dtype)
    return x + p.cond_embed[1].to(dtype)


def embed_stream(p, cfg, token_ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, T) ids in stream order (element 0 the bos slot) -> their
    embeddings in ``dtype`` as the decode step makes them (``embed_ids``
    at each one's generated index)."""
    gen_index = torch.arange(token_ids.shape[1], device=token_ids.device)[None, :]
    return embed_ids(p, cfg, token_ids, gen_index, dtype)


# ---------------------------------------------------------------------------
# checks


def resolve_attn(attn: str) -> str:
    """``"auto"`` is the exact tier; anything else must be ported."""
    attn = "pallas" if attn == "auto" else attn
    if attn not in ATTN_MODES:
        raise ValueError(f"attn={attn!r}: the port runs {ATTN_MODES} (and 'auto')")
    return attn


def check_wq(attn: str, wq: bool) -> None:
    if wq and attn == "megakernel":
        raise ValueError("wq (int8 weights) does not compose with the megakernel path")


def check_capture(p) -> None:
    """Raise where a step would be captured with collectives that a CUDA
    graph cannot hold (a gloo model group): run such a decode with
    ``graph=False``."""
    if not capturable(p.layers[0].tp_group):
        raise ValueError("a CUDA-graph capture of a tensor-parallel step over gloo: gloo's "
                         "collectives cannot be captured; decode with graph=False (eager), "
                         "or one rank a card over NCCL")


def check_prompt(prompt_ids: Optional[torch.Tensor], max_new_tokens: int,
                 device: torch.device) -> tuple:
    """(the prompt as int64 on ``device``, or None; its length, 0 without
    one); raises where it leaves no token to generate."""
    p_len = 0 if prompt_ids is None else prompt_ids.shape[1]
    if p_len >= max_new_tokens:
        raise ValueError(f"prompt length {p_len} must be < max_new_tokens={max_new_tokens}")
    if prompt_ids is not None:
        prompt_ids = prompt_ids.to(device=device, dtype=torch.int64)
    return prompt_ids, p_len


# ---------------------------------------------------------------------------
# the decode state


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
    # OPT's attn="megakernel": the decoder that the prefill ran on and K5 runs, under a model
    # group the whole one gathered (shape_opt.whole_decoder), and its layers packed for K5
    decoder: Optional[torch.nn.Module] = None
    mega_layers: Optional[MegakernelLayers] = None

    @classmethod
    def start(cls, cfg, first: torch.Tensor, tokens: torch.Tensor, kv, p_len: int,
              into: Optional["DecodeState"] = None, **fields) -> "DecodeState":
        """The state after the first token (``first_tokens``), in slot
        ``p_len``; ``into``, a kept state, is set to it in place
        (``decode_graph.refill_state``) and returned instead."""
        state = cls(step=p_len + 1,
                    step_t=torch.full((), p_len + 1, dtype=torch.int64, device=tokens.device),
                    tokens=tokens, kv=kv, done=first == cfg.eos_token_id, last_token=first,
                    **fields)
        return state if into is None else decode_graph.refill_state(into, state)


def first_tokens(cfg, logits0: torch.Tensor, length: int,
                 prompt_ids: Optional[torch.Tensor] = None, **sample_kw) -> tuple:
    """The first token of each row, drawn (``ops.sampling.sample_token``
    with ``sample_kw``) from the prefill's f32 logits (B, vocab), and the
    (B, length) int64 token buffer: eos-filled, the prompt (B, P) echoed
    into slots [0, P) and the first token in slot P -> (first (B,), tokens)."""
    first = sample_token(logits0, **sample_kw)
    tokens = torch.full((logits0.shape[0], length), cfg.eos_token_id, dtype=torch.int64,
                        device=logits0.device)
    p_len = 0 if prompt_ids is None else prompt_ids.shape[1]
    if p_len:
        tokens[:, :p_len] = prompt_ids
    tokens[:, p_len] = first
    return first, tokens


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


# ---------------------------------------------------------------------------
# the driver


def decode_step(p, cfg, state: DecodeState, **step_kw) -> torch.Tensor:
    """The family's ``step_body`` run eagerly, and the host's step counter
    advanced with it; returns the step's f32 logits (B, vocab)."""
    logits = family(cfg).step_body(p, cfg, state, **step_kw)
    state.step += 1
    return logits


def decode_segment(p, cfg, state: DecodeState, *, max_new_tokens: int,
                   until: Optional[int] = None, early_exit: bool = True,
                   wq_layers: Optional[Sequence] = None, graph: bool = True,
                   sampling: bool = False, top_k: int = 50, top_p: float = 0.95,
                   temperature: float = 1.0) -> DecodeState:
    """JAX's ``decode_segment``: decode steps while the step is below
    ``max_new_tokens`` and, when given, below ``until``, and, with
    ``early_exit``, while some row is live. A step after every row has
    finished changes nothing, so the segment runs its bound's count of
    steps with no read inside it; at its end the host reads the device's
    step counter once into ``state.step`` (short of the bound: every row
    has finished), as JAX's host reads between segment dispatches.

    On the card (``graph``, any tier but the megakernel's) the steps are
    replays of one CUDA graph of the family's ``step_body``, captured at
    the request's first segment after one eager step
    (``runtime/decode_graph.py``) with the family's ``CAPTURE_COUNTERS``,
    and kept in ``state.graph``; a capture that fails raises. Elsewhere,
    and with ``graph=False`` (the eager comparison), the same step runs
    eagerly. Sampling with a generator that the installed torch cannot
    register with a graph runs eagerly, with a warning.

    The segment is a ``segment`` span (``runtime/profiling.py``): its
    device time covers the replays or eager steps (from after a capture),
    with its first step, the steps run, the host's launch time and its
    wait at the read as attributes."""
    fam = family(cfg)
    body = fam.step_body
    bound = max_new_tokens if until is None else min(int(until), max_new_tokens)
    n = bound - state.step
    step_kw = dict(wq_layers=wq_layers, sampling=sampling, top_k=top_k, top_p=top_p,
                   temperature=temperature, early_exit=early_exit)
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
                    counters=fam.CAPTURE_COUNTERS)
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
                decode_step(p, cfg, state, **step_kw)
                ran += 1
        t1 = time.perf_counter_ns()
        sp.device_end()
        state.step = int(state.step_t)
        sp.set(steps=ran, launch_ns=t1 - t0, sync_ns=time.perf_counter_ns() - t1)
    return state


def decode_loop(p, cfg, state: DecodeState, *, max_new_tokens: int, sync_every: int = 32,
                wq: bool = False, early_exit: bool = True, graph: bool = True,
                wq_layers: Optional[Sequence] = None, **sample_kw) -> DecodeState:
    """Decode until ``max_new_tokens`` or, with ``early_exit``, until
    every row is done: segments (``decode_segment``) of ``sync_every``
    steps, the host reading the step counter once after each, so the
    steps past the last live one are at most a segment's no-op replays
    and ``state.step`` ends where JAX's loop ends. With ``wq`` the layer
    matrices are quantized once, here (the family's ``quantize_layers``),
    or given already quantized as ``wq_layers``, as a runner that keeps
    its graphs gives them."""
    check_wq(state.attn, wq)
    if wq and wq_layers is None:
        wq_layers = family(cfg).quantize_layers(p.layers)
    while state.step < max_new_tokens:
        until = min(state.step + sync_every, max_new_tokens)
        state = decode_segment(p, cfg, state, max_new_tokens=max_new_tokens, until=until,
                               early_exit=early_exit, wq_layers=wq_layers, graph=graph,
                               **sample_kw)
        if state.step < until:
            break
    return state


def generate(p, cfg, cond_embeds: torch.Tensor, *, max_new_tokens: int,
             sampling: bool = False, top_k: int = 50, top_p: float = 0.95,
             temperature: float = 1.0, bucket: int = 512,
             generator: Optional[torch.Generator] = None, attn: str = "pallas",
             wq: bool = False, prompt_ids: Optional[torch.Tensor] = None,
             graph: bool = True) -> torch.Tensor:
    """Autoregressive generation with the family's decoder -> (B,
    max_new_tokens) int64, eos-filled past the stop point (``attn`` and
    ``wq`` as the family's module text says; ``graph=False``: the eager
    loop on a card). ``prompt_ids`` (B, P): continue from a token prefix
    in stream order (element 0 the bos slot), prefilled in one causal
    pass and echoed at the front of the output: mesh completion
    (``models/meshanything.py::complete``)."""
    kw = dict(sampling=sampling, top_k=top_k, top_p=top_p, temperature=temperature)
    state = family(cfg).init_decode_state(p, cfg, cond_embeds, max_new_tokens=max_new_tokens,
                                          bucket=bucket, generator=generator, attn=attn,
                                          prompt_ids=prompt_ids, **kw)
    return decode_loop(p, cfg, state, max_new_tokens=max_new_tokens, wq=wq, graph=graph,
                       **kw).tokens
