"""Decode steps and window forwards as CUDA-graph replays: the port's
counterpart of the JAX package's device-resident ``while_loop`` segments
(``meshanything_tpu/models/shape_opt.py::decode_segment``,
``models/lookahead.py::lookahead_segment``).

A ``StepGraph`` captures one call of a function that updates a decode
state's own tensors in place (a decoder family's step, which
``models/decoding.py`` drives, or a window forward of
``models/lookahead.py``) into a
``torch.cuda.CUDAGraph``; ``replay(n)`` runs it n times, one host launch
each. What the captured functions keep to: no host read of a device value
(positions and lengths live in device tensors: K1-K3 read the live length
on the device, K4 its bases), no shape that depends on the data, and every
state field written in place, never rebound, so that the next replay
reads what the last one wrote.

The graph is captured on one side stream a device, after one eager call
of the function on that stream (the warm-up): a stream's first call makes
its fold workspace (``ops/decode_attention.py::FoldWorkspace``), cuBLAS
its workspace and each kernel library its shared-memory opt-in, and none
of that may happen inside a capture. The warm-up is a real step of the
state, so the caller counts it. A capture that fails raises: nothing
falls back to the eager loop. A graph lives as long as the state that
holds it (one a window width). ``runtime/phases.py::PhaseRunner`` keeps a
state and its graphs for each batch size and mode across requests: a new
request's prefill is written into the kept state's tensors
(``refill_state``) and the graph captured for an earlier request
replays it. ``pool_bytes`` is what a capture's private memory pool took
from the card (the budget counts it while the state is kept). Each capture
is a ``capture`` span (``runtime/profiling.py``), whose host time is
``capture_s``, with the launch counts that the caller names
(``counters``: the decode loops name the residual add and post-LN kernel's,
``add_ln``); no span records a CUDA event while a capture is underway.

Sampling draws from a ``torch.Generator`` that the graph registers
(``CUDAGraph.register_generator_state``): the request's own, or, for a
kept state, the state's generator, into which the runner copies the
request generator's seed and offset before the decode and back after
(``get_state``/``set_state`` change the registered state in place, so the
replays draw what the request's generator would). Where the installed
torch has no such call, ``generator_capturable`` is false and the callers
keep the sampled mode eager, with a warning.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Mapping, Optional

import torch

from meshanything_tpu_torch.runtime import profiling

_streams: dict = {}


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream that every graph of ``device`` is captured on (one
    a device, so that one fold workspace serves all of them)."""
    stream = _streams.get(device.index)
    if stream is None:
        stream = _streams[device.index] = torch.cuda.Stream(device)
    return stream


def use_graph(device: torch.device, graph: bool) -> bool:
    """Whether a segment on ``device`` replays a captured step: on a card,
    unless the caller asked for the eager loop."""
    return graph and device.type == "cuda"


def generator_capturable() -> bool:
    """Whether a graph can replay draws from a generator of the caller's;
    where it cannot, says so in a warning: the sampled decode runs eagerly."""
    if hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
        return True
    warnings.warn("this torch cannot register a generator with a CUDA graph "
                  "(CUDAGraph.register_generator_state): the sampled decode runs eagerly")
    return False


class StepGraph:
    """One captured call of ``fn`` (see the module's text). ``key`` names
    what the call was captured with; a caller that would replay it with
    other settings compares it and captures anew or raises.

    ``counters`` maps an attribute of the ``capture`` span to a callable
    that reads a process-wide launch count: the span gets how far each
    count rose while ``fn`` was captured.

    ``captures`` and ``replays`` count over the process, as the kernel
    wrappers count their launches: a run sets them to 0 before and reads
    them after."""

    captures = 0
    replays = 0

    def __init__(self, fn: Callable[[], object], device: torch.device, *,
                 generator: Optional[torch.Generator] = None, key=None,
                 counters: Optional[Mapping[str, Callable[[], int]]] = None):
        with profiling.span("capture") as sp:      # the warm-up step's time included
            stream = capture_stream(device)
            current = torch.cuda.current_stream(device)
            stream.wait_stream(current)
            with torch.cuda.stream(stream):      # the warm-up: a real step, the stream's first call
                fn()
            current.wait_stream(stream)
            self.graph = torch.cuda.CUDAGraph()
            if generator is not None:
                self.graph.register_generator_state(generator)
            reserved = torch.cuda.memory_reserved(device)
            counters = counters or {}
            before = {name: read() for name, read in counters.items()}
            with profiling.RECORDER.capturing(), torch.cuda.graph(self.graph, stream=stream):
                fn()
            torch.cuda.synchronize(device)
            self.pool_bytes = max(torch.cuda.memory_reserved(device) - reserved, 0)
            sp.set(pool_bytes=self.pool_bytes,
                   **{name: read() - before[name] for name, read in counters.items()})
        self.capture_s = sp.seconds
        self.key = key
        self.replayed = 0
        StepGraph.captures += 1

    def replay(self, n: int) -> None:
        """n calls of the captured function, on the current stream."""
        for _ in range(n):
            self.graph.replay()
        self.replayed += n
        StepGraph.replays += n


def refill_state(into, fresh):
    """Set every tensor of the state ``into`` to the same field of
    ``fresh`` (a state made for a new request) in place, and its host
    fields to fresh's; its cache (which the new prefill wrote) and its
    captured graphs stay. Returns ``into``."""
    for field in dataclasses.fields(fresh):
        new, old = getattr(fresh, field.name), getattr(into, field.name)
        if field.name in ("kv", "graph", "graphs"):
            continue
        if isinstance(new, torch.Tensor):
            if new.shape != old.shape or new.dtype != old.dtype:
                raise ValueError(f"refill: {field.name} is {tuple(new.shape)} {new.dtype}, the "
                                 f"kept state's {tuple(old.shape)} {old.dtype}")
            old.copy_(new)
        else:
            setattr(into, field.name, new)
    return into
