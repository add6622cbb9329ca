"""Tracing and profiling: spans of the request path, per-phase timers, a
``torch.profiler`` trace and the device's memory counters (the port of
``meshanything_tpu/runtime/profiling.py``, with the span recorder added).

**Spans.** ``span(name, ...)`` is a context manager that records one span
of the request path: its name, an id, its parent's id (the span open
around it on the same thread), the id of the ``request`` span it lies in,
its start and end on the host clock (``time.perf_counter_ns``), a few
integer attributes, and, for a span that covers device work
(``device=``), its device time: on a card the milliseconds between a CUDA
event recorded on the current stream at its start and one at its end (its
time on the stream, which is the device's work only where the host keeps
ahead of the device); on the CPU, where the work runs in the calling
thread, the host clock between the same two marks. The events are read
lazily, when ``spans()`` is called: nothing on the hot path waits for the
device to read one. A thread looks its stream up once while its outermost
span is open, and a span's end makes the next span's start event. No CUDA
event is recorded while a graph capture is underway
(``RECORDER.capturing()``). Spans open no
``torch.profiler.record_function`` range: the profiler would copy such a
range onto the device's timeline, where it reads as a device operation.

The spans the port records, from the entry down (``runtime/phases.py``,
``models/decoding.py``, ``models/lookahead.py``, ``runtime/decode_graph.py``):

- ``request``: one ``PhaseRunner.run`` (attributes ``batch``,
  ``decode_steps``, ``graph_captures``, ``graph_replays``);
- ``encode`` (device, fenced), ``prefill`` (device: the prefill, the
  first token and the refill of a kept state; ``prompt_tokens``),
  ``decode`` (fenced: the loop), ``detok`` (device, fenced);
- ``segment``: the steps between two reads of the decode's counters
  (``decode_segment``; a stretch of ``lookahead_segment`` between two
  reads). Device time covers its replays or eager steps, from after a
  capture; ``pos`` is its first step (window loop: its first forward),
  ``steps`` the steps (forwards) it ran, ``captured`` 1 where its first
  step was a capture's warm-up (outside the device time), ``launch_ns``
  the host's time launching, ``sync_ns`` its wait at the read;
- ``capture``: one ``StepGraph`` capture, warm-up step included
  (``pool_bytes``).

The spans are kept in a ring of ``RING_SPANS`` at module level
(``RECORDER``), so they outlive the runner that recorded them; the oldest
go first, counted in ``RECORDER.dropped``. ``MESHANYTHING_TRACE=0`` turns
recording off: a span then keeps its host clock (the runner's returned
seconds read it) and records nothing, no CUDA event either.

**The profiler's clock.** ``RECORDER.anchor_ns`` put on a span's
``perf_counter_ns`` times gives the clock that ``torch.profiler`` stamps
its events with (Kineto's: nanoseconds since the epoch);
``profiler_us(ns, prof)`` places such a time among a profile's
``FunctionEvent.time_range`` values, so that any span, one recorded
outside a profiled stretch included, can be laid over a device trace.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import os
import subprocess
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Union

import torch

Fence = Union[torch.Tensor, torch.device, "torch.cuda.Event", None]

TRACE_ENV = "MESHANYTHING_TRACE"
RING_SPANS = 65536


def fence(on: Fence) -> None:
    """Wait for the device work ``on`` stands for: a CUDA event's own
    work, or everything queued on a CUDA tensor's or a CUDA device's
    card. CPU tensors and devices need no fence."""
    if on is None:
        return
    if isinstance(on, torch.cuda.Event):
        on.synchronize()
        return
    device = on.device if isinstance(on, torch.Tensor) else on
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def clock_anchor(samples: int = 7) -> int:
    """Nanoseconds that put a ``perf_counter_ns`` reading on the epoch
    clock of ``time.time_ns`` (the profiler's): the reading taken between
    the two host clocks' closest pair of ``samples``."""
    best = None
    for _ in range(samples):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


@dataclasses.dataclass
class Span:
    """One recorded span (see the module's text). ``device_ms`` is None
    where no device time was taken; ``spans()`` reads it from the span's
    CUDA events."""
    name: str
    span_id: int = 0
    parent_id: Optional[int] = None
    request_id: Optional[int] = None
    start_ns: int = 0
    end_ns: int = 0
    attrs: dict = dataclasses.field(default_factory=dict)
    device_ms: Optional[float] = None
    events: Optional[list] = dataclasses.field(default=None, repr=False)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def resolve(self) -> None:
        """Read the device time from the span's events (waits for the end
        event's work if it is still queued) and drop them."""
        if self.events is not None and len(self.events) == 2:
            start, end = self.events
            end.synchronize()
            self.device_ms = start.elapsed_time(end)
        self.events = None


class _Open:
    """A span in progress: the ``with`` target of ``Recorder.span``.
    ``set`` adds attributes; ``device_begin`` / ``device_end`` mark the
    device time where it is not the span's own edges."""

    __slots__ = ("span", "recorder", "device", "fence_on", "stream", "cpu_ns")

    def __init__(self, span: Span, recorder, device, fence_on):
        self.span, self.recorder, self.device, self.fence_on = span, recorder, device, fence_on
        self.stream = self.cpu_ns = None

    @property
    def seconds(self) -> float:
        return self.span.seconds

    def set(self, **attrs) -> None:
        self.span.attrs.update(attrs)

    def device_begin(self, device: Optional[torch.device] = None) -> None:
        """Mark the start of the span's device time now, on ``device`` (the
        span's own by default): a CUDA event on its current stream, on the
        CPU the host clock. Nothing with recording off or during a
        capture."""
        device = device or self.device
        rec = self.recorder
        if rec is None or device is None or rec.capturing_now():
            return
        if device.type != "cuda":
            self.cpu_ns = time.perf_counter_ns()
            return
        self.stream, event = rec._start_event(device)
        event.record(self.stream)
        self.span.events = [event]

    def device_end(self) -> None:
        """Mark the end of the span's device time, if its start was marked:
        an event on the start event's stream (then the next span's start
        event is made, while the device still works), or the host clock."""
        events = self.span.events
        if events is not None and len(events) == 1 and not self.recorder.capturing_now():
            event = torch.cuda.Event(enable_timing=True)
            event.record(self.stream)
            events.append(event)
            self.recorder._make_start_event(self.stream)
        elif self.cpu_ns is not None:
            self.span.device_ms = (time.perf_counter_ns() - self.cpu_ns) / 1e6
            self.cpu_ns = None

    def __enter__(self) -> "_Open":
        rec, sp = self.recorder, self.span
        if rec is not None:
            stack = rec._stack()
            if stack:
                sp.parent_id, sp.request_id = stack[-1].span_id, stack[-1].request_id
            sp.span_id = next(rec._ids)
            if sp.name == "request":
                sp.request_id = sp.span_id
            stack.append(sp)
        sp.start_ns = time.perf_counter_ns()
        if self.device is not None:
            self.device_begin()
        return self

    def __exit__(self, *exc) -> bool:
        self.device_end()
        fence(self.fence_on)
        sp = self.span
        sp.end_ns = time.perf_counter_ns()
        rec = self.recorder
        if rec is not None:
            stack = rec._stack()
            stack.pop()
            if not stack:       # the thread's outermost span: forget its stream
                rec._local.timing = None
            rec._keep(sp)
        return False


class Recorder:
    """The ring of spans (see the module's text). ``enabled`` defaults to
    ``MESHANYTHING_TRACE`` (on unless it is "0"). Safe for several
    threads: each has its own stack of open spans."""

    def __init__(self, capacity: int = RING_SPANS, enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.environ.get(TRACE_ENV, "1") != "0"
        self.enabled = enabled
        self.capacity = capacity
        self.dropped = 0
        self.anchor_ns = clock_anchor()
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._captures = 0

    def span(self, name: str, *, device: Optional[torch.device] = None,
             fence: Fence = None, **attrs) -> _Open:
        """A span named ``name``, to open with ``with``: device time where
        ``device`` is a CUDA device, ``fence`` waited for before its end is
        read, ``attrs`` its first attributes."""
        return _Open(Span(name, attrs=attrs), self if self.enabled else None, device, fence)

    def spans(self) -> List[Span]:
        """The kept spans, oldest first, their device times read."""
        with self._lock:
            out = list(self._ring)
        for sp in out:
            sp.resolve()
        return out

    @contextlib.contextmanager
    def capturing(self):
        """Marks a graph capture in progress: no span records a CUDA event
        meanwhile, on any thread."""
        with self._lock:
            self._captures += 1
        try:
            yield
        finally:
            with self._lock:
                self._captures -= 1

    def capturing_now(self) -> bool:
        return self._captures > 0

    def _start_event(self, device: torch.device):
        """The current stream of ``device`` and an event to record on it as a
        span's start. Both are kept on the thread while its outermost span
        is open: the stream is looked up once (a request's segments follow
        the host's read of the decode's counters, while the device waits),
        and the event was made by the last span's end."""
        timing = getattr(self._local, "timing", None)
        if timing is None or timing[0] != device:
            timing = self._local.timing = [device, torch.cuda.current_stream(device), None]
        event, timing[2] = timing[2], None
        if event is None:
            event = torch.cuda.Event(enable_timing=True)
        return timing[1], event

    def _make_start_event(self, stream) -> None:
        """Make the next start event on ``stream`` now (CUDA makes an event
        at its first record), if the thread keeps that stream."""
        timing = getattr(self._local, "timing", None)
        if timing is not None and timing[1] is stream and timing[2] is None:
            event = torch.cuda.Event(enable_timing=True)
            event.record(stream)
            timing[2] = event

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, sp: Span) -> None:
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(sp)


RECORDER = Recorder()


def span(name: str, **kw) -> _Open:
    """``RECORDER.span``."""
    return RECORDER.span(name, **kw)


def spans() -> List[Span]:
    """``RECORDER.spans()``: the kept spans, oldest first."""
    return RECORDER.spans()


def profiler_us(ns: int, prof) -> float:
    """A ``perf_counter_ns`` time (a span's start or end) in the time base
    of ``prof``'s events (``FunctionEvent.time_range``: microseconds since
    the trace's start), through ``RECORDER.anchor_ns``."""
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    return (ns + RECORDER.anchor_ns - start_ns) / 1e3


def write_spans(path: str) -> int:
    """Write the kept spans as JSON lines (one object a span, device time
    in ms, host times in ``perf_counter_ns`` and ``anchor_ns`` in the
    first line); returns the number written."""
    kept = spans()
    with open(path, "w") as fh:
        fh.write(json.dumps({"anchor_ns": RECORDER.anchor_ns, "dropped": RECORDER.dropped}) + "\n")
        for sp in kept:
            row = dataclasses.asdict(sp)
            row.pop("events")
            fh.write(json.dumps(row) + "\n")
    return len(kept)


class PhaseTimer:
    """Accumulates seconds per named phase (encode / decode / detok /
    postprocess): a span's host clock around a block, read after a fence
    on a CUDA tensor, device or event, or durations fed in (``record``;
    ``PhaseRunner.run(timer=)`` feeds its phases' spans)."""

    def __init__(self):
        self.records: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str, block_on: Fence = None):
        """Time the block as a span of that name (its host clock);
        ``block_on`` (a CUDA tensor, device or event) is fenced before the
        clock is read."""
        opened = span(name, fence=block_on)
        try:
            with opened:
                yield
        finally:
            self.records[name].append(opened.seconds)

    def record(self, name: str, seconds: float) -> None:
        """Add a duration measured elsewhere."""
        self.records[name].append(float(seconds))

    def summary(self) -> Dict[str, dict]:
        out = {}
        for name, xs in self.records.items():
            xs_sorted = sorted(xs)
            out[name] = {
                "count": len(xs),
                "total_s": sum(xs),
                "mean_s": sum(xs) / len(xs),
                "p50_s": xs_sorted[len(xs) // 2],
                "max_s": xs_sorted[-1],
            }
        return out

    def dump(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.summary(), indent=2)
        if path:
            with open(path, "w") as fh:
                fh.write(s)
        return s


@contextlib.contextmanager
def cuda_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (host, and the
    card where there is one) and write it to ``log_dir/trace.json`` for
    chrome://tracing or Perfetto. Yields the profiler, whose
    ``key_averages()`` sum the time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def kernel_device_us(evt) -> float:
    """A profiler event's own device time in µs (its name differs across
    torch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def device_memory_stats() -> dict:
    """Live and peak allocated bytes of every visible card ({} without
    one), from the caching allocator's counters."""
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": ms.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": ms.get("allocated_bytes.all.peak", 0),
        }
    return stats


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, to
    stand beside every measurement; "cpu" for a CPU run."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
