"""Device traces of slices of one request, and their reduction.

A traced run decodes one more request after the window and profiles a few
slices of it with ``torch.profiler``, never the whole request (7,201
steps of ~550 kernels each would swamp the profiler). The decode replays
one captured CUDA graph a step, ``replay(n)`` at a time,
and the host reads the device's counters after each such call: a slice
starts at one call and ends at the call ``span`` calls later, so it covers
whole periods of the loop, the host's read and launch between calls
included. The profiler starts one call before the slice, so that its own
start-up (buffer requests, its first graph launch) falls outside. ``SliceTracer`` wraps the program's ``StepGraph.replay`` for the
request (a span of the benchmark's own around a call into the decode-graph
layer) and reads the decode state's position counters at each slice's
edges, where the device is idle.

The reduction: busy time is the union of the intervals of every device
operation (kernels, copies, sets) over the slice, which holds on any
number of streams; a kernel group's time is the sum of its kernels'
durations; idle gaps are the stretches of a slice with nothing on the
device, each named by the innermost host event under its midpoint. A gap
under one of the profiler's own host events (``PROFILER_EVENTS``: CUPTI
fetching or flushing its record buffers, which an untraced run does not
do) is left out of the slice's length.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Sequence

import torch

SLICE_LABEL = "perfbench.slice"
PROFILER_EVENTS = ("Activity Buffer Request", "Buffer Flush")


@dataclasses.dataclass
class Slice:
    device_ops: list            # (name, start_us, end_us) on the device
    host_ops: list              # (name, start_us, end_us) on the host
    start_us: float             # the slice's edges in the trace's clock
    end_us: float
    seconds: float              # its length on the host clock
    pos0: list                  # tokens generated per row at its start
    pos1: list                  # ... at its end
    calls: int                  # replay calls it spans
    replays: int                # steps replayed in it


def _events(prof) -> tuple:
    dev, host, edges = [], [], None
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.name == SLICE_LABEL:        # the label, and its copy on the device's timeline
            if e.device_type != torch.autograd.DeviceType.CUDA:
                edges = span[1:]
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(span)
        else:
            host.append(span)
    return dev, host, edges


class SliceTracer:
    """Profiles the replay calls ``[k, k + span)`` of a request for each k
    at the fractions ``at`` of its calls (calls counted from the request's
    first; their number is ``expected`` replays over the first call's
    count). ``positions()`` returns the tokens generated per row by the
    decode state in flight; it is read at each slice's edges."""

    def __init__(self, at: Sequence[float], span: int, expected: int,
                 positions: Callable[[], tuple]):
        self.at, self.span, self.expected, self.positions = at, span, expected, positions
        self.calls = 0
        self.starts: List[int] = []
        self.slices: List[Slice] = []
        self._prof = None
        self._open = None

    def _profile(self) -> None:
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()

    def _begin(self) -> None:
        torch.cuda.synchronize()
        pos = self.positions()
        label = torch.profiler.record_function(SLICE_LABEL)
        label.__enter__()
        self._open = (label, time.perf_counter(), pos, self.calls, 0)

    def _end(self) -> None:
        label, t0, pos0, call0, replays = self._open
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        label.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        pos1 = self.positions()
        dev, host, edges = _events(self._prof)
        dev = [op for op in dev if edges[0] <= op[1] < edges[1]]
        self.slices.append(Slice(dev, host, edges[0], edges[1], seconds, pos0, pos1,
                                 self.calls - call0, replays))
        self._open = self._prof = None

    def before(self, n: int) -> None:
        """Called at each replay call, before it runs ``n`` replays."""
        if self.calls == 0:
            total = -(-self.expected // max(n, 1))
            self.starts = sorted({max(1, min(int(f * total), total - self.span - 1))
                                  for f in self.at})
        if self._open is not None and self.calls - self._open[3] >= self.span:
            self._end()
        if self._prof is None and self.calls + 1 in self.starts:
            self._profile()
        elif self._open is None and self.calls in self.starts:
            self._begin()
        if self._open is not None:
            self._open = self._open[:4] + (self._open[4] + n,)
        self.calls += 1

    def close(self) -> None:
        if self._open is not None:
            self._end()
        elif self._prof is not None:
            self._prof.__exit__(None, None, None)
            self._prof = None

    def install(self, graph_cls):
        """Wrap ``graph_cls.replay`` while the tracer is in use; returns
        the function that puts it back."""
        original = graph_cls.replay
        tracer = self

        def replay(graph, n):
            tracer.before(n)
            return original(graph, n)

        graph_cls.replay = replay

        def restore():
            graph_cls.replay = original
        return restore


def union_us(intervals: list, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_seconds(sl: Slice) -> float:
    return union_us([(s, e) for _, s, e in sl.device_ops], sl.start_us, sl.end_us) / 1e6


def window_seconds(sl: Slice) -> float:
    """The slice's length less its gaps under the profiler's own events."""
    own = sum(b - a for a, b, name in gaps(sl) if name in PROFILER_EVENTS)
    return (sl.end_us - sl.start_us - own) / 1e6


def matches(name: str, patterns: Sequence[str]) -> bool:
    return any(p in name for p in patterns)


def kernel_seconds(slices: Sequence[Slice], patterns: Sequence[str]) -> float:
    """Summed device time of the operations whose names contain any of
    ``patterns``."""
    return sum(e - s for sl in slices for name, s, e in sl.device_ops
               if matches(name, patterns)) / 1e6


def top_device_ops(slices: Sequence[Slice], n: int = 10) -> list:
    by_name: dict = {}
    for sl in slices:
        for name, s, e in sl.device_ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    return sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:n]


def gaps(sl: Slice) -> list:
    """(start_us, end_us, host event) of each stretch of the slice with
    nothing on the device, named by the innermost host event over its
    midpoint ("host, no traced call" where none is)."""
    ivs = sorted((max(s, sl.start_us), min(e, sl.end_us)) for _, s, e in sl.device_ops)
    edge, out = sl.start_us, []
    for s, e in ivs + [(sl.end_us, sl.end_us)]:
        if s > edge:
            mid = (edge + s) / 2
            under = [(he - hs, name) for name, hs, he in sl.host_ops if hs <= mid <= he]
            out.append((edge, s, min(under)[1] if under else "host, no traced call"))
        edge = max(edge, e)
    return out


def idle_gaps(slices: Sequence[Slice], n: int = 10) -> list:
    """Idle seconds by what the host was doing (``gaps``), longest first."""
    by_name: dict = {}
    for sl in slices:
        for a, b, name in gaps(sl):
            if name not in PROFILER_EVENTS:
                by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    return sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:n]
