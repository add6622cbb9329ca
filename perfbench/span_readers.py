"""The program's own spans (``meshanything_tpu_torch/runtime/profiling.py``)
as the per-layer metrics read them.

The window's requests are the first ``len(run.requests)`` ``request`` spans
the program's recorder holds (set-up runs no request; the traced request
follows the window's), each with its ``encode``, ``prefill``, ``decode``
(whose children are the ``segment`` spans) and ``detok``. A request that
failed is left out. Each reader returns None where the program keeps no
spans (a version without the recorder, or recording turned off), where
the recorder dropped spans (the window's first requests may be gone),
where the window has no request, and where a span it needs has no device
time.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class Request:
    span: object            # the ``request`` span
    phases: dict            # name -> span: encode, prefill, decode, detok
    segments: list          # the decode's ``segment`` spans, in order


def window(run) -> Optional[List[Request]]:
    """The window's requests with their spans, or None (see the module's
    text)."""
    try:
        from meshanything_tpu_torch.runtime import profiling

        kept = profiling.spans()
        dropped = profiling.RECORDER.dropped
    except (ImportError, AttributeError):
        return None
    if dropped:
        return None
    children: dict = {}
    for sp in kept:
        children.setdefault(sp.parent_id, []).append(sp)
    roots = [sp for sp in kept if sp.name == "request"][:len(run.requests)]
    out = []
    for root, rec in zip(roots, run.requests):
        if "error" in rec:
            continue
        phases = {sp.name: sp for sp in children.get(root.span_id, [])}
        decode = phases.get("decode")
        segments = [] if decode is None else children.get(decode.span_id, [])
        out.append(Request(root, phases, sorted(segments, key=lambda sp: sp.start_ns)))
    return out or None


def device_ms(spans) -> Optional[float]:
    """Summed device ms of ``spans``; None if one has none, or there are
    none."""
    spans = list(spans)
    if not spans or any(sp is None or sp.device_ms is None for sp in spans):
        return None
    return sum(sp.device_ms for sp in spans)


def timed_steps(segment) -> int:
    """The steps a segment's device time covers: a capture's warm-up step
    runs before its start event."""
    return segment.attrs["steps"] - segment.attrs.get("captured", 0)


def _step_ms(segments) -> Optional[float]:
    ms, steps = device_ms(segments), sum(timed_steps(sp) for sp in segments)
    return ms / steps if ms is not None and steps else None


def step_device_ms(run) -> Optional[float]:
    """Device ms of the window's segments over the steps they timed."""
    reqs = window(run)
    return None if reqs is None else _step_ms([sp for r in reqs for sp in r.segments])


def prefill_ms(run) -> Optional[float]:
    """Ms of a request's ``prefill`` span on the stream (event to event),
    over the window: its latency, which the host's launching sets."""
    reqs = window(run)
    ms = None if reqs is None else device_ms(r.phases.get("prefill") for r in reqs)
    return None if ms is None else ms / len(reqs)


def loop_idle(run) -> Optional[float]:
    """Percent of the ``decode`` spans' host time not covered by their
    segments' device time."""
    reqs = window(run)
    if reqs is None or any("decode" not in r.phases for r in reqs):
        return None
    ms = device_ms(sp for r in reqs for sp in r.segments)
    host_ms = sum(r.phases["decode"].end_ns - r.phases["decode"].start_ns for r in reqs) / 1e6
    return None if ms is None or not host_ms else 100.0 * (1.0 - ms / host_ms)


def cycle_idle(run) -> Optional[float]:
    """Percent of the cycles (one window request's start to the next one's)
    outside the device time of the first one's ``segment`` spans; None
    under two requests. The encode, prefill and detok count whole: their
    event times are the host's launching, not the device's work."""
    reqs = window(run)
    if reqs is None or len(reqs) < 2:
        return None
    ms = device_ms(sp for r in reqs[:-1] for sp in r.segments)
    length_ms = (reqs[-1].span.start_ns - reqs[0].span.start_ns) / 1e6
    return None if ms is None else 100.0 * (1.0 - ms / length_ms)


def step_spread(run) -> Optional[float]:
    """The slowest window request's device ms a step over the fastest
    one's, less one, in percent; None under two requests."""
    reqs = window(run)
    if reqs is None or len(reqs) < 2:
        return None
    per = [_step_ms(r.segments) for r in reqs]
    if any(ms is None for ms in per):
        return None
    return 100.0 * (max(per) / min(per) - 1.0)
