"""The metrics that read the program's spans (``span_readers.py``): each
reads the value worked out by hand from a recorder filled with made-up
spans and device times, and None without device times, without requests
and without the recorder. On the card, one exact-b1 request at the cell's
size: its segments' device time covers the decode span, and no CUDA event
is recorded inside a capture."""
import pytest

from meshanything_tpu_torch.runtime import profiling
from perfbench import harness

MS = 1_000_000      # ns


def _span(rec, name, start_ms, end_ms, parent=None, device_ms=None, **attrs):
    sp = profiling.Span(name, span_id=next(rec._ids), start_ns=int(start_ms * MS),
                        end_ns=int(end_ms * MS), attrs=attrs, device_ms=device_ms,
                        parent_id=None if parent is None else parent.span_id)
    sp.request_id = sp.span_id if name == "request" else (parent and parent.request_id)
    rec._keep(sp)
    return sp


def _request(rec, start, encode, prefill, segments, detok, decode=(100, 900)):
    """A request at ``start`` ms: device ms of its encode, prefill and
    detok, (device ms, steps, captured) of each segment, the decode's host
    interval from its start."""
    req = _span(rec, "request", start, start + 1000, batch=1)
    _span(rec, "encode", start, start + 20, req, encode)
    _span(rec, "prefill", start + 20, start + 100, req, prefill, prompt_tokens=0)
    dec = _span(rec, "decode", start + decode[0], start + decode[1], req)
    t = start + decode[0]
    for ms, steps, captured in segments:
        extra = {"captured": 1} if captured else {}
        _span(rec, "segment", t, t + ms, dec, ms, steps=steps, **extra)
        t += ms
    _span(rec, "detok", start + 950, start + 990, req, detok)


@pytest.fixture
def filled(monkeypatch):
    """The set-up's capture segment, two window requests 1,200 ms apart and
    the traced request after them, with device times."""
    rec = profiling.Recorder(enabled=True)
    monkeypatch.setattr(profiling, "RECORDER", rec)
    _span(rec, "segment", -50, -40, device_ms=0.01, steps=1, captured=1)
    _request(rec, 0, 10, 4, [(260, 101, True), (260, 100, False), (270, 100, False)], 6)
    _request(rec, 1200, 10, 6, [(265, 100, False), (265, 100, False), (262, 100, False)], 8)
    _request(rec, 2500, 99, 99, [(1000, 100, False)], 99)
    run = harness.Run(cell={}, config={}, model={}, traffic={}, batch=1)
    run.requests = [{"decode_steps": 300}, {"decode_steps": 300}]
    return rec, run


BY_HAND = {
    "step_device_ms.lat": (790 + 792) / 600,        # the capture's warm-up step is not timed
    "step_device_ms.tput": (790 + 792) / 600,
    "prefill_ms.lat": (4 + 6) / 2,
    "prefill_ms.tput": (4 + 6) / 2,
    "loop_idle.lat": 100 * (1 - 1582 / 1600),       # two decode spans of 800 ms
    "loop_idle.tput": 100 * (1 - 1582 / 1600),
    "cycle_idle.tput": 100 * (1 - 790 / 1200),     # the segments' device time only
    "step_spread.lat": 100 * ((792 / 300) / (790 / 300) - 1),
}


@pytest.mark.parametrize("metric", sorted(BY_HAND))
def test_each_metric_reads_its_value_by_hand(metric, filled):
    _, run = filled
    assert harness.load_reader(metric)(run) == pytest.approx(BY_HAND[metric], rel=1e-12)


@pytest.mark.parametrize("metric", sorted(BY_HAND))
@pytest.mark.parametrize("case", ["no_device_times", "no_requests", "dropped", "no_recorder"])
def test_each_metric_is_none_where_there_is_nothing_to_read(metric, case, filled, monkeypatch):
    rec, run = filled
    if case == "no_device_times":       # no span was timed
        for sp in rec.spans():
            sp.device_ms = None
    elif case == "no_requests":
        run.requests = []
    elif case == "dropped":             # the window's first requests may be gone
        rec.dropped = 1
    else:                               # a program without the recorder (the parent's)
        monkeypatch.delattr(profiling, "spans")
    assert harness.load_reader(metric)(run) is None


@pytest.mark.parametrize("metric", ["cycle_idle.tput", "step_spread.lat"])
def test_the_metrics_of_two_requests_need_two(metric, filled):
    _, run = filled
    run.requests = run.requests[:1]
    assert harness.load_reader(metric)(run) is None


def test_a_failed_request_is_left_out(filled):
    _, run = filled
    run.requests[1] = {"error": "Traceback ..."}
    assert harness.load_reader("prefill_ms.lat")(run) == 4


SEED = 3_100_000_019


@pytest.mark.cuda
def test_segments_cover_the_decode_on_the_card(card, monkeypatch):
    """One exact-b1 request at the cell's size: the segments' device ms are
    97-100.5% of the decode span's host time; no CUDA event recorded while
    a graph captures (the set-up's precompile captures); a span's kernels
    lie inside it on the profiler's clock."""
    import torch

    seen = {"capturing": False, "records": 0, "in_capture": 0}
    graph_cls, event_cls = torch.cuda.CUDAGraph, torch.cuda.Event
    begin, end, record = graph_cls.capture_begin, graph_cls.capture_end, event_cls.record

    def capture_begin(self, *a, **k):
        seen["capturing"] = True
        return begin(self, *a, **k)

    def capture_end(self, *a, **k):
        try:
            return end(self, *a, **k)
        finally:
            seen["capturing"] = False

    def event_record(self, *a, **k):
        seen["records"] += 1
        seen["in_capture"] += seen["capturing"]
        return record(self, *a, **k)

    monkeypatch.setattr(graph_cls, "capture_begin", capture_begin)
    monkeypatch.setattr(graph_cls, "capture_end", capture_end)
    monkeypatch.setattr(event_cls, "record", event_record)
    rec = profiling.Recorder(enabled=True)
    monkeypatch.setattr(profiling, "RECORDER", rec)
    s = harness.Session("exact-b1", SEED)
    try:
        captures = [sp for sp in rec.spans() if sp.name == "capture"]
        s.request(0)
    finally:
        s.close()
    spans = rec.spans()
    (req,) = [sp for sp in spans if sp.name == "request"]
    (decode,) = [sp for sp in spans if sp.name == "decode" and sp.parent_id == req.span_id]
    segments = [sp for sp in spans if sp.parent_id == decode.span_id]
    covered = sum(sp.device_ms for sp in segments) / ((decode.end_ns - decode.start_ns) / 1e6)
    print({"segments": len(segments), "covered": covered, "captures": len(captures),
           "records": seen["records"], "card": profiling.card_line(card)})
    assert captures and seen["in_capture"] == 0 and seen["records"] >= 2 * len(segments)
    assert 0.97 <= covered <= 1.005
    assert sum(sp.attrs["steps"] for sp in segments) == req.attrs["decode_steps"]

    a = torch.randn(2048, 2048, device=card)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with rec.span("encode", device=card, fence=card) as sp:
            for _ in range(4):
                a = a @ a / 2048
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    lo, hi = (profiling.profiler_us(ns, prof) for ns in (sp.span.start_ns, sp.span.end_ns))
    assert kernels and all(lo - 50 <= e.time_range.start <= e.time_range.end <= hi + 50
                           for e in kernels), (lo, hi, [e.time_range for e in kernels][:4])
