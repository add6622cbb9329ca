"""The span recorder of the PyTorch port (``runtime/profiling.py``) and the
spans of the request path: the tree one ``PhaseRunner.run`` records, the
runner's seconds and ``PhaseTimer`` read from it, recording off, the ring,
threads, and the anchor to ``torch.profiler``'s clock."""
import json
import math
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from meshanything_tpu_torch.config import small_test_config
from meshanything_tpu_torch.models import decoding
from meshanything_tpu_torch.models import shape_opt as opt
from meshanything_tpu_torch.runtime import decode_graph, profiling
from meshanything_tpu_torch.runtime.checkpoint import init_random_params
from meshanything_tpu_torch.runtime.phases import PhaseRunner

PROGRAM_SPANS = ("request", "encode", "prefill", "decode", "segment", "detok", "capture")


@pytest.fixture(scope="module")
def small():
    cfg = small_test_config()
    model = init_random_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    pc = torch.randn(2, cfg.perceiver.num_points, 6, generator=torch.Generator().manual_seed(1))
    return cfg, model, pc


@pytest.fixture
def recorder(monkeypatch):
    """A fresh recorder, recording, in place of the module's."""
    rec = profiling.Recorder(enabled=True)
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return rec


def _tree(spans):
    by_parent = {}
    for sp in spans:
        by_parent.setdefault(sp.parent_id, []).append(sp)
    for kids in by_parent.values():
        kids.sort(key=lambda sp: sp.start_ns)
    return by_parent


def _within(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


@pytest.mark.parametrize("tier", [{}, {"lookahead": 4}])
def test_a_run_records_one_request_tree(small, recorder, tier):
    """One ``request`` span; its children encode, prefill, decode, detok in
    turn; the decode's children the segments, one a read of the counters,
    whose steps (window forwards) sum to the run's; each child inside its
    parent; on the CPU the device time of a span that covers device work
    is the host's, inside the span."""
    cfg, model, pc = small
    runner = PhaseRunner(model, cfg, bucket=16, early_exit=False, **tier)
    out = runner.run(pc)
    spans = recorder.spans()
    tree = _tree(spans)
    (req,) = [sp for sp in spans if sp.name == "request"]
    assert req.parent_id is None and req.request_id == req.span_id
    kids = tree[req.span_id]
    assert [sp.name for sp in kids] == ["encode", "prefill", "decode", "detok"]
    decode = kids[2]
    segments = tree[decode.span_id]
    assert {sp.name for sp in segments} == {"segment"}
    steps = [sp.attrs["steps"] for sp in segments]
    if tier:
        # a read after every window forward on the CPU
        assert sum(steps) == len(segments) == out["window_forwards"]
        assert [sp.attrs["pos"] for sp in segments] == list(range(len(segments)))
    else:
        assert len(segments) == math.ceil(out["decode_steps"] / 32)
        assert sum(steps) == out["decode_steps"] == cfg.generate_length - 1
        assert [sp.attrs["pos"] for sp in segments] == [1 + 32 * i for i in range(len(segments))]
    for sp in segments:
        assert sp.attrs["launch_ns"] > 0 and sp.attrs["sync_ns"] >= 0
        assert "captured" not in sp.attrs
    assert req.attrs == {"batch": 2, "decode_steps": out["decode_steps"],
                         "graph_captures": 0, "graph_replays": 0}
    assert kids[1].attrs == {"prompt_tokens": 0}
    for sp in spans:
        assert sp.request_id == req.span_id
        if sp.name in ("request", "decode"):
            assert sp.device_ms is None
        else:
            assert 0 < sp.device_ms <= (sp.end_ns - sp.start_ns) / 1e6
        if sp.parent_id is not None:
            parent = next(p for p in spans if p.span_id == sp.parent_id)
            assert _within(sp, parent)
    assert len(spans) == 1 + 4 + len(segments) and recorder.dropped == 0


def test_the_runners_seconds_are_the_spans(small, recorder):
    """``encode_s`` / ``decode_s`` / ``detok_s`` are the spans' host times
    (the decode from the prefill's start to the loop's end), and a
    ``PhaseTimer`` fed by ``timer=`` sums the same."""
    cfg, model, pc = small
    runner = PhaseRunner(model, cfg, bucket=16)
    timer = profiling.PhaseTimer()
    outs = [runner.run(pc, timer=timer) for _ in range(2)]
    by_name = {}
    for sp in recorder.spans():
        by_name.setdefault(sp.name, []).append(sp)
    for i, out in enumerate(outs):
        assert out["encode_s"] == by_name["encode"][i].seconds
        assert out["detok_s"] == by_name["detok"][i].seconds
        assert out["decode_s"] == (by_name["decode"][i].end_ns
                                   - by_name["prefill"][i].start_ns) / 1e9
    summary = timer.summary()
    assert list(summary) == ["encode", "decode", "detok"]
    for name in summary:
        assert summary[name]["count"] == 2
        assert summary[name]["total_s"] == sum(out[f"{name}_s"] for out in outs)


def test_trace_off_records_nothing_and_changes_no_output(small, monkeypatch):
    """``MESHANYTHING_TRACE=0``: no span kept, no CUDA event made (even for a
    span given a card), the runner's seconds still read, and the tokens
    and coordinates bit-equal to a run that records."""
    cfg, model, pc = small
    monkeypatch.setenv(profiling.TRACE_ENV, "0")
    off = profiling.Recorder()
    monkeypatch.delenv(profiling.TRACE_ENV)
    on = profiling.Recorder()
    assert not off.enabled and on.enabled
    runs = {}
    for rec in (on, off):
        monkeypatch.setattr(profiling, "RECORDER", rec)
        runs[rec.enabled] = PhaseRunner(model, cfg, bucket=16, lookahead=4).run(pc)
    assert off.spans() == [] and len(on.spans()) > 5
    assert torch.equal(runs[True]["tokens"], runs[False]["tokens"])
    # padding faces' coordinates are NaN in both
    torch.testing.assert_close(runs[True]["coords"], runs[False]["coords"], rtol=0, atol=0,
                               equal_nan=True)
    assert runs[False]["encode_s"] > 0 and runs[False]["decode_s"] > 0

    def no_event(*a, **k):
        raise AssertionError("a CUDA event was made with recording off")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    with off.span("encode", device=torch.device("cuda")) as sp:
        sp.device_begin(torch.device("cuda"))
        sp.set(steps=1)
    assert off.spans() == [] and sp.seconds >= 0


class _FakeStream:
    pass


class _FakeEvent:
    """Stands in for ``torch.cuda.Event`` on the CPU: counts its records."""
    made = []

    def __init__(self, enable_timing=False):
        self.records = []
        _FakeEvent.made.append(self)

    def record(self, stream=None):
        self.records.append(stream)

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1.0


def test_a_thread_looks_its_stream_up_once_and_makes_start_events_ahead(monkeypatch):
    """On a card a request's spans look the current stream up once, each
    span's end makes (records) the next span's start event, no event is
    recorded during a capture, and the thread forgets the stream when its
    outermost span ends."""
    lookups = []

    def current_stream(device=None):
        lookups.append(device)
        return _FakeStream()

    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.made = []
    rec = profiling.Recorder(enabled=True)
    card = torch.device("cuda", 0)
    with rec.span("request"):
        with rec.span("decode"):
            for i in range(3):
                with rec.span("segment", pos=i) as sp:
                    sp.device_begin(card)
                    sp.device_end()
        with rec.capturing():
            with rec.span("segment", pos=3) as sp:
                sp.device_begin(card)
        with rec.span("detok", device=card):
            pass
    assert len(lookups) == 1
    segments = [sp for sp in rec.spans() if sp.name == "segment"]
    assert segments[-1].events is None and segments[-1].device_ms is None
    # each span's start event was made at the last one's end, so it was recorded there first
    starts = [e for e in _FakeEvent.made if len(e.records) == 2]
    assert len(starts) == 3 and len(_FakeEvent.made) == 1 + 4 + 4   # first start, ends, next starts
    assert len({id(stream) for e in _FakeEvent.made for stream in e.records}) == 1
    assert [sp.device_ms for sp in segments[:3]] == [1.0] * 3
    with rec.span("segment") as sp:
        sp.device_begin(card)
        sp.device_end()
    assert len(lookups) == 2


def test_the_ring_drops_the_oldest_and_counts_them():
    rec = profiling.Recorder(capacity=4, enabled=True)
    for i in range(10):
        with rec.span("segment", pos=i):
            pass
    kept = rec.spans()
    assert [sp.attrs["pos"] for sp in kept] == [6, 7, 8, 9] and rec.dropped == 6


def test_threads_keep_their_own_parents():
    """Many threads recording at once, each its own request tree: every
    span's parent is its own thread's, no span is lost and ids are
    unique."""
    rec = profiling.Recorder(enabled=True)
    threads, per_thread = 16, 50
    interval = sys.getswitchinterval()

    def work(k):
        for _ in range(per_thread):
            with rec.span("request", batch=k):
                with rec.span("decode"):
                    with rec.span("segment", steps=k):
                        pass

    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    spans = rec.spans()
    assert len(spans) == 3 * threads * per_thread
    assert len({sp.span_id for sp in spans}) == len(spans)
    by_id = {sp.span_id: sp for sp in spans}
    for seg in (sp for sp in spans if sp.name == "segment"):
        decode = by_id[seg.parent_id]
        req = by_id[decode.parent_id]
        assert decode.name == "decode" and req.name == "request"
        assert seg.request_id == decode.request_id == req.span_id
        assert req.attrs["batch"] == seg.attrs["steps"]


def test_phase_timer_times_a_span():
    rec = profiling.Recorder(enabled=True)
    timer = profiling.PhaseTimer()
    old, profiling.RECORDER = profiling.RECORDER, rec
    try:
        with timer.phase("postprocess"):
            sum(range(1000))
    finally:
        profiling.RECORDER = old
    (sp,) = rec.spans()
    assert sp.name == "postprocess" and timer.records["postprocess"] == [sp.seconds]


def test_the_anchor_lays_a_span_over_the_profiler_trace(small, recorder):
    """Under a CPU ``torch.profiler`` run, an ``aten::mm`` inside a span lies
    inside the span moved onto the profiler's clock (to 50 µs), and no
    event of the profile is named after a program span: a whole request
    runs under it."""
    cfg, model, pc = small
    a = torch.randn(96, 96)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recorder.span("encode") as sp:
            torch.mm(a, a)
        PhaseRunner(model, cfg, bucket=16).run(pc)
    # the first matrix product of the profile is the span's: the request runs after it
    mm = min((e for e in prof.events() if e.name == "aten::mm"), key=lambda e: e.time_range.start)
    assert profiling.profiler_us(sp.span.start_ns, prof) - 50 <= mm.time_range.start
    assert mm.time_range.end <= profiling.profiler_us(sp.span.end_ns, prof) + 50
    names = {e.name for e in prof.events()}
    assert not names & set(PROGRAM_SPANS)
    assert {sp.name for sp in recorder.spans()} >= set(PROGRAM_SPANS) - {"capture"}


class _StandInGraph:
    """Runs the step where a CUDA graph would replay it: the warm-up call,
    then one call a replay."""

    def __init__(self, fn, device, *, generator=None, key=None, counters=None):
        fn()
        self.fn, self.key, self.capture_s, self.replayed = fn, key, 0.0, 0

    def replay(self, n):
        for _ in range(n):
            self.fn()
        self.replayed += n


def test_the_replayed_segments_mark_the_capture(small, recorder, monkeypatch):
    """On the replay path the first segment's first step is the capture's
    warm-up (``captured``), and the steps still sum to the decode's."""
    cfg, model, pc = small
    monkeypatch.setattr(decode_graph, "use_graph", lambda device, graph: graph)
    monkeypatch.setattr(decode_graph, "StepGraph", _StandInGraph)
    gl = cfg.generate_length
    cond = torch.randn(1, cfg.opt.cond_length, cfg.opt.hidden_size,
                       generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        state = opt.init_decode_state(model.opt, cfg.opt, cond, max_new_tokens=gl, bucket=16)
        state = decoding.decode_loop(model.opt, cfg.opt, state, max_new_tokens=gl,
                                     sync_every=20, early_exit=False)
    segments = [sp for sp in recorder.spans() if sp.name == "segment"]
    assert [sp.attrs.get("captured", 0) for sp in segments] == [1] + [0] * (len(segments) - 1)
    assert sum(sp.attrs["steps"] for sp in segments) == state.step - 1 == gl - 1
    assert state.graph.replayed == gl - 2


def test_write_spans_writes_one_line_a_span(tmp_path, recorder):
    with recorder.span("request", batch=1):
        with recorder.span("segment", steps=3):
            pass
    path = tmp_path / "spans.jsonl"
    assert profiling.write_spans(str(path)) == 2
    head, *rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert head == {"anchor_ns": recorder.anchor_ns, "dropped": 0}
    assert [r["name"] for r in rows] == ["segment", "request"]
    assert rows[0]["attrs"] == {"steps": 3} and rows[0]["parent_id"] == rows[1]["span_id"]
    assert "events" not in rows[0] and rows[0]["device_ms"] is None
