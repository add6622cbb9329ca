"""The yardstick's arithmetic: byte and operation counts, and the trace
reduction."""
import dataclasses

import pytest

from meshanything_tpu_torch.config import MeshAnythingConfig
from perfbench import counts, devtrace, harness

MODEL = dataclasses.asdict(MeshAnythingConfig())
OPT = harness.load_decoder("opt")
O = MODEL["opt"]


def test_exact_totals():
    # 0.62 GB of bf16 weights a step, 2.73 TB of cache a mesh at 800 faces
    assert OPT.step_weight_bytes(O) == pytest.approx(0.6233e9, rel=1e-3)
    rows = counts.cache_rows_read(O["cond_length"], 1, 7201)
    assert rows * 2 * O["num_layers"] * O["hidden_size"] * 2 == pytest.approx(2.731e12, rel=1e-3)
    work = OPT.decode_work(MODEL, 1, 7201)
    assert work.bound() == "bytes"
    assert work.bytes == pytest.approx(7.2275e12, rel=1e-3)     # 4.49 TB weights + 2.73 TB cache
    assert work.least_seconds() == pytest.approx(2.157, rel=1e-3)
    b16 = OPT.decode_work(MODEL, 16, 7201)
    assert b16.least_seconds() / 16 == pytest.approx(0.901, rel=1e-3)


def _slice(pos0, pos1, ops=(), host=(), lo=0.0, hi=100.0):
    return devtrace.Slice(list(ops), list(host), lo, hi, (hi - lo) / 1e6, pos0, pos1, 2, 0)


def test_slice_work_matches_the_steps():
    c, L = O["cond_length"], O["num_layers"]
    sl = _slice([101], [165])
    got = OPT.slice_work(MODEL, 1, sl)
    want = counts.Work()
    for s in range(101, 165):
        want += OPT.attention_call(O, 1, c + s) * L
    assert got["attention"].bytes == pytest.approx(want.bytes, rel=1e-12)
    assert got["gemm"].bytes == pytest.approx(64 * OPT.step_weight_bytes(O) +
                                              64 * (OPT.gemm_work(O, 1).bytes -
                                                    OPT.step_weight_bytes(O)), rel=1e-12)


def test_busy_union_and_gaps():
    ops = [("k1", 10, 20), ("k2", 15, 30), ("k3", 50, 60)]
    host = [("cudaGraphLaunch", 30, 45), ("aten::item", 60, 95), ("outer", 0, 100)]
    sl = _slice([0], [1], ops=ops, host=host)
    assert devtrace.busy_seconds(sl) == pytest.approx(30e-6)
    gaps = dict(devtrace.idle_gaps([sl]))
    assert gaps["cudaGraphLaunch"] == pytest.approx(20e-6)   # 30-50, midpoint 40
    assert gaps["aten::item"] == pytest.approx(40e-6)        # 60-100, midpoint 80
    assert gaps["outer"] == pytest.approx(10e-6)             # 0-10
    assert devtrace.kernel_seconds([sl], ["k1", "k3"]) == pytest.approx(20e-6)
