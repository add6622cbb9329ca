"""The harness on the CPU: it finds every configuration, traffic mix and
metric by name, a dry run of each cell at a small size prints a last line
of the result's shape with nothing of JAX loaded, and the command refuses
to run without a card or outside a checkout."""
import dataclasses
import json
import re
import shutil
import subprocess
import sys

import pytest

from meshanything_tpu_torch.config import MeshAnythingConfig, small_test_config
from meshanything_tpu_torch.models.meshanything import MeshAnything
from perfbench import harness, traffic
from perfbench.reference import model as ref

BENCH = harness.load_benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_file_keeps_to_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]] + CELLS
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in BENCH["workloads"]:
        assert c["chips"] == 1 and len(c["why"]) <= 200
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/") and c["reduced"] == []


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files_by_name(cell):
    found, entry, config, mix = harness.find_cell(BENCH, cell)
    assert config["name"] == entry["name"] == found["config"]
    traffic.check_traffic(mix)
    # the configuration as run is the published model, width for width
    assert config["model"] == dataclasses.asdict(MeshAnythingConfig())
    family = harness.load_decoder(config["decoder"])
    spec = ref.param_spec(config["model"], family)
    _, net = family.program(config["model"], "meta")
    assert {n: tuple(t.shape) for n, t in net.state_dict().items()} == \
        {n: tuple(shape) for n, shape, _, _ in spec}
    e2e = harness.metrics_for(BENCH, found, False)
    layer = harness.metrics_for(BENCH, found, True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    for m in e2e + layer:
        assert callable(harness.load_reader(m["name"]))


DRY = """
import dataclasses, json, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, {root!r})
from meshanything_tpu_torch.config import small_test_config
from perfbench import harness
model = dataclasses.asdict(small_test_config(8))
for trace in (1, 0):
    result = harness.run_cell({cell!r}, 2 ** 31 + 11, 4.0, bool(trace), device="cpu", model=model)
    print(json.dumps({{"trace": trace, "result": result,
                       "forbidden": harness.forbidden_modules()}}))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_dry_run_prints_a_result_line(cell):
    """A dry run on the CPU at ``small_test_config``, on one thread in a 4 s
    window, so that the metrics read across requests have two requests or
    more: the result's keys, the cell's metrics (less those read from a
    device trace, which needs the card), the comparison last, and no
    module of JAX or the JAX package loaded. (A B=16 request takes about
    0.2 s with a thread a core on an idle CPU, and 0.7-0.9 s on one thread
    beside four more such runs; with a thread a core beside four more runs
    it took some 250 times as long, as the runs' threads wait on each
    other, and the window held one request.)"""
    out = subprocess.run([sys.executable, "-c", DRY.format(root=str(harness.ROOT), cell=cell)],
                         capture_output=True, text=True, timeout=600, cwd=str(harness.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(line) for line in out.stdout.strip().splitlines()]
    found = harness.find_cell(BENCH, cell)[0]
    for line in lines:
        result = line["result"]
        assert line["forbidden"] == []
        assert list(result)[:4] == ["correct", "attempted", "failed", "metrics"]
        assert list(result)[-1] == "check"
        assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
        assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        want = {m["name"] for m in harness.metrics_for(BENCH, found, bool(line["trace"]))
                if m["source"] != "device_trace" and m["name"] != "peak_mem_gb.tput"}
        assert set(result["metrics"]) == want
        for v in result["metrics"].values():
            assert set(v) == {"value", "unit"} and v["value"] > 0


def test_the_command_needs_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the command would run the cell")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=str(harness.ROOT))
    assert out.returncode != 0 and out.stdout == ""


def test_the_benchmark_alone_runs_nothing(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files: the
    program is not there, so a run fails and prints no result."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.PACKAGE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = (f"import sys; sys.path.insert(0, {str(tmp_path)!r}); from perfbench import harness; "
            f"harness.run_cell({CELLS[0]!r}, 1, 0.5, False, device='cpu')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path))
    assert out.returncode != 0 and out.stdout == ""
    assert "meshanything_tpu_torch" in out.stderr


def test_the_traffic_is_the_same_work_for_every_seed():
    mix = harness.find_cell(BENCH, CELLS[0])[3]
    for seed in (0, 2 ** 31 + 5, 2 ** 40):
        a = traffic.batch(mix, seed, 3, 4096)
        assert a.shape == (1, 4096, 6) and a.dtype.name == "float32"
        assert abs(abs(a[..., :3]).max() - 0.9995) < 1e-3
        assert (abs(a[..., 3:].astype("float64") ** 2).sum(-1) > 0.98).all()
        assert (a == traffic.batch(mix, seed, 3, 4096)).all()
    assert not (traffic.batch(mix, 1, 0, 4096) == traffic.batch(mix, 2, 0, 4096)).all()


def test_the_sample_takes_the_longest_and_both_halves():
    mix = dict(harness.find_cell(BENCH, "exact-b16")[3])
    pairs = traffic.check_sample(mix, 7, [10, 30, 20])
    assert pairs[0][0] == 1 and len(pairs) == mix["check"]["requests"] * mix["check"]["rows"]
    for req in {p[0] for p in pairs}:
        rows = [r for q, r in pairs if q == req]
        assert min(rows) < 8 <= max(rows)


def test_small_config_parameters_follow_the_specification():
    cfg = small_test_config(8)
    net = MeshAnything(cfg, device="meta")
    spec = ref.param_spec(dataclasses.asdict(cfg), harness.load_decoder("opt"))
    assert {n: tuple(t.shape) for n, t in net.state_dict().items()} == \
        {n: tuple(shape) for n, shape, _, _ in spec}
