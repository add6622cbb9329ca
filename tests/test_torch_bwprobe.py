"""The measurement path of the PyTorch port around the kernels: the
bandwidth probe's byte model and floors and the memory budget against the
JAX package's values, the phase timer, and the pipeline's ``timer=``."""
import json

import numpy as np
import pytest
import torch

import jax

from meshanything_tpu.config import MeshAnythingConfig as JaxConfig
from meshanything_tpu.config import small_test_config as jax_small_config
from meshanything_tpu.models import meshanything as jma
from meshanything_tpu.runtime import bwprobe as jax_bwprobe
from meshanything_tpu.runtime import phases as jax_phases
from meshanything_tpu.runtime.profiling import PhaseTimer as JaxPhaseTimer
from meshanything_tpu_torch.config import MeshAnythingConfig, small_test_config
from meshanything_tpu_torch.ops.decode_attention import decode_attention
from meshanything_tpu_torch.ops.probes import stream
from meshanything_tpu_torch.runtime import bwprobe, phases, profiling
from meshanything_tpu_torch.runtime.checkpoint import params_from_jax_numpy
from meshanything_tpu_torch.runtime.pipeline import InferencePipeline, Sample

CONFIGS = {"full": (MeshAnythingConfig, JaxConfig), "small": (small_test_config, jax_small_config)}


@pytest.mark.parametrize("config", ["full", "small"])
@pytest.mark.parametrize("int8", [False, True])
def test_decode_bytes_equal_jax(config, int8):
    cfg, jcfg = (make() for make in CONFIGS[config])
    assert bwprobe.decode_bytes(cfg, int8) == jax_bwprobe.decode_bytes(jcfg, int8)


@pytest.mark.parametrize("config", ["full", "small"])
@pytest.mark.parametrize("batch,int8,acceptance,bw", [
    (1, False, 1.0, 3000.0), (16, False, 1.0, 2951.7), (16, True, 1.0, 819.0),
    (8, True, 7.9, 3350.0)])
def test_exact_floor_seconds_equal_jax(config, batch, int8, acceptance, bw):
    cfg, jcfg = (make() for make in CONFIGS[config])
    assert (bwprobe.exact_floor_seconds(cfg, bw, batch, int8, acceptance)
            == jax_bwprobe.exact_floor_seconds(jcfg, bw, batch, int8, acceptance))


@pytest.mark.parametrize("config", ["full", "small"])
@pytest.mark.parametrize("tier", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("batch,bucket,extra_tokens", [(1, 512, 0), (16, 512, 16), (3, 128, 8)])
def test_estimate_kv_bytes_equal_jax(config, tier, batch, bucket, extra_tokens):
    cfg, jcfg = (make() for make in CONFIGS[config])
    kw = {"int8": tier == "int8", "int4": tier == "int4", "extra_tokens": extra_tokens}
    got = phases.estimate_kv_bytes(cfg, batch, bucket, **kw)
    assert isinstance(got, int)
    assert got == jax_phases.estimate_kv_bytes(jcfg, batch, bucket, **kw)


@pytest.fixture(scope="module")
def bridged():
    jcfg, cfg = jax_small_config(), small_test_config()
    params = jma.init_meshanything_params(jax.random.PRNGKey(7), jcfg)
    model = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, params), cfg)
    return cfg, params, model


def test_param_tree_bytes_equal_jax_on_a_bridged_tree(bridged):
    _, params, model = bridged
    assert phases.param_tree_bytes(model) == jax_phases.param_tree_bytes(params)
    assert phases.param_tree_bytes(model.bfloat16()) * 2 == jax_phases.param_tree_bytes(params)
    model.float()


@pytest.mark.parametrize("attn", ["auto", "pallas", "pallas_int8", "pallas_int4", "megakernel"])
def test_check_memory_budget_raises_over_the_limit_and_passes_under(attn, bridged):
    cfg, _, model = bridged
    weights = phases.param_tree_bytes(model)

    def check(batch, limit):
        return phases.check_memory_budget(cfg, batch, 64, attn, limit, weights)

    est = check(2, 10 ** 12)
    assert est > weights
    assert check(2, est) == est
    with pytest.raises(ValueError, match="--batchsize_per_gpu"):
        check(2, est - 1)
    assert check(4, 10 ** 12) >= est       # a larger batch never costs less


def test_check_memory_budget_counts_what_each_tier_adds():
    """At the full width, with the weights given: the quantized caches
    shrink the estimate (less their prefill's quantization transients),
    the megakernel adds its packed layers, ``wq`` the int8 matrices, and
    an f32 model doubles the cache's and the prefill's elements."""
    cfg = MeshAnythingConfig(dtype="bfloat16")
    o = cfg.opt

    def est(attn, cfg=cfg, **kw):
        return phases.check_memory_budget(cfg, 16, 512, attn, limit_bytes=10 ** 12,
                                          param_bytes=10 ** 9, **kw)

    kv = phases.estimate_kv_bytes(cfg, 16)
    rows = 2 * o.num_layers * 16 * 7680
    compact = rows // 7680 * cfg.cond_length * o.hidden_size      # the prefill's K/V elements
    assert est("pallas") == 10 ** 9 + kv + 2 * compact + int(0.5e9)
    assert est("pallas_int8") == est("pallas") - kv // 2 + 4 * rows + (18 - 2) * compact
    assert est("pallas_int4") == est("pallas") - 3 * kv // 4 + 4 * rows + (28 - 2) * compact
    matrices = o.num_layers * 12 * o.hidden_size ** 2
    assert est("megakernel") - est("pallas") == 2 * matrices + 4 * o.num_layers * 13 * o.hidden_size
    assert est("pallas", wq=True) - est("pallas") == matrices + 4 * o.num_layers * 10 * o.hidden_size
    f32 = MeshAnythingConfig(dtype="float32")
    assert est("pallas", cfg=f32) - est("pallas") == kv + 2 * compact
    # in a short run the encode and detok transients are the peak, not the cache
    short = MeshAnythingConfig(dtype="bfloat16", n_max_triangles=4)
    p, n, ntok = short.perceiver, short.nrd, short.nrd.cond_length + 4
    act_row = (16 * (p.num_points * p.width + ntok * n.hidden_size)
               + 8 * (p.heads * p.total_latents * p.num_points + n.num_heads * ntok * ntok))
    assert est("pallas", cfg=short) == 10 ** 9 + 16 * act_row
    assert est("pallas", extra_tokens=16) == est("pallas")        # within the same bucket
    assert est("pallas", extra_tokens=300) > est("pallas")


def test_check_memory_budget_needs_its_inputs():
    cfg = small_test_config()
    with pytest.raises(ValueError, match="param_bytes"):
        phases.check_memory_budget(cfg, 1, limit_bytes=10 ** 9)
    with pytest.raises(ValueError, match="limit_bytes"):
        phases.check_memory_budget(cfg, 1, param_bytes=10 ** 6)


def test_phase_timer_summary_keys_equal_jax(tmp_path):
    mine, theirs = profiling.PhaseTimer(), JaxPhaseTimer()
    for timer in (mine, theirs):
        for _ in range(3):
            with timer.phase("decode"):
                pass
        with timer.phase("encode", block_on=None):
            pass
    got, want = mine.summary(), theirs.summary()
    assert list(got) == list(want) == ["decode", "encode"]
    for name in got:
        assert list(got[name]) == list(want[name])
        assert got[name]["count"] == want[name]["count"]
    path = tmp_path / "phases.json"
    assert json.loads(mine.dump(str(path))) == json.loads(path.read_text()) == got


def test_phase_timer_fences_and_records():
    timer = profiling.PhaseTimer()
    with timer.phase("cpu tensor", block_on=torch.zeros(2)):
        pass
    with timer.phase("cpu device", block_on=torch.device("cpu")):
        pass
    timer.record("elsewhere", 0.25)
    timer.record("elsewhere", 0.75)
    s = timer.summary()
    assert s["elsewhere"] == {"count": 2, "total_s": 1.0, "mean_s": 0.5, "p50_s": 0.75,
                              "max_s": 0.75}
    assert s["cpu tensor"]["count"] == s["cpu device"]["count"] == 1
    with pytest.raises(RuntimeError):      # an exception still closes the phase
        with timer.phase("failing"):
            raise RuntimeError("boom")
    assert timer.summary()["failing"]["count"] == 1


def test_cuda_trace_and_memory_stats_without_a_card(tmp_path):
    with profiling.cuda_trace(str(tmp_path / "trace")) as prof:
        torch.ones(16, 16) @ torch.ones(16, 16)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key or "matmul" in e.key for e in prof.key_averages())
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}
        assert profiling.card_line(torch.device("cpu")) == "cpu"


@pytest.mark.parametrize("tier", [{}, {"lookahead": 4}, {"attn": "megakernel"}])
def test_pipeline_timer_records_the_three_phases(tier, bridged, tmp_path):
    cfg, _, model = bridged
    timer = profiling.PhaseTimer()
    pipe = InferencePipeline(model, cfg, batch_size=2, bucket=16, timer=timer, **tier)
    rng = np.random.default_rng(0)
    samples = [Sample(pc_normal=rng.normal(size=(cfg.perceiver.num_points, 6)).astype(np.float16),
                      uid=f"s{i}") for i in range(3)]           # two batches
    results = pipe.run(samples, str(tmp_path))
    summary = timer.summary()
    assert list(summary) == ["encode", "decode", "detok"]
    assert all(v["count"] == 2 for v in summary.values())
    by_batch = {r["batch"]: r for r in results}
    for name in summary:
        assert summary[name]["total_s"] == pytest.approx(
            sum(r[f"{name}_s"] for r in by_batch.values()))
    # without a timer the records are the same
    assert "encode_s" in InferencePipeline(model, cfg, batch_size=2, bucket=16, **tier).run(
        samples[:1], str(tmp_path))[0]


def test_time_loop_on_the_cpu_counts_every_call():
    calls = []
    seconds = bwprobe.time_loop(lambda: calls.append(1), 5, torch.device("cpu"), graph=True)
    assert len(calls) == 6 and seconds > 0          # one warm-up call, then the timed five


@pytest.mark.parametrize("measure,kwargs", [
    ("measure_stream_bw", {"gbytes": 1e-3, "iters": 2}),
    ("measure_matmul_bw", {"rows": 16, "cols": 64, "iters": 2}),
    ("measure_kernel_bw", {"ctx": 40, "iters": 4, "layers": 2}),
    ("measure_wire_bw", {"gib": 1e-3, "chunk": 8, "depth": 2, "iters": 2}),
    ("measure_wire_bw", {"gib": 1e-3, "chunk": 8, "iters": 2, "dtype": torch.int8}),
])
def test_measure_functions_run_on_the_cpu(measure, kwargs):
    """At a tiny size, through the plain versions: a positive rate, and no
    kernel launch counted."""
    before = (decode_attention.launches, stream.launches)
    rate = getattr(bwprobe, measure)(device="cpu", **kwargs)
    assert np.isfinite(rate) and rate > 0
    assert (decode_attention.launches, stream.launches) == before


def test_bwprobe_main_on_the_cpu(capsys):
    assert bwprobe.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    records = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert records.pop(0)["tool"] == "build_canary"
    assert [r["measurement"] for r in records[:-1]] == ["stream", "matmul", "kernel", "wire"]
    assert all(r["device"] == "cpu" and r["card"] == "cpu" for r in records)
    floors = records[-1]["floors_s_per_mesh"]
    assert floors["exact_bf16_floor_b16"] < floors["exact_bf16_floor_b1"]
    assert floors["int8_kv_floor_b16"] < floors["exact_bf16_floor_b16"]
    cfg = MeshAnythingConfig()
    assert floors["exact_bf16_floor_b1"] == bwprobe.exact_floor_seconds(
        cfg, records[-1]["bw_gb_per_s"], 1)


def test_bwprobe_main_refuses_a_missing_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    with pytest.raises(SystemExit):
        bwprobe.main([])
    assert "{" not in capsys.readouterr().out


@pytest.mark.cuda
def test_pipeline_checks_the_budget_on_the_card(bridged, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the budget is held against the card's memory")
    import copy

    cfg, _, model = bridged
    pipe = InferencePipeline(copy.deepcopy(model).cuda(), cfg, batch_size=1, bucket=16)
    pc = torch.randn(1, cfg.perceiver.num_points, 6, device="cuda")
    assert pipe.generate(pc)["coords"].shape[0] == 1
    monkeypatch.setattr(phases, "check_memory_budget",
                        lambda *a, **k: (_ for _ in ()).throw(ValueError("over budget")))
    with pytest.raises(ValueError, match="over budget"):
        pipe.generate(pc)
