"""The Moonlight family (``decoders/moonlight.py``) on the CPU: a dry run of
``moon-b1`` at a moderate size reaches ``correct`` through the program's
latent cache and expert path at the cell's own limits, a copy of the
family whose router takes a softmax in place of the published sigmoid is
not correct, nor is the program with a fault planted in its expert path, the
configuration file states the published model as the cell runs it, and
the family's counts are the step's bytes."""
import dataclasses
import io
import json
from pathlib import Path

import pytest
import torch

from meshanything_tpu_torch.config import MoonlightConfig, small_moonlight_config
from meshanything_tpu_torch.models import moonlight
from perfbench import devtrace, harness
from perfbench.reference import model as ref

BENCH = harness.load_benchmark()
CELL = "moon-b1"
CONFIG = harness.find_cell(BENCH, CELL)[2]
CATALOG = Path(__file__).parent / "moonlight_catalog.json"
SEED = 2 ** 31 + 91


def moderate_moonlight() -> dict:
    """The cell's model at a size the CPU runs in seconds: hidden 1024 (so
    that logits spread as at the published width: lm_head's N(0, 0.02)
    over 1024 normalised values gives a logit std of 0.64), 4 heads, a
    latent of 64, one dense layer and two layers of 64 experts, top 6 (so
    that the routing's scores crowd as at the published size), 2 shared,
    8 faces."""
    model = dataclasses.asdict(small_moonlight_config(8))
    model["moonlight"] = {**model.pop("opt"), "hidden_size": 1024, "num_heads": 4,
                          "kv_lora_rank": 64, "qk_nope_head_dim": 32, "qk_rope_head_dim": 16,
                          "v_head_dim": 32, "intermediate_size": 256,
                          "moe_intermediate_size": 64, "n_routed_experts": 64,
                          "num_experts_per_tok": 6}
    return model


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(model=None, log=None) -> dict:
    kw = {} if log is None else {"log": log}
    return harness.run_cell(CELL, SEED, 0.3, False, device="cpu",
                            model=model or moderate_moonlight(), **kw)


def test_a_dry_run_of_the_cell_is_correct(one_thread):
    """Set-up, a window of requests through ``PhaseRunner.run`` with the
    Moonlight decoder, and the comparison of its sample (logits over the
    program's replayed routing, detok, the latent cache in two groups, the
    OBJ) with the plain reference, at the cell's own limits; traced, the
    per-layer metrics the CPU can read, the expert counter's skew among
    them (64 experts, top 6: at most 64 / 6)."""
    for trace in (False, True):
        result = harness.run_cell(CELL, SEED, 0.3, trace, device="cpu",
                                  model=moderate_moonlight())
        assert result["correct"] is True, result["check"]
        assert result["check"]["cache_err"]["value"] == 0.0
        assert result["check"]["decode_gap"]["value"] < 1e-4
    assert 1.0 <= result["metrics"]["expert_skew.lat"]["value"] <= 64 / 6
    assert "forward_ms.lat" in result["metrics"]


def test_softmax_routing_in_the_reference_is_not_correct(tmp_path, monkeypatch, one_thread):
    """The same family with the router's sigmoid scores replaced by a
    softmax over the experts: the program's choices are not the wrong
    reference's own, and the comparison says so (at the cell's limits)."""
    src = (harness.DECODERS / "moonlight.py").read_text()
    old = 'scores = torch.sigmoid(x @ W[f"{name}.gate.weight"].T)'
    assert src.count(old) == 1
    src = src.replace(old, 'scores = torch.softmax(x @ W[f"{name}.gate.weight"].T, dim=-1)')
    (tmp_path / "moonlight.py").write_text(src)
    monkeypatch.setattr(harness, "DECODERS", tmp_path)
    log = io.StringIO()
    result = _run(log=log)
    assert result["correct"] is False
    assert result["check"]["decode_gap"]["value"] is None
    assert "chosen experts lie" in log.getvalue()


def _drop_last_slot(monkeypatch):
    """The expert kernel's call with its last chosen slot weighted 0."""
    kernel = moonlight.routed_experts

    def dropped(x, ids, weights, *a, **kw):
        weights = weights.clone()
        weights[:, -1] = 0.0
        return kernel(x, ids, weights, *a, **kw)
    monkeypatch.setattr(moonlight, "routed_experts", dropped)


def _no_shared_experts(monkeypatch):
    """The expert kernel's call without the shared experts' slots."""
    kernel = moonlight.routed_experts

    def alone(x, ids, weights, *a, **kw):
        return kernel(x, ids, weights, *a, **{**kw, "shared": None})
    monkeypatch.setattr(moonlight, "routed_experts", alone)


def _no_bias(monkeypatch):
    """A router that chooses by the scores alone, without the correction
    bias."""
    def route(gate, cfg, h):
        scores = torch.nn.functional.linear(h.float(), gate.weight.float()).sigmoid()
        ids = scores.topk(cfg.num_experts_per_tok, dim=-1).indices
        weights = scores.gather(-1, ids)
        return ids, weights / weights.sum(-1, keepdim=True) * cfg.routed_scaling_factor
    monkeypatch.setattr(moonlight, "route", route)


FAULTS = {"last slot dropped": _drop_last_slot, "no shared experts": _no_shared_experts,
          "router without bias": _no_bias}


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_in_the_expert_path_is_not_correct(fault, monkeypatch, one_thread):
    """The program broken underneath in its MoE layers, at the cell's own
    limits: the comparison fails by the routing it replays (a later
    layer's choices, or the router's own, are no longer the reference's)
    or by the logit gap."""
    FAULTS[fault](monkeypatch)
    result = _run()
    assert result["correct"] is False
    gap = result["check"]["decode_gap"]
    assert gap["value"] is None or gap["value"] > gap["limit"], result["check"]


def test_the_configuration_is_the_published_model_as_run():
    """Every number of the published ``config.json`` (the catalog's copy)
    is at the file's top level unchanged but those ``reduced`` names, and
    the sizes the program runs (``model["moonlight"]``) are those numbers
    wherever the port names them alike: no width, head, expert or layer
    cut."""
    published = json.loads(CATALOG.read_text())["config"]
    entry = next(c for c in BENCH["configs"] if c["name"] == CONFIG["name"])
    assert entry["reduced"] == CONFIG["reduced"] == ["vocab_size"]
    for key, value in published.items():
        if key not in entry["reduced"]:
            assert CONFIG[key] == value, key
    run = CONFIG["model"]["moonlight"]
    renamed = {"num_hidden_layers": "num_layers", "num_attention_heads": "num_heads"}
    fields = {f.name for f in dataclasses.fields(MoonlightConfig)}
    for key, value in CONFIG.items():
        name = renamed.get(key, key)
        if name in fields and key in published:
            assert run[name] == value, key
    assert MoonlightConfig(**run) == MoonlightConfig()     # the port's defaults are the cell's


def test_the_parameters_are_the_specification_at_the_published_size():
    """The program built on the meta device holds exactly the family's
    specification, about 15.3 billion parameters (30.6 GB in bf16)."""
    family = harness.load_decoder(CONFIG["decoder"])
    spec = ref.param_spec(CONFIG["model"], family)
    _, net = family.program(CONFIG["model"], "meta")
    assert {n: tuple(t.shape) for n, t in net.state_dict().items()} == \
        {n: tuple(shape) for n, shape, _, _ in spec}
    decoder = sum(p.numel() for n, p in net.named_parameters() if n.startswith("opt."))
    assert 15.2e9 < decoder < 15.4e9, decoder


def test_the_counts_are_the_steps_bytes():
    """At B=1 a step reads about 4.65 GB: the 6 chosen and 2 shared experts'
    matrices of 26 layers (3.6 GB), the attention's and dense layer's
    matrices, the latent cache; the experts' part raises at B > 1."""
    family = harness.load_decoder(CONFIG["decoder"])
    model = CONFIG["model"]
    o = model["moonlight"]
    sl = devtrace.Slice([], [], 0.0, 1.0, 1e-6, [3860], [3861], 2, 0)
    parts = family.slice_work(model, 1, sl)
    assert set(parts) == set(CONFIG["kernels"])
    expert = 3 * o["moe_intermediate_size"] * o["hidden_size"] * 2
    assert parts["experts"].bytes == pytest.approx(26 * 8 * expert + 26 * 2048 * 6, rel=1e-12)
    step = sum(w.bytes for w in parts.values())
    assert 4.55e9 < step < 4.75e9, step
    with pytest.raises(ValueError, match="B=1"):
        family.slice_work(model, 2, sl)
    work = family.decode_work(model, 1, 7201)
    assert 7201 * 4.5e9 < work.bytes < 7201 * 4.8e9
