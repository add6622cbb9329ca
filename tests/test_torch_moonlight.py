"""The Moonlight decoder of the port (``models/moonlight.py``) against the
plain reference of the benchmark's family (``perfbench/decoders/moonlight.py``),
float32 on the CPU, on seeded random weights at a small Moonlight-shaped
size (``small_moonlight_config``: hidden 64, 4 heads, latent 32, nope /
rope / v 16 / 8 / 16, one dense and two MoE layers of 8 experts, top 2,
2 shared, sigmoid scores with a correction bias, normalised and scaled):

  * the prefill and then every step through the latent cache give the
    reference's full-forward logits at every position;
  * the latent op is dense softmax attention over the materialised keys
    and values, the expert op the all-experts masked sum;
  * a correction bias that changes the chosen experts still matches, and
    a reference that weights by score plus bias does not;
  * the runner's path (``PhaseRunner.run``) decodes it, the request span
    carries the expert counter, and what the decoder does not have raises.

Nothing here needs JAX."""
import dataclasses
import math

import pytest
import torch
import torch.nn.functional as F

from meshanything_tpu_torch.config import small_moonlight_config
from meshanything_tpu_torch.models import meshanything as ma
from meshanything_tpu_torch.models import moonlight as moon
from meshanything_tpu_torch.ops.experts import routed_experts, routed_experts_reference
from meshanything_tpu_torch.ops.latent_attention import (
    latent_attention,
    latent_attention_reference,
)
from meshanything_tpu_torch.parallel.mesh import Mesh, shard_params
from meshanything_tpu_torch.runtime import profiling
from meshanything_tpu_torch.runtime.phases import PhaseRunner, estimate_kv_bytes
from perfbench import harness, weights
from perfbench.reference import model as ref

CPU = torch.device("cpu")
SEED = 5
ZERO = ("opt.lm_head.weight", 1)     # eos's row of the head: no request stops early
# The port's step and the reference's full forward sum in other orders: the
# absorbed attention (the query through kv_b_proj's K half, the latent
# output through its V half) against the materialised keys and values, the
# experts' slots against one product a slot, einsum against matmul. In f32
# that moves a logit of std 0.16 by a few ulp (1.5e-7 measured); 2e-6 is
# ten times that, and a routing or weighting error moves it by 1e-3 or more.
LOGIT_ATOL = 2e-6


def _family():
    return harness.load_decoder("moonlight")


def _model(n_max_triangles: int = 4) -> dict:
    model = dataclasses.asdict(small_moonlight_config(n_max_triangles))
    model["moonlight"] = model.pop("opt")
    return model


def _built(model: dict, seed: int = SEED):
    """(cfg, the program's model, the reference's weights) from one seed."""
    fam = _family()
    cfg, net = fam.program(model, CPU)
    spec = ref.param_spec(model, fam)
    weights.fill(spec, net.state_dict().__getitem__, seed, CPU, torch.float32, ZERO)
    return cfg, net, weights.reference_params(spec, seed, CPU, torch.float32, ZERO)


@torch.no_grad()
def _decode(net, cfg, cond):
    """Prefill, then every step through the latent cache: (the state,
    tokens (T,), the logits that chose each token (T, vocab))."""
    logits = []
    state = moon.init_decode_state(net.opt, cfg.opt, cond, max_new_tokens=cfg.generate_length,
                                   into=None)
    first = moon.prefill(net.opt, cfg.opt, cond, torch.zeros_like(state.kv))
    logits.append(first[0])
    while state.step < cfg.generate_length:
        logits.append(moon.step_body(net.opt, cfg.opt, state, early_exit=False)[0])
        state.step += 1
    return state, state.tokens[0], torch.stack(logits)


def test_prefill_and_latent_decode_give_the_references_logits():
    model = _model()
    cfg, net, W = _built(model)
    cond = torch.randn(1, cfg.cond_length, cfg.opt.hidden_size,
                       generator=torch.Generator().manual_seed(3))
    state, tokens, logits = _decode(net, cfg, cond)
    assert tokens.shape[0] == cfg.generate_length == 38
    want = _family().decoder_logits(W, model, cond[0], tokens)
    assert torch.equal(tokens, want.argmax(dim=-1))
    assert (logits - want).abs().max().item() <= LOGIT_ATOL
    # the expert kernel's counter: K tokens a step in every MoE layer
    counts = state.expert_counts
    assert counts.shape == (2, 8) and counts.sum(dim=1).tolist() == [2 * 37] * 2


def test_the_latent_op_is_dense_attention_over_materialised_keys():
    """Absorbed: q_nope through kv_b's K half into the latent space, the
    latent op over [latent || rotated key] rows, the output through the V
    half. Dense: every head's keys [W_UK c || k_pe] and values W_UV c
    materialised, softmax(q k / sqrt(D)) v."""
    g = torch.Generator().manual_seed(11)
    b, h, r, nope, rd, vd, n, s = 2, 4, 32, 16, 8, 16, 37, 64
    latent = torch.randn(b, n, r, generator=g)
    k_pe = torch.randn(b, n, rd, generator=g)
    w = torch.randn(h, nope + vd, r, generator=g) / math.sqrt(r)
    q = torch.randn(b, h, nope + rd, generator=g)
    cache = torch.full((3, b, s, r + rd), float("nan"))      # rows past the live ones: never read
    cache[1, :, :n] = torch.cat([latent, k_pe], dim=-1)
    scale = (nope + rd) ** -0.5
    q_latent = torch.einsum("bhi,hic->bhc", q[..., :nope], w[:, :nope])
    out = latent_attention(torch.cat([q_latent, q[..., nope:]], -1).contiguous(), cache, 1,
                           torch.tensor(n, dtype=torch.int32), scale=scale, latent=r)
    got = torch.einsum("bhc,hvc->bhv", out, w[:, nope:])
    keys = torch.cat([torch.einsum("bnc,hic->bnhi", latent, w[:, :nope]),
                      k_pe[:, :, None].expand(b, n, h, rd)], dim=-1)
    values = torch.einsum("bnc,hvc->bnhv", latent, w[:, nope:])
    p = torch.softmax(torch.einsum("bhd,bnhd->bhn", q, keys) * scale, dim=-1)
    want = torch.einsum("bhn,bnhv->bhv", p, values)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    assert torch.equal(out, latent_attention_reference(
        torch.cat([q_latent, q[..., nope:]], -1).contiguous(), cache, 1, n, scale=scale,
        latent=r, max_len=s))


def test_the_expert_op_is_the_all_experts_masked_sum():
    g = torch.Generator().manual_seed(12)
    b, e, k, d, width = 3, 8, 2, 16, 8
    x = torch.randn(b, d, generator=g)
    gate, up = (torch.randn(e, width, d, generator=g) for _ in range(2))
    down = torch.randn(e, d, width, generator=g)
    shared = (torch.randn(2 * width, d, generator=g), torch.randn(2 * width, d, generator=g),
              torch.randn(d, 2 * width, generator=g))
    ids = torch.stack([torch.randperm(e, generator=g)[:k] for _ in range(b)])
    w = torch.rand(b, k, generator=g)
    counts = torch.zeros(2, e, dtype=torch.int32)
    got = routed_experts(x, ids, w, gate, up, down, shared=shared, counts=counts, layer=1)
    every = torch.stack([F.silu(x @ gate[j].T) * (x @ up[j].T) @ down[j].T for j in range(e)], 1)
    mask = torch.zeros(b, e).scatter_(1, ids, w)
    want = (every * mask[..., None]).sum(1)
    want += (F.silu(x @ shared[0].T) * (x @ shared[1].T)) @ shared[2].T
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-5)
    assert counts[0].sum() == 0 and counts[1].tolist() == torch.bincount(
        ids.flatten(), minlength=e).tolist()
    assert torch.equal(got, routed_experts_reference(x, ids, w, gate, up, down, shared=shared))


def test_a_bias_that_changes_the_choice_matches_and_weighting_by_it_does_not(monkeypatch):
    """The correction bias chooses some tokens' experts away from the
    scores' own top K; the program still gives the reference's logits. A
    reference whose weights are taken from score plus bias (the choice's
    key) does not."""
    model = _model()
    cfg, net, W = _built(model)
    cond = torch.randn(1, cfg.cond_length, cfg.opt.hidden_size,
                       generator=torch.Generator().manual_seed(4))
    _, tokens, logits = _decode(net, cfg, cond)
    fam = _family()
    changed = []
    published = fam.route

    def spy(o, W_, name, x, served=None):
        scores = torch.sigmoid(x @ W_[f"{name}.gate.weight"].T)
        by_score = scores.topk(o["num_experts_per_tok"], dim=-1).indices.sort(-1).values
        ids, w = published(o, W_, name, x, served)
        changed.append(bool((by_score != ids.sort(-1).values).any(-1).float().mean() > 0.05))
        return ids, w

    monkeypatch.setattr(fam, "route", spy)
    want = fam.decoder_logits(W, model, cond[0], tokens)
    assert all(changed) and len(changed) == 2
    assert (logits - want).abs().max().item() <= LOGIT_ATOL

    def by_choice(o, W_, name, x, served=None):
        scores = torch.sigmoid(x @ W_[f"{name}.gate.weight"].T)
        choice = scores + W_[f"{name}.gate.e_score_correction_bias"]
        ids = choice.topk(o["num_experts_per_tok"], dim=-1).indices
        w = choice.gather(1, ids)
        return ids, w / (w.sum(-1, keepdim=True) + 1e-20) * o["routed_scaling_factor"]

    monkeypatch.setattr(fam, "route", by_choice)
    wrong = fam.decoder_logits(W, model, cond[0], tokens)
    assert (logits - wrong).abs().max().item() > 100 * LOGIT_ATOL


def _points(cfg, batch=1, seed=1):
    pc = torch.randn(batch, cfg.perceiver.num_points, 6,
                     generator=torch.Generator().manual_seed(seed))
    pc[..., 3:] /= pc[..., 3:].norm(dim=-1, keepdim=True)
    return pc


def test_the_runner_decodes_it_and_the_request_carries_the_expert_counter():
    model = _model()
    cfg, net, W = _built(model)
    runner = PhaseRunner(net, cfg, early_exit=False)
    pc = _points(cfg, batch=2)
    first = runner.run(pc)
    again = runner.run(pc)                         # the kept state, refilled
    assert torch.equal(first["tokens"], again["tokens"])
    assert first["decode_steps"] == cfg.generate_length - 1
    request = [sp for sp in profiling.spans() if sp.name == "request"][-1]
    counts = request.attrs["expert_tokens"]
    assert len(counts) == 2 and all(sum(c) == 2 * 2 * 37 for c in counts)
    _, cond = ma.encode(net, cfg, pc)
    direct = moon.generate(net.opt, cfg.opt, cond, max_new_tokens=cfg.generate_length)
    assert torch.equal(direct, first["tokens"])
    assert torch.equal(ma.generate(net, cfg, pc).token_ids, first["tokens"])


def test_the_routing_record_holds_every_positions_chosen_experts():
    """The prefill and each step write each position's chosen ids into the
    state's routing record: the step's rows are the expert counter's
    tokens, and every row is the reference's own top K (no shortfall) at
    its position, f32 on both sides."""
    model = _model()
    cfg, net, W = _built(model)
    runner = PhaseRunner(net, cfg, early_exit=False)
    out = runner.run(_points(cfg))
    state = harness._kept_state(runner)
    counts = torch.tensor([sp for sp in profiling.spans()
                           if sp.name == "request"][-1].attrs["expert_tokens"])
    c, steps = cfg.cond_length, out["decode_steps"]
    stepped = state.routes[:, 0, c:c + steps].long()
    assert torch.equal(torch.stack([torch.bincount(r.flatten(), minlength=8) for r in stepped]),
                       counts)
    fam = _family()
    cache = fam.read_cache(state, 0, c + steps)
    assert cache.routes.shape == (2, c + steps, 2)
    seen = []
    published = fam.served_shortfall

    def spy(choice, ids):
        seen.append(published(choice, ids))
        return seen[-1]

    fam.served_shortfall = spy
    try:
        with torch.no_grad():
            _, cond = ma.encode(net, cfg, _points(cfg))
            fam.decoder_logits(W, model, cond[0], out["tokens"][0], _Probe(cache))
    finally:
        fam.served_shortfall = published
    assert seen == [0.0, 0.0]


class _Probe:
    """A cache probe that only carries the program's cache."""

    def __init__(self, cache):
        self.cache = cache

    def __call__(self, layer, groups):
        pass


def test_what_the_decoder_does_not_have_raises():
    model = _model()
    cfg, net, _ = _built(model)
    for kw in ({"attn": "pallas_int8"}, {"attn": "pallas_int4"}, {"attn": "megakernel"},
               {"lookahead": 8}, {"lookahead": "adaptive"}):
        with pytest.raises(ValueError, match="moonlight"):
            PhaseRunner(net, cfg, **kw)
    with pytest.raises(NotImplementedError, match="training"):
        ma.forward_logits(net, cfg, _points(cfg), torch.zeros(1, 9, dtype=torch.int64))
    with pytest.raises(ValueError, match="tensor parallelism"):
        shard_params(Mesh(1, 2, 0, 0, None, None, CPU), net)
    with pytest.raises(ValueError, match="megakernel"):
        moon.step_body(net.opt, cfg.opt, None, mega_layers=object())


def test_the_cache_budget_counts_the_latent_rows():
    """27 layers x 7,680 padded positions x 576 values x 2 bytes at B=1,
    and the routing record's 26 MoE layers x 7,680 x 6 int32 ids."""
    from meshanything_tpu_torch.config import MeshAnythingConfig, MoonlightConfig

    cfg = MeshAnythingConfig(opt=MoonlightConfig())
    assert estimate_kv_bytes(cfg, 1) == 27 * 7680 * 576 * 2 + 26 * 7680 * 6 * 4 == 243_671_040
    assert cfg.decoder == "moonlight" and MeshAnythingConfig().decoder == "opt"


def test_wq_runs_the_projections_and_dense_mlps_as_int8():
    """``wq``: the W8A8 path changes the logits (a precision step the
    comparison has to see) and leaves the routed experts on the kernel."""
    model = _model()
    cfg, net, _ = _built(model)
    pc = _points(cfg)
    exact = PhaseRunner(net, cfg, early_exit=False).run(pc)
    quant = PhaseRunner(net, cfg, early_exit=False, wq=True).run(pc)
    layers = moon.quantize_layers(net.opt.layers)
    assert [q.q_proj.wq.dtype for q in layers] == [torch.int8] * 3
    shared = net.opt.layers[1].mlp.shared_experts
    assert layers[1].mlp.gate_proj.wq.shape == shared.gate_proj.weight.shape
    assert exact["tokens"].shape == quant["tokens"].shape
