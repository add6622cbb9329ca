"""Data and tensor parallelism of the PyTorch port
(``meshanything_tpu_torch/parallel/``) on the small config in f32, held to
the JAX package's single-device results on the same weights (its
``axis_name`` contrastive loss over vmap's named axis).

Four gloo processes on the CPU (``parallel/launch.py``; no JAX in them,
one torch thread each) run one worker script over three meshes of the
same ranks: (data 2, model 2), (4, 1) and (1, 4). They read the weights
as a native checkpoint and their inputs from an ``.npz`` in tmp_path,
written here from JAX's arrays, and write what they computed back; the
tests hold it to JAX's ``forward_logits``, single-device ``generate`` in
every tier (its Pallas kernels in interpret mode: what GSPMD computes
over a mesh), ``train_step`` and ``contrastive_loss(axis_name=)``, and
the quantizers and W8A8 products under a model group to one process's
bit for bit. The workers run while JAX computes its side.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from meshanything_tpu.config import small_test_config as jax_small_config
from meshanything_tpu.models import meshanything as jma
from meshanything_tpu.training import losses as jlosses
from meshanything_tpu.training import optim as joptim
from meshanything_tpu.training import train as jtrain
from meshanything_tpu_torch.config import MeshAnythingConfig, small_test_config
from meshanything_tpu_torch.models import meshanything as ma
from meshanything_tpu_torch.ops import kvcache, wquant
from meshanything_tpu_torch.parallel import mesh as pmesh
from meshanything_tpu_torch.parallel.dryrun import dryrun_multichip
from meshanything_tpu_torch.parallel.launch import start_ranks, wait_ranks
from meshanything_tpu_torch.runtime import phases
from meshanything_tpu_torch.runtime.checkpoint import params_from_jax_numpy, save_native
from meshanything_tpu_torch.training import train as ttrain
from meshanything_tpu_torch.training.optim import make_optimizer

N_MAX = 4
BUCKET = 16
SEQ = 21            # test_torch_training's length
LR = 1e-3           # test_torch_training's recipe and tolerances
GRAD_RTOL = 1e-4
CLIP = 0.05         # every update clipped: the clip's global norm decides it
STEPS = 3
WORLD = 4
FAST = {"attn": "pallas_int8", "lookahead": 4, "wq": True}     # --fast at window 4
# case -> generate's keywords; the prefix names the mesh: dp (4, 1), tp (1, 4),
# dp_tp (2, 2)
GENERATE_CASES = {
    "dp": {}, "tp": {}, "dp_tp": {}, "tp_lookahead": {"lookahead": 4},
    "dp_tp_lookahead": {"lookahead": 4},
    "tp_int8": {"attn": "pallas_int8"}, "tp_int4": {"attn": "pallas_int4"},
    "dp_tp_int4": {"attn": "pallas_int4"},
    "tp_int4_lookahead": {"attn": "pallas_int4", "lookahead": 4},
    "tp_fast": FAST, "dp_tp_fast": FAST,
    "tp_megakernel": {"attn": "megakernel"}, "dp_tp_megakernel": {"attn": "megakernel"},
}
QMAX = {"pallas_int8": 127, "pallas_int4": 7}
# the decode states whose caches the ranks keep: (tier, lookahead window)
CACHE_CASES = {"int8_decode": ("pallas_int8", 0), "int4_lookahead": ("pallas_int4", 4)}


def _tier(kw: dict) -> tuple:
    """generate's keywords -> (attn, lookahead, wq), JAX's run key."""
    return kw.get("attn", "pallas"), kw.get("lookahead", 0), kw.get("wq", False)

WORKER = r"""
import json
import os
import torch
from meshanything_tpu_torch.config import small_test_config
from meshanything_tpu_torch.models import decoding
from meshanything_tpu_torch.models import meshanything as ma
from meshanything_tpu_torch.models import lookahead as la_mod
from meshanything_tpu_torch.models import shape_opt as opt_mod
from meshanything_tpu_torch.models.layers import row_lin
from meshanything_tpu_torch.ops import kvcache, wquant
from meshanything_tpu_torch.parallel import collectives
from meshanything_tpu_torch.parallel import mesh as pmesh
from meshanything_tpu_torch.parallel.multihost import process_info
from meshanything_tpu_torch.runtime.checkpoint import load_native
from meshanything_tpu_torch.runtime.phases import PhaseRunner
from meshanything_tpu_torch.training import losses, train
from meshanything_tpu_torch.training.optim import make_optimizer

torch.set_num_threads(1)
d = os.environ["PARALLEL_TEST_DIR"]
pmesh.join("cpu")
rank, world = process_info()
cfg = small_test_config(n_max_triangles=4)
import numpy as np
x = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(d, "inputs.npz")).items()}
m22, m41, m14 = (pmesh.create_mesh(a, b, "cpu") for a, b in ((2, 2), (4, 1), (1, 4)))
ckpt = os.path.join(d, "ckpt")
full = load_native(ckpt, cfg, device="cpu")
local22 = load_native(ckpt, cfg, device="cpu", mesh=m22)
local14 = pmesh.shard_params(m14, full)
res = {"mesh22": (m22.data, m22.model, m22.data_index, m22.model_index, m22.rank),
       "heads14": [m.num_heads for m in local14.modules() if hasattr(m, "tp_group")],
       "roundtrip": all(
           set(dict(back.named_parameters())) == set(dict(full.named_parameters()))
           and all(torch.equal(p, dict(full.named_parameters())[n])
                   for n, p in back.named_parameters())
           for back in (pmesh.gather_params(m22, local22), pmesh.gather_params(m14, local14)))}

with torch.no_grad():
    res["forward"] = ma.forward_logits(local22, cfg, x["pc"][:2], x["toks"], mesh=m22)
    meshes = {"dp": (full, m41), "tp": (local14, None), "dp_tp": (local22, m22)}
    cases = json.load(open(os.path.join(d, "cases.json")))
    for name, kw in cases["generate"].items():
        model, mesh = meshes["dp_tp" if name.startswith("dp_tp") else name.split("_")[0]]
        out = ma.generate(model, cfg, x["pc"], bucket=16, mesh=mesh, **kw)
        res["gen_" + name] = (out.token_ids, out.face_coords)
    # the (1, 4) runner in the fast tier, the shared device side of the entry points
    runner = PhaseRunner(local14, cfg, bucket=16, attn="pallas_int8", lookahead=4, wq=True)
    res["runner_fast"] = runner(x["pc"]).token_ids

    try:
        decoding.check_capture(local14.opt)
    except ValueError as e:
        res["graph_gloo"] = str(e)
    decoding.check_capture(full.opt)        # no model group: captures

    # the parts under the (1, 4) model group, each rank on its columns
    g14, me = m14.model_group, m14.model_index
    res["max"] = collectives.all_reduce_max(x["max_in"][me], g14)
    cols = x["qrows"].shape[-1] // 4
    mine = x["qrows"][..., me * cols:(me + 1) * cols]
    res["quantized"] = {"int8": kvcache.quantize_rows(mine, g14),
                        "int4": kvcache.quantize_rows_int4(mine, g14),
                        "int8_rank_local_scale": kvcache.quantize_rows(mine)[1]}
    feats = x["w8a8_w"].shape[1] // 4
    w_mine = x["w8a8_w"][:, me * feats:(me + 1) * feats]
    entry = wquant.QuantizedLinear(*wquant.quantize_weight(w_mine, g14), x["w8a8_b"])
    res["w8a8"] = {str(dtype)[6:]: row_lin(x["w8a8_x"][:, me * feats:(me + 1) * feats].to(dtype),
                                           entry, g14) for dtype in (torch.float32, torch.bfloat16)}
    res["w8a8_scale"] = entry.scale
    # the caches that the decode left: every written row's scale is the rows' over the
    # group (equal on every rank, some rank's code at the largest code)
    _, cond = ma.encode(local14, cfg, x["pc"])
    gl = cfg.generate_length
    res["caches"] = {}
    for name, (attn, window) in cases["caches"].items():
        if window:
            st = la_mod.init_lookahead_state(local14.opt, cfg.opt, cond, max_new_tokens=gl,
                                             window=window, bucket=16, attn=attn)
            st = la_mod.lookahead_segment(local14.opt, cfg.opt, st, max_new_tokens=gl,
                                          wq_layers=wquant.quantize_opt_layers(local14.opt.layers))
        else:
            st = opt_mod.init_decode_state(local14.opt, cfg.opt, cond, max_new_tokens=gl,
                                           bucket=16, attn=attn)
            st = decoding.decode_loop(local14.opt, cfg.opt, st, max_new_tokens=gl)
        res["caches"][name] = st.kv

opt = make_optimizer(1e-3, steps=20, clip_norm=0.05)
state, step = train.make_sharded_train_step(m22, cfg, load_native(ckpt, cfg, device="cpu"), opt)
res["metrics"] = []
for _ in range(3):
    state, metrics = step(state, x["train_pc"], x["train_ids"], x["train_labels"])
    res["metrics"].append({k: float(v) for k, v in metrics.items()})
trained = {part: pmesh.gather_tensors(m22, tensors) for part, tensors in (
    ("params", {n: p.detach() for n, p in state.model.named_parameters()}),
    ("mu", state.opt_state.mu), ("nu", state.opt_state.nu))}
train.save_train_state(state, os.path.join(d, "sharded_state"), mesh=m22)
template, _ = train.make_sharded_train_step(m22, cfg, load_native(ckpt, cfg, device="cpu"), opt)
train.restore_train_state(os.path.join(d, "single_state"), template, mesh=m22)
res["restored"] = {"params": {n: p.detach() for n, p in template.model.named_parameters()},
                   "mu": template.opt_state.mu, "nu": template.opt_state.nu,
                   "count": template.opt_state.count, "step": template.step}
if rank == 0:
    res["trained"] = trained

a = ma.local_rows(m41, x["con_a"]).clone().requires_grad_()
b = ma.local_rows(m41, x["con_b"]).clone().requires_grad_()
loss = losses.contrastive_loss(a, b, x["con_scale"], group=m41.data_group)
loss.backward()
res["contrastive"] = (loss.detach(), a.grad, b.grad)
torch.save(res, os.path.join(d, f"out{rank}.pt"))
torch.distributed.destroy_process_group()
"""


def _parts_inputs(rng) -> dict:
    """The parts' inputs: each column of the K/V rows and of the W8A8 input
    features at a scale of its own (so the amax lies on one rank), and a
    max input a rank."""
    col = rng.uniform(0.05, 3.0, size=32).astype(np.float32)
    feat = rng.uniform(0.05, 3.0, size=64).astype(np.float32)
    return {"qrows": (rng.normal(size=(2, 2, 2, 5, 32)) * col).astype(np.float32),
            "w8a8_w": (rng.normal(size=(32, 64)) * feat).astype(np.float32),
            "w8a8_x": (rng.normal(size=(3, 64)) * feat[::-1]).astype(np.float32),
            "w8a8_b": rng.normal(size=32).astype(np.float32),
            "max_in": rng.normal(size=(WORLD, 3, 7)).astype(np.float32)}


def _jax_tree():
    jcfg = jax_small_config(n_max_triangles=N_MAX)
    params = jax.jit(jma.init_meshanything_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jcfg, params, jax.tree_util.tree_map(np.array, params)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Start the four ranks, compute JAX's side while they run, then read
    every rank's results: (JAX results, [rank results], the run's dir)."""
    torch.set_num_threads(1)
    d = str(tmp_path_factory.mktemp("parallel"))
    jcfg, jparams, tree = _jax_tree()
    cfg = small_test_config(n_max_triangles=N_MAX)
    model = params_from_jax_numpy(tree, cfg)
    save_native(model, os.path.join(d, "ckpt"))
    rng = np.random.default_rng(0)
    pc = (rng.normal(size=(4, cfg.perceiver.num_points, 6)) * 0.5).astype(np.float32)
    toks = rng.integers(0, cfg.opt.vocab_size, size=(2, 9)).astype(np.int64)
    tpc, tids, tlab = jtrain.make_batch(jcfg, np.random.default_rng(1), batch=4, seq=SEQ)
    con_a, con_b = (rng.normal(size=(8, 8)).astype(np.float32) for _ in range(2))
    x = {"pc": pc, "toks": toks, "train_pc": tpc, "train_ids": tids, "train_labels": tlab,
         "con_a": con_a, "con_b": con_b, "con_scale": np.float32(7.0), **_parts_inputs(rng)}
    np.savez(os.path.join(d, "inputs.npz"), **x)
    with open(os.path.join(d, "cases.json"), "w") as f:
        json.dump({"generate": GENERATE_CASES, "caches": CACHE_CASES}, f)
    # a one-process train state, which the ranks restore into their shards
    single, single_step = ttrain.make_train_step(cfg, params_from_jax_numpy(tree, cfg),
                                                 make_optimizer(LR, steps=20, clip_norm=CLIP))
    single, _ = single_step(single, tpc, tids, tlab)
    ttrain.save_train_state(single, os.path.join(d, "single_state"))

    procs = start_ranks([sys.executable, "-c", WORKER], WORLD, d,
                        env={"PARALLEL_TEST_DIR": d, "OMP_NUM_THREADS": "1"})
    try:
        want = _jax_side(jcfg, jparams, x)
    finally:
        wait_ranks(procs, timeout=400)
    ranks = [torch.load(os.path.join(d, f"out{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    want["inputs"] = x
    return want, ranks, d, single


def _jax_side(jcfg, jparams, x):
    """JAX's single-device results on the same weights and inputs."""
    forward = jax.jit(lambda p, a, b: jma.forward_logits(p, jcfg, a, b))
    want = {"forward": np.asarray(forward(jparams, jnp.asarray(x["pc"][:2]),
                                          jnp.asarray(x["toks"].astype(np.int32))))}
    for attn, la, wq in dict.fromkeys(_tier(kw) for kw in GENERATE_CASES.values()):
        out = jma.generate(jparams, jcfg, jnp.asarray(x["pc"]), bucket=BUCKET, attn=attn,
                           lookahead=la, wq=wq)
        want[(attn, la, wq)] = (np.asarray(out.token_ids), np.asarray(out.face_coords))

    grad_fn = jax.jit(jax.value_and_grad(lambda p, a, b, c: jtrain.loss_fn(p, jcfg, a, b, c),
                                         has_aux=True))
    jopt = joptim.make_optimizer(LR, steps=20, clip_norm=CLIP)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = jopt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    params, opt_state, metrics = jparams, jopt.init(jparams), []
    batch = tuple(jnp.asarray(x[k]) for k in ("train_pc", "train_ids", "train_labels"))
    for _ in range(STEPS):
        (loss, aux), grads = grad_fn(params, *batch)
        metrics.append({"loss": float(loss), "accuracy": float(aux["accuracy"]),
                        "grad_norm": float(optax.global_norm(grads))})
        params, opt_state = update(grads, opt_state, params)
    want["metrics"] = metrics
    want["trained"] = jax.tree_util.tree_map(np.asarray, params)

    # the data axis as vmap's named axis (shard_map's values, a third of its compile)
    scale = jnp.float32(x["con_scale"])
    per_rank = jax.vmap(lambda a, b: jlosses.contrastive_loss(a, b, scale, axis_name="data"),
                        axis_name="data")
    a, b = (jnp.asarray(x[k]).reshape(WORLD, -1, x[k].shape[-1]) for k in ("con_a", "con_b"))
    want["contrastive"] = (np.asarray(per_rank(a, b)), tuple(
        np.asarray(g).reshape(-1, g.shape[-1])
        for g in jax.grad(lambda a, b: per_rank(a, b).sum(), argnums=(0, 1))(a, b)))
    return want


# ---------------------------------------------------------------------------
# the mesh and the spec table, in this process


def test_create_mesh_shapes_and_too_few_ranks(run):
    """One process is the (1, 1) mesh with no group; a mesh of more ranks
    than the world raises as JAX's create_mesh does; on the ranks, the
    (2, 2) mesh has JAX's layout, rank = data_index * model + model_index."""
    one = pmesh.create_mesh(1, 1, "cpu")
    assert (one.shape, one.rank, one.data_group, one.model_group) == ((1, 1), 0, None, None)
    assert one.axis_names == ("data", "model")
    with pytest.raises(ValueError, match="need 4 ranks, have 1"):
        pmesh.create_mesh(data=2, model=2, device="cpu")
    _, ranks, _, _ = run
    assert [r["mesh22"] for r in ranks] == [(2, 2, d, m, 2 * d + m)
                                            for d in range(2) for m in range(2)]


def test_backend_follows_the_device():
    """gloo on the CPU; another backend there raises."""
    assert pmesh.resolve_backend(torch.device("cpu")) == "gloo"
    with pytest.raises(ValueError, match="the CPU runs gloo"):
        pmesh.resolve_backend(torch.device("cpu"), "nccl")


def _spec_leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, pmesh.Split):
            yield ".".join(prefix + (key,))
        else:
            yield from _spec_leaves(value, prefix + (key,))


@pytest.mark.parametrize("config", ["full", "small"])
def test_spec_table_covers_every_parameter(config):
    """Every parameter name of the port's MeshAnything has a spec, and
    every spec of the table names a parameter (JAX's
    test_param_shardings_cover_tree)."""
    cfg = MeshAnythingConfig() if config == "full" else small_test_config()
    model = ma.MeshAnything(cfg, device="meta")
    names = [n for n, _ in model.named_parameters()]
    for name in names:
        pmesh.spec_for(name)
    stripped = {".".join(p for p in n.split(".") if not p.isdigit()) for n in names}
    assert stripped == set(_spec_leaves(pmesh.meshanything_specs()))
    assert pmesh.spec_for("opt.lm_head.weight") == pmesh.REP      # vocab 8195 = 5*11*149
    assert pmesh.spec_for("opt.layers.3.qkv.weight") == pmesh.COL(3)
    assert pmesh.spec_for("nrd.encoder.1.attn_out.bias") == pmesh.REP
    with pytest.raises(KeyError):
        pmesh.spec_for("opt.layers.0.nope.weight")


@pytest.mark.parametrize("n", [2, 4])
def test_shard_then_unshard_is_bit_equal(run, n):
    """shard_tensor over n ranks then unshard_tensor gives every parameter
    back bit for bit; on the ranks gather_params(shard_params(...)) did
    the same over real broadcasts, at (2, 2) and (1, 4), and each block of
    the (1, 4) shard holds a quarter of its heads."""
    model = ma.MeshAnything(small_test_config(), device="cpu")
    for p in model.parameters():
        torch.nn.init.normal_(p)
    for name, p in model.named_parameters():
        split = pmesh.spec_for(name)
        shards = [pmesh.shard_tensor(p.detach(), split, r, n) for r in range(n)]
        assert torch.equal(pmesh.unshard_tensor(shards, split), p), name
    _, ranks, _, _ = run
    assert all(r["roundtrip"] for r in ranks)
    assert set(ranks[0]["heads14"]) == {1}      # 4 heads everywhere in the small config


@pytest.mark.parametrize("block,parts", [("opt.layers.0.qkv", 3),
                                         ("perceiver.cross_attn.kv", 2),
                                         ("nrd.encoder.0.qkv", 3)])
def test_fused_projection_shard_is_its_heads_rows(block, parts):
    """A fused [Q|K|V] (or [K|V]) shard is the rank's heads' rows of each
    part, taken head by head: not a contiguous slice of the matrix."""
    cfg = small_test_config()
    model = ma.MeshAnything(cfg, device="cpu")
    lin = model.get_submodule(block)
    torch.nn.init.normal_(lin.weight)
    width = lin.weight.shape[0] // parts
    heads = 4
    hd = width // heads
    for n in (2, 4):
        for r in range(n):
            mine = range(r * heads // n, (r + 1) * heads // n)
            want = torch.cat([lin.weight[part * width + h * hd:part * width + (h + 1) * hd]
                              for part in range(parts) for h in mine])
            got = pmesh.shard_tensor(lin.weight.detach(), pmesh.COL(parts), r, n)
            assert torch.equal(got, want), (block, n, r)


def test_budget_error_names_the_rank(monkeypatch):
    """A runner of a rank past the first (``place``) names it in the
    memory budget's error."""
    cfg = small_test_config()
    runner = phases.PhaseRunner(ma.MeshAnything(cfg, device="cpu"), cfg,
                                place="rank 1 of 2 (--multihost)")
    runner.device = torch.device("cuda")        # the budget holds cards only

    def too_big(*a, **kw):
        raise ValueError("estimated device footprint 99.0 GB exceeds the budget")

    monkeypatch.setattr(phases, "check_memory_budget", too_big)
    with pytest.raises(ValueError, match=r"^rank 1 of 2 \(--multihost\): estimated"):
        runner._budget(1, 0, (1, False))


# ---------------------------------------------------------------------------
# the ranks against JAX


def test_dp_tp_forward_matches_jax(run):
    """The (2, 2) sharded teacher-forcing forward, rows split over data and
    gathered, against JAX's single-device forward_logits at JAX's own
    bound for its sharded forward (atol 2e-4, rtol 1e-3)."""
    want, ranks, _, _ = run
    for r in ranks:
        np.testing.assert_allclose(r["forward"].numpy(), want["forward"], atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("case", GENERATE_CASES)
def test_sharded_generate_matches_jax(run, case):
    """Greedy generate of four rows under data (4, 1), tensor (1, 4) and
    both (2, 2) parallelism, in the case's tier (the exact one, the int8
    and int4 caches, ``--fast``'s int8 + lookahead + W8A8, the megakernel;
    single-token and lookahead 4), token-identical on every rank to JAX's
    single-device generate of the same tier in interpret mode (what GSPMD
    computes over a mesh); the coordinates identical (NaN-aware)."""
    want, ranks, _, _ = run
    tokens, coords = want[_tier(GENERATE_CASES[case])]
    for r in ranks:
        got_tokens, got_coords = r["gen_" + case]
        np.testing.assert_array_equal(got_tokens.numpy(), tokens)
        np.testing.assert_array_equal(got_coords.numpy(), coords)


def test_tp_phase_runner_fast_tier_matches_jax(run):
    """``PhaseRunner`` over a (1, 4) model group in the fast tier (int8 +
    lookahead 4 + W8A8): every rank's tokens equal JAX's single-device
    generate of that tier."""
    want, ranks, _, _ = run
    tokens, _ = want[_tier(FAST)]
    for r in ranks:
        np.testing.assert_array_equal(r["runner_fast"].numpy(), tokens)


def test_gloo_model_group_refuses_graph_capture(run):
    """A graph capture of a step with collectives over a gloo model group
    raises (the decode must ask for graph=False); without a group it
    captures."""
    _, ranks, _, _ = run
    message = ranks[0]["graph_gloo"]
    assert "gloo" in message and "graph=False" in message


def test_all_reduce_max_equal_on_every_rank(run):
    """all_reduce_max over the (1, 4) model group: every rank holds the
    elementwise max of the four ranks' inputs, bit for bit."""
    want, ranks, _, _ = run
    expect = want["inputs"]["max_in"].max(axis=0)
    for r in ranks:
        np.testing.assert_array_equal(r["max"].numpy(), expect)


def _one_process_rows(want, bits: int):
    rows = torch.from_numpy(want["inputs"]["qrows"])
    return (kvcache.quantize_rows if bits == 8 else kvcache.quantize_rows_int4)(rows)


def test_tp_int8_codes_and_scales_equal_one_process(run):
    """Each rank quantizes its quarter of the K/V rows' columns over the
    (1, 4) model group: the codes joined in rank order are one process's
    int8 codes and every rank's scales are one process's, bit for bit. A
    rank-local scale differs (the inputs put a row's amax on one rank)."""
    want, ranks, _, _ = run
    codes, scales = _one_process_rows(want, 8)
    got = torch.cat([r["quantized"]["int8"][0] for r in ranks], dim=-1)
    assert torch.equal(got, codes)
    for r in ranks:
        assert torch.equal(r["quantized"]["int8"][1], scales)
    assert not all(torch.equal(r["quantized"]["int8_rank_local_scale"], scales) for r in ranks)


def test_tp_int4_plane_words_unpack_to_one_process_codes(run):
    """int4 over the (1, 4) group: each rank packs its columns in the plane
    layout over its own width (a word a row here); unpack_int4 of each
    rank's words, joined in rank order, is unpack_int4 of one process's
    words, and every rank's scales are one process's."""
    want, ranks, _, _ = run
    words, scales = _one_process_rows(want, 4)
    got = torch.cat([kvcache.unpack_int4(r["quantized"]["int4"][0]) for r in ranks], dim=-1)
    assert ranks[0]["quantized"]["int4"][0].shape[-1] == words.shape[-1] // 4
    assert torch.equal(got, kvcache.unpack_int4(words))
    for r in ranks:
        assert torch.equal(r["quantized"]["int4"][1], scales)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_parallel_w8a8_equals_one_process(run, dtype):
    """A row-parallel W8A8 product (``row_lin`` of a QuantizedLinear, each
    rank a quarter of the input features) over the (1, 4) group: the
    weight scales and the result on every rank are one process's
    ``linear_w8a8`` bit for bit (int32 accumulators summed, the bias
    once)."""
    want, ranks, _, _ = run
    x = want["inputs"]
    wq, scale = wquant.quantize_weight(torch.from_numpy(x["w8a8_w"]))
    expect = wquant.linear_w8a8(torch.from_numpy(x["w8a8_x"]).to(getattr(torch, dtype)), wq,
                                scale, torch.from_numpy(x["w8a8_b"]))
    for r in ranks:
        assert torch.equal(r["w8a8_scale"], scale)
        assert r["w8a8"][dtype].dtype == expect.dtype
        assert torch.equal(r["w8a8"][dtype], expect)


@pytest.mark.parametrize("case", CACHE_CASES)
def test_tp_decode_caches_share_the_group_scale(run, case):
    """The caches that a (1, 4) decode left (int8 single-token; int4 with
    lookahead 4 and W8A8): every written row's scales are equal on the
    four ranks, and some rank holds the row's largest code (127, or 7):
    the scale is the whole row's, not a rank's own."""
    _, ranks, _, _ = run
    attn, _ = CACHE_CASES[case]
    values = [r["caches"][case][0] for r in ranks]
    scales = [r["caches"][case][1] for r in ranks]
    written = scales[0][..., 0, :] != 1.0                       # (2, L, B, S)
    cond = small_test_config(n_max_triangles=N_MAX).opt.cond_length
    assert int(written.sum(dim=-1).min()) > cond
    for s in scales[1:]:
        assert torch.equal(s, scales[0])
    codes = [v if attn == "pallas_int8" else kvcache.unpack_int4(v) for v in values]
    top = torch.stack([c.abs().amax(dim=-1) for c in codes]).amax(dim=0)   # (2, L, B, S)
    assert torch.all(top[written] == QMAX[attn])


def test_sharded_train_steps_match_jax(run):
    """Three (2, 2) sharded train steps of the global batch (four rows,
    two a data rank) against JAX's train_step on one device: the global
    batch's loss and accuracy and the clip's global norm each step (loss
    rtol 1e-5, norm GRAD_RTOL), and every parameter after the third step
    at test_torch_training's tolerance (rtol 1e-5, atol 5 * lr *
    GRAD_RTOL); the clip (0.05) cuts every update, so a wrong norm moves
    every parameter."""
    want, ranks, _, _ = run
    cfg = small_test_config(n_max_triangles=N_MAX)
    for r in ranks:
        for got, ref in zip(r["metrics"], want["metrics"]):
            assert got["grad_norm"] > CLIP
            np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
            np.testing.assert_allclose(got["accuracy"], ref["accuracy"], rtol=1e-6)
            np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=GRAD_RTOL)
    trained = dict(params_from_jax_numpy(want["trained"], cfg).named_parameters())
    for name, p in ranks[0]["trained"]["params"].items():
        np.testing.assert_allclose(p.numpy(), trained[name].detach().numpy(), rtol=1e-5,
                                   atol=5 * LR * GRAD_RTOL, err_msg=name)


def test_contrastive_loss_group_matches_jax(run):
    """contrastive_loss(group=) over four data ranks against JAX's
    axis_name form under shard_map: each rank's loss, and the grads of
    the ranks' summed losses for its rows of both embeddings (the
    negatives' grads come back through the gather)."""
    want, ranks, _, _ = run
    losses, (grad_a, grad_b) = want["contrastive"]
    for i, r in enumerate(ranks):
        loss, ga, gb = r["contrastive"]
        np.testing.assert_allclose(float(loss), losses[i], rtol=1e-5)
        np.testing.assert_allclose(ga.numpy(), grad_a[2 * i:2 * i + 2], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(gb.numpy(), grad_b[2 * i:2 * i + 2], rtol=1e-4, atol=1e-6)


def _state_tensors(state):
    return {"params": {n: p.detach() for n, p in state.model.named_parameters()},
            "mu": state.opt_state.mu, "nu": state.opt_state.nu}


def test_sharded_checkpoint_resumes_in_one_process_and_back(run):
    """The (2, 2) trainer's checkpoint (full tensors, written by rank 0)
    restores in one process bit-equal to the sharded state gathered; a
    one-process checkpoint restores into each rank's shards bit-equal to
    the slices of the one-process state."""
    _, ranks, d, single = run
    cfg = small_test_config(n_max_triangles=N_MAX)
    template, _ = ttrain.make_train_step(cfg, ma.MeshAnything(cfg, device="cpu"),
                                         make_optimizer(LR, steps=20, clip_norm=CLIP))
    restored = ttrain.restore_train_state(os.path.join(d, "sharded_state"), template)
    assert (restored.step, restored.opt_state.count) == (STEPS, STEPS)
    for part, tensors in _state_tensors(restored).items():
        for name, t in tensors.items():
            assert torch.equal(t, ranks[0]["trained"][part][name]), (part, name)
    want = _state_tensors(single)
    for r in ranks:
        got = r["restored"]
        assert (got["step"], got["count"]) == (1, 1)
        model_index = r["mesh22"][3]
        for part, tensors in want.items():
            for name, t in tensors.items():
                piece = pmesh.shard_tensor(t, pmesh.spec_for(name), model_index, 2)
                assert torch.equal(got[part][name], piece), (part, name)


def test_dryrun_multichip_four_processes():
    """dryrun_multichip(4): a (2, 2) train step, sharded generate (every
    tier, and ``PhaseRunner`` in every tier), lookahead under data
    parallelism and the segmented int8/int4 decode and lookahead, each
    token-identical to one process."""
    line = dryrun_multichip(4, timeout=400)
    assert line.startswith("dryrun_multichip OK: mesh=(2x2)")
    for name in ("segmented_pallas_int8", "segmented_lookahead_pallas_int4", "lookahead",
                 "generate_fast", "runner_megakernel"):
        assert name in line


def test_dryrun_multichip_two_processes():
    """dryrun_multichip(2): the same over a (1, 2) mesh: the sharded
    generate and ``PhaseRunner`` of a model group of two in every tier
    (int8, int4, --fast, the megakernel, and the runner's adaptive
    lookahead over int4) token-identical to one process."""
    line = dryrun_multichip(2, timeout=400)
    assert line.startswith("dryrun_multichip OK: mesh=(1x2)")
    for tier in ("exact", "int8", "int4", "fast", "megakernel"):
        assert f"generate_{tier}" in line and f"runner_{tier}" in line
    assert "runner_int4_adaptive" in line
