"""The face-grammar probe of the PyTorch port against the JAX package:
the procedural meshes, token streams and batches bit-equal for the same
seeds, the small decoder learning the grammar (JAX's
test_lookahead_acceptance_on_trained_grammar), the acceptance stats on
JAX-trained weights equal to JAX's own, lookahead's ``max_accept``, and
the weights carried back into JAX's tree for the trained-weights cache."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from meshanything_tpu.config import small_test_config as jax_small_config
from meshanything_tpu.models import meshanything as jma
from meshanything_tpu.training import synthetic_grammar as jsg
from meshanything_tpu.training import train as jtrain
from meshanything_tpu_torch.config import small_test_config
from meshanything_tpu_torch.models import lookahead as la
from meshanything_tpu_torch.runtime.checkpoint import jax_numpy_from_params, params_from_jax_numpy
from meshanything_tpu_torch.training import synthetic_grammar as sg
from meshanything_tpu_torch.training import train as ttrain


def _grammar_cfgs(n_max_triangles):
    """JAX's test config of the grammar: vocab 67 over a 64-row codebook."""
    out = []
    for base in (jax_small_config(n_max_triangles), small_test_config(n_max_triangles)):
        out.append(dataclasses.replace(
            base, opt=dataclasses.replace(base.opt, vocab_size=67, codebook_size=64)))
    return out


def _equal(got, want):
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", [
    ("grid_mesh", dict(k=5)),
    ("grid_mesh", dict(k=4, smooth=1, jitter=0.03)),
    ("chain_grid_mesh", dict(k=5, bins=63)),
    ("chain_grid_mesh", dict(k=4, bins=128, per_mesh_perm=True)),
    ("make_grammar_batch", dict(batch=2, k=4)),
    ("make_grammar_batch", dict(batch=3, k=5, mask_padding=True, jitter=0.03)),
    ("make_grammar_batch", dict(batch=2, k=4, mask_padding=True, chain=True)),
    ("make_grammar_batch", dict(batch=2, k=3, chain="rand")),
], ids=lambda c: f"{c[0]}-{'-'.join(f'{k}{v}' for k, v in c[1].items())}")
def test_grammar_builders_bit_equal(case):
    """The meshes, and the batches built from them (token streams, labels
    and surface-sampled conditions), equal JAX's bit for bit for the same
    seed; mesh_to_token_stream over each mesh too."""
    name, kw = case
    jcfg, cfg = _grammar_cfgs(20)
    if name == "make_grammar_batch":
        got = sg.make_grammar_batch(cfg, np.random.default_rng(11), **kw)
        want = jsg.make_grammar_batch(jcfg, np.random.default_rng(11), **kw)
        _equal(got, want)
        return
    got = getattr(sg, name)(np.random.default_rng(12), **kw)
    want = getattr(jsg, name)(np.random.default_rng(12), **kw)
    _equal(got, want)
    v, f = got[0], got[-1]
    _equal(sg.mesh_to_token_stream(v, f, kw.get("bins", 128)),
           jsg.mesh_to_token_stream(v, f, kw.get("bins", 128)))


def test_grammar_batches_skip_bit_equal():
    """grammar_batches(skip=2) yields JAX's skip=2 stream, which is the
    third batch on of the unskipped stream (the resume contract)."""
    jcfg, cfg = _grammar_cfgs(8)
    got = ttrain.grammar_batches(cfg, 2, seed=3, k=3, skip=2)
    want = jtrain.grammar_batches(jcfg, 2, seed=3, k=3, skip=2)
    whole = ttrain.grammar_batches(cfg, 2, seed=3, k=3)
    for _ in range(2):
        next(whole)
    for _ in range(2):
        g = next(got)
        _equal(g, next(want))
        _equal(g, next(whole))


def test_train_on_grammar_learns():
    """JAX's test_lookahead_acceptance_on_trained_grammar in the port: the
    small config (n_max_triangles=20) learns the grammar in 120 steps at
    batch 8, k=4, lr 3e-3 (loss < 0.5), and lookahead W=8 on held-out
    conditions accepts > 2 tokens a forward with f32 agreement > 0.99."""
    _, cfg = _grammar_cfgs(20)
    torch.manual_seed(0)
    model, loss = sg.train_on_grammar(cfg, steps=120, batch=8, k=4, lr=3e-3, device="cpu")
    assert loss < 0.5, loss
    pc, _, _ = sg.make_grammar_batch(cfg, np.random.default_rng(99), 2, k=4)
    stats = sg.measure_lookahead_acceptance(model, cfg, pc, window=8, bucket=32)
    assert stats["acceptance"] > 2.0, stats
    assert stats["agreement"] > 0.99, stats


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small ops: with the test runner's workers
    sharing the cores, torch's thread pool per worker turns them into a
    spin-wait contest (a 10 s test took 600 s). One thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_trained():
    """Weights trained by JAX's train_on_grammar (n_max_triangles=10, k=3:
    72 content tokens in a 92-token budget; 60 steps: rows that stop at
    eos and windows that are not accepted whole), bridged into the port,
    and held-out conditions."""
    jcfg, cfg = _grammar_cfgs(10)
    params, loss = jsg.train_on_grammar(jcfg, steps=60, batch=8, k=3, lr=3e-3)
    tree = jax.tree_util.tree_map(np.array, params)
    pc, _, _ = jsg.make_grammar_batch(jcfg, np.random.default_rng(99), 2, k=3)
    return jcfg, params, cfg, params_from_jax_numpy(tree, cfg), pc


@pytest.mark.parametrize("max_accept", [None, 3])
def test_measure_acceptance_matches_jax(jax_trained, max_accept):
    """measure_lookahead_acceptance on JAX-trained weights returns JAX's
    own stats exactly (f32 greedy: the same streams, the same forward
    count), JAX at attn="pallas" in interpret mode; with max_accept=3 too,
    where the acceptance is at most the cap and the forwards grow."""
    jcfg, params, cfg, model, pc = jax_trained
    kw = dict(window=8, bucket=32, max_accept=max_accept)
    want = jsg.measure_lookahead_acceptance(params, jcfg, pc, attn="pallas", **kw)
    got = sg.measure_lookahead_acceptance(model, cfg, pc, attn="pallas", **kw)
    assert got == want
    assert 0 < got["plain_tokens"] < 2 * cfg.generate_length     # a row stopped at eos
    assert got["acceptance"] < 8                                # not every window accepted
    if max_accept is not None:
        assert got["acceptance"] <= max_accept


def test_max_accept_keeps_the_stream(jax_trained):
    """lookahead with max_accept=2 gives the uncapped greedy stream, no
    row accepts more than 2 tokens a forward, and with sampling the cap
    raises."""
    _, _, cfg, model, pc = jax_trained
    from meshanything_tpu_torch.models import meshanything as ma

    with torch.no_grad():
        _, cond = ma.encode(model, cfg, torch.from_numpy(pc))
        kw = dict(max_new_tokens=cfg.generate_length, window=8, bucket=32, return_stats=True)
        free, free_stats = la.generate_lookahead(model.opt, cfg.opt, cond, **kw)
        capped, stats = la.generate_lookahead(model.opt, cfg.opt, cond, max_accept=2, **kw)
        assert torch.equal(capped, free)
        emitted = int((stats["emitted"] - 1).sum())
        assert emitted <= 2 * stats["iterations"] * capped.shape[0]
        assert stats["iterations"] > free_stats["iterations"]
        with pytest.raises(ValueError, match="greedy-mode"):
            la.generate_lookahead(model.opt, cfg.opt, cond, max_accept=2, sampling=True,
                                  generator=torch.Generator().manual_seed(0), **kw)


def test_weights_round_trip_and_cache(tmp_path):
    """JAX tree -> port (params_from_jax_numpy) -> JAX tree
    (jax_numpy_from_params) is bit for bit, key for key; a cache the port
    writes loads through JAX's _unflatten_tree to equal arrays; a bf16
    module raises (numpy has no bfloat16)."""
    jcfg, cfg = jax_small_config(4), small_test_config(4)
    tree = jax.tree_util.tree_map(np.array, jma.init_meshanything_params(
        jax.random.PRNGKey(7), jcfg))
    model = params_from_jax_numpy(tree, cfg)
    back = jax_numpy_from_params(model)
    flat_want, flat_got = jsg._flatten_tree(tree), sg._flatten_tree(back)
    assert set(flat_got) == set(flat_want)
    for key, want in flat_want.items():
        _equal(flat_got[key], want)

    path = tmp_path / "cache.npz"
    np.savez(path, **sg._flatten_tree(back))
    with np.load(path) as flat:
        loaded = jsg._unflatten_tree(dict(flat))
    for key, want in jsg._flatten_tree(loaded).items():
        _equal(want, flat_want[key])
    with pytest.raises(ValueError, match="bfloat16"):
        jax_numpy_from_params(model.to(torch.bfloat16))
