"""The whole slice of the PyTorch port (encode -> prefill -> decode
through K1 -> detok) against the JAX package in f32 on shared weights:
greedy raw tokens must be identical, coordinates identical (NaN-aware)."""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meshanything_tpu.config import small_test_config as jax_small_config
from meshanything_tpu.models import meshanything as jma
from meshanything_tpu_torch.config import small_test_config
from meshanything_tpu_torch.models import decoding
from meshanything_tpu_torch.models import meshanything as ma
from meshanything_tpu_torch.models import shape_opt as opt
from meshanything_tpu_torch.runtime.checkpoint import params_from_jax_numpy

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "small_config.json")
BUCKET = 16
# The staggered-eos weights copy token 9's lm_head column into eos's, so a
# row emits eos wherever it would have emitted 9 (the lower index wins
# argmax ties): at these inputs row 0 stops at step 8 and row 1 at 25 of
# 38, which exercises pad-after-eos rows and the early exit.
EOS_AS_TOKEN = 9


def _trees():
    jcfg = jax_small_config(n_max_triangles=4)
    params = jma.init_meshanything_params(jax.random.PRNGKey(42), jcfg)
    tree = jax.tree_util.tree_map(np.array, params)
    return jcfg, tree


def _staggered_eos(tree):
    tree = jax.tree_util.tree_map(np.array, tree)
    for k in ("cond_proj", "cond_head_proj"):   # make rows depend on their input
        tree[k]["w"] = tree[k]["w"] * 30
    tree["opt"]["lm_head"]["w"][:, 1] = tree["opt"]["lm_head"]["w"][:, EOS_AS_TOKEN]
    return tree


def _pc(batch):
    rng = np.random.default_rng(7)
    return (rng.normal(size=(batch, jax_small_config().perceiver.num_points, 6)) * 0.5
            ).astype(np.float32)


def _coords_key(coords):
    return np.where(np.isnan(coords), -9.0, np.round(coords * 128)).astype(int)


def test_greedy_matches_golden_stream():
    """B=1 on the golden weights: the pinned JAX stream and detok."""
    jcfg, tree = _trees()
    cfg = small_test_config(n_max_triangles=4)
    model = params_from_jax_numpy(tree, cfg)
    with torch.no_grad():
        out = ma.generate(model, cfg, torch.from_numpy(_pc(1)), bucket=BUCKET)
    golden = json.load(open(GOLDEN))
    coords = out.face_coords.numpy().astype(np.float64)
    assert out.token_ids[0].tolist() == golden["greedy_tokens"]
    assert (~np.isnan(coords[0, :, 0, 0])).astype(int).tolist() == golden["valid_faces"]
    assert _coords_key(coords)[0].tolist() == golden["coords_rounded"]


@pytest.fixture(scope="module")
def staggered():
    jcfg, tree = _trees()
    tree = _staggered_eos(tree)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    ref = {}
    for batch in (1, 2):
        out = jma.generate(params, jcfg, jnp.asarray(_pc(batch)), bucket=BUCKET, attn="pallas")
        ref[batch] = (np.asarray(out.token_ids), np.asarray(out.face_coords))
    return params_from_jax_numpy(tree, small_test_config(n_max_triangles=4)), ref


@pytest.mark.parametrize("batch,sync_every", [(1, 64), (2, 64), (2, 1), (2, 5)])
def test_greedy_matches_jax_pallas(staggered, batch, sync_every):
    model, ref = staggered
    cfg = small_test_config(n_max_triangles=4)
    jtokens, jcoords = ref[batch]
    if batch == 2:   # the construction this test relies on
        assert [list(r).index(1) for r in jtokens] == [8, 25]
        assert (jtokens[0, 9:26] == cfg.opt.pad_token_id).all()
    with torch.no_grad():
        point_feature, cond = ma.encode(model, cfg, torch.from_numpy(_pc(batch)))
        state = opt.init_decode_state(model.opt, cfg.opt, cond,
                                      max_new_tokens=cfg.generate_length, bucket=BUCKET)
        state = decoding.decode_loop(model.opt, cfg.opt, state,
                                     max_new_tokens=cfg.generate_length, sync_every=sync_every)
        coords = ma.detokenize(model, cfg, state.tokens, point_feature)
    np.testing.assert_array_equal(state.tokens.numpy(), jtokens)
    np.testing.assert_array_equal(coords.numpy(), jcoords)
    # the loop stops at the first look at `done` after every row finished
    last = max(list(r).index(1) for r in jtokens)
    assert last + 1 <= state.step <= last + sync_every + 1
