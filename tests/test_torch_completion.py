"""Mesh completion in the PyTorch port against the JAX package, on the
small config in f32 with weights bridged from the JAX tree and JAX's
Pallas kernels in interpret mode: the prompt (``discretize_faces``,
``build_face_prompt``), ``complete`` in the exact, int8 and lookahead
tiers, the golden file, the prompt-seeded decode against a plain
generation whose first P steps emitted the prompt, and the long-prompt
prefill. Token streams are held identical; prefilled cache rows to 1e-6
(f32 sums in another order); the long prefill's logits and cache to 1e-4
(another attention past 1,024 rows)."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meshanything_tpu.config import small_test_config as jax_small_config
from meshanything_tpu.models import meshanything as jma
from meshanything_tpu.models import shape_opt as jsopt
from meshanything_tpu_torch.config import small_test_config
from meshanything_tpu_torch.models import decoding
from meshanything_tpu_torch.models import lookahead as la
from meshanything_tpu_torch.models import meshanything as ma
from meshanything_tpu_torch.models import shape_opt as opt
from meshanything_tpu_torch.runtime.checkpoint import params_from_jax_numpy

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "completion.json")
BUCKET = 16


@pytest.fixture(scope="module")
def bridged():
    """The golden file's weights, point cloud and partial faces
    (tests/test_golden.py::_compute_completion)."""
    jcfg, cfg = jax_small_config(n_max_triangles=4), small_test_config(n_max_triangles=4)
    params = jma.init_meshanything_params(jax.random.PRNGKey(42), jcfg)
    model = params_from_jax_numpy(jax.tree_util.tree_map(np.array, params), cfg)
    rng = np.random.default_rng(7)
    pc = rng.normal(size=(1, cfg.perceiver.num_points, 6)).astype(np.float32) * 0.5
    partial = rng.uniform(-0.45, 0.45, size=(1, 2, 3, 3)).astype(np.float32)
    return jcfg, params, cfg, model, pc, partial


def test_prompt_matches_jax(bridged):
    """Coordinates at the grid's edges, outside it and in f64 discretize
    as JAX's f32 arithmetic does; the face budget's ValueError is JAX's."""
    jcfg, _, cfg, _, _, _ = bridged
    rng = np.random.default_rng(0)
    coords = rng.uniform(-0.6, 0.6, size=(2, 3, 3, 3))
    coords[0, 0, 0] = [-0.5, 0.5, 0.5 - 1e-9]
    coords[1, 2, 1] = [1 / 128 - 0.5, -1 / 256, 0.0]
    for face_coords in (coords, coords.astype(np.float32)):
        np.testing.assert_array_equal(ma.discretize_faces(cfg, face_coords).numpy(),
                                      np.asarray(jma.discretize_faces(jcfg, face_coords)))
        mine = ma.build_face_prompt(cfg, face_coords)
        assert mine.dtype == torch.int64 and mine.shape == (2, 1 + 3 * 9)
        np.testing.assert_array_equal(mine.numpy(),
                                      np.asarray(jma.build_face_prompt(jcfg, face_coords)))
    max_nf = (cfg.generate_length - 2) // cfg.opt.face_per_token
    too_many = np.zeros((1, max_nf, 3, 3))
    with pytest.raises(ValueError) as mine:
        ma.build_face_prompt(cfg, too_many)
    with pytest.raises(ValueError) as ref:
        jma.build_face_prompt(jcfg, too_many)
    assert str(mine.value) == str(ref.value) and "completion needs room" in str(mine.value)
    assert ma.build_face_prompt(cfg, too_many[:, 1:]).shape == (1, 1 + (max_nf - 1) * 9)


@pytest.mark.parametrize("tier", [{}, {"attn": "pallas_int8"}, {"lookahead": 4}],
                         ids=["exact", "int8", "lookahead4"])
def test_complete_matches_jax(bridged, tier):
    jcfg, params, cfg, model, pc, partial = bridged
    with torch.no_grad():
        out = ma.complete(model, cfg, torch.from_numpy(pc), partial, bucket=BUCKET, **tier)
    ref = jma.complete(params, jcfg, jnp.asarray(pc), jnp.asarray(partial), bucket=BUCKET,
                       attn=tier.get("attn", "pallas"), lookahead=tier.get("lookahead", 0))
    tokens = out.token_ids.numpy()
    np.testing.assert_array_equal(tokens, np.asarray(ref.token_ids))
    prompt = ma.build_face_prompt(cfg, partial).numpy()
    np.testing.assert_array_equal(tokens[:, :prompt.shape[1]], prompt)
    np.testing.assert_allclose(out.face_coords.numpy(), np.asarray(ref.face_coords),
                               rtol=0, atol=1e-6)


def test_complete_matches_the_golden_file(bridged):
    _, _, cfg, model, pc, partial = bridged
    golden = json.load(open(GOLDEN))
    with torch.no_grad():
        out = ma.complete(model, cfg, torch.from_numpy(pc), partial, bucket=BUCKET)
    assert ma.build_face_prompt(cfg, partial)[0].tolist() == golden["prompt_echo"]
    assert out.token_ids[0].tolist() == golden["tokens"]
    coords = out.face_coords.numpy().astype(np.float64)
    assert (~np.isnan(coords[0, :, 0, 0])).astype(int).tolist() == golden["valid_faces"]
    rounded = np.where(np.isnan(coords), -9.0, np.round(coords * 128)).astype(int)
    assert rounded[0].tolist() == golden["coords_rounded"]


def _stream_until_eos(tokens, eos):
    stop = np.where(tokens == eos)[0]
    return tokens[: stop[0] + 1] if len(stop) else tokens


@pytest.mark.parametrize("tier", [("pallas", 0), ("pallas_int8", 0), ("pallas_int4", 0),
                                  ("pallas", 4)],
                         ids=["exact", "int8", "int4", "lookahead4"])
def test_prompt_seeded_decode_equals_the_plain_stream(bridged, tier):
    """generate(prompt_ids=plain[:, :P]) reproduces the plain greedy
    stream through each row's eos: the one-pass prefill of the prompt
    is position- and phase-identical to having decoded it token by token
    (JAX tests/test_shape_opt.py::test_prompt_seeded_generate_matches_plain)."""
    attn, window = tier
    _, _, cfg, model, _, _ = bridged
    rng = np.random.default_rng(1)
    cond = torch.from_numpy((rng.normal(size=(2, cfg.opt.cond_length, cfg.opt.hidden_size))
                             * 0.5).astype(np.float32))
    max_new = 24

    def run(prompt=None):
        kw = dict(max_new_tokens=max_new, bucket=BUCKET, attn=attn, prompt_ids=prompt)
        with torch.no_grad():
            if window:
                return la.generate_lookahead(model.opt, cfg.opt, cond, window=window, **kw)
            return decoding.generate(model.opt, cfg.opt, cond, **kw)

    plain = run().numpy()
    for p_len in (1, 7):
        seeded = run(torch.from_numpy(plain[:, :p_len])).numpy()
        for row in range(2):
            want = _stream_until_eos(plain[row], cfg.opt.eos_token_id)
            np.testing.assert_array_equal(seeded[row, :len(want)], want,
                                          err_msg=f"{tier} p_len={p_len} row={row}")


def test_prompt_seeded_state_starts_after_the_prompt(bridged):
    """init_decode_state / init_lookahead_state with a prompt: the prompt
    echoed, the first token at slot P, the device step counter at P + 1
    (the decode's first cache row is C + P), as JAX's states."""
    jcfg, params, cfg, model, _, _ = bridged
    rng = np.random.default_rng(2)
    cond = (rng.normal(size=(2, cfg.opt.cond_length, cfg.opt.hidden_size)) * 0.5).astype(
        np.float32)
    prompt = np.array([[0, 5, 9, 40, 3, 3], [0, 60, 7, 7, 12, 66]])
    with torch.no_grad():
        st = opt.init_decode_state(model.opt, cfg.opt, torch.from_numpy(cond), max_new_tokens=20,
                                   bucket=BUCKET, prompt_ids=torch.from_numpy(prompt))
        lst = la.init_lookahead_state(model.opt, cfg.opt, torch.from_numpy(cond),
                                      max_new_tokens=20, bucket=BUCKET, window=4,
                                      prompt_ids=torch.from_numpy(prompt))
    jst = jsopt.init_decode_state(jax.tree_util.tree_map(jnp.asarray, params["opt"]), jcfg.opt,
                                  jnp.asarray(cond), max_new_tokens=20, bucket=BUCKET,
                                  attn="pallas", prompt_ids=jnp.asarray(prompt))
    assert st.step == int(st.step_t) == int(jst.step) == 7
    np.testing.assert_array_equal(st.tokens.numpy(), np.asarray(jst.tokens))
    np.testing.assert_allclose(st.kv[:, :, :, :cfg.opt.cond_length + 6].numpy(),
                               np.asarray(jst.kv)[:, :, :, :cfg.opt.cond_length + 6],
                               rtol=0, atol=1e-6)
    assert lst.steps.tolist() == [7, 7]
    np.testing.assert_array_equal(lst.tokens[:, :20].numpy(), st.tokens.numpy())
    with pytest.raises(ValueError, match="prompt length"):
        decoding.generate(model.opt, cfg.opt, torch.from_numpy(cond), max_new_tokens=4,
                          bucket=BUCKET, prompt_ids=torch.zeros((2, 4), dtype=torch.int64))


def test_long_prompt_prefill_matches_jax():
    """Past 1,024 rows the prompt's prefill attends through
    scaled_dot_product_attention (JAX: its blockwise attention): logits
    and the written cache rows equal JAX's to 1e-4."""
    jcfg, cfg = jax_small_config(), small_test_config()
    jcfg = dataclasses.replace(jcfg, opt=dataclasses.replace(jcfg.opt, max_positions=1200))
    cfg = dataclasses.replace(cfg, opt=dataclasses.replace(cfg.opt, max_positions=1200))
    params = jma.init_meshanything_params(jax.random.PRNGKey(3), jcfg)
    p = params_from_jax_numpy(jax.tree_util.tree_map(np.array, params), cfg).opt
    jparams, jcfg, cfg = params["opt"], jcfg.opt, cfg.opt
    rng = np.random.default_rng(4)
    c = cfg.cond_length
    cond = (rng.normal(size=(1, c, cfg.hidden_size)) * 0.5).astype(np.float32)
    prompt = rng.integers(0, cfg.vocab_size, size=(1, 1040))
    prompt[0, 0] = cfg.bos_token_id
    n = c + 1040
    kv = torch.zeros((2, cfg.num_layers, 1, n + 7, cfg.hidden_size))
    with torch.no_grad():
        logits = opt.prefill_with_prompt(p, cfg, torch.from_numpy(cond),
                                         torch.from_numpy(prompt), kv)
    jlogits, jkv = jsopt.prefill_with_prompt(jparams, jcfg, jnp.asarray(cond),
                                             jnp.asarray(prompt, jnp.int32), n + 7)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-4)
    np.testing.assert_allclose(kv[:, :, :, :n].numpy(), np.asarray(jkv)[:, :, :, :n],
                               rtol=0, atol=1e-4)
