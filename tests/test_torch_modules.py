"""Module parity of the PyTorch port against the JAX package, in f32, on
the same weights (the bridge of runtime/checkpoint.py) and the same
seeded inputs.

Tolerances: the perceiver at 2e-5, the JAX perceiver's own oracle bound
at full scale; everything else at 1e-5; integer outputs exactly."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meshanything_tpu.config import small_test_config as jax_small_config
from meshanything_tpu.models import layers as jlayers
from meshanything_tpu.models import meshanything as jma
from meshanything_tpu.models import nrd as jnrd
from meshanything_tpu.models import perceiver as jper
from meshanything_tpu.models import shape_opt as jopt
from meshanything_tpu.ops import sampling as jsampling
from meshanything_tpu_torch.config import small_test_config
from meshanything_tpu_torch.models import decoding, layers
from meshanything_tpu_torch.models import meshanything as ma
from meshanything_tpu_torch.models import nrd
from meshanything_tpu_torch.models import perceiver as per
from meshanything_tpu_torch.models import shape_opt as opt
from meshanything_tpu_torch.ops import sampling
from meshanything_tpu_torch.runtime.checkpoint import params_from_jax_numpy

ATOL = 1e-5
PERCEIVER_ATOL = 2e-5


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_small_config(), small_test_config()
    params = jma.init_meshanything_params(jax.random.PRNGKey(42), jcfg)
    model = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, params), cfg)
    rng = np.random.default_rng(11)
    pc = (rng.normal(size=(2, cfg.perceiver.num_points, 6)) * 0.5).astype(np.float32)
    return jcfg, cfg, params, model, pc


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=atol)


def test_layer_primitives_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 24)).astype(np.float32)
    w = rng.normal(size=(24, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    scale, bias = (rng.normal(size=(24,)).astype(np.float32) for _ in range(2))
    t = torch.from_numpy
    _close(layers.layer_norm(t(x), t(scale), t(bias), 1e-12),
           jlayers.layer_norm(x, scale, bias, 1e-12))
    _close(layers.linear(t(x), t(w.T.copy()), t(b)), jlayers.linear(x, w, b))
    _close(layers.gelu(t(x)), jlayers.gelu(x))
    q, k, v = (rng.normal(size=(2, 7, 4, 6)).astype(np.float32) for _ in range(3))
    for kw in ({}, {"dual_sqrt_scale": True}, {"causal": True}):
        _close(layers.attention(t(q), t(k), t(v), **kw), jlayers.attention(q, k, v, **kw))
    emb = rng.normal(size=(2, 9, 3)).astype(np.float32)
    _close(per.fourier_embed(t(emb), 8), jper.fourier_embed(emb, 8))


def test_encode_latents_and_point_feature_match_jax(setup):
    jcfg, cfg, params, model, pc = setup
    with torch.no_grad():
        pf, cond = ma.encode(model, cfg, torch.from_numpy(pc))
    jpf = jper.encode_latents(params["perceiver"], jcfg.perceiver, jnp.asarray(pc))
    jcond = jma.process_point_feature(params, jcfg, jpf)
    _close(pf, jpf, PERCEIVER_ATOL)
    _close(cond, jcond, PERCEIVER_ATOL)
    with torch.no_grad():
        nrd_cond = nrd.process_point_feature(model.nrd, cfg.nrd, pf)
    _close(nrd_cond, jnrd.process_point_feature(params["nrd"], jcfg.nrd, jpf), PERCEIVER_ATOL)


def _cond(setup):
    jcfg, cfg, params, model, pc = setup
    jpf = jper.encode_latents(params["perceiver"], jcfg.perceiver, jnp.asarray(pc))
    return np.array(jma.process_point_feature(params, jcfg, jpf))


def test_prefill_logits_and_cache_match_jax(setup):
    jcfg, cfg, params, model, pc = setup
    cond = _cond(setup)
    s = 32
    jlogits, jkv = jopt.prefill(params["opt"], jcfg.opt, jnp.asarray(cond), s)
    kv = torch.zeros(tuple(jkv.shape))
    with torch.no_grad():
        logits = opt.prefill(model.opt, cfg.opt, torch.from_numpy(cond), kv)
    _close(logits, jlogits)
    _close(kv, jkv)


def test_one_decode_step_matches_jax(setup):
    """One step through K1's plain version: the cache row it writes and
    the token it takes against JAX's pallas step (interpret mode), its
    logits against JAX's teacher-forcing pass at that position."""
    jcfg, cfg, params, model, pc = setup
    cond = _cond(setup)
    gl, bucket = cfg.generate_length, 16
    jstate = jopt.init_decode_state(params["opt"], jcfg.opt, jnp.asarray(cond),
                                    max_new_tokens=gl, bucket=bucket, attn="pallas")
    s_max = jstate.kv.shape[3]
    jnext = jopt._decode_step(params["opt"], jcfg.opt, jstate, s_max, sampling=False,
                              top_k=50, top_p=0.95, temperature=1.0, attn="pallas",
                              chunk=bucket, interpret=True)
    with torch.no_grad():
        state = opt.init_decode_state(model.opt, cfg.opt, torch.from_numpy(cond),
                                      max_new_tokens=gl, bucket=bucket)
        np.testing.assert_array_equal(_np(state.tokens), np.asarray(jstate.tokens))
        _close(state.kv, jstate.kv)
        logits = decoding.decode_step(model.opt, cfg.opt, state)
    assert state.step == int(jnext.step) == 2
    np.testing.assert_array_equal(_np(state.tokens), np.asarray(jnext.tokens))
    np.testing.assert_array_equal(_np(state.done), np.asarray(jnext.done))
    _close(state.kv, jnext.kv)
    jfull = jopt.forward_full(params["opt"], jcfg.opt, jnp.asarray(cond),
                              jstate.tokens[:, :1])
    _close(logits, jfull[:, cond.shape[1]])


def test_embedding_helpers_match_jax(setup):
    jcfg, cfg, params, model, pc = setup
    ids = np.array([[0, 1, 2, 3, 30, 66], [5, 2, 9, 1, 0, 44]], np.int64)
    with torch.no_grad():
        emb = decoding.embed_tokens(model.opt, cfg.opt, torch.from_numpy(ids))
    _close(emb, jopt.embed_tokens(params["opt"], jcfg.opt, jnp.asarray(ids, jnp.int32)))
    for gen_index in (0, 1, 9, 10, 17):
        np.testing.assert_array_equal(
            _np(decoding.face_phase_ids(torch.from_numpy(ids), gen_index, 9)),
            np.asarray(jopt.face_phase_ids(jnp.asarray(ids), gen_index, 9)))


def test_decode_faces_and_codes_match_jax(setup):
    jcfg, cfg, params, model, pc = setup
    rng = np.random.default_rng(5)
    nf = cfg.n_max_triangles
    raw = rng.integers(0, cfg.opt.vocab_size, size=(2, cfg.generate_length))
    raw[1, 20:] = 1   # an eos tail: masked faces come out NaN
    raw = raw.astype(np.int64)
    ids = ma.token_postprocess(cfg, torch.from_numpy(raw))
    jids = jma.token_postprocess(jcfg, jnp.asarray(raw, jnp.int32))
    np.testing.assert_array_equal(_np(ids), np.asarray(jids))
    with torch.no_grad():
        codes = ma.get_codes(model, cfg, ids)
        jcodes = jma.get_codes(params, jcfg, jids)
        _close(codes, jcodes)
        jpf = jper.encode_latents(params["perceiver"], jcfg.perceiver, jnp.asarray(pc))
        coords = nrd.decode_faces(model.nrd, cfg.nrd, ids, codes, torch.from_numpy(np.array(jpf)))
    jcoords = jnrd.decode_faces(params["nrd"], jcfg.nrd, jids, jcodes, jpf)
    assert coords.shape == (2, nf, 3, 3)
    assert np.isnan(_np(coords)[1]).any()
    np.testing.assert_array_equal(_np(coords), np.asarray(jcoords))


@pytest.mark.parametrize("k,p", [(5, 0.9), (50, 0.95), (1, 0.5), (0, 0.3), (20, 1.0)])
def test_sampling_filters_mask_like_jax(k, p):
    rng = np.random.default_rng(k)
    logits = (rng.normal(size=(4, 67)) * 3).astype(np.float32)
    logits[0, 7] = logits[0, 9] = logits[0].max() + 1   # a tie at the top
    tk = sampling.top_k_filter(torch.from_numpy(logits), k)
    jtk = jsampling.top_k_filter(jnp.asarray(logits), k)
    np.testing.assert_array_equal(np.isfinite(_np(tk)), np.isfinite(np.asarray(jtk)))
    tp = sampling.top_p_filter(tk, p)
    jtp = jsampling.top_p_filter(jtk, p)
    np.testing.assert_array_equal(np.isfinite(_np(tp)), np.isfinite(np.asarray(jtp)))
    greedy = sampling.sample_token(torch.from_numpy(logits), sampling=False)
    np.testing.assert_array_equal(_np(greedy), np.argmax(logits, -1))   # first max index
    g = torch.Generator().manual_seed(0)
    drawn = sampling.sample_token(torch.from_numpy(logits), sampling=True, top_k=k, top_p=p,
                                  generator=g)
    assert np.isfinite(_np(tp)[np.arange(4), _np(drawn)]).all()   # only kept tokens
