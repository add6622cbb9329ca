"""The fast tier's decode paths of the PyTorch port on the small config in
f32, on weights bridged from the JAX package: the quantized single-token
tiers, W8A8 weights and Jacobi lookahead against the port's own greedy
stream and against the JAX package (Pallas kernels in interpret mode),
token for token; the window controller; speculative sampling's law."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meshanything_tpu.config import small_test_config as jax_small_config
from meshanything_tpu.models import meshanything as jma
from meshanything_tpu.models import shape_opt as jsopt
from meshanything_tpu.models.lookahead import generate_lookahead as jax_generate_lookahead
from meshanything_tpu.ops import wquant as jwq
from meshanything_tpu_torch.config import small_test_config
from meshanything_tpu_torch.models import decoding
from meshanything_tpu_torch.models import lookahead as la
from meshanything_tpu_torch.models import shape_opt as opt
from meshanything_tpu_torch.ops import wquant as wq
from meshanything_tpu_torch.ops.sampling import top_k_filter, top_p_filter
from meshanything_tpu_torch.runtime.checkpoint import params_from_jax_numpy

BUCKET = 16
MAX_NEW = 21            # not a multiple of any window below
TIERS = ("pallas", "pallas_int8", "pallas_int4")
# token 54's lm_head column copied into eos's: a row stops where it would
# emit 54 (the lower index wins argmax ties): at these inputs row 0 stops
# (at step 6; at 19 in the int4 tier) and row 1 runs to the budget
EOS_AS_TOKEN = 54


@pytest.fixture(scope="module")
def bridged():
    jcfg = jax_small_config(n_max_triangles=4)
    tree = jax.tree_util.tree_map(np.array, jma.init_meshanything_params(jax.random.PRNGKey(42),
                                                                         jcfg))
    tree["opt"]["lm_head"]["w"][:, 1] = tree["opt"]["lm_head"]["w"][:, EOS_AS_TOKEN]
    cfg = small_test_config(n_max_triangles=4)
    rng = np.random.default_rng(0)
    cond = (rng.normal(size=(2, cfg.opt.cond_length, cfg.opt.hidden_size)) * 10).astype(np.float32)
    model = params_from_jax_numpy(tree, cfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree["opt"])
    return jcfg.opt, jparams, cfg.opt, model.opt, cond


@pytest.fixture(scope="module")
def plain_streams(bridged):
    """The port's single-token greedy stream of each tier."""
    _, _, cfg, p, cond = bridged
    with torch.no_grad():
        return {attn: decoding.generate(p, cfg, torch.from_numpy(cond), max_new_tokens=MAX_NEW,
                                        bucket=BUCKET, attn=attn).numpy() for attn in TIERS}


def assert_same_stream(got, want):
    """Equal through each row's first eos: past it the single-token loop
    writes pad and the window loop leaves the eos fill, in both packages."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for row in range(len(want)):
        eos = np.flatnonzero(want[row] == 1)
        limit = eos[0] + 1 if len(eos) else want.shape[1]
        np.testing.assert_array_equal(got[row, :limit], want[row, :limit], err_msg=f"row={row}")


def _lookahead(bridged, window, attn, **kw):
    _, _, cfg, p, cond = bridged
    with torch.no_grad():
        return la.generate_lookahead(p, cfg, torch.from_numpy(cond), max_new_tokens=MAX_NEW,
                                     window=window, bucket=BUCKET, attn=attn, **kw)


def test_the_rows_diverge_and_freeze(plain_streams):
    """The construction the tests below rely on: one row stops early, so
    it stays frozen while the other runs to the budget."""
    for attn in TIERS:
        stops = [list(r).index(1) if 1 in r else None for r in plain_streams[attn]]
        assert stops[0] is not None and stops[0] < MAX_NEW - 1 and stops[1] is None, (attn, stops)


@pytest.mark.parametrize("window", [2, 4, 8])
@pytest.mark.parametrize("attn", TIERS)
def test_lookahead_matches_the_ports_single_token_stream(bridged, plain_streams, attn, window):
    tokens, stats = _lookahead(bridged, window, attn, return_stats=True)
    assert_same_stream(tokens, plain_streams[attn])
    stop = list(tokens[0]).index(1)
    assert bool((tokens[0, stop:] == 1).all())          # the frozen row keeps its eos fill
    assert 0 < stats["iterations"] < MAX_NEW
    assert stats["emitted"].tolist() == [stop + 1, MAX_NEW]


@pytest.mark.parametrize("attn", TIERS)
def test_lookahead_matches_jax(bridged, attn):
    jcfg, jparams, *_ , cond = bridged
    want = jax_generate_lookahead(jparams, jcfg, jnp.asarray(cond), max_new_tokens=MAX_NEW,
                                  window=4, bucket=BUCKET, attn=attn)
    np.testing.assert_array_equal(_lookahead(bridged, 4, attn).numpy(), np.asarray(want))


@pytest.mark.parametrize("attn", ["pallas_int8", "pallas_int4"])
def test_quantized_single_token_matches_jax(bridged, plain_streams, attn):
    jcfg, jparams, *_, cond = bridged
    want = jsopt.generate(jparams, jcfg, jnp.asarray(cond), max_new_tokens=MAX_NEW, bucket=BUCKET,
                          attn=attn)
    np.testing.assert_array_equal(plain_streams[attn], np.asarray(want))


def test_wq_matches_jax(bridged):
    jcfg, jparams, cfg, p, cond = bridged
    want = jsopt.generate(jparams, jcfg, jnp.asarray(cond), max_new_tokens=MAX_NEW, bucket=BUCKET,
                          attn="pallas", wq=True)
    with torch.no_grad():
        got = decoding.generate(p, cfg, torch.from_numpy(cond), max_new_tokens=MAX_NEW,
                                bucket=BUCKET, attn="pallas", wq=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the window forwards on the same int8 weights give the same stream
    assert_same_stream(_lookahead(bridged, 4, "pallas", wq=True), got)


def test_resize_window_round_trips(bridged):
    _, _, cfg, p, cond = bridged
    with torch.no_grad():
        st = la.init_lookahead_state(p, cfg, torch.from_numpy(cond), max_new_tokens=MAX_NEW,
                                     window=4, bucket=BUCKET, buf_window=8)
        st = la.lookahead_segment(p, cfg, st, max_new_tokens=MAX_NEW, until_iters=2)
    assert st.iters == 2
    wide = la.resize_window(st, 8)
    np.testing.assert_array_equal(wide.window[:, :4].numpy(), st.window.numpy())
    assert bool((wide.window[:, 4:] == 0).all())
    back = la.resize_window(wide, 4)
    np.testing.assert_array_equal(back.window.numpy(), st.window.numpy())
    assert back.steps is st.steps and back.tokens is st.tokens and back.kv is st.kv
    assert la.resize_window(st, 4) is st


def test_adaptive_controller_gives_the_fixed_windows_tokens(bridged, plain_streams):
    _, _, cfg, p, cond = bridged
    trace = []

    def seg(state, until, window):
        assert state.window.shape[1] == window
        return la.lookahead_segment(p, cfg, state, max_new_tokens=MAX_NEW, until_iters=until)

    with torch.no_grad():
        st = la.init_lookahead_state(p, cfg, torch.from_numpy(cond), max_new_tokens=MAX_NEW,
                                     window=2, bucket=BUCKET, buf_window=4)
        st = la.run_adaptive_controller(st, seg, windows=(2, 4), check_iters=2,
                                        max_new_tokens=MAX_NEW, trace=trace)
    assert_same_stream(st.tokens[:, :MAX_NEW], plain_streams["pallas"])
    assert trace and {w for _, w, _ in trace} <= {2, 4}
    assert [it for it, _, _ in trace] == sorted(it for it, _, _ in trace)


@pytest.mark.parametrize("m", [1, 8, 17])
def test_linear_w8a8_matches_jax(m):
    rng = np.random.default_rng(m)
    w = rng.normal(size=(96, 64)).astype(np.float32)            # (in, out) as JAX keeps it
    x = rng.normal(size=(m, 96)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    jq, js = jwq.quantize_weight(jnp.asarray(w))
    q, s = wq.quantize_weight(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    got = wq.linear_w8a8(torch.from_numpy(x), q, s, torch.from_numpy(b))
    want = jwq.linear_w8a8(jnp.asarray(x), jq, js, jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_speculative_accept_preserves_distribution():
    """Per position, P(emit = x) is the warped target p(x): accept the
    draft w.p. p(g), else draw from p without g renormalized (the law
    tests/test_lookahead.py checks for the JAX package)."""
    rng = np.random.default_rng(0)
    v, w, top_k, top_p = 12, 3, 8, 0.9
    logits = torch.from_numpy(rng.normal(size=(1, w, v)).astype(np.float32) * 1.5)
    probs = torch.softmax(top_p_filter(top_k_filter(logits, top_k), top_p), dim=-1)[0].numpy()
    g1 = int(np.argsort(probs[0])[-2])
    n = 20000
    window = torch.tensor([[5, g1, 3]]).expand(n, w)
    emitted, n_acc = la._speculative_accept(torch.Generator().manual_seed(0),
                                            logits.expand(n, w, v), window, top_k, top_p)
    emitted, n_acc = emitted.numpy(), n_acc.numpy()
    np.testing.assert_allclose(np.bincount(emitted[:, 0], minlength=v) / n, probs[0], atol=0.02)
    sel = n_acc >= 1
    assert sel.sum() > 2000
    np.testing.assert_allclose(np.bincount(emitted[sel, 1], minlength=v) / sel.sum(), probs[1],
                               atol=0.03)


def test_sampling_lookahead_runs_and_freezes(bridged):
    """Speculative sampling through the window loop: valid ids, and a row
    that emitted eos stays eos."""
    _, _, cfg, p, cond = bridged
    tokens = _lookahead(bridged, 4, "pallas_int8", sampling=True,
                        generator=torch.Generator().manual_seed(1)).numpy()
    assert tokens.shape == (2, MAX_NEW) and tokens.min() >= 0 and tokens.max() < cfg.vocab_size
    for row in tokens:
        if cfg.eos_token_id in row:
            stop = list(row).index(cfg.eos_token_id)
            assert set(row[stop:]) <= {cfg.eos_token_id}
