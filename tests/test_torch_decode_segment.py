"""The device-resident decode segment of the PyTorch port: ``decode_segment``
and ``lookahead_segment`` against the JAX package's (Pallas kernels in
interpret mode) over schedules of segment bounds, on the small config in
f32 with weights bridged from the JAX package; the plain versions of K1-K3
called with a device length; the kernels' live split plan; the replay path
of the segment for both decoder families, with a stand-in for the graph;
and, where a card is present, CUDA-graph replays against the eager loop."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meshanything_tpu.config import small_test_config as jax_small_config
from meshanything_tpu.models import lookahead as jla
from meshanything_tpu.models import meshanything as jma
from meshanything_tpu.models import shape_opt as jsopt
from meshanything_tpu_torch.config import small_moonlight_config, small_test_config
from meshanything_tpu_torch.models import decoding
from meshanything_tpu_torch.models import lookahead as la
from meshanything_tpu_torch.models import moonlight as moon
from meshanything_tpu_torch.models import shape_opt as opt
from meshanything_tpu_torch.ops import kvcache as kvc
from meshanything_tpu_torch.ops.decode_attention import (
    K1_TILE,
    QUANT_TILE,
    decode_attention,
    decode_attention_int4,
    decode_attention_int8,
    decode_attention_quant_reference,
    decode_attention_reference,
    fold_group,
    split_bounds,
    split_plan,
)
from meshanything_tpu_torch.runtime.checkpoint import params_from_jax_numpy, randomize_

BUCKET = 16
# token 21's lm_head column copied into eos's: a row stops where it would
# emit 21 (the lower index wins argmax ties). At these inputs row 1 stops
# at step 14 and row 0 at 23 of 38, so the loop exits early, at step 24.
EOS_AS_TOKEN = 21
STOPS = [23, 14]
UNTIL = (5, 17, None)          # segment bounds: before, between and after the stops


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
    return jcfg, jparams, cfg, model.opt, cond


def _jax_segments(bridged, early_exit):
    """JAX's decode_segment over UNTIL -> [(tokens, done, step)] a segment."""
    jcfg, jparams, cfg, _, cond = bridged
    gl = cfg.generate_length
    s_max = -(-(cfg.opt.cond_length + gl) // BUCKET) * BUCKET
    seg = jax.jit(functools.partial(jsopt.decode_segment, cfg=jcfg.opt, s_max=s_max,
                                    max_new_tokens=gl, early_exit=early_exit, attn="pallas",
                                    bucket=BUCKET, interpret=True))
    state = jsopt.init_decode_state(jparams, jcfg.opt, jnp.asarray(cond), max_new_tokens=gl,
                                    bucket=BUCKET, attn="pallas")
    out = []
    for until in UNTIL:
        state = seg(jparams, state=state, until=jnp.asarray(gl if until is None else until,
                                                            jnp.int32))
        out.append((np.asarray(state.tokens), np.asarray(state.done), int(state.step)))
    return out


@pytest.mark.parametrize("early_exit", [True, False])
def test_decode_segment_matches_jax(bridged, early_exit):
    """Tokens, done flags and step equal after every segment; with early
    exit the step ends where JAX's while_loop ends (the step after the
    last row's eos), not past it."""
    _, _, cfg, p, cond = bridged
    gl = cfg.generate_length
    want = _jax_segments(bridged, early_exit)
    with torch.no_grad():
        state = opt.init_decode_state(p, cfg.opt, torch.from_numpy(cond), max_new_tokens=gl,
                                      bucket=BUCKET)
        for until, (tokens, done, step) in zip(UNTIL, want):
            state = decoding.decode_segment(p, cfg.opt, state, max_new_tokens=gl, until=until,
                                            early_exit=early_exit)
            np.testing.assert_array_equal(state.tokens.numpy(), tokens, err_msg=f"until={until}")
            np.testing.assert_array_equal(state.done.numpy(), done)
            assert state.step == int(state.step_t) == step, (until, state.step, step)
    assert [list(r).index(1) for r in want[-1][0]] == STOPS   # the construction
    assert want[-1][2] == (max(STOPS) + 1 if early_exit else gl)
    if not early_exit:        # finished rows emit pad to the end
        assert (want[-1][0][1, STOPS[1] + 1:] == cfg.opt.pad_token_id).all()


@pytest.mark.parametrize("sync_every", [1, 7, 64])
def test_decode_loop_steps_end_where_jax_ends(bridged, sync_every):
    """The repair of the step count: whatever the host's read interval, the
    loop's step is JAX's, and the no-op steps past it change nothing."""
    _, _, cfg, p, cond = bridged
    gl = cfg.generate_length
    want = _jax_segments(bridged, True)[-1]
    with torch.no_grad():
        state = opt.init_decode_state(p, cfg.opt, torch.from_numpy(cond), max_new_tokens=gl,
                                      bucket=BUCKET)
        state = decoding.decode_loop(p, cfg.opt, state, max_new_tokens=gl, sync_every=sync_every)
        np.testing.assert_array_equal(state.tokens.numpy(), want[0])
        assert state.step == want[2] == max(STOPS) + 1
        # steps past the end are no-ops on every state tensor
        before = [t.clone() for t in (state.tokens, state.done, state.last_token, state.step_t)]
        for _ in range(3):
            opt.step_body(p, cfg.opt, state)
        after = (state.tokens, state.done, state.last_token, state.step_t)
        assert all(torch.equal(a, b) for a, b in zip(before, after))


def _jax_lookahead_segments(bridged, window, attn, schedule):
    jcfg, jparams, cfg, _, cond = bridged
    gl = cfg.generate_length
    s_max = -(-(cfg.opt.cond_length + gl + window) // BUCKET) * BUCKET
    seg = jax.jit(functools.partial(jla.lookahead_segment, cfg=jcfg.opt, s_max=s_max,
                                    max_new_tokens=gl, window=window, attn=attn, bucket=BUCKET,
                                    interpret=True))
    state = jla.init_lookahead_state(jparams, jcfg.opt, jnp.asarray(cond), max_new_tokens=gl,
                                     window=window, bucket=BUCKET, attn=attn)
    out = []
    for until in schedule:
        state = seg(jparams, state=state, until_iters=jnp.asarray(until, jnp.int32))
        out.append(tuple(np.asarray(x) for x in (state.tokens, state.steps, state.done,
                                                  state.iters)))
    return out


@pytest.mark.parametrize("window", [4, 8])
@pytest.mark.parametrize("attn", ["pallas", "pallas_int8"])
def test_lookahead_segment_matches_jax(bridged, window, attn):
    """Tokens, steps, done flags and iterations equal after every segment
    of an until_iters schedule whose last bound lies past the end: a
    forward with no live row counts no iteration."""
    _, _, cfg, p, cond = bridged
    gl = cfg.generate_length
    schedule = (2, 5, 4 * gl)
    want = _jax_lookahead_segments(bridged, window, attn, schedule)
    with torch.no_grad():
        state = la.init_lookahead_state(p, cfg.opt, torch.from_numpy(cond), max_new_tokens=gl,
                                        window=window, bucket=BUCKET, attn=attn)
        for until, (tokens, steps, done, iters) in zip(schedule, want):
            state = la.lookahead_segment(p, cfg.opt, state, max_new_tokens=gl,
                                         until_iters=until)
            np.testing.assert_array_equal(state.tokens.numpy(), tokens, err_msg=f"until={until}")
            np.testing.assert_array_equal(state.steps.numpy(), steps)
            np.testing.assert_array_equal(state.done.numpy(), done)
            assert state.iters == int(state.iters_t) == int(iters), (until, state.iters, iters)
    assert bool(want[-1][2].all()) and int(want[-1][3]) < schedule[-1]   # ended by the flags
    # a forward with no live row changes nothing and counts nothing
    before = [t.clone() for t in (state.tokens, state.steps, state.done, state.window,
                                  state.iters_t)]
    with torch.no_grad():
        la._window_step(p, cfg.opt, state, max_new_tokens=gl)
    after = (state.tokens, state.steps, state.done, state.window, state.iters_t)
    assert all(torch.equal(a, b) for a, b in zip(before, after))


# ---------------------------------------------------------------------------
# K1-K3 with the length on the device

B, H, D, S, L = 2, 4, 64, 256, 2


def _cache(rng, kind):
    rows = (rng.normal(size=(2, L, B, S, H * D)) * 0.5).astype(np.float32)
    if kind == "float32":
        return torch.from_numpy(rows), None
    quantize = kvc.quantize_rows if kind == "int8" else kvc.quantize_rows_int4
    codes, scale = quantize(torch.from_numpy(rows))
    return codes, scale.transpose(-1, -2).contiguous()


@pytest.mark.parametrize("kind", ["float32", "int8", "int4"])
@pytest.mark.parametrize("cur_len", [1, 32, 33, S])
def test_plain_versions_with_a_device_length_equal_the_int_call(kind, cur_len):
    """The plain K1 (f32 cache), K2 (int8) and K3 (int4) called with a 0-d
    int32 length and max_len = S mask the rows past it and equal the call
    with an int length bit for bit, NaN in the masked rows included; the
    wrappers route a CPU tensor length to them."""
    rng = np.random.default_rng(cur_len)
    values, scales = _cache(rng, kind)
    if kind == "float32":
        values[:, :, :, cur_len:] = float("nan")
    else:
        scales[:, :, :, :, cur_len:] = float("nan")
    q = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32))
    length = torch.tensor(cur_len, dtype=torch.int32)
    for layer in range(L):
        if kind == "float32":
            by_int = decode_attention_reference(q, values, layer, cur_len)
            by_tensor = decode_attention_reference(q, values, layer, length, max_len=S)
            wrapped = decode_attention(q, values, layer, length)
        else:
            by_int = decode_attention_quant_reference(q, values, scales, layer, cur_len)
            by_tensor = decode_attention_quant_reference(q, values, scales, layer, length,
                                                         max_len=S)
            kernel = decode_attention_int8 if kind == "int8" else decode_attention_int4
            wrapped = kernel(q, values, scales, layer, length)
        assert torch.isfinite(by_int).all()
        assert torch.equal(by_tensor, by_int) and torch.equal(wrapped, by_int)


@pytest.mark.parametrize("case", ["shape", "dtype", "max_len", "int_past_max"])
def test_device_length_arguments_are_checked(case):
    q = torch.zeros(B, H, D)
    kv = torch.zeros(2, L, B, S, H * D)
    length, max_len = torch.tensor(5, dtype=torch.int32), None
    err = ValueError
    if case == "shape":
        length, err = torch.tensor([5], dtype=torch.int32), TypeError
    elif case == "dtype":
        length, err = torch.tensor(5), TypeError
    elif case == "max_len":
        max_len = S + 1
    elif case == "int_past_max":
        length, max_len = 9, 8
    with pytest.raises(err):
        decode_attention(q, kv, 0, length, max_len=max_len)


def _device_fold_group(nsplit: int) -> int:
    """split_fold.cuh's fold_group, step for step: a float square root
    corrected to the integer one."""
    if nsplit <= 24:
        return nsplit
    r = int(np.sqrt(np.float32(nsplit - 1)))
    while r * r > nsplit - 1:
        r -= 1
    while (r + 1) * (r + 1) <= nsplit - 1:
        r += 1
    return r + 1


def _live_plan(grid_nsplit: int, cur_len: int, tile: int) -> tuple:
    """split_fold.cuh's live plan, step for step: min(live tiles, the
    grid's splits), at least one, folded in groups of fold_group."""
    nsplit = max(1, min(-(-cur_len // tile), grid_nsplit))
    return nsplit, _device_fold_group(nsplit)


def test_device_fold_group_mirror_equals_fold_group():
    assert all(_device_fold_group(n) == fold_group(n) for n in range(1, 65536))


@pytest.mark.parametrize("batch", [1, 2, 16])
@pytest.mark.parametrize("tile", sorted({*K1_TILE.values(), QUANT_TILE}))
def test_live_plan_is_the_by_value_plan(batch, tile):
    """For every cur_len in [1, 2S] of a grid planned for 2S rows, the plan
    each block computes (split_fold::plan_for) is the plan
    of the call made for cur_len by value; its splits cover every live row,
    so the grid's surplus splits cover none; and the workspace sized for
    the grid holds its slots and counters."""
    s2, sms = 2 * 7680, 132
    grid, grid_group = split_plan(batch, s2, sms, tile)
    grid_slots, grid_groups = grid + -(-grid // grid_group), -(-grid // grid_group)
    for cur_len in range(1, s2 + 1):
        nsplit, group = _live_plan(grid, cur_len, tile)
        assert (nsplit, group) == split_plan(batch, cur_len, sms, tile), cur_len
        bounds = split_bounds(cur_len, tile, nsplit)
        assert bounds[0][0] == 0 and bounds[-1][1] == cur_len
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        ngroups = -(-nsplit // group)
        assert nsplit + ngroups <= grid_slots and ngroups <= grid_groups


# ---------------------------------------------------------------------------
# on the card


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"attn": "pallas_int8"}, {"wq": True},
                                {"lookahead": 4}, {"lookahead": 4, "attn": "pallas_int4"}])
def test_graph_replays_give_the_eager_tokens_on_the_card(bridged, kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode graphs and kernels have no CPU mode")
    from meshanything_tpu_torch.runtime import decode_graph

    _, _, cfg, p, cond = bridged
    gl = cfg.generate_length
    p = p.cuda()
    c = torch.from_numpy(cond).cuda()
    streams = {}
    with torch.no_grad():
        for graph in (True, False):
            captures = decode_graph.StepGraph.captures
            if "lookahead" in kw:
                state = la.init_lookahead_state(p, cfg.opt, c, max_new_tokens=gl,
                                                window=kw["lookahead"], bucket=BUCKET,
                                                attn=kw.get("attn", "pallas"))
                state = la.lookahead_segment(p, cfg.opt, state, max_new_tokens=gl, graph=graph)
                streams[graph] = (state.tokens.cpu(), state.iters)
            else:
                state = opt.init_decode_state(p, cfg.opt, c, max_new_tokens=gl, bucket=BUCKET,
                                              attn=kw.get("attn", "pallas"))
                state = decoding.decode_loop(p, cfg.opt, state, max_new_tokens=gl,
                                             wq=kw.get("wq", False), graph=graph)
                streams[graph] = (state.tokens.cpu(), state.step)
            assert decode_graph.StepGraph.captures == captures + graph
    assert torch.equal(streams[True][0], streams[False][0])
    assert streams[True][1] == streams[False][1]


# ---------------------------------------------------------------------------
# the replay path's control flow, with a stand-in for the CUDA graph


class _StandInGraph:
    """Runs the step where a CUDA graph would replay it: the warm-up call,
    then one call a replay (the capture itself runs nothing)."""
    captures = 0
    replays = 0

    def __init__(self, fn, device, *, generator=None, key=None, counters=None):
        fn()
        self.fn, self.key, self.capture_s, self.replayed = fn, key, 0.0, 0
        _StandInGraph.captures += 1

    def replay(self, n):
        for _ in range(n):
            self.fn()
        self.replayed += n
        _StandInGraph.replays += n


@pytest.fixture
def stand_in(monkeypatch):
    from meshanything_tpu_torch.runtime import decode_graph

    monkeypatch.setattr(decode_graph, "use_graph", lambda device, graph: graph)
    monkeypatch.setattr(decode_graph, "StepGraph", _StandInGraph)
    _StandInGraph.captures = _StandInGraph.replays = 0
    return _StandInGraph


def _moonlight_seeded():
    """(cfg, a small Moonlight decoder on seeded f32 weights, a condition)."""
    cfg = small_moonlight_config(n_max_triangles=4)
    gen = torch.Generator().manual_seed(4)
    p = randomize_(moon.MoonlightDecoder(cfg.opt, dtype=torch.float32), gen)
    cond = torch.randn((2, cfg.opt.cond_length, cfg.opt.hidden_size), generator=gen)
    return cfg, p, cond


# (sync_every, decoder family); OPT's cases keep the ids they had before the family
REPLAY_CASES = [pytest.param(5, "opt", id="5"), pytest.param(32, "opt", id="32"),
                pytest.param(5, "moonlight", id="moonlight-5"),
                pytest.param(32, "moonlight", id="moonlight-32")]


@pytest.mark.parametrize("sync_every,decoder", REPLAY_CASES)
def test_replayed_segments_give_the_eager_tokens(bridged, stand_in, sync_every, decoder):
    """One capture a request after one eager step; a segment replays its
    bound's count of steps; the replays past the last live step change
    nothing; the step count is the eager loop's (JAX's). For each decoder
    family through the one driver: OPT on the bridged weights, Moonlight
    on seeded ones."""
    if decoder == "opt":
        _, _, cfg, p, cond = bridged
        cond = torch.from_numpy(cond)
    else:
        cfg, p, cond = _moonlight_seeded()
    gl = cfg.generate_length
    runs = {}
    with torch.no_grad():
        for graph in (False, True):
            state = decoding.family(cfg).init_decode_state(p, cfg.opt, cond, max_new_tokens=gl,
                                                           bucket=BUCKET)
            runs[graph] = decoding.decode_loop(p, cfg.opt, state, max_new_tokens=gl,
                                               sync_every=sync_every, graph=graph)
    eager, replayed = runs[False], runs[True]
    assert torch.equal(replayed.tokens, eager.tokens) and replayed.step == eager.step
    assert stand_in.captures == 1 and replayed.graph.replayed == stand_in.replays
    segments = -(-(replayed.step - 1) // sync_every)      # the last one ends short: all done
    assert 1 + stand_in.replays == min(segments * sync_every, gl - 1)


def test_replayed_window_forwards_follow_the_adaptive_widths(bridged, stand_in, monkeypatch):
    """The window controller switches widths between segments: one capture
    a width, the window moved into the graph's tensor on a switch back,
    and the eager loop's tokens, steps and iterations."""
    _, _, cfg, p, cond = bridged
    gl = cfg.generate_length
    monkeypatch.setattr(la, "CHECK_EVERY", 3)
    runs = {}
    with torch.no_grad():
        for graph in (False, True):
            trace = []

            def seg(st, until, window, graph=graph):
                assert st.window.shape[1] == window
                return la.lookahead_segment(p, cfg.opt, st, max_new_tokens=gl,
                                            until_iters=until, graph=graph)

            st = la.init_lookahead_state(p, cfg.opt, torch.from_numpy(cond), max_new_tokens=gl,
                                         window=2, bucket=BUCKET, buf_window=4)
            st = la.run_adaptive_controller(st, seg, windows=(2, 4), check_iters=2,
                                            max_new_tokens=gl, trace=trace)
            runs[graph] = (st, trace)
    (eager, eager_trace), (replayed, trace) = runs[False], runs[True]
    assert torch.equal(replayed.tokens, eager.tokens)
    assert torch.equal(replayed.steps, eager.steps) and replayed.iters == eager.iters
    assert trace == eager_trace and {w for _, w, _ in trace} == {2, 4}
    assert set(replayed.graphs) == {2, 4} and stand_in.captures == 2
    widths = [w for _, w, _ in trace]      # a width taken again after a switch
    assert any(a == c != b for a, b, c in zip(widths, widths[1:], widths[2:]))
