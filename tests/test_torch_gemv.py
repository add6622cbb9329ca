"""The few-row product kernel (``ops/gemv.py``, ``csrc/gemv.cu``): its plain
version is ``F.linear`` (then ``F.relu``) bit for bit; the decode entry
(``gemv.lin``) sends a product to it on the rows, dtypes, contiguity,
in-features and grad alone; both decoders' steps call it once a layer
matrix, once for the codebook projection and once for lm_head, and the
``capture`` span counts those launches; a short greedy decode gives the
tokens it gave before the entry. Where a card is present: the kernel at
every shape the two decode steps run against an f32 reference (no further
off than cuBLAS), replayed from a CUDA graph, repeatable bit for bit,
refusing what it does not take, and the real capture span. Imports nothing
of JAX, so the card cases run without it."""
import dataclasses

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from meshanything_tpu_torch.config import small_moonlight_config, small_test_config
from meshanything_tpu_torch.models import decoding, layers
from meshanything_tpu_torch.models import lookahead as la
from meshanything_tpu_torch.models import moonlight as moon
from meshanything_tpu_torch.models import shape_opt as opt
from meshanything_tpu_torch.ops import gemv as gemv_op
from meshanything_tpu_torch.ops import wquant
from meshanything_tpu_torch.ops.add_layer_norm import add_layer_norm
from meshanything_tpu_torch.ops.gemv import gemv, gemv_reference, takes
from meshanything_tpu_torch.runtime import decode_graph, profiling
from meshanything_tpu_torch.runtime.checkpoint import randomize_

BF16 = torch.bfloat16
# (N, K, bias, relu) of every product the two decode steps run at the
# published widths: OPT-350M's qkv, out, fc1 (ReLU), fc2, lm_head and the
# codebook projection; Moonlight's q, latent (576 = 512 + 64), o, the dense
# MLP's gate, up and down, lm_head and codebook projection
OPT_SHAPES = [(3072, 1024, True, False), (1024, 1024, True, False), (4096, 1024, True, True),
              (1024, 4096, True, False), (8195, 1024, False, False)]
MOON_SHAPES = [(3072, 2048, False, False), (576, 2048, False, False),
               (2048, 2048, False, False), (11264, 2048, False, False),
               (2048, 11264, False, False), (8195, 2048, False, False),
               (2048, 1024, True, False)]
CARD_ROWS = (1, 2, 3, 8, 16)


def _inputs(rows, n, k, bias=True, seed=0, device="cpu", lead=()):
    """x (*lead, rows, k), weight (n, k) and bias (n,) or None, bf16, made
    on the CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((*lead, rows, k), generator=gen)
    w = torch.randn((n, k), generator=gen) * 0.02
    b = torch.randn((n,), generator=gen) * 0.1 if bias else None
    move = dict(device=device, dtype=BF16)
    return x.to(**move), w.to(**move), None if b is None else b.to(**move)


@pytest.mark.parametrize("rows,n,k,lead", [(1, 24, 64, ()), (3, 40, 32, ()), (16, 8, 96, ()),
                                           (4, 67, 32, (2,))])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("relu", [False, True])
def test_plain_version_is_f_linear(rows, n, k, lead, bias, relu):
    """On the CPU the wrapper is ``F.linear`` (then ``F.relu``) bit for
    bit, and a CPU call is no launch."""
    x, w, b = _inputs(rows, n, k, bias, lead=lead)
    want = F.linear(x, w, b)
    if relu:
        want = F.relu(want)
    before = gemv.launches
    got = gemv(x, w, b, relu)
    assert got.dtype == BF16 and got.shape == (*lead, rows, n)
    assert torch.equal(got, want)
    assert torch.equal(gemv_reference(x, w, b, relu), want)
    assert gemv.launches == before


# ---------------------------------------------------------------------------
# the decode entry's rule


def _linear(n, k, bias=True, dtype=BF16):
    m = nn.Linear(k, n, bias=bias)
    with torch.no_grad():
        m.weight.copy_(torch.randn(n, k, generator=torch.Generator().manual_seed(1)) * 0.02)
        if bias:
            m.bias.copy_(torch.randn(n, generator=torch.Generator().manual_seed(2)) * 0.1)
    return m.to(dtype).requires_grad_(False)


def _case(case):
    """(x, nn.Linear, whether the entry takes the kernel) for ``case``."""
    k, n, rows = 64, 24, 4
    m = _linear(n, k)
    x = torch.randn(rows, k, generator=torch.Generator().manual_seed(3)).to(BF16)
    if case == "one_row":
        x = x[:1]
    if case == "16_rows":
        x = x.repeat(4, 1)
    if case == "17_rows":
        x = torch.cat([x.repeat(4, 1), x[:1]])
    if case == "3d_16_rows":
        x = x.repeat(4, 1).reshape(2, 8, k)
    if case == "3d_18_rows":
        x = torch.cat([x, x[:2]]).repeat(3, 1).reshape(2, 9, k)
    if case == "f32":
        x, m = x.float(), m.float()
    if case == "bias_f32":
        m.bias = nn.Parameter(m.bias.float(), requires_grad=False)
    if case == "no_bias":
        m = _linear(n, k, bias=False)
    if case == "weight_view":
        m.weight = nn.Parameter(_linear(2 * n, k).weight.detach()[::2], requires_grad=False)
    if case == "k_not_8":
        m = _linear(n, k - 4)
        x = x[:, : k - 4]
    if case == "grad":
        m.weight.requires_grad_(True)
    takes_kernel = case in ("one_row", "16_rows", "3d_16_rows", "no_bias", "plain")
    return x, m, takes_kernel


CASES = ["plain", "one_row", "16_rows", "3d_16_rows", "no_bias", "17_rows", "3d_18_rows",
         "f32", "bias_f32", "weight_view", "k_not_8", "grad"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("relu", [False, True])
def test_entry_takes_the_kernel_on_what_the_call_shows(monkeypatch, case, relu):
    """1 to 16 rows, x, weight and bias bf16, a contiguous weight, K a
    multiple of 8 and no grad recorded go to ``gemv``; anything else to
    ``layers.linear``; either way the result is ``F.linear`` (then
    ``F.relu``) bit for bit."""
    x, m, want_kernel = _case(case)
    assert takes(x, m.weight, m.bias) == want_kernel
    calls = []

    def spy(*args, **kw):
        calls.append(args)
        return gemv_reference(*args, **kw)

    monkeypatch.setattr(gemv_op, "gemv", spy)
    with torch.set_grad_enabled(case == "grad"):
        got = gemv_op.lin(x, m, relu=relu)
        want = layers.linear(x, m.weight, m.bias)
    if relu:
        want = F.relu(want)
    assert len(calls) == int(want_kernel)
    assert torch.equal(got.detach(), want.detach())


def test_a_tensor_off_the_cpu_never_reaches_the_plain_version():
    """The plain version is the CPU's alone: a tensor on any other device
    goes to the kernel or raises (the meta device: raises)."""
    x, w, b = (t.to("meta") for t in _inputs(2, 8, 16))
    with pytest.raises(ValueError, match="cpu or cuda"):
        gemv(x, w, b)


def test_lin_dispatch_sends_linear_entries_to_the_entry():
    assert wquant.lin_dispatch(False) is gemv_op.lin
    x, m, _ = _case("plain")
    e = wquant.QuantizedLinear(*wquant.quantize_weight(m.weight), m.bias)
    y = wquant.lin_dispatch(True)(x, e, relu=True)
    assert torch.equal(y, F.relu(wquant.linear_w8a8(x, e.wq, e.scale, e.bias)))


# ---------------------------------------------------------------------------
# the decode steps


def _opt_small(dtype=BF16):
    cfg = small_test_config(n_max_triangles=4).opt
    gen = torch.Generator().manual_seed(3)
    p = randomize_(opt.ShapeOPT(cfg, dtype=dtype), gen)
    cond = torch.randn((1, cfg.cond_length, cfg.hidden_size), generator=gen).to(dtype)
    return cfg, p, cond


def _moon_small(dtype=BF16, card_latent=False):
    """A small Moonlight decoder; ``card_latent``: with the latent width
    (512 + 64) the latent kernel is built for."""
    cfg = small_moonlight_config(n_max_triangles=4).opt
    if card_latent:
        cfg = dataclasses.replace(cfg, kv_lora_rank=512, qk_rope_head_dim=64)
    gen = torch.Generator().manual_seed(4)
    p = randomize_(moon.MoonlightDecoder(cfg, dtype=dtype), gen)
    with torch.no_grad():
        for layer in p.layers:
            if hasattr(layer.mlp, "gate"):
                layer.mlp.gate.e_score_correction_bias.normal_(0.0, 0.05, generator=gen)
    cond = torch.randn((1, cfg.cond_length, cfg.hidden_size), generator=gen).to(dtype)
    return cfg, p, cond


def _opt_step(cfg, p, cond, **kw):
    state = opt.init_decode_state(p, cfg, cond, max_new_tokens=12, bucket=16)
    return lambda: opt.step_body(p, cfg, state, **kw)


def _opt_wq_step(cfg, p, cond):
    return _opt_step(cfg, p, cond, wq_layers=opt.quantize_opt_layers(p.layers))


def _window(cfg, p, cond):
    state = la.init_lookahead_state(p, cfg, cond, max_new_tokens=12, window=4, bucket=16)
    return lambda: la._window_step(p, cfg, state, max_new_tokens=12)


def _moon_step(cfg, p, cond):
    state = moon.init_decode_state(p, cfg, cond, max_new_tokens=12, into=None)
    return lambda: moon.step_body(p, cfg, state, early_exit=False)


def _opt_prefill(cfg, p, cond):
    kv = torch.zeros((2, cfg.num_layers, 1, 32, cfg.hidden_size), dtype=cond.dtype)
    return lambda: opt.prefill(p, cfg, cond, kv)


def step_products(decoder: str, cfg) -> int:
    """The products of one step through the kernel: OPT's four matrices a
    layer, Moonlight's three projections a layer and the dense layers' three
    MLP matrices, and both decoders' codebook projection and lm_head."""
    if decoder == "opt":
        return 4 * cfg.num_layers + 2
    return 3 * cfg.num_layers + 3 * cfg.first_k_dense_replace + 2


def _spy(monkeypatch):
    """Count the kernel wrapper's calls (and take each as a launch, as the
    card's kernel would count it), computing the plain version."""
    real = gemv_op.gemv

    def spy(*args, **kw):
        spy.launches += 1
        spy.shapes.append(tuple(args[1].shape))
        return real(*args, **kw)

    spy.launches, spy.shapes = 0, []
    monkeypatch.setattr(gemv_op, "gemv", spy)
    return spy


@pytest.mark.parametrize("path,decoder,want", [
    (_opt_step, "opt", "all"), (_window, "opt", "all"), (_moon_step, "moonlight", "all"),
    (_opt_wq_step, "opt", 2), (_opt_prefill, "opt", 0)])
def test_decode_steps_run_their_products_through_the_kernel(monkeypatch, path, decoder, want):
    """A bf16 decode step (and a window forward of 4 rows) calls the kernel
    once a layer matrix, once for the codebook projection and once for
    lm_head; with W8A8 layer matrices only those two; the prefill never."""
    cfg, p, cond = _opt_small() if decoder == "opt" else _moon_small()
    with torch.no_grad():
        run = path(cfg, p, cond)     # the states' own prefills are not counted
    spy = _spy(monkeypatch)
    run()
    assert spy.launches == (step_products(decoder, cfg) if want == "all" else want)
    if want == "all" and decoder == "opt":
        d, f, v = cfg.hidden_size, cfg.ffn_dim, cfg.vocab_size
        layer = [(3 * d, d), (d, d), (f, d), (d, f)]
        assert spy.shapes == [(d, cfg.codebook_dim)] + layer * cfg.num_layers + [(v, d)]


def test_fc1_takes_its_relu_in_the_product(monkeypatch):
    """The decode step asks the product for fc1's ReLU (the kernel's
    epilogue), and for no other matrix's."""
    cfg, p, cond = _opt_small()
    with torch.no_grad():
        run = _opt_step(cfg, p, cond)
    relus = []
    real = gemv_op.gemv

    def spy(x, w, b=None, relu=False):
        relus.append((tuple(w.shape), relu))
        return real(x, w, b, relu)

    monkeypatch.setattr(gemv_op, "gemv", spy)
    run()
    f, d = cfg.ffn_dim, cfg.hidden_size
    assert [shape for shape, relu in relus if relu] == [(f, d)] * cfg.num_layers


class _NullStream:
    def wait_stream(self, other):
        pass


@pytest.mark.parametrize("decoder", ["opt", "moonlight"])
def test_capture_span_counts_the_steps_products(monkeypatch, decoder):
    """``StepGraph`` records, on its ``capture`` span, how far the kernel's
    launch count rose while it captured a step (``CAPTURE_COUNTERS``'s
    ``gemv``): one a product. The graph calls are stood in for on the CPU;
    the counting and the step are the real ones."""
    cfg, p, cond = _opt_small() if decoder == "opt" else _moon_small()
    module = opt if decoder == "opt" else moon
    with torch.no_grad():
        run = (_opt_step if decoder == "opt" else _moon_step)(cfg, p, cond)
    rec = profiling.Recorder(enabled=True)
    monkeypatch.setattr(profiling, "RECORDER", rec)
    _spy(monkeypatch)
    monkeypatch.setattr(decode_graph, "capture_stream", lambda device: _NullStream())
    for name, value in (("current_stream", lambda device=None: _NullStream()),
                        ("stream", lambda s: _Null()), ("CUDAGraph", _Null),
                        ("graph", lambda g, stream=None: _Null()),
                        ("synchronize", lambda device=None: None),
                        ("memory_reserved", lambda device=None: 0)):
        monkeypatch.setattr(torch.cuda, name, value)
    decode_graph.StepGraph(run, torch.device("cpu"), counters=module.CAPTURE_COUNTERS)
    captures = [sp for sp in rec.spans() if sp.name == "capture"]
    assert [sp.attrs["gemv"] for sp in captures] == [step_products(decoder, cfg)]


class _Null:
    def __init__(self, *args, **kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("decoder", ["opt", "moonlight"])
def test_greedy_tokens_are_the_ones_before_the_entry(monkeypatch, decoder):
    """A short bf16 greedy decode gives the same tokens through the entry
    as through ``layers.lin`` everywhere, the step's products before the
    kernel (fc1's ReLU after the product, lm_head and the codebook
    projection through ``lin``)."""
    cfg, p, cond = _opt_small() if decoder == "opt" else _moon_small()

    def decode():
        with torch.no_grad():
            if decoder == "opt":
                state = opt.init_decode_state(p, cfg, cond, max_new_tokens=10, bucket=16)
            else:
                state = moon.init_decode_state(p, cfg, cond, max_new_tokens=10, into=None)
            state = decoding.decode_loop(p, cfg, state, max_new_tokens=10, early_exit=False)
        return state.tokens.clone()

    spy = _spy(monkeypatch)
    through_entry = decode()
    assert spy.launches > 0
    monkeypatch.setattr(gemv_op, "lin", layers.lin)
    before = spy.launches
    assert torch.equal(decode(), through_entry)
    assert spy.launches == before


# ---------------------------------------------------------------------------
# on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _reference(x, w, b, relu):
    """The product in f32 on the card, full f32 (no TF32)."""
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        y = x.float() @ w.float().T + (0.0 if b is None else b.float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep
    return F.relu(y) if relu else y


@pytest.mark.cuda
@pytest.mark.parametrize("shape", OPT_SHAPES + MOON_SHAPES + [(5, 64, True, True),
                                                               (17, 40, True, False)])
def test_kernel_is_as_close_as_cublas_on_the_card(shape):
    """At every product of the two decode steps, 1, 2, 3, 8 and 16 rows,
    with and without the bias and the ReLU: the kernel's largest error
    against the f32 product is no larger than cuBLAS's (``F.linear``, then
    ``F.relu``); one launch a call."""
    dev = _card()
    n, k, bias, relu = shape
    for rows in CARD_ROWS:
        for use_bias in sorted({bias, False}):
            for use_relu in sorted({relu, False}):
                x, w, b = _inputs(rows, n, k, use_bias, seed=rows + 7 * n + k, device=dev)
                want = _reference(x, w, b, use_relu)
                library = gemv_reference(x, w, b, use_relu)
                before = gemv.launches
                with torch.no_grad():
                    got = gemv(x, w, b, use_relu)
                torch.cuda.synchronize()
                assert gemv.launches == before + 1
                assert got.dtype == BF16 and got.shape == (rows, n)
                err = (got.float() - want).abs().max().item()
                lib_err = (library.float() - want).abs().max().item()
                assert err <= lib_err, (shape, rows, use_bias, use_relu, err, lib_err)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 16])
def test_graph_replay_equals_the_eager_calls(rows):
    """A chain as the step runs it (qkv; out; the residual add and post-LN,
    which lets its dependents start; fc1 with its ReLU; fc2) captured in a
    CUDA graph replays bit-equal to the eager calls, and two eager runs are
    equal bit for bit."""
    dev = _card()
    d, f = 1024, 4096
    gen = torch.Generator().manual_seed(rows)
    mats = [_linear(n, k).to(dev) for n, k in ((3 * d, d), (d, d), (f, d), (d, f))]
    norm = nn.LayerNorm(d).to(device=dev, dtype=BF16).requires_grad_(False)
    x = torch.randn(rows, d, generator=gen).to(device=dev, dtype=BF16)

    def chain():
        qkv = gemv_op.lin(x, mats[0])
        h = add_layer_norm(x, gemv_op.lin(qkv[:, :d].contiguous(), mats[1]), norm)
        return gemv_op.lin(gemv_op.lin(h, mats[2], relu=True), mats[3])

    with torch.no_grad():
        eager = chain()
        assert torch.equal(chain(), eager)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            chain()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = gemv.launches
        with torch.cuda.graph(graph, stream=side):
            out = chain()
        assert gemv.launches == before + 4      # the capture; replays are not counted
        for _ in range(5):
            out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rows", "k", "dtype", "bias_dtype", "contiguous", "aligned",
                                  "grad", "shape"])
def test_kernel_refuses_what_it_does_not_take(case):
    dev = _card()
    rows = 17 if case == "rows" else 2
    k = 60 if case == "k" else 64
    x, w, b = _inputs(rows, 24, k, device=dev)
    if case == "dtype":
        x = x.float()
    if case == "bias_dtype":
        b = b.float()
    if case == "contiguous":
        w = torch.cat([w, w], dim=-1)[:, ::2]
    if case == "aligned":
        x = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view(x.shape)
    if case == "grad":
        w.requires_grad_(True)
    if case == "shape":
        b = b[:-1]
    before = gemv.launches
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        with torch.set_grad_enabled(case == "grad"):
            gemv(x, w, b)
    assert gemv.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("decoder", ["opt", "moonlight"])
def test_capture_span_counts_the_launches_on_the_card(monkeypatch, decoder):
    """The ``capture`` span's ``gemv`` is the kernel's launches in the
    captured step of a bf16 decoder: one a product."""
    dev = _card()
    rec = profiling.Recorder(enabled=True)
    monkeypatch.setattr(profiling, "RECORDER", rec)
    cfg, p, cond = _opt_small() if decoder == "opt" else _moon_small(card_latent=True)
    p, cond = p.to(dev), cond.to(dev)
    with torch.no_grad():
        if decoder == "opt":
            state = opt.init_decode_state(p, cfg, cond, max_new_tokens=12, bucket=16)
        else:
            state = moon.init_decode_state(p, cfg, cond, max_new_tokens=12, into=None)
        state.done.zero_()          # a live row: the segment captures its step
        decoding.decode_segment(p, cfg, state, max_new_tokens=12, until=state.step + 3)
    captures = [sp for sp in rec.spans() if sp.name == "capture"]
    assert [sp.attrs["gemv"] for sp in captures] == [step_products(decoder, cfg)]


def test_step_products_count_the_published_steps():
    """97 layer matrices and lm_head of OPT-350M's step and 85 of
    Moonlight's, each plus the codebook projection."""
    from meshanything_tpu_torch.config import MoonlightConfig, ShapeOPTConfig

    assert step_products("opt", ShapeOPTConfig()) == 98
    assert step_products("moonlight", MoonlightConfig()) == 86
