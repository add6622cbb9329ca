"""The residual add and post-LayerNorm kernel (``ops/add_layer_norm.py``,
``csrc/add_layer_norm.cu``): its plain version is the layer's
``ln(x + y, m)`` bit for bit; the decode step and the window forward go
through the wrapper and the prefill and the trainer's pass do not; and,
where a card is present, the kernel against its plain version, replayed
from a CUDA graph, refusing what it does not take and counting its
launches. Imports nothing of JAX, so the card cases run without it."""
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from meshanything_tpu_torch.config import small_test_config
from meshanything_tpu_torch.models import decoding
from meshanything_tpu_torch.models import lookahead as la
from meshanything_tpu_torch.models import shape_opt as opt
from meshanything_tpu_torch.ops.add_layer_norm import add_layer_norm, add_layer_norm_reference
from meshanything_tpu_torch.runtime import profiling
from meshanything_tpu_torch.runtime.checkpoint import randomize_

SHAPES = [(1, 1024), (16, 1024), (2, 3, 64)]
DTYPES = [torch.float32, torch.bfloat16]
# The kernel and PyTorch's layer norm sum a row in another order (two
# passes over registers against Welford), so their f32 statistics differ
# in the last bits: an f32 output moves by a few ulp of the row's largest
# element; a bf16 output by at most one ulp, and rarely.
F32_ROW_RTOL = 2e-6
BF16_SAME_MIN = 0.99


def _inputs(shape, dtype, seed=0, device="cpu"):
    """x, y of ``shape`` and a LayerNorm over the last dim with random
    weight and bias, all in ``dtype``, made on the CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    d = shape[-1]
    x = torch.randn(shape, generator=gen) * 2.0 + 0.5
    y = torch.randn(shape, generator=gen)
    m = nn.LayerNorm(d, eps=1e-5)
    with torch.no_grad():
        m.weight.copy_(1.0 + 0.1 * torch.randn(d, generator=gen))
        m.bias.copy_(0.1 * torch.randn(d, generator=gen))
    m = m.to(device=device, dtype=dtype).requires_grad_(False)
    return x.to(device=device, dtype=dtype), y.to(device=device, dtype=dtype), m


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_version_is_the_layers_expression(shape, dtype):
    """On the CPU the wrapper is ``ln(x + y, m)`` as the layer wrote it
    before the kernel: the sum rounded to the dtype, the statistics in f32,
    one rounding back; and a CPU call is no launch."""
    x, y, m = _inputs(shape, dtype)
    want = F.layer_norm((x + y).float(), (shape[-1],), m.weight.float(), m.bias.float(),
                        m.eps).to(dtype)
    before = add_layer_norm.launches
    got = add_layer_norm(x, y, m)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, want)
    assert torch.equal(add_layer_norm_reference(x, y, m), want)
    assert add_layer_norm.launches == before


# ---------------------------------------------------------------------------
# routing


@pytest.fixture(scope="module")
def small():
    cfg = small_test_config(n_max_triangles=4).opt
    gen = torch.Generator().manual_seed(3)
    p = randomize_(opt.ShapeOPT(cfg, dtype=torch.float32), gen)
    cond = torch.randn((2, cfg.cond_length, cfg.hidden_size), generator=gen)
    tokens = torch.randint(3, cfg.vocab_size, (2, 6), generator=gen)
    return cfg, p, cond, tokens


def _step(cfg, p, cond, tokens):
    state = opt.init_decode_state(p, cfg, cond, max_new_tokens=12, bucket=16)
    return lambda: opt.step_body(p, cfg, state)


def _window(cfg, p, cond, tokens):
    state = la.init_lookahead_state(p, cfg, cond, max_new_tokens=12, window=4, bucket=16)
    return lambda: la._window_step(p, cfg, state, max_new_tokens=12)


def _prefill(cfg, p, cond, tokens):
    kv = torch.zeros((2, cfg.num_layers, 2, 32, cfg.hidden_size))
    return lambda: opt.prefill(p, cfg, cond, kv)


def _forward_full(cfg, p, cond, tokens):
    def run():
        with torch.enable_grad():
            p.zero_grad(set_to_none=True)
            opt.forward_full(p, cfg, cond, tokens).logsumexp(-1).mean().backward()
        grads = [q.grad for q in p.layers.parameters()]
        assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads)
        assert any(bool(g.abs().sum() > 0) for g in grads)
    return run


@pytest.mark.parametrize("path,calls_a_layer", [(_step, 2), (_window, 2), (_prefill, 0),
                                                (_forward_full, 0)])
def test_decode_steps_route_through_the_wrapper(small, monkeypatch, path, calls_a_layer):
    """One decode step and one window forward reach the wrapper twice a
    layer; the prefill and ``forward_full`` never do, and ``forward_full``
    still back-propagates into every layer."""
    cfg, p, cond, tokens = small
    calls = []

    def spy(x, y, m):
        calls.append(m)
        return add_layer_norm(x, y, m)

    with torch.no_grad():
        run = path(cfg, p, cond, tokens)     # the states' own prefills are not counted
    monkeypatch.setattr(opt, "add_layer_norm", spy)
    monkeypatch.setattr(la, "add_layer_norm", spy)
    with torch.no_grad():
        run()
    assert len(calls) == calls_a_layer * cfg.num_layers
    norms = [norm for layer in p.layers for norm in (layer.ln_attn, layer.ln_ffn)]
    assert all(a is b for a, b in zip(calls, norms))


@pytest.mark.parametrize("path", [_step, _window])
def test_decode_steps_run_without_grad(small, monkeypatch, path):
    """A step or a window forward called with grad on, on parameters that
    require grad, reaches the wrapper with grad off: the kernel, which has
    no backward and refuses autograd, never sees such a call."""
    cfg, p, cond, tokens = small
    grad_on = []

    def spy(x, y, m):
        grad_on.append(torch.is_grad_enabled())
        return add_layer_norm(x, y, m)

    with torch.no_grad():
        run = path(cfg, p, cond, tokens)
    monkeypatch.setattr(opt, "add_layer_norm", spy)
    monkeypatch.setattr(la, "add_layer_norm", spy)
    assert all(q.requires_grad for q in p.parameters())
    with torch.enable_grad():
        run()
    assert grad_on == [False] * (2 * cfg.num_layers)


# ---------------------------------------------------------------------------
# on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |v| (f32): 2^(exponent - 8) of frexp's
    mantissa in [0.5, 1), the smallest normal's where v is 0."""
    _, exp = torch.frexp(v.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), exp - 8)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [*SHAPES, (16, 8, 1024)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_plain_on_the_card(shape, dtype):
    dev = _card()
    x, y, m = _inputs(shape, dtype, seed=11, device=dev)
    before = add_layer_norm.launches
    with torch.no_grad():
        got = add_layer_norm(x, y, m)
        want = add_layer_norm_reference(x, y, m)
    torch.cuda.synchronize()
    assert add_layer_norm.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        assert bool((diff <= _bf16_ulp(want)).all()), diff.max().item()
        assert (diff == 0).float().mean().item() >= BF16_SAME_MIN
    else:
        row = want.abs().amax(dim=-1, keepdim=True)
        assert bool((diff <= F32_ROW_RTOL * row).all()), (diff / row).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_graph_replay_equals_the_eager_call(dtype):
    dev = _card()
    x, y, m = _inputs((16, 1024), dtype, seed=12, device=dev)
    with torch.no_grad():
        eager = add_layer_norm(x, y, m)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            add_layer_norm(x, y, m)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = add_layer_norm.launches
        with torch.cuda.graph(graph, stream=side):
            out = add_layer_norm(x, y, m)
        assert add_layer_norm.launches == before + 1   # the capture; replays are not counted
        for _ in range(5):
            out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["4d", "dim", "too_wide", "shape", "dtype", "params_dtype",
                                  "contiguous", "aligned", "grad"])
def test_kernel_refuses_what_it_does_not_take(case):
    dev = _card()
    shape = {"4d": (1, 2, 3, 64), "dim": (2, 100), "too_wide": (1, 4104)}.get(case, (2, 64))
    x, y, m = _inputs(shape, torch.bfloat16, seed=13, device=dev)
    if case == "shape":
        y = y[:1]
    if case == "dtype":
        y = y.float()
    if case == "params_dtype":
        m = m.float()
    if case == "contiguous":
        x = torch.cat([x, x], dim=-1)[:, ::2]
    if case == "aligned":
        x = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view(x.shape)
    if case == "grad":
        m.weight.requires_grad_(True)
    before = add_layer_norm.launches
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        with torch.set_grad_enabled(case == "grad"):
            add_layer_norm(x, y, m)
    assert add_layer_norm.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["step", "window"])
def test_capture_span_counts_the_launches_on_the_card(monkeypatch, path):
    """The ``capture`` span's ``add_ln`` is the kernel's launches in the
    captured step or window forward: two a layer."""
    dev = _card()
    rec = profiling.Recorder(enabled=True)
    monkeypatch.setattr(profiling, "RECORDER", rec)
    cfg = small_test_config(n_max_triangles=4).opt
    gen = torch.Generator(device=dev).manual_seed(3)
    p = randomize_(opt.ShapeOPT(cfg, device=dev, dtype=torch.float32), gen)
    cond = torch.randn((1, cfg.cond_length, cfg.hidden_size), generator=gen, device=dev)
    with torch.no_grad():
        if path == "step":
            state = opt.init_decode_state(p, cfg, cond, max_new_tokens=12, bucket=16)
            state.done.zero_()          # a live row: the segment captures its step
            decoding.decode_segment(p, cfg, state, max_new_tokens=12, until=state.step + 3)
        else:
            state = la.init_lookahead_state(p, cfg, cond, max_new_tokens=12, window=4,
                                            bucket=16)
            state.done.zero_()
            la.lookahead_segment(p, cfg, state, max_new_tokens=12, until_iters=state.iters + 2)
    captures = [sp for sp in rec.spans() if sp.name == "capture"]
    assert [sp.attrs["add_ln"] for sp in captures] == [2 * cfg.num_layers]


def test_bf16_ulp_helper():
    """The card test's ulp: one step of bf16 at 1.0 is 2^-7, at 3.0 2^-6."""
    v = torch.tensor([1.0, 3.0, -0.75, 0.0])
    tiny = torch.finfo(torch.bfloat16).tiny
    want = torch.tensor([2.0 ** -7, 2.0 ** -6, 2.0 ** -8, tiny * 2.0 ** -7])
    assert torch.equal(_bf16_ulp(v), want)
