"""The Moonlight decoder's three kernels on the card (``csrc/latent_attention.cu``,
``csrc/experts.cu``, ``csrc/router.cu``) against their plain versions
(``ops/latent_attention.py``, ``ops/experts.py``, ``ops/router.py``): at the
published widths, at an int and a device length, replayed from a CUDA graph
bit-equal to the eager call, deterministic, and counting their calls and the
experts' tokens; the router's ties going to the lower expert. The kernels
have no CPU mode, so every case skips without a card. Imports nothing of
JAX."""
import pytest
import torch

from meshanything_tpu_torch.ops.experts import routed_experts, routed_experts_reference
from meshanything_tpu_torch.ops.latent_attention import (
    latent_attention,
    latent_attention_reference,
)
from meshanything_tpu_torch.ops.router import route_reference, route_topk

H, LATENT, ROPE, S = 16, 512, 64, 7680
E, K, D, WIDTH = 64, 6, 2048, 1408
SCALE = 2.446                     # Moonlight's routed_scaling_factor
# R1's weights against the plain version's: a logit's f32 sum of 2,048
# products in another order than cuBLAS's moves a weight by a few 1e-7 of it
ROUTER_RTOL = 2e-6
# R1's ids equal the plain version's, in order, wherever the 6th and 7th
# choices lie further apart than this (rounding moves a choice by ~1e-7)
ROUTER_GAP = 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _latent_inputs(batch, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    cache = torch.randn(3, batch, S, LATENT + ROPE, generator=g, device=dev).bfloat16()
    q = (torch.randn(batch, H, LATENT + ROPE, generator=g, device=dev) * 0.05).bfloat16()
    return q, cache


def _graph(fn, dev):
    """(the eager result, a graph of ``fn`` captured on a side stream after
    a warm-up there, the tensor its replays write)."""
    eager = fn()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    return eager, graph, out


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2, 16])
@pytest.mark.parametrize("cur_len", [1, 31, 258, 3860, 7459])
def test_latent_kernel_matches_plain(batch, cur_len):
    """bf16 output within 1% of each head's largest plain element (one bf16
    rounding of the output, f32 sums in another order), over rows [0,
    cur_len) of layer 1 read as an int and as a device length; NaN past
    the live rows is never read."""
    dev = _card()
    q, cache = _latent_inputs(batch, dev)
    cache[1, :, cur_len:] = float("nan")
    scale = 192 ** -0.5
    want = latent_attention_reference(q, cache, 1, cur_len, scale=scale, latent=LATENT).float()
    before = latent_attention.launches
    for length in (cur_len, torch.tensor(cur_len, dtype=torch.int32, device=dev)):
        got = latent_attention(q, cache, 1, length, scale=scale, latent=LATENT).float()
        tol = 0.01 * want.abs().amax(dim=-1, keepdim=True)
        assert bool(((got - want).abs() <= tol).all()), (got - want).abs().max().item()
    assert latent_attention.launches == before + 2


@pytest.mark.cuda
def test_latent_kernel_replays_every_length_bit_equal():
    dev = _card()
    q, cache = _latent_inputs(1, dev, seed=1)
    length = torch.tensor(300, dtype=torch.int32, device=dev)

    def call():
        return latent_attention(q, cache, 2, length, scale=0.07, latent=LATENT)

    with torch.no_grad():
        _, graph, out = _graph(call, dev)
        for n in (300, 1, 4097, 7459):
            length.fill_(n)
            graph.replay()
            torch.cuda.synchronize(dev)
            assert torch.equal(out, latent_attention(q, cache, 2, n, scale=0.07, latent=LATENT))


def _expert_inputs(batch, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def w(*shape):
        return (torch.randn(*shape, generator=g, device=dev) * 0.02).bfloat16()

    x = torch.randn(batch, D, generator=g, device=dev).bfloat16()
    mats = (w(E, WIDTH, D), w(E, WIDTH, D), w(E, D, WIDTH))
    shared = (w(2 * WIDTH, D), w(2 * WIDTH, D), w(D, 2 * WIDTH))
    ids = torch.stack([torch.randperm(E, generator=g, device=dev)[:K] for _ in range(batch)])
    weights = torch.rand(batch, K, generator=g, device=dev)
    return x, ids, weights, mats, shared


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3])
def test_expert_kernel_matches_plain_and_counts(batch):
    """f32 output within 1e-3 of the row's largest plain element (f32 sums
    of 2,048 and 1,408 products in another order); the counter gains each
    chosen id once and the routing record takes the ids at the device
    position alone; a second call is bit-equal (no float atomics)."""
    dev = _card()
    x, ids, weights, mats, shared = _expert_inputs(batch, dev)
    counts = torch.zeros(26, E, dtype=torch.int32, device=dev)
    routes = torch.full((26, batch, S, K), -1, dtype=torch.int32, device=dev)
    pos = torch.tensor([S - 1], dtype=torch.int64, device=dev)
    before = routed_experts.launches
    got = routed_experts(x, ids, weights, *mats, shared=shared, counts=counts, layer=3,
                         routes=routes, pos=pos)
    again = routed_experts(x, ids, weights, *mats, shared=shared)
    want = routed_experts_reference(x, ids, weights, *mats, shared=shared)
    torch.cuda.synchronize(dev)
    assert routed_experts.launches == before + 2
    tol = 1e-3 * want.abs().amax(dim=-1, keepdim=True)
    assert bool(((got - want).abs() <= tol).all()), (got - want).abs().max().item()
    assert torch.equal(got, again)
    assert counts[3].tolist() == torch.bincount(ids.flatten(), minlength=E).tolist()
    assert counts.sum().item() == batch * K
    assert torch.equal(routes[3, :, S - 1], ids.int())
    assert int((routes != -1).sum()) == batch * K


@pytest.mark.cuda
def test_expert_kernel_replays_other_routings_bit_equal():
    dev = _card()
    x, ids, weights, mats, shared = _expert_inputs(1, dev, seed=2)

    def call():
        return routed_experts(x, ids, weights, *mats, shared=shared)

    with torch.no_grad():
        _, graph, out = _graph(call, dev)
        for seed in range(3):
            g = torch.Generator(device=dev).manual_seed(100 + seed)
            ids.copy_(torch.randperm(E, generator=g, device=dev)[:K][None])
            graph.replay()
            torch.cuda.synchronize(dev)
            assert torch.equal(out, call())


def _router_inputs(rows, dev, seed=0, d=D, experts=E):
    """h (rows, d) as an RMSNorm's output, the gate's weight (E, d) N(0,
    0.02) and its correction bias (E,) N(0, 0.05), as the benchmark draws
    them; bf16."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(rows, d, generator=g, device=dev).bfloat16()
    gate = (torch.randn(experts, d, generator=g, device=dev) * 0.02).bfloat16()
    bias = (torch.randn(experts, generator=g, device=dev) * 0.05).bfloat16()
    return h, gate, bias


# (rows, d, E, K, norm): Moonlight's router at 1, 3 and 16 rows; then a
# width past one pass of a lane's loads (d 2560: two, the second partial)
# with idle warps (40 experts) and no normalisation, and a narrower one
ROUTER_CASES = [(1, D, E, K, True), (3, D, E, K, True), (16, D, E, K, True),
                (3, 2560, 40, 4, False), (16, 1024, E, 8, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,experts,k,norm", ROUTER_CASES)
def test_router_kernel_matches_plain(rows, d, experts, k, norm):
    """The ids equal the plain version's, in order, on every row whose k-th
    and next choices lie over ROUTER_GAP apart, and the weights lie within
    ROUTER_RTOL of theirs there; one launch a call."""
    dev = _card()
    h, gate, bias = _router_inputs(rows, dev, seed=rows, d=d, experts=experts)
    before = route_topk.launches
    with torch.no_grad():
        ids, weights = route_topk(h, gate, bias, k, norm=norm, scale=SCALE)
        want_ids, want_w = route_reference(h, gate, bias, k, norm=norm, scale=SCALE)
    torch.cuda.synchronize(dev)
    assert route_topk.launches == before + 1
    assert ids.dtype == torch.int64 and weights.dtype == torch.float32
    top = (torch.sigmoid(h.float() @ gate.float().T) + bias.float()).topk(k + 1).values
    clear = (top[:, k - 1] - top[:, k]) > ROUTER_GAP
    assert bool(clear.any())
    assert torch.equal(ids[clear], want_ids[clear])
    err = (weights - want_w).abs()[clear] / want_w.abs()[clear]
    assert float(err.max()) <= ROUTER_RTOL, float(err.max())


@pytest.mark.cuda
def test_router_kernel_breaks_ties_towards_the_lower_expert():
    """Every expert's row and bias equal: every choice ties, so the ids are
    0 .. K-1 in order and the weights all equal. Two experts whose rows and
    biases are equal and lead the rest: the lower id comes first."""
    dev = _card()
    h, gate, bias = _router_inputs(2, dev, seed=5)
    with torch.no_grad():
        ids, weights = route_topk(h, gate[:1].expand(E, D).contiguous(),
                                  torch.zeros_like(bias), K, scale=SCALE)
        assert ids.tolist() == [list(range(K))] * 2
        assert torch.equal(weights, weights[:, :1].expand(2, K))
        pair = gate.clone()
        pair[41] = pair[9]
        lead = bias.clone()
        lead[9] = lead[41] = 1.0                      # over any other choice
        ids, _ = route_topk(h, pair, lead, K, scale=SCALE)
    assert ids[:, :2].tolist() == [[9, 41]] * 2


@pytest.mark.cuda
def test_router_kernel_replays_other_rows_bit_equal():
    dev = _card()
    h, gate, bias = _router_inputs(16, dev, seed=7)

    def call():
        return route_topk(h, gate, bias, K, scale=SCALE)

    with torch.no_grad():
        _, graph, (ids, weights) = _graph(call, dev)
        for seed in range(3):
            g = torch.Generator(device=dev).manual_seed(200 + seed)
            h.copy_(torch.randn(h.shape, generator=g, device=dev).bfloat16())
            graph.replay()
            torch.cuda.synchronize(dev)
            want_ids, want_w = call()
            assert torch.equal(ids, want_ids) and torch.equal(weights, want_w)
