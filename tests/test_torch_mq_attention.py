"""K4 of the PyTorch port: the windowed multi-query plain version against
the JAX package's Pallas kernel (interpret mode, ``grouped=False``) over
f32, bf16, int8 and int4 caches, the wrapper's checks, and the kernel
itself where a card is present."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meshanything_tpu.ops import decode_attention as jda
from meshanything_tpu.ops import kvcache as jkv
from meshanything_tpu_torch.ops import kvcache as kvc
from meshanything_tpu_torch.ops.decode_attention import (
    WINDOW_TILE,
    decode_attention_int4,
    decode_attention_int8,
    decode_attention_mq,
    decode_attention_mq_reference,
    decode_attention_quant_reference,
    mq_kernel_for,
    split_bounds,
    window_split_plan,
)

B, H, D, S, L, CHUNK = 2, 4, 64, 256, 2, 128
BASES = (1, CHUNK - 1, CHUNK, 200)
# f32: the same math in another summation order; bf16: one rounding of
# the O(1) outputs to bf16, plus the bf16 rounding of P (quantized tiers),
# which the TPU kernel takes per chunk and the plain version once
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
QROWS = {"int8": (kvc.quantize_rows, jkv.quantize_rows),
         "int4": (kvc.quantize_rows_int4, jkv.quantize_rows_int4)}


def _bf16_round(x):
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _quantized_cache(rng, bits):
    """K/V rows made with numpy, quantized by the port (equal to JAX's:
    test_torch_fast_attention.py) -> values, scales as numpy arrays."""
    rows = (rng.normal(size=(2, L, B, S, H * D)) * 0.5).astype(np.float32)
    codes, scale = QROWS[bits][0](torch.from_numpy(rows))
    return codes.numpy(), np.ascontiguousarray(np.swapaxes(scale.numpy(), -1, -2))


def _q(rng, shape, dtype):
    q = rng.normal(size=shape).astype(np.float32)
    return _bf16_round(q) if dtype == "bfloat16" else q


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(getattr(torch, dtype)) if dtype else t


def _j(x, dtype=None):
    return jnp.asarray(x, getattr(jnp, dtype)) if dtype else jnp.asarray(x)


def _window_inputs(rng, kind, w, dtype):
    """Cache, window rows and their scales for one K4 call."""
    if kind in ("int8", "int4"):
        values, scales = _quantized_cache(rng, kind)
        rows = (rng.normal(size=(2, B, w, H * D)) * 0.5).astype(np.float32)
        codes, s = QROWS[kind][0](torch.from_numpy(rows))
        win = (codes[0].numpy(), codes[1].numpy())
        win_s = tuple(np.ascontiguousarray(np.swapaxes(s[i].numpy(), -1, -2)) for i in (0, 1))
        return values, scales, win, win_s
    kv = (rng.normal(size=(2, L, B, S, H * D)) * 0.5).astype(np.float32)
    rows = (rng.normal(size=(2, B, w, H * D)) * 0.5).astype(np.float32)
    if dtype == "bfloat16":
        kv, rows = _bf16_round(kv), _bf16_round(rows)
    return kv, None, (rows[0], rows[1]), None


def _port_mq(q, kv, scales, layer, base, win, win_s, dtype, cache_dtype):
    return decode_attention_mq(
        _t(q, dtype), _t(kv, cache_dtype), None if scales is None else _t(scales), layer,
        _t(base), _t(win[0], cache_dtype), _t(win[1], cache_dtype),
        *(None, None) if win_s is None else (_t(win_s[0]), _t(win_s[1])))


@pytest.mark.parametrize("w", [1, 4, 8])
@pytest.mark.parametrize("kind,dtype", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                        ("int8", "float32"), ("int8", "bfloat16"),
                                        ("int4", "float32"), ("int4", "bfloat16")])
def test_k4_plain_matches_jax_pallas(kind, dtype, w):
    rng = np.random.default_rng(w)
    kv, scales, win, win_s = _window_inputs(rng, kind, w, dtype)
    cache_dtype = dtype if kind in ("float32", "bfloat16") else None
    q = _q(rng, (B, w, H, D), dtype)
    for base_pair in (BASES[:2], BASES[2:]):
        base = np.array(base_pair, np.int32)
        got = _port_mq(q, kv, scales, 1, base, win, win_s, dtype, cache_dtype)
        assert got.shape == (B, w, H, D) and got.dtype == getattr(torch, dtype)
        jkv_ = _j(kv, cache_dtype)
        jwin = (_j(win[0], cache_dtype), _j(win[1], cache_dtype))
        if scales is None:
            want = jda.decode_attention_mq_impl(_j(q, dtype), jkv_, 1, _j(base), chunk=CHUNK,
                                                interpret=True, grouped=False, win_kv=jwin)
        else:
            impl = (jda.decode_attention_mq_int8_impl if kind == "int8"
                    else jda.decode_attention_mq_int4_impl)
            want = impl(_j(q, dtype), jkv_, _j(scales), 1, _j(base), chunk=CHUNK,
                        interpret=True, grouped=False, win_kv=jwin,
                        win_scales=(_j(win_s[0]), _j(win_s[1])))
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=TOL[dtype], rtol=TOL[dtype], err_msg=f"base={base}")


def test_k4_poisoned_rows_do_not_reach_output():
    """NaN cache rows past base[b], NaN in the other layer, NaN scales
    there and garbage codes: the output is unchanged."""
    rng = np.random.default_rng(3)
    base = np.array([5, 130], np.int32)
    for kind in ("float32", "int8", "int4"):
        kv, scales, win, win_s = _window_inputs(rng, kind, 4, "float32")
        cache_dtype = "float32" if kind == "float32" else None
        q = _q(rng, (B, 4, H, D), "float32")
        clean = _port_mq(q, kv, scales, 1, base, win, win_s, "float32", cache_dtype)
        for row, n in enumerate(base):
            if scales is None:
                kv[:, :, row, n:] = np.nan
            else:
                scales[:, :, row, :, n:] = np.nan
                kv[:, :, row, n:] = rng.integers(-100, 100, size=kv[:, :, row, n:].shape)
        if scales is None:
            kv[:, 0] = np.nan
        else:
            scales[:, 0] = np.nan
        got = _port_mq(q, kv, scales, 1, base, win, win_s, "float32", cache_dtype)
        np.testing.assert_array_equal(got.numpy(), clean.numpy(), err_msg=kind)


@pytest.mark.parametrize("case", ["window", "win_dtype", "scales_missing", "scales_extra",
                                  "mixed", "layer", "base_shape"])
def test_k4_wrapper_rejects_bad_arguments(case):
    q = torch.zeros(B, 4, H, D)
    kv = torch.zeros(2, L, B, S, H * D)
    base = torch.tensor([3, 4])
    wk = wv = torch.zeros(B, 4, H * D)
    scales = ks = vs = None
    layer, err = 0, ValueError
    if case == "window":
        q, wk, wv = torch.zeros(B, 17, H, D), torch.zeros(B, 17, H * D), torch.zeros(B, 17, H * D)
    elif case == "win_dtype":
        wk = wk.bfloat16()
    elif case == "scales_missing":
        kv = torch.zeros(2, L, B, S, H * D, dtype=torch.int8)
        wk = wv = torch.zeros(B, 4, H * D, dtype=torch.int8)
    elif case == "scales_extra":
        scales = torch.ones(2, L, B, 1, S)
    elif case == "mixed":
        q, err = q.bfloat16(), TypeError
    elif case == "layer":
        layer = L
    elif case == "base_shape":
        base = torch.tensor([3, 4, 5])
    with pytest.raises(err):
        decode_attention_mq(q, kv, scales, layer, base, wk, wv, ks, vs)


def test_cpu_calls_do_not_count_as_launches():
    rng = np.random.default_rng(2)
    values, scales = _quantized_cache(rng, "int8")
    q = _t(_q(rng, (B, H, D), "float32"))
    before = (decode_attention_int8.launches, decode_attention_int4.launches,
              decode_attention_mq.launches)
    decode_attention_int8(q, _t(values), _t(scales), 0, 9)
    decode_attention_quant_reference(q, _t(values), _t(scales), 0, 9)
    kv, _, win, _ = _window_inputs(rng, "float32", 2, "float32")
    decode_attention_mq(_t(_q(rng, (B, 2, H, D), "float32")), _t(kv), None, 0,
                        torch.tensor([3, 9]), _t(win[0]), _t(win[1]))
    assert (decode_attention_int8.launches, decode_attention_int4.launches,
            decode_attention_mq.launches) == before


@pytest.mark.parametrize("w", [1, 4, 8, 16])
def test_k4_two_bf16_terms_of_p_keep_the_f32_contract(w):
    """The tensor-core K4 feeds P to its P.V product as bf16 terms. On
    bf16-valued inputs held in f32 (so that outputs stay f32), the plain
    version with P replaced by two terms stays within 2e-5 of the JAX
    kernel (interpret mode), whose P is f32: what two terms leave out is
    below 2^-17 of p. One term (a bf16 P) misses that tolerance, which is
    why the kernel takes two products."""
    rng = np.random.default_rng(10 + w)
    kv, _, win, _ = _window_inputs(rng, "bfloat16", w, "bfloat16")
    q = _q(rng, (B, w, H, D), "bfloat16")
    base = np.array([CHUNK - 1, 200], np.int32)
    want = np.asarray(jda.decode_attention_mq_impl(
        _j(q), _j(kv), 1, _j(base), chunk=CHUNK, interpret=True, grouped=False,
        win_kv=(_j(win[0]), _j(win[1]))), np.float32)
    args = (_t(q), _t(kv), None, 1, _t(base), _t(win[0]), _t(win[1]))
    two = decode_attention_mq_reference(*args, p_terms=2).numpy()
    one = decode_attention_mq_reference(*args, p_terms=1).numpy()
    np.testing.assert_allclose(two, want, atol=2e-5, rtol=2e-5)
    assert np.abs(one - want).max() > 2e-5
    full = decode_attention_mq_reference(*args).numpy()
    assert np.abs(two - full).max() < np.abs(one - full).max() / 50


@pytest.mark.parametrize("batch,n_rows", [(1, 7672), (1, 7664), (1, 300), (1, 1), (2, 7672),
                                          (16, 7672), (16, 100), (200, 7672)])
def test_window_split_plan_covers_the_confirmed_rows(batch, n_rows):
    """The bf16 K4's grid, sized from the rows a base can reach (S - W):
    for any base[b] up to there the cache splits are whole tiles that
    cover [0, base[b]) once; with base at its end no split is empty; with
    the window's block about one block an SM, and at B=1 over the whole
    cache one on every SM."""
    nsplit, group = window_split_plan(batch, n_rows, num_sms=132)
    assert nsplit >= 1 and 1 <= group <= nsplit + 1
    assert batch * (nsplit + 1) <= max(132 + batch, 2 * batch)
    for base in {n_rows, max(1, n_rows // 2), max(1, n_rows - 17), 1}:
        bounds = split_bounds(base, WINDOW_TILE, nsplit)
        live = [(r0, r1) for r0, r1 in bounds if r1 > r0]
        assert live[0][0] == 0 and live[-1][1] == base
        assert all(r0 % WINDOW_TILE == 0 for r0, _ in live)
        assert all(a[1] == b[0] for a, b in zip(live, live[1:]))
        if base == n_rows:
            assert len(live) == nsplit
    if (batch, n_rows) == (1, 7672):
        assert nsplit + 1 >= 132


@pytest.mark.parametrize("dtype,head_dim,want", [
    (torch.bfloat16, 64, "window"), (torch.bfloat16, 8, "tile_split"),
    (torch.float32, 64, "tile_split"), (torch.float32, 8, "tile_split"),
    (torch.int8, 64, "tile_split"), (torch.int32, 64, "tile_split"),
    (torch.float16, 64, TypeError), (torch.int64, 8, TypeError),
    (torch.bfloat16, 32, ValueError), (torch.int8, 128, ValueError)])
def test_k4_kernel_dispatch_table(dtype, head_dim, want):
    """(cache dtype, head width) -> kernel; what neither kernel is built
    for raises instead of trying one and falling back to the other."""
    if isinstance(want, str):
        assert mq_kernel_for(dtype, head_dim) == want
    else:
        with pytest.raises(want):
            mq_kernel_for(dtype, head_dim)


def test_k4_row_bound_does_not_change_the_cpu_result():
    """The plain version's ``n_rows`` only spares it a read of ``base``:
    any bound from max(base) up gives the same result, and the wrapper on
    the CPU gives it too. (The card's grid is sized from the cache's
    length: the wrapper takes no bound.)"""
    rng = np.random.default_rng(6)
    kv, _, win, _ = _window_inputs(rng, "float32", 4, "float32")
    q = _t(_q(rng, (B, 4, H, D), "float32"))
    args = (q, _t(kv), None, 1, torch.tensor([7, 150], dtype=torch.int32), _t(win[0]), _t(win[1]))
    want = decode_attention_mq(*args)
    for n_rows in (150, 151, S - 4, S):
        np.testing.assert_allclose(      # masked rows add zeros: at most another summation order
            decode_attention_mq_reference(*args, n_rows=n_rows).numpy(), want.numpy(),
            atol=1e-6, rtol=1e-6)
    with pytest.raises(TypeError):
        decode_attention_mq(*args, n_rows=150)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("kind,dtype", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                        ("int8", "bfloat16"), ("int4", "bfloat16")])
def test_k4_kernel_matches_plain_on_the_card(kind, dtype):
    _needs_card()
    rng = np.random.default_rng(5)
    cache_dtype = dtype if kind in ("float32", "bfloat16") else None
    for w in (1, 4, 8, 16):
        kv, scales, win, win_s = _window_inputs(rng, kind, w, dtype)
        q = _q(rng, (B, w, H, D), dtype)
        args = (_t(q, dtype).cuda(), _t(kv, cache_dtype).cuda(),
                None if scales is None else _t(scales).cuda(), 1,
                torch.tensor([1, 200]).cuda(), _t(win[0], cache_dtype).cuda(),
                _t(win[1], cache_dtype).cuda(),
                *((None, None) if win_s is None else (_t(win_s[0]).cuda(), _t(win_s[1]).cuda())))
        before = decode_attention_mq.launches
        got = decode_attention_mq(*args)
        torch.cuda.synchronize()
        assert decode_attention_mq.launches == before + 1
        want = decode_attention_mq_reference(*args)
        torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
