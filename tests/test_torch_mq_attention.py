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
    decode_attention_int4,
    decode_attention_int8,
    decode_attention_mq,
    decode_attention_mq_reference,
    decode_attention_quant_reference,
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
