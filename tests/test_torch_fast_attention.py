"""K2 and K3 of the PyTorch port: the quantized caches' codecs and the
plain versions against the JAX package's Pallas kernels (interpret mode,
``pipelined=True``), the split plan, and the kernels themselves where a
card is present (K4: test_torch_mq_attention.py)."""
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
    decode_attention_quant_reference,
    fast_split_plan,
)

B, H, D, S, L, CHUNK = 2, 4, 64, 256, 2, 128
CUR_LENS = (1, CHUNK - 1, CHUNK, CHUNK + 1, S)
# f32: the same math in another summation order; bf16: one rounding of
# the O(1) outputs to bf16, plus the bf16 rounding of P, which the TPU
# kernel takes per chunk and the plain version once
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
QROWS = {"int8": (kvc.quantize_rows, jkv.quantize_rows),
         "int4": (kvc.quantize_rows_int4, jkv.quantize_rows_int4)}


def _bf16_round(x):
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _quantized_cache(rng, bits):
    """K/V rows made with numpy, quantized by the port (equal to JAX's:
    test_quantizers_match_jax) -> values, scales as numpy arrays."""
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


# ---------------------------------------------------------------------------
# quantizers


@pytest.mark.parametrize("hd", [32, 1024])
@pytest.mark.parametrize("bits", ["int8", "int4"])
def test_quantizers_match_jax(hd, bits):
    rng = np.random.default_rng(hd)
    rows = (rng.normal(size=(3, 5, hd)) * rng.uniform(0.01, 4.0, size=(3, 5, 1))).astype(np.float32)
    rows[1, 2] = 0.0                                     # the 1e-8 floor
    rows[0, 0, :4] = [0.5, -0.5, 1.5, 127.0]             # ties of the rounding
    mine, ref = QROWS[bits]
    codes, scale = mine(torch.from_numpy(rows))
    jcodes, jscale = ref(jnp.asarray(rows))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert codes.dtype == (torch.int8 if bits == "int8" else torch.int32)


def test_unpack_int4_round_trips():
    rng = np.random.default_rng(0)
    codes = rng.integers(-8, 8, size=(6, 1024)).astype(np.int32)
    n = 1024 // 8
    words = np.zeros((6, n), np.int64)
    for p in range(8):
        words |= (codes[:, p * n:(p + 1) * n].astype(np.int64) & 15) << (4 * p)
    words = np.where(words >= 2 ** 31, words - 2 ** 32, words).astype(np.int32)
    np.testing.assert_array_equal(kvc.unpack_int4(torch.from_numpy(words)).numpy(), codes)
    np.testing.assert_array_equal(np.asarray(jkv.unpack_int4(jnp.asarray(words))), codes)
    rows = rng.normal(size=(4, 32)).astype(np.float32)
    packed, scale = kvc.quantize_rows_int4(torch.from_numpy(rows))
    back = kvc.unpack_int4(packed).float() * scale
    np.testing.assert_allclose(back.numpy(), rows, atol=float(scale.max()) / 2 + 1e-7)


def test_quantized_cache_allocation():
    for attn, dtype, width in (("pallas_int8", torch.int8, 64), ("pallas_int4", torch.int32, 8)):
        values, scales = kvc.alloc_quantized_cache(attn, 3, 2, 100, 64, chunk=32)
        assert values.shape == (2, 3, 2, 128, width) and values.dtype == dtype
        assert scales.shape == (2, 3, 2, 1, 128) and bool((scales == 1.0).all())


# ---------------------------------------------------------------------------
# K2 / K3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cur_len", CUR_LENS)
@pytest.mark.parametrize("bits", ["int8", "int4"])
def test_k2_k3_plain_matches_jax_pallas(bits, cur_len, dtype):
    rng = np.random.default_rng(cur_len)
    values, scales = _quantized_cache(rng, bits)
    q = _q(rng, (B, H, D), dtype)
    port = decode_attention_int8 if bits == "int8" else decode_attention_int4
    impl = jda.decode_attention_int8_impl if bits == "int8" else jda.decode_attention_int4_impl
    layer = L - 1          # a layer past the first: the layer offset is exercised
    got = port(_t(q, dtype), _t(values), _t(scales), layer, cur_len)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, H, D)
    want = impl(_j(q, dtype), _j(values), _j(scales), layer, cur_len, chunk=CHUNK,
                interpret=True, pipelined=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("bits", ["int8", "int4"])
def test_k2_k3_nan_scale_tail_does_not_reach_output(bits):
    rng = np.random.default_rng(1)
    values, scales = _quantized_cache(rng, bits)
    q = _t(_q(rng, (B, H, D), "float32"))
    port = decode_attention_int8 if bits == "int8" else decode_attention_int4
    cur = 100
    clean = port(q, _t(values), _t(scales), 1, cur)
    scales[:, :, :, :, cur:] = np.nan
    scales[:, 0] = np.nan
    values[:, :, :, cur:] = rng.integers(-100, 100, size=values[:, :, :, cur:].shape)
    np.testing.assert_array_equal(port(q, _t(values), _t(scales), 1, cur).numpy(), clean.numpy())


@pytest.mark.parametrize("batch,n_rows", [(1, 1), (1, 257), (1, 7680), (16, 4000),
                                          (16, 7680), (2, 129)])
def test_fast_split_plan_covers_the_rows(batch, n_rows):
    rows, nsplit = fast_split_plan(batch, n_rows, num_sms=132)
    assert rows % 128 == 0 and nsplit >= 1
    assert (nsplit - 1) * rows < n_rows <= nsplit * rows


# ---------------------------------------------------------------------------
# on the card


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("bits", ["int8", "int4"])
def test_k2_k3_kernel_matches_plain_on_the_card(bits):
    _needs_card()
    rng = np.random.default_rng(4)
    values, scales = _quantized_cache(rng, bits)
    port = decode_attention_int8 if bits == "int8" else decode_attention_int4
    for dtype in ("float32", "bfloat16"):
        q = _t(_q(rng, (B, H, D), dtype), dtype).cuda()
        for cur_len in CUR_LENS:
            before = port.launches
            got = port(q, _t(values).cuda(), _t(scales).cuda(), 1, cur_len)
            torch.cuda.synchronize()
            assert port.launches == before + 1
            want = decode_attention_quant_reference(q, _t(values).cuda(), _t(scales).cuda(), 1,
                                                    cur_len)
            torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
