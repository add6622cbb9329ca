"""K2 and K3 of the PyTorch port: the quantized caches' codecs and the
plain versions against the JAX package's Pallas kernels (interpret mode,
``pipelined=True``), the split plans, a mirror of the kernels' int4
unpacking, and the kernels themselves where a card is present (K4:
test_torch_mq_attention.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meshanything_tpu.ops import decode_attention as jda
from meshanything_tpu.ops import kvcache as jkv
from meshanything_tpu_torch.ops import kvcache as kvc
from meshanything_tpu_torch.ops.decode_attention import (
    QUANT_TILE,
    FoldWorkspace,
    decode_attention_int4,
    decode_attention_int8,
    decode_attention_quant_reference,
    fast_split_plan,
    quant_split_plan,
    split_bounds,
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


@pytest.mark.parametrize("batch", [1, 2, 16])
@pytest.mark.parametrize("cur_len", [1, 257, 7459, 7680])
def test_quant_split_plan_covers_the_rows(batch, cur_len):
    """K2's and K3's grid (B, nsplit): splits of whole QUANT_TILE-row
    tiles that cover [0, cur_len) once with no empty split, about one
    block an SM, and a fold workspace whose counters hold the call at the
    350M width (16 heads of 64)."""
    nsplit, group = quant_split_plan(batch, cur_len, num_sms=132)
    bounds = split_bounds(cur_len, QUANT_TILE, nsplit)
    assert all(r1 > r0 for r0, r1 in bounds)
    assert bounds[0][0] == 0 and bounds[-1][1] == cur_len
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(r0 % QUANT_TILE == 0 for r0, _ in bounds)
    assert batch * nsplit <= max(132, batch) and 1 <= group <= nsplit
    ws = FoldWorkspace(torch.device("cpu"))
    o_part, ml_part, counters = ws.pointers(batch, nsplit, group, 16, 64)
    ngroups = -(-nsplit // group)
    assert batch * (1 + ngroups) <= ws.counters.numel()
    assert ml_part - o_part == 4 * batch * (nsplit + ngroups) * 16 * 64


# ---------------------------------------------------------------------------
# the kernels' int4 unpacking (csrc/quant_codes.cuh), mirrored bit for bit


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint64 arrays holding 32-bit words."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def _words4_to_codes(w):
    """quant_codes::words4_to_codes: four words -> eight words of codes
    biased by 8, out[p] byte j = nibble p of word j as code + 8."""
    ab01 = _byte_perm(w[0], w[1], 0x5140)
    cd01 = _byte_perm(w[2], w[3], 0x5140)
    ab23 = _byte_perm(w[0], w[1], 0x7362)
    cd23 = _byte_perm(w[2], w[3], 0x7362)
    y = [_byte_perm(ab01, cd01, 0x5410), _byte_perm(ab01, cd01, 0x7632),
         _byte_perm(ab23, cd23, 0x5410), _byte_perm(ab23, cd23, 0x7632)]
    out = []
    for k in range(4):
        out += [(y[k] & 0x0F0F0F0F) ^ 0x08080808, ((y[k] >> 4) & 0x0F0F0F0F) ^ 0x08080808]
    return out


def _stage_int4(words):
    """quant_codes::unpack_int4_tile on rows of plane words (..., nw) ->
    the bytes (..., 8 nw) it writes, code + 8 each: column p*nw + j + i is
    byte i of out[p] of the four words at j."""
    nw = words.shape[-1]
    w = words.astype(np.int64) & 0xFFFFFFFF
    staged = np.zeros(words.shape[:-1] + (8 * nw,), np.uint8)
    for j in range(0, nw, 4):
        out = _words4_to_codes([w[..., j + i] for i in range(4)])
        for p in range(8):
            as_bytes = np.stack([(out[p] >> (8 * i)) & 0xFF for i in range(4)], axis=-1)
            staged[..., p * nw + j:p * nw + j + 4] = as_bytes
    return staged


def _head_words(h, head_dim, hd):
    """(nibble, word) of each of head h's columns in a plane-packed row."""
    nw = hd // 8
    cols = h * head_dim + np.arange(head_dim)
    return cols // nw, cols % nw


def test_int8_code_widening_mirror_is_exact():
    """quant_codes::codes02_to_bf16x2, which widens int8 codes into the
    tensor cores' bf16 pairs, mirrored on every byte: 0x4300 | (c & 0x7f)
    is 128 + (c & 127) and 0x4300 | (c & 0x80) is 128 or 256, so their
    bf16 difference is c exactly. And codes4_to_f32 (CUDA cores): the
    biased byte in the low mantissa of 2^23, less 2^23 + 128."""
    c = np.arange(-128, 128)
    u = c.astype(np.int64) & 0xFF
    lo = torch.from_numpy((0x4300 | (u & 0x7F)).astype(np.int16)).view(torch.bfloat16)
    hi = torch.from_numpy((0x4300 | (u & 0x80)).astype(np.int16)).view(torch.bfloat16)
    np.testing.assert_array_equal((lo - hi).float().numpy(), c)   # bf16 subtraction, exact
    f32 = torch.from_numpy((0x4B000000 | (u ^ 0x80)).astype(np.int32)).view(torch.float32)
    np.testing.assert_array_equal((f32 - 8388736.0).numpy(), c)


@pytest.mark.parametrize("heads,head_dim", [(16, 64), (4, 8)])
def test_int4_staging_mirror_matches_unpack(heads, head_dim):
    """The kernels unpack an int4 tile once into a byte a code, biased by
    8, in the int8 row layout. Mirrored bit for bit on seeded words (every
    nibble, -8 included), the staged bytes less 8 equal
    ops/kvcache.py::unpack_int4 and JAX's in-kernel _unpack4, and the
    widening of a pair of them to bf16 (0x4300 | u, less 136) gives the
    codes; head h's columns are nibble h*D // nw .. of words (h*D) % nw ..:
    at the 350M width nibble h // 2 of words 64 * (h % 2) .. + 63, eight
    heads a word."""
    hd = heads * head_dim
    rng = np.random.default_rng(hd)
    words = rng.integers(-2 ** 31, 2 ** 31, size=(5, hd // 8), dtype=np.int64).astype(np.int32)
    staged = _stage_int4(words).astype(np.int32) - 8
    want = kvc.unpack_int4(torch.from_numpy(words)).numpy()
    np.testing.assert_array_equal(staged, want)
    # quant_codes::biased4_02_to_bf16x2 on one staged byte: bf16 bits 0x4300 | u less 136
    as_bf16 = torch.from_numpy((0x4300 | (staged + 8)).astype(np.int16)).view(torch.bfloat16)
    np.testing.assert_array_equal((as_bf16.float() - 136.0).numpy(), want)
    np.testing.assert_array_equal(np.asarray(jda._unpack4(jnp.asarray(words), jnp.int32)), want)
    u = words.astype(np.int64) & 0xFFFFFFFF
    for h in range(heads):
        nib, word = _head_words(h, head_dim, hd)
        codes = (u[:, word] >> (4 * nib)) & 15
        codes = codes - ((codes & 8) << 1)
        np.testing.assert_array_equal(staged[:, h * head_dim:(h + 1) * head_dim], codes)
        if (heads, head_dim) == (16, 64):
            assert set(nib) == {h // 2} and list(word) == list(64 * (h % 2) + np.arange(64))


@pytest.mark.parametrize("variant", ["kernel", "stream_only", "no_unpack", "no_convert",
                                     "no_fold", "long_splits"])
def test_quant_breakdown_variants_apply_to_the_kernels(variant):
    """Every variant of tools/quant_breakdown.py applies to the current
    sources it names (K2/K3 and the window kernel's int8/int4 instances):
    the constants it changes are there, at their values."""
    from meshanything_tpu_torch.ops import _build
    from meshanything_tpu_torch.ops.decode_attention import quant_window_split_plan
    from meshanything_tpu_torch.tools.quant_breakdown import (
        PLAN_MIN_TILES, SOURCES, VARIANTS, _capped, variant_source)

    changed_any = False
    for lib in SOURCES:
        with open(f"{_build.CSRC_DIR}/{lib}.cu") as fh:
            source = fh.read()
        changed_any |= variant_source(source, variant, lib) != source
    assert changed_any == (VARIANTS[variant] != [])
    with pytest.raises(ValueError):
        variant_source("no constants here", "stream_only", SOURCES[0])
    if variant in PLAN_MIN_TILES:     # a launch-plan variant: at least that many tiles a split
        plan = _capped(quant_window_split_plan, PLAN_MIN_TILES[variant])
        nsplit, _ = plan(1, 7450, 132)
        assert nsplit == -(-233 // PLAN_MIN_TILES[variant]) and plan(16, 7450, 132)[0] == 8


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


@pytest.mark.cuda
@pytest.mark.parametrize("bits", ["int8", "int4"])
def test_k2_k3_kernel_at_head_width_8_on_the_card(bits):
    """The small config's head width (4 heads of 8) through the same
    kernel, with NaN scales and garbage codes past cur_len."""
    _needs_card()
    rng = np.random.default_rng(8)
    heads, hd = 4, 8
    rows = (rng.normal(size=(2, L, B, S, heads * hd)) * 0.5).astype(np.float32)
    codes, scale = QROWS[bits][0](torch.from_numpy(rows))
    values = codes.cuda()
    scales = scale.transpose(-1, -2).contiguous().cuda()
    port = decode_attention_int8 if bits == "int8" else decode_attention_int4
    for dtype in ("float32", "bfloat16"):
        q = _t(_q(rng, (B, heads, hd), dtype), dtype).cuda()
        for cur_len in CUR_LENS:
            got = port(q, values, scales, 1, cur_len)
            poisoned_scales = scales.clone()
            poisoned_scales[:, :, :, :, cur_len:] = float("nan")
            again = port(q, values, poisoned_scales, 1, cur_len)
            want = decode_attention_quant_reference(q, values, scales, 1, cur_len)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
            assert torch.equal(got, again)
