"""The measurement kernels of the PyTorch port (T1-T5): each plain version
against the JAX package's kernel body run in interpret mode, the
wrappers' checks, the launch plans, the tools on the CPU, and the kernels
themselves where a card is present."""
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from meshanything_tpu.ops.decode_attention import (
    decode_attention_reference as jax_decode_attention_reference,
)
from meshanything_tpu_torch.ops import k1_probe as kp
from meshanything_tpu_torch.ops import probes
from meshanything_tpu_torch.ops.decode_attention import decode_attention, decode_attention_reference
from meshanything_tpu_torch.tools import build_canary, dma_wire_probe, pipe_compute_probe
from tools import dma_wire_probe as jax_wire
from tools import pipe_compute_probe as jax_pipe

WIDTH = 128          # a narrow row: the kernels' own is 1024
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "int8": (torch.int8, jnp.int8)}


def _integer_rows(seed, rows, dtype):
    """Random integers in [-8, 8]: exact in bf16 and int8, and their f32
    sums are exact in any order."""
    x = np.random.default_rng(seed).integers(-8, 9, size=(rows, WIDTH)).astype(np.float32)
    return torch.from_numpy(x).to(DTYPES[dtype][0]), jnp.asarray(x, DTYPES[dtype][1])


def _jax_stream_call(body, arrays, scalars, *, chunk, depth, sem_shape, buf_shape, **static):
    """``pl.pallas_call(..., interpret=True)`` around one of the JAX tool's
    kernel bodies, with the grid spec that the tool's own wrapper gives it
    (``pallas_stream`` and its siblings take no ``interpret`` argument)."""
    nchunks = arrays[0].shape[0] // chunk
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=len(scalars), grid=(1,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.HBM)] * len(arrays),
        out_specs=pl.BlockSpec((1, 1), lambda i, *_: (0, 0), memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM(buf_shape, arrays[0].dtype),
                        pltpu.SemaphoreType.DMA(sem_shape)])
    kernel = functools.partial(body, chunk=chunk, nchunks=nchunks, depth=depth, **static)
    out = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
                         grid_spec=grid_spec, interpret=True)(*scalars, *arrays)
    return np.asarray(out)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("chunk,depth", [(16, 2), (8, 4), (64, 2)])
def test_stream_plain_matches_jax_kernel(dtype, chunk, depth):
    xt, xj = _integer_rows(chunk + depth, 128, dtype)
    want = _jax_stream_call(jax_wire._stream_kernel, [xj], [], chunk=chunk, depth=depth,
                            sem_shape=(depth,), buf_shape=(depth, chunk, WIDTH))
    got = probes.stream(xt, chunk, depth)
    assert got.shape == (1, 1) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(probes.stream_reference(xt, chunk).numpy(), want)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("rot", [True, False])
@pytest.mark.parametrize("start", [0, 3, 7])
def test_stream_rot_plain_matches_jax_kernel(dtype, rot, start):
    chunk, depth = 16, 2
    xt, xj = _integer_rows(10 + start, 128, dtype)          # 8 chunks: start 7 is the last
    want = _jax_stream_call(jax_wire._stream_kernel_rot, [xj],
                            [jnp.asarray([start], jnp.int32)], chunk=chunk, depth=depth,
                            sem_shape=(depth,), buf_shape=(depth, chunk, WIDTH), rot=rot)
    got = probes.stream_rot(xt, start, chunk, depth, rot)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(probes.stream_rot_reference(xt, start, chunk).numpy(), want)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("depth,nsem", [(2, 1), (2, 2), (4, 2)])
def test_dual_stream_plain_matches_jax_kernel(dtype, depth, nsem):
    chunk = 16
    x0t, x0j = _integer_rows(20 + depth, 128, dtype)
    x1t, x1j = _integer_rows(30 + nsem, 128, dtype)
    want = _jax_stream_call(jax_wire._dual_kernel, [x0j, x1j], [], chunk=chunk, depth=depth,
                            sem_shape=(depth, nsem), buf_shape=(depth, 2, chunk, WIDTH),
                            nsem=nsem)
    got = probes.dual_stream(x0t, x1t, chunk, depth, nsem)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(probes.dual_stream_reference(x0t, x1t, chunk).numpy(), want)


@pytest.mark.parametrize("c", [0.5, -3.25, 1e3])
def test_scale_shift_plain_matches_jax_kernel(c):
    """T5 against the body of ``tools/xla_cpu_crash_repro.py``'s Pallas
    kernel (nested in its ``main``, so written out here) in interpret
    mode, at its (8, 128) f32 shape: exact."""
    x = np.random.default_rng(3).normal(size=(8, 128)).astype(np.float32)

    def kern(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0 + c

    want = pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
                          interpret=True)(jnp.asarray(x))
    got = probes.scale_shift(torch.from_numpy(x), c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(probes.scale_shift_reference(torch.from_numpy(x), c).numpy(),
                                  np.asarray(want))


# T4: a small cache, 4 heads of 8, tiles of 16 rows
B, H, D, S, L, CHUNK = 2, 4, 8, 64, 3, 16
# f32: the same math in another summation order; bf16: one rounding of the output to bf16
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _attention_inputs(seed, dtype):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    kv = (rng.normal(size=(2, L, B, S, H * D)) * 0.5).astype(np.float32)
    if dtype == "bfloat16":   # round once, so both packages see the same values
        q = np.array(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
        kv = np.array(jnp.asarray(kv, jnp.bfloat16).astype(jnp.float32))
    return q, kv


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [CHUNK, 8])      # the card's tiles: 16 rows of bf16, 8 of f32
@pytest.mark.parametrize("mode,cur_len", [
    ("full", 64), ("full", 41), ("full", 5), ("tap", 48), ("tap", 41), ("qk", 64), ("qk", 41),
    ("qk", 5), ("softmax", 64), ("softmax", 16), ("pv", 48), ("pv", 16)])
def test_k1_probe_plain_matches_jax_probe(mode, cur_len, chunk, dtype):
    """The plain version against ``tools/pipe_compute_probe.build`` in
    interpret mode, whose output is the H-fold inflated (B, H, H*D)
    block-diagonal form: the diagonal blocks are compared. The JAX tool
    divides no mode by the softmax sum, hence ``normalize=False``; its
    constant-logit modes do not mask the last tile, so they are compared
    where cur_len is a multiple of the tile."""
    q, kv = _attention_inputs(cur_len, dtype)
    jdt = getattr(jnp, dtype)
    inflated = np.asarray(jax_pipe.build(jnp.asarray(q, jdt), jnp.asarray(kv, jdt), 1, cur_len,
                                         chunk=chunk, mode=mode, interpret=True), np.float32)
    want = np.stack([inflated[:, i, i * D:(i + 1) * D] for i in range(H)], axis=1)
    got = kp.k1_probe_reference(_torch(q, dtype), _torch(kv, dtype), 1, cur_len, chunk=chunk,
                                mode=mode, normalize=False)
    assert got.shape == (B, H, D) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype], rtol=TOL[dtype])
    if mode != "full":      # the wrapper's CPU route is the same function
        wrapped = kp.k1_probe(_torch(q, dtype), _torch(kv, dtype), 1, cur_len, chunk=chunk,
                              mode=mode)
        np.testing.assert_array_equal(wrapped.float().numpy(), got.float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["full", "one_split", "no_combine", "depth1"])
@pytest.mark.parametrize("cur_len", [1, 17, 41, 64])
def test_k1_probe_full_is_k1(mode, cur_len, dtype):
    """``full`` and the three machinery cuts compute K1: against both
    packages' references, whatever the tiles and context splits."""
    q, kv = _attention_inputs(100 + cur_len, dtype)
    qt, kvt = _torch(q, dtype), _torch(kv, dtype)
    jdt = getattr(jnp, dtype)
    refs = (decode_attention_reference(qt, kvt, 2, cur_len).float().numpy(),
            np.asarray(jax_decode_attention_reference(jnp.asarray(q, jdt), jnp.asarray(kv, jdt),
                                                      2, cur_len), np.float32))
    tile = kp.K1_TILE[qt.dtype]
    for nsplit in (1, 2, 3):
        nsplit = min(nsplit, -(-cur_len // tile))       # the plan leaves no split empty
        got = kp.k1_probe_reference(qt, kvt, 2, cur_len, chunk=tile, mode=mode, nsplit=nsplit)
        if mode == "no_combine":     # fold the partials as K1 does
            o_part, ml_part = got
            assert o_part.shape == (B, nsplit, H, D) and ml_part.shape == (B, nsplit, H, 2)
            w = torch.exp(ml_part[..., 0] - ml_part[..., 0].amax(dim=1, keepdim=True))
            got = ((o_part * w[..., None]).sum(dim=1)
                   / (ml_part[..., 1] * w).sum(dim=1)[..., None]).to(qt.dtype)
        for ref in refs:
            np.testing.assert_allclose(got.float().numpy(), ref, atol=TOL[dtype], rtol=TOL[dtype])


def test_k1_probe_softmax_depends_on_the_split_plan():
    """The online softmax restarts in every context split, so ``softmax``
    is a function of the plan as well; tap and qk are not."""
    q, kv = _attention_inputs(7, "float32")
    qt, kvt = torch.from_numpy(q), torch.from_numpy(kv)

    def run(mode, nsplit):
        return kp.k1_probe_reference(qt, kvt, 0, 64, chunk=CHUNK, mode=mode, nsplit=nsplit)

    assert not torch.allclose(run("softmax", 1), run("softmax", 2), atol=1e-3)
    for mode in ("tap", "qk", "pv"):
        torch.testing.assert_close(run(mode, 1), run(mode, 2), atol=1e-5, rtol=1e-5)


def test_k1_probe_masks_rows_past_cur_len():
    q, kv = _attention_inputs(8, "float32")
    nan = kv.copy()
    nan[:, :, :, 41:] = np.nan
    for mode in kp.MODES:
        clean = kp.k1_probe(torch.from_numpy(q), torch.from_numpy(kv), 1, 41, chunk=CHUNK, mode=mode)
        got = kp.k1_probe(torch.from_numpy(q), torch.from_numpy(nan), 1, 41, chunk=CHUNK, mode=mode)
        for a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (clean, got))):
            assert torch.isfinite(b).all()
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_cpu_calls_do_not_count_as_launches():
    x, _ = _integer_rows(0, 64, "bfloat16")
    q, kv = _attention_inputs(1, "float32")
    wrappers = (probes.scale_shift, probes.stream, probes.stream_rot, probes.dual_stream,
                kp.k1_probe, decode_attention)
    before = [w.launches for w in wrappers]
    probes.scale_shift(torch.ones(8, 128), 1.0)
    probes.stream(x, 16)
    probes.stream_rot(x, 2, 16)
    probes.dual_stream(x, x.clone(), 16)
    kp.k1_probe(torch.from_numpy(q), torch.from_numpy(kv), 0, 17, chunk=CHUNK, mode="full")
    assert [w.launches for w in wrappers] == before


@pytest.mark.parametrize("case", ["dtype", "dim", "rows", "chunk0", "contiguous", "depth0",
                                  "depth9", "device", "start", "nsem", "pair_shape",
                                  "pair_dtype"])
def test_stream_wrappers_reject_bad_arguments(case):
    x = torch.zeros(64, WIDTH, dtype=torch.bfloat16)
    chunk, depth, err = 16, 2, ValueError
    call = lambda: probes.stream(x, chunk, depth)           # noqa: E731
    if case == "dtype":
        x, err = x.float(), TypeError
    elif case == "dim":
        x = x.reshape(-1)
    elif case == "rows":
        chunk = 24
    elif case == "chunk0":
        chunk = 0
    elif case == "contiguous":
        x = torch.zeros(WIDTH, 64, dtype=torch.bfloat16).t()
    elif case == "depth0":
        depth = 0
    elif case == "depth9":
        depth = probes.MAX_DEPTH + 1
    elif case == "device":
        x = x.to("meta")
    elif case == "start":
        call = lambda: probes.stream_rot(x, -1, chunk)      # noqa: E731
    elif case == "nsem":
        call = lambda: probes.dual_stream(x, x.clone(), chunk, nsem=3)   # noqa: E731
    elif case == "pair_shape":
        call = lambda: probes.dual_stream(x, x[:32].clone(), chunk)      # noqa: E731
    elif case == "pair_dtype":
        call = lambda: probes.dual_stream(x, x.to(torch.int8), chunk)    # noqa: E731
    with pytest.raises(err):
        call()


@pytest.mark.parametrize("case", ["dtype", "empty", "contiguous", "device"])
def test_scale_shift_rejects_bad_arguments(case):
    x, err = torch.zeros(8, 128), ValueError
    if case == "dtype":
        x, err = x.bfloat16(), TypeError
    elif case == "empty":
        x = torch.zeros(0, 128)
    elif case == "contiguous":
        x = torch.zeros(128, 8).t()
    elif case == "device":
        x = x.to("meta")
    with pytest.raises(err):
        probes.scale_shift(x, 1.0)


@pytest.mark.parametrize("case", ["mode", "chunk", "shape", "dtype", "cur_len", "layer", "columns",
                                  "device"])
def test_k1_probe_rejects_bad_arguments(case):
    q, kv = torch.zeros(B, H, D), torch.zeros(2, L, B, S, H * D)
    layer, cur, chunk, mode, err = 0, 5, CHUNK, "full", ValueError
    if case == "mode":
        mode = "tap_min"           # a TPU machinery cut: not ported, see ops/k1_probe.py
    elif case == "chunk":
        chunk = 0
    elif case == "shape":
        kv = torch.zeros(2, L, B + 1, S, H * D)
    elif case == "dtype":
        q, kv, err = q.half(), kv.half(), TypeError
    elif case == "cur_len":
        cur = S + 1
    elif case == "layer":
        layer = L
    elif case == "columns":
        mode, chunk = "pv", 64     # 64 logits from a 32-column row
    elif case == "device":
        q, kv = q.to("meta"), kv.to("meta")
    with pytest.raises(err):
        kp.k1_probe(q, kv, layer, cur, chunk=chunk, mode=mode)


@pytest.mark.parametrize("chunk_bytes,planes,depth,nchunks", [
    (512 * 2048, 1, 2, 4096), (512 * 1024, 1, 4, 8192), (64 * 1024, 1, 2, 65536),
    (512 * 2048, 2, 2, 4096), (512 * 2048, 2, 4, 4096), (512 * 2048, 1, 8, 4096),
    (512 * 2048, 2, 8, 4096), (48, 1, 2, 3), (512 * 2048, 1, 2, 5)])
def test_stream_plan_fits_the_card(chunk_bytes, planes, depth, nchunks):
    """Whole stages per chunk, 16-byte multiples, rings that fit an SM's
    shared memory for as many blocks as the plan puts there, and never
    more blocks than chunks."""
    stage, blocks = probes.stream_plan(chunk_bytes, planes, depth, nchunks, num_sms=132)
    assert stage % 16 == 0 and chunk_bytes % stage == 0
    assert planes * stage <= 32 * 1024
    per_sm = -(-blocks // 132)
    assert per_sm * (depth * planes * stage + 1024) <= 227 * 1024
    assert 1 <= blocks <= min(nchunks, 2 * 132)
    if chunk_bytes >= 64 * 1024 and depth <= 4:
        assert planes * stage == 32 * 1024          # full slots where the chunk allows
    with pytest.raises(ValueError):
        probes.stream_plan(chunk_bytes + 8, planes, depth, nchunks, num_sms=132)


@pytest.mark.parametrize("tile", [16, 8])
@pytest.mark.parametrize("batch,cur_len", [(1, 1), (1, 257), (1, 7168), (16, 7168), (16, 7459)])
def test_k1_probe_plan(batch, cur_len, tile):
    """Every mode but one_split runs K1's own grid; one_split one block a
    batch row. Either way the splits are whole tiles that cover the live
    rows once, none empty."""
    from meshanything_tpu_torch.ops.decode_attention import split_bounds, split_plan

    for mode in kp.MODES:
        nsplit, group = kp.k1_probe_plan(batch, cur_len, 132, mode, tile)
        bounds = split_bounds(cur_len, tile, nsplit)
        assert bounds[0][0] == 0 and bounds[-1][1] == cur_len
        assert all(r0 < r1 and r0 % tile == 0 for r0, r1 in bounds)
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        if mode == "one_split":
            assert (nsplit, group) == (1, 1)
        else:
            assert (nsplit, group) == split_plan(batch, cur_len, 132, tile)


@pytest.mark.parametrize("tool,argv,closing", [
    (build_canary, [], "BUILD-CANARY-OK"),
    (dma_wire_probe, ["0.002", "8"], "DMA-WIRE-PROBE-OK"),
    (dma_wire_probe, ["0.002", "8", "verify"], "DMA-WIRE-PROBE-OK"),
    (dma_wire_probe, ["0.002", "8", "dual"], "DMA-WIRE-PROBE-OK"),
    (pipe_compute_probe, [], "PIPE-COMPUTE-PROBE-OK"),
    (pipe_compute_probe, ["tap", "one_split"], "PIPE-COMPUTE-PROBE-OK"),
])
def test_tools_run_on_the_cpu(tool, argv, closing, capsys):
    """Each entry point runs its plain versions with ``--device cpu``,
    prints one JSON line a measurement that names the device, and closes
    with its OK line."""
    assert tool.main([*argv, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == closing
    records = [json.loads(ln) for ln in lines[:-1]]
    assert records[0]["tool"] == "build_canary" and records[0]["launches"] == 0
    assert all(r["device"] == "cpu" and r["card"] == "cpu" for r in records)
    if tool is pipe_compute_probe:
        assert [r["mode"] for r in records[1:]] == (argv or list(kp.MODES))
    if tool is dma_wire_probe:
        assert all(r["gb_per_s"] > 0 for r in records[1:])


def test_tools_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    for tool in (build_canary, dma_wire_probe, pipe_compute_probe):
        with pytest.raises(SystemExit):
            tool.main([])


def test_attn_compare_child_program_compiles():
    """The comparison tool runs each tree in a process of its own from a
    program text that times K1-K4 through the tree's own smoke phases and
    its own K2-K4 grid (one source for both trees) and runs the CLI cases
    asked for, and pairs the four runs' readings a kernel and shape: each
    tree's in the order made, the ratio of their means."""
    from meshanything_tpu_torch.tools import attn_compare

    program = attn_compare.child_program("/some/checkout", ["exact_pc", "F3"])
    compile(program, "attn_compare child", "exec")
    for needle in ("'/some/checkout'", "cs.time_k1(", "cs.time_fast(", "def quant_grid(",
                   "quant_grid(torch, da, card)", "'--lookahead', '8'"):
        assert needle in program
    assert "meshanything_tpu_torch" not in attn_compare.inspect.getsource(
        attn_compare.quant_grid)       # it runs in the other tree as it is

    def run(label, k1, k4):
        rec = {"bound_ms": 0.1, "card": "card", "library_ms": 0.2 if label == "this" else None}
        return label, {("k1", 1, 7459, 1): {**rec, "ms": k1},
                       ("k4_int8", 16, 300, 16): {**rec, "ms": k4}}

    out = attn_compare.summarize([run("other", 4.0, 9.0), run("this", 1.0, 3.0),
                                  run("this", 3.0, 3.0), run("other", 4.0, 3.0)])
    assert [(r["kernel"], r["batch"], r["cur_len"], r["window"]) for r in out] == [
        ("k1", 1, 7459, 1), ("k4_int8", 16, 300, 16)]
    assert out[0]["other_ms"] == [4.0, 4.0] and out[0]["this_ms"] == [1.0, 3.0]
    assert out[0]["other_over_this"] == 2.0 and out[1]["other_over_this"] == 2.0
    assert out[0]["library_ms"] == 0.2 and out[0]["card"] == "card"
    with pytest.raises(SystemExit):
        attn_compare.main([])          # the other tree's root is required
    with pytest.raises(SystemExit):
        attn_compare.main(["/some/checkout", "--cli", "F9"])


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
def test_scale_shift_kernel_on_the_card():
    _need_card()
    x = torch.randn(8, 128, device="cuda")
    before = probes.scale_shift.launches
    got = probes.scale_shift(x, 0.5)
    torch.cuda.synchronize()
    assert probes.scale_shift.launches == before + 1
    assert torch.equal(got, probes.scale_shift_reference(x, 0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["stream", "stream_rot", "dual_stream"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_stream_kernels_on_the_card(kernel, dtype):
    _need_card()
    x0 = _integer_rows(1, 4096, dtype)[0].cuda()
    x1 = _integer_rows(2, 4096, dtype)[0].cuda()
    for chunk, depth in ((512, 2), (64, 4), (16, 8)):
        if kernel == "stream":
            got, want = probes.stream(x0, chunk, depth), probes.stream_reference(x0, chunk)
        elif kernel == "stream_rot":
            start = 4096 // chunk - 1
            got = probes.stream_rot(x0, start, chunk, depth)
            want = probes.stream_rot_reference(x0, start, chunk)
        else:
            got = probes.dual_stream(x0, x1, chunk, depth, nsem=2)
            want = probes.dual_stream_reference(x0, x1, chunk)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert getattr(probes, kernel).launches > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_probe_kernel_on_the_card(dtype):
    _need_card()
    rng = np.random.default_rng(5)
    q = _torch(rng.normal(size=(2, 16, 64)).astype(np.float32), dtype).cuda()
    kv = _torch((rng.normal(size=(2, 2, 2, 512, 1024)) * 0.3).astype(np.float32), dtype).cuda()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tile = kp.K1_TILE[q.dtype]
    for cur_len in (1, 129, 500):
        full = kp.k1_probe(q, kv, 1, cur_len, chunk=tile, mode="full")
        assert torch.equal(full, decode_attention(q, kv, 1, cur_len))
        for mode in kp.MODES[1:]:
            nsplit, _ = kp.k1_probe_plan(2, cur_len, sms, mode, tile)
            got = kp.k1_probe(q, kv, 1, cur_len, chunk=tile, mode=mode)
            want = kp.k1_probe_reference(q, kv, 1, cur_len, chunk=tile, mode=mode, nsplit=nsplit)
            for a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
                torch.testing.assert_close(a.float(), b.float(), atol=TOL[dtype], rtol=TOL[dtype])
    with pytest.raises(ValueError):
        kp.k1_probe(q, kv, 1, 129, chunk=64, mode="tap")
