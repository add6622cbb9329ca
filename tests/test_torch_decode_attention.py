"""K1 in the PyTorch port: the plain version against the JAX package's
Pallas kernel (interpret mode) and reference, the wrapper's checks, and
the kernel itself where a card is present."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meshanything_tpu.ops.decode_attention import (
    decode_attention_impl as jax_decode_attention_impl,
    decode_attention_reference as jax_decode_attention_reference,
)
from meshanything_tpu_torch.ops.decode_attention import (
    decode_attention,
    K1_TILE,
    FoldWorkspace,
    fold_workspace,
    decode_attention_reference,
    fold_group,
    split_bounds,
    split_plan,
)

B, H, D, S, L, CHUNK = 2, 4, 64, 256, 2, 128
# cur_len: one row, a chunk edge on both sides, the whole cache
CUR_LENS = (1, CHUNK - 1, CHUNK, CHUNK + 1, S)
# f32: the same math in another summation order; bf16: one rounding of
# the O(1) outputs to bf16
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _inputs(seed, dtype):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    kv = (rng.normal(size=(2, L, B, S, H * D)) * 0.5).astype(np.float32)
    if dtype == "bfloat16":   # round once, so both packages see the same values
        q = np.array(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
        kv = np.array(jnp.asarray(kv, jnp.bfloat16).astype(jnp.float32))
    return q, kv


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _jax(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cur_len", CUR_LENS)
def test_plain_matches_jax_pallas_and_reference(dtype, cur_len):
    q, kv = _inputs(cur_len, dtype)
    tol = TOL[dtype]
    for layer in range(L):
        got = decode_attention(_torch(q, dtype), _torch(kv, dtype), layer, cur_len)
        assert got.dtype == getattr(torch, dtype) and got.shape == (B, H, D)
        got = got.float().numpy()
        pallas = jax_decode_attention_impl(_jax(q, dtype), _jax(kv, dtype), layer, cur_len,
                                           chunk=CHUNK, interpret=True, pipelined=True)
        ref = jax_decode_attention_reference(_jax(q, dtype), _jax(kv, dtype), layer, cur_len)
        for other in (pallas, ref):
            np.testing.assert_allclose(got, np.asarray(other, np.float32), atol=tol, rtol=tol,
                                       err_msg=f"layer={layer} cur_len={cur_len}")


def test_poisoned_tail_does_not_reach_output():
    """Rows past cur_len are never read: a huge tail (as the JAX test
    poisons it) leaves both packages unchanged, and a NaN tail leaves
    the port unchanged."""
    q, kv = _inputs(0, "float32")
    cur = 100
    huge = kv.copy()
    huge[:, :, :, cur:] = 1e4
    nan = kv.copy()
    nan[:, :, :, cur:] = np.nan
    clean = decode_attention(torch.from_numpy(q), torch.from_numpy(kv), 1, cur).numpy()
    for poisoned in (huge, nan):
        got = decode_attention(torch.from_numpy(q), torch.from_numpy(poisoned), 1, cur).numpy()
        np.testing.assert_array_equal(got, clean)
    pallas = jax_decode_attention_impl(jnp.asarray(q), jnp.asarray(huge), 1, cur, chunk=CHUNK,
                                       interpret=True, pipelined=True)
    np.testing.assert_allclose(clean, np.asarray(pallas), atol=1e-5, rtol=1e-5)


def test_cpu_calls_do_not_count_as_launches():
    q, kv = _inputs(1, "float32")
    before = decode_attention.launches
    decode_attention(torch.from_numpy(q), torch.from_numpy(kv), 0, 17)
    decode_attention_reference(torch.from_numpy(q), torch.from_numpy(kv), 0, 17)
    assert decode_attention.launches == before


@pytest.mark.parametrize("case", ["dtype", "mixed", "shape", "contiguous", "layer", "cur_len",
                                  "cur_len0", "device"])
def test_wrapper_rejects_bad_arguments(case):
    q = torch.zeros(B, H, D)
    kv = torch.zeros(2, L, B, S, H * D)
    layer, cur = 0, 5
    err = ValueError
    if case == "dtype":
        q, kv, err = q.half(), kv.half(), TypeError
    elif case == "mixed":
        q, err = q.bfloat16(), TypeError
    elif case == "shape":
        kv = torch.zeros(2, L, B + 1, S, H * D)
    elif case == "contiguous":
        kv = torch.zeros(2, L, B, H * D, S).transpose(-1, -2)
    elif case == "layer":
        layer = L
    elif case == "cur_len":
        cur = S + 1
    elif case == "cur_len0":
        cur = 0
    elif case == "device":
        q, kv = q.to("meta"), kv.to("meta")
    with pytest.raises(err):
        decode_attention(q, kv, layer, cur)


@pytest.mark.parametrize("tile", sorted(K1_TILE.values()))     # 8 rows of f32, 16 of bf16
@pytest.mark.parametrize("batch,cur_len", [(1, 1), (1, 257), (1, 7459), (16, 4000),
                                           (16, 7459), (2, 129), (1, 7680), (3, 300),
                                           (200, 7459)])
def test_split_plan_covers_the_live_rows(batch, cur_len, tile):
    """The kernel's grid: splits of whole tiles, balanced to within one
    tile, that cover exactly [0, cur_len) once with no empty split; at
    most one block an SM (a block holds most of an SM's shared memory),
    and at B=1 over the whole cache one block on every SM."""
    nsplit, group = split_plan(batch, cur_len, num_sms=132, tile=tile)
    bounds = split_bounds(cur_len, tile, nsplit)
    assert len(bounds) == nsplit >= 1 and 1 <= group <= nsplit
    assert bounds[0][0] == 0 and bounds[-1][1] == cur_len
    assert all(r0 < r1 and r0 % tile == 0 for r0, r1 in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    sizes = [-(-(r1 - r0) // tile) for r0, r1 in bounds]
    assert max(sizes) - min(sizes) <= 1
    assert batch * nsplit <= max(132, batch)
    if (batch, cur_len) == (1, 7680):
        assert nsplit >= 132


@pytest.mark.parametrize("nsplit", [1, 8, 24, 25, 66, 132, 4096])
def test_fold_groups_cover_the_splits(nsplit):
    """The two-level fold: groups of ``fold_group`` splits; one group while
    two batches of the fold's loads cover every split, else about
    sqrt(nsplit) a group and as many groups."""
    group = fold_group(nsplit)
    ngroups = -(-nsplit // group)
    assert 1 <= group <= nsplit and (ngroups - 1) * group < nsplit <= ngroups * group
    assert ngroups == 1 if nsplit <= 24 else abs(group - ngroups) <= 1


def test_fold_workspace_layout_and_growth():
    """The partials of a call lie in one buffer a device, o_part then
    ml_part, 16-byte aligned; a larger call gets a larger buffer and the
    outgrown one is kept (a captured graph may still write to it); more
    batch rows than there are counters raise."""
    ws = FoldWorkspace(torch.device("cpu"))
    assert ws.counters.dtype == torch.int32 and not ws.counters.any()
    first = ws.partials
    o_ptr, ml_ptr, c_ptr = ws.pointers(1, 132, 12, 16, 64)
    assert (o_ptr, c_ptr) == (first.data_ptr(), ws.counters.data_ptr())
    assert ml_ptr - o_ptr == 4 * (132 + 11) * 16 * 64 and ml_ptr % 16 == 0
    assert ws.partials is first
    o_ptr, ml_ptr, _ = ws.pointers(16, 9, 9, 16 * 16, 64)     # B=16, W=16: past the first buffer
    need = 16 * 10 * 256 * (64 + 2)
    assert ws.partials is not first and ws.partials.numel() >= need
    assert o_ptr == ws.partials.data_ptr() and any(t is first for t in ws._outgrown)
    with pytest.raises(ValueError):
        ws.pointers(ws.counters.numel(), 8, 8, 16, 64)


def test_fold_workspace_is_one_a_device_and_stream():
    """Two streams of one device never share counters or partials; one
    stream gets the workspace it made at its first call."""
    dev = torch.device("cpu")
    first, other = fold_workspace(dev, 0x10), fold_workspace(dev, 0x20)
    assert first is fold_workspace(dev, 0x10) and first is not other
    assert first.counters.data_ptr() != other.counters.data_ptr()
    assert first.partials.data_ptr() != other.partials.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_the_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q, kv = _inputs(3, dtype)
    qd, kvd = _torch(q, dtype).cuda(), _torch(kv, dtype).cuda()
    for cur_len in CUR_LENS:
        before = decode_attention.launches
        got = decode_attention(qd, kvd, 1, cur_len)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 1
        want = decode_attention_reference(qd, kvd, 1, cur_len)
        torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
