"""Cached attention for the decode loop: four kernels, each with its
plain PyTorch version beside it.

  K1 ``decode_attention``: single query over a bf16/f32 cache
     (``csrc/decode_attention.cu``);
  K2 ``decode_attention_int8``: single query over an int8 cache;
  K3 ``decode_attention_int4``: single query over an int4 plane cache
     (K2 and K3: ``csrc/decode_attention_quant.cu``, K1's design);
  K4 ``decode_attention_mq``: W window queries per row over the confirmed
     rows of any of the four caches plus the window rows as one causal
     tile: ``csrc/decode_attention_window.cu`` (tensor cores) for a bf16
     cache at head width 64 and for the int8/int4 caches with bf16
     queries at head width 64, ``csrc/decode_attention_fast.cu`` for the
     rest (``mq_kernel_for``).

K1, K2, K3 and the tensor-core K4 stream whole cache rows through the
ring of ``csrc/row_stream.cuh`` (the quantized caches' scales ride it
too) and fold their partials in the same launch (``csrc/split_fold.cuh``):
one launch a call.

They port the TPU kernels of ``meshanything_tpu/ops/decode_attention.py``
(K1-K3 ``_flash_decode_pipelined_kernel``, K4 ``_flash_decode_kernel``
with ``win_kv``). For a CUDA tensor each wrapper launches its kernel
(counted in ``<wrapper>.launches``) or raises; for a CPU tensor it
computes the same function with its ``*_reference`` plain version. There
is no other route between the two.

Cache layout contract (shared with ``ops/kvcache.py`` and
``models/shape_opt.py``): one tensor (2, L, B, S, H*D) of values, K at
index 0 and V at index 1, flat head rows; the quantized caches add
scales (2, L, B, 1, S) f32. Only the live rows are read. On the card the
quantized kernels that stream the scales need S % 4 == 0 (the port's
caches pad S to 512).

Numerics of the quantized tiers (the TPU kernels' contract): the K scale
multiplies the f32 logits, the running sum is built from the unscaled
probabilities, the V scale then multiplies them, and with bf16 queries
they are rounded to bf16 before P.V, which accumulates in f32.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from meshanything_tpu_torch.ops import _build
from meshanything_tpu_torch.ops.kvcache import unpack_int4

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CACHE_FORMATS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.int32: 3}
_HEAD_DIMS = (8, 64)               # instantiated in both CUDA sources
_MAX_WINDOW = 16                   # K4 is instantiated for W <= 16
_TILE = 128                         # K4 of csrc/decode_attention_fast.cu: rows per split unit
_FAST_BLOCKS_PER_SM = 2             # K4 of csrc/decode_attention_fast.cu: blocks per SM
K1_TILE = {torch.float32: 8, torch.bfloat16: 16}   # rows a tile of K1's ring, by dtype
WINDOW_TILE = 16                    # rows a tile of the bf16 K4's ring
QUANT_TILE = 32                     # rows a tile of K2, K3 and the int8/int4 tensor-core K4
_MAX_HEADS = 16                     # the row-stream kernels: one warp a head
_FOLD_COUNTERS = 65536              # int32 ticket counters a workspace: B * (1 + groups) of a call


def _lengths(cur_len, max_len, s: int, device: torch.device):
    """(cur_len, max_len) of a K1-K3 call. ``cur_len`` is a Python int
    (``max_len`` defaults to it) or a 0-d int32 tensor on the call's
    device that the kernel reads there (``max_len`` defaults to the
    cache's length ``s``). ``max_len`` bounds the live length and plans
    the grid; the host checks it, never a device length."""
    if isinstance(cur_len, torch.Tensor):
        if cur_len.dim() != 0 or cur_len.dtype != torch.int32:
            raise TypeError(f"a tensor cur_len must be a 0-d int32 tensor, got shape "
                            f"{tuple(cur_len.shape)} {cur_len.dtype}")
        if cur_len.device != device:
            raise ValueError(f"cur_len on {cur_len.device} but the call on {device}")
        max_len = s if max_len is None else int(max_len)
        if not 1 <= max_len <= s:
            raise ValueError(f"max_len {max_len} outside [1, {s}]")
        return cur_len, max_len
    cur_len = int(cur_len)
    max_len = cur_len if max_len is None else int(max_len)
    if not 1 <= cur_len <= s:
        raise ValueError(f"cur_len {cur_len} outside [1, {s}]")
    if not cur_len <= max_len <= s:
        raise ValueError(f"max_len {max_len} outside [cur_len {cur_len}, {s}]")
    return cur_len, max_len


def _live_rows(cur_len, n: int, device: torch.device) -> torch.Tensor:
    """(n,) bool: row < cur_len (an int or a 0-d tensor on ``device``)."""
    return torch.arange(n, device=device) < cur_len


def _single_query_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            ks: Optional[torch.Tensor], vs: Optional[torch.Tensor],
                            live: torch.Tensor) -> torch.Tensor:
    """The plain math of K1-K3 over the rows ``live`` (N,) marks of k, v
    (B, N, H*D) f32 (ks, vs (B, N) f32 scales or None). Rows past the
    live ones are masked, never read into a sum: NaN there does not reach
    the output. Every sum over rows runs in row order (``cumsum``), so a
    call over more masked rows is bit-equal to one over fewer. Returns
    (B, H, D) in q's dtype."""
    b, h, d = q.shape
    n = k.shape[1]
    seen = live[None, :, None]
    k = torch.where(seen, k, 0.0).reshape(b, n, h, d)
    v = torch.where(seen, v, 0.0).reshape(b, n, h, d)
    logits = (q.float()[:, None] * k).sum(dim=-1).transpose(1, 2) * (1.0 / math.sqrt(d))
    if ks is not None:
        logits = logits * torch.where(live, ks, 0.0)[:, None, :]
    logits = torch.where(live, logits, float("-inf"))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))       # (B, H, N)
    l_sum = p.cumsum(dim=-1)[..., -1:]
    if vs is not None:
        p = p * torch.where(live, vs, 0.0)[:, None, :]
        if q.dtype != torch.float32:     # the quantized tiers' bf16 P
            p = p.to(q.dtype).float()
    acc = (p.transpose(1, 2)[..., None] * v).cumsum(dim=1)[:, -1]    # (B, H, D)
    return (acc / l_sum.clamp_min(1e-30)).to(q.dtype)


def _check(q: torch.Tensor, kv_cache: torch.Tensor, layer: int, cur_len,
           max_len: Optional[int] = None):
    """Check a K1 call; returns its (cur_len, max_len) (``_lengths``)."""
    if q.dim() != 3 or kv_cache.dim() != 5:
        raise ValueError(f"expected q (B, H, D) and kv_cache (2, L, B, S, H*D); "
                         f"got {tuple(q.shape)} and {tuple(kv_cache.shape)}")
    b, h, d = q.shape
    two, n_layers, bk, s, hd = kv_cache.shape
    if two != 2 or bk != b or hd != h * d:
        raise ValueError(f"kv_cache {tuple(kv_cache.shape)} does not match q {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODES or kv_cache.dtype != q.dtype:
        raise TypeError(f"q and kv_cache must share dtype float32 or bfloat16; "
                        f"got {q.dtype} and {kv_cache.dtype}")
    if q.device != kv_cache.device:
        raise ValueError(f"q on {q.device} but kv_cache on {kv_cache.device}")
    if not (q.is_contiguous() and kv_cache.is_contiguous()):
        raise ValueError("q and kv_cache must be contiguous")
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} outside [0, {n_layers})")
    return _lengths(cur_len, max_len, s, q.device)


def decode_attention_reference(q: torch.Tensor, kv_cache: torch.Tensor, layer: int, cur_len,
                               max_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of K1: the same f32 math on the live rows.

    q (B, H, D); kv_cache (2, L, B, S, H*D); returns (B, H, D) in q's
    dtype. Logits in f32 scaled by 1/sqrt(D) after the dot; P.V with P
    in f32; out = acc / max(l, 1e-30). ``cur_len``, ``max_len`` as
    ``decode_attention``'s: the rows [0, max_len) are taken and those
    past cur_len masked, so a device length is never read on the host."""
    cur_len, max_len = _lengths(cur_len, max_len, kv_cache.shape[3], q.device)
    k = kv_cache[0, layer, :, :max_len].float()
    v = kv_cache[1, layer, :, :max_len].float()
    return _single_query_reference(q, k, v, None, None, _live_rows(cur_len, max_len, q.device))


def _kernel():
    lib = _build.load("decode_attention")
    fn = lib.lib.mt_decode_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_int64] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.lib.mt_error_string.argtypes = [ctypes.c_int]
        lib.lib.mt_error_string.restype = ctypes.c_char_p
    return lib.lib


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream_ptr(device: torch.device) -> int:
    """The current stream of ``device`` as the integer the C interface takes."""
    if _raw_stream is not None:
        return _raw_stream(device.index)
    return torch.cuda.current_stream(device).cuda_stream


class FoldWorkspace:
    """What the folded combine (``csrc/split_fold.cuh``) needs between and
    across calls: the ticket counters, zeros that every launch leaves at
    zero, and one f32 buffer for the splits' partials, grown to the
    largest call so far. One a (device, stream), made at the first call
    there and shared by K1, the bf16 K4 and T4, so that a call allocates
    only its output: the calls of one stream run in order (a kernel's
    partials are dead when the next kernel starts), and two streams never
    share counters or partials. A CUDA graph is captured on a stream that
    has made its workspace (warm up on the capture stream); its replays
    use that stream's workspace wherever they are enqueued, so they must
    not run beside other work of the stream they were captured on. A
    launch that fails is refused before it runs and leaves the counters
    at zero."""

    def __init__(self, device: torch.device):
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the first call on a stream makes its fold counters: make it "
                               "outside a CUDA-graph capture (warm up on the capture stream)")
        self.device = device
        self.length = torch.ones(1, dtype=torch.int32, device=device)   # an int call's cur_len
        self.counters = torch.zeros(_FOLD_COUNTERS, dtype=torch.int32, device=device)
        self.partials = torch.empty(1 << 20, dtype=torch.float32, device=device)
        self._outgrown: list = []    # kept: a captured CUDA graph may still write to them

    def pointers(self, batch: int, nsplit: int, group: int, rows: int, d: int):
        """(o_part, ml_part, counters) device pointers for a call with
        ``nsplit`` splits folded in groups of ``group`` over ``rows`` x d
        outputs a batch row: o_part (B, nsplit + ngroups, rows, d) f32,
        then ml_part (B, nsplit + ngroups, rows, 2)."""
        ngroups = -(-nsplit // group)
        if batch * (1 + ngroups) > self.counters.numel():
            raise ValueError(f"batch {batch} in {ngroups} fold groups needs more counters than "
                             f"{self.counters.numel()}")
        n_o = batch * (nsplit + ngroups) * rows * d
        need = n_o + batch * (nsplit + ngroups) * rows * 2
        if need > self.partials.numel():
            self._outgrown.append(self.partials)
            self.partials = torch.empty(1 << (need - 1).bit_length(), dtype=torch.float32,
                                        device=self.device)
        base = self.partials.data_ptr()
        return base, base + 4 * n_o, self.counters.data_ptr()

    def length_pointer(self, cur_len) -> int:
        """The device address of a call's live length: a tensor length's
        own, or an int written by a fill kernel into this stream's scalar
        (no allocation and no host copy a call; the stream runs the fill
        after the previous call has read the scalar and before this one)."""
        if isinstance(cur_len, torch.Tensor):
            return cur_len.data_ptr()
        self.length.fill_(cur_len)
        return self.length.data_ptr()


_workspaces: dict = {}


def fold_workspace(device: torch.device, stream: int) -> FoldWorkspace:
    """The ``FoldWorkspace`` of ``stream`` (its raw pointer, as
    ``_stream_ptr`` gives it) on ``device``, made at the first call."""
    ws = _workspaces.get((device.index, stream))
    if ws is None:
        ws = _workspaces[(device.index, stream)] = FoldWorkspace(device)
    return ws


def fold_group(nsplit: int) -> int:
    """Splits a group of the two-level fold: every split in one group up
    to 24 splits (two batches of the fold's loads), about sqrt(nsplit)
    beyond (132 splits: 11 groups of 12, one batch a level)."""
    return nsplit if nsplit <= 24 else math.isqrt(nsplit - 1) + 1


def split_bounds(n_rows: int, tile: int, nsplit: int) -> list[tuple[int, int]]:
    """The rows [row0, row1) of each of ``nsplit`` splits of ``n_rows``
    rows, as the kernels cut them: whole tiles, balanced to within one
    tile; a split is empty only where there are fewer tiles than splits."""
    tiles = -(-n_rows // tile)
    return [(s * tiles // nsplit * tile, min(n_rows, (s + 1) * tiles // nsplit * tile))
            for s in range(nsplit)]


def split_plan(batch: int, cur_len: int, num_sms: int, tile: int) -> tuple[int, int]:
    """(nsplit, group) of K1's grid (B, nsplit): about one block an SM
    over ``batch * nsplit`` and never more (a block holds most of an SM's
    shared memory), at most one split a tile so that no split is empty
    (``split_bounds``); folded in groups of ``group`` splits.

    A call whose length the kernel reads on the device is launched with
    the plan of its bound ``max_len``, and each block takes the plan of
    the live length inside it (``csrc/split_fold.cuh::plan_for``)."""
    tiles = -(-cur_len // tile)
    nsplit = max(1, min(tiles, num_sms // batch))
    return nsplit, fold_group(nsplit)


def window_split_plan(batch: int, n_rows: int, num_sms: int) -> tuple[int, int]:
    """(nsplit_cache, group) of the bf16 K4's grid (B, nsplit_cache + 1):
    splits of the ``n_rows`` cache rows a base can reach (S - W) plus the
    window tile's block, about one block an SM. On the card a block takes
    its share of the tiles below base[b], so the grid needs no read of
    ``base``. The window's block is short: with many splits a row (small
    batch) it takes one of the row's blocks, with few it rides behind
    them. ``group`` counts the window's split too."""
    tiles = -(-n_rows // WINDOW_TILE)
    budget = max(1, num_sms // batch)
    nsplit = max(1, min(tiles, budget - 1 if budget >= 16 else budget))
    return nsplit, fold_group(nsplit + 1)


def quant_window_split_plan(batch: int, n_rows: int, num_sms: int) -> tuple[int, int]:
    """(nsplit, group) of the int8/int4 tensor-core K4's grid (B, nsplit):
    splits of the ``n_rows`` cache rows a base can reach (S - W) in tiles
    of ``QUANT_TILE`` rows, at most one block an SM over the batch (one
    wave), the last split of a row also taking the window tile. As for the
    bf16 K4, a block takes its share of the tiles below base[b] on the
    card, so the grid needs no read of ``base``."""
    tiles = -(-n_rows // QUANT_TILE)
    nsplit = max(1, min(tiles, num_sms // batch))
    return nsplit, fold_group(nsplit)


def decode_attention(q: torch.Tensor, kv_cache: torch.Tensor, layer: int, cur_len,
                     max_len: Optional[int] = None) -> torch.Tensor:
    """Single-query attention of q (B, H, D) over rows [0, cur_len) of
    ``kv_cache[:, layer]``; returns (B, H, D) in q's dtype.

    ``cur_len`` is a Python int or a 0-d int32 tensor on q's device, which
    the kernel reads there (so that a CUDA graph of a decode step replays
    at every length); ``max_len`` bounds it (default: the int, or the
    cache's length for a tensor) and plans the grid. Either way the
    output is that of the call planned for the live length, bit for bit.

    CUDA tensors go to the kernel (counted in ``decode_attention.launches``);
    CPU tensors to ``decode_attention_reference``."""
    layer = int(layer)
    cur_len, max_len = _check(q, kv_cache, layer, cur_len, max_len)
    if q.device.type == "cpu":
        return decode_attention_reference(q, kv_cache, layer, cur_len, max_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda tensors, not {q.device}")
    b, h, d = q.shape
    if d not in _HEAD_DIMS or h > _MAX_HEADS:
        raise ValueError(f"head_dim {d} with {h} heads not built; the kernel takes head_dim "
                         f"{_HEAD_DIMS} and at most {_MAX_HEADS} heads")
    if q.data_ptr() % 16 or kv_cache.data_ptr() % 16:
        raise ValueError("q and kv_cache must be 16-byte aligned")
    lib = _kernel()
    _, n_layers, _, s, _ = kv_cache.shape
    nsplit, group = split_plan(b, max_len, _num_sms(q.device.index), K1_TILE[q.dtype])
    stream = _stream_ptr(q.device)
    ws = fold_workspace(q.device, stream)
    o_part, ml_part, counters = ws.pointers(b, nsplit, group, h, d)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.mt_decode_attention(
            q.data_ptr(), kv_cache.data_ptr(), out.data_ptr(), o_part, ml_part, counters,
            ws.length_pointer(cur_len), _DTYPE_CODES[q.dtype], b, h, d, n_layers, s, layer,
            max_len, nsplit, group, stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"{lib.mt_error_string(err).decode()} (cudaError {err})")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


# ---------------------------------------------------------------------------
# K2, K3, K4: the fast tier


def cache_rows_f32(values: torch.Tensor) -> torch.Tensor:
    """Cache rows (..., packed) -> (..., H*D) f32: bf16/f32 values, int8
    codes, or int4 plane words unpacked to codes."""
    if values.dtype == torch.int32:
        return unpack_int4(values).float()
    return values.float()


def _attend_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      ks: Optional[torch.Tensor], vs: Optional[torch.Tensor],
                      mask: torch.Tensor, p_terms: Optional[int] = None) -> torch.Tensor:
    """The plain math of K2-K4. q (B, W, H, D); k, v (B, N, H*D) f32
    rows; ks, vs (B, N) f32 scales or None; mask (B, W, N) bool (every
    query sees at least one row). Rows no query sees are never read, so
    NaN there does not reach the output. Returns (B, W, H, D) in q's
    dtype.

    ``p_terms`` emulates the tensor-core K4, which feeds P to its P.V
    product as that many bf16 terms (p0 = bf16(p), p1 = bf16(p - p0), ..),
    each product exact in f32: P is replaced by the sum of its terms. The
    running sum is still built from the f32 P."""
    b, w, h, d = q.shape
    n = k.shape[1]
    seen = mask.any(dim=1)                                       # (B, N)
    k = torch.where(seen[..., None], k, 0.0).reshape(b, n, h, d)
    v = torch.where(seen[..., None], v, 0.0).reshape(b, n, h, d)
    logits = torch.einsum("bwhd,bnhd->bwhn", q.float(), k) * (1.0 / math.sqrt(d))
    if ks is not None:
        logits = logits * torch.where(seen, ks, 0.0)[:, None, None, :]
    logits = torch.where(mask[:, :, None, :], logits, float("-inf"))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    l_sum = p.sum(dim=-1, keepdim=True)
    if vs is not None:
        p = p * torch.where(seen, vs, 0.0)[:, None, None, :]
        if q.dtype != torch.float32:     # the quantized tiers' bf16 P
            p = p.to(q.dtype).float()
    if p_terms is not None:
        rest, p = p, torch.zeros_like(p)
        for _ in range(p_terms):
            term = rest.bfloat16().float()
            p, rest = p + term, rest - term
    acc = torch.einsum("bwhn,bnhd->bwhd", p, v)
    return (acc / l_sum.clamp_min(1e-30)).to(q.dtype)


def _check_quant(q, values, scales, layer, cur_len, max_len, code_dtype, packed_div):
    """Check a K2/K3 call; returns its (cur_len, max_len) (``_lengths``)."""
    if q.dim() != 3 or values.dim() != 5 or scales is None or scales.dim() != 5:
        raise ValueError(f"expected q (B, H, D), values (2, L, B, S, packed) and scales "
                         f"(2, L, B, 1, S); got {tuple(q.shape)}, {tuple(values.shape)}, "
                         f"{None if scales is None else tuple(scales.shape)}")
    b, h, d = q.shape
    two, n_layers, bk, s, packed = values.shape
    if two != 2 or bk != b or packed * packed_div != h * d:
        raise ValueError(f"values {tuple(values.shape)} do not match q {tuple(q.shape)}")
    if tuple(scales.shape) != (2, n_layers, b, 1, s):
        raise ValueError(f"scales {tuple(scales.shape)} do not match values {tuple(values.shape)}")
    if q.dtype not in _DTYPE_CODES or values.dtype != code_dtype or scales.dtype != torch.float32:
        raise TypeError(f"expected q float32/bfloat16, values {code_dtype} and scales float32; "
                        f"got {q.dtype}, {values.dtype} and {scales.dtype}")
    if not (q.device == values.device == scales.device):
        raise ValueError("q, values and scales must be on one device")
    if not (q.is_contiguous() and values.is_contiguous() and scales.is_contiguous()):
        raise ValueError("q, values and scales must be contiguous")
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} outside [0, {n_layers})")
    return _lengths(cur_len, max_len, s, q.device)


def decode_attention_quant_reference(q: torch.Tensor, values: torch.Tensor,
                                     scales: torch.Tensor, layer: int, cur_len,
                                     max_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of K2 (int8 values) and K3 (int4 plane
    words): q (B, H, D) over rows [0, cur_len) of layer ``layer``;
    ``cur_len`` and ``max_len`` as ``decode_attention_reference``'s."""
    cur_len, max_len = _lengths(cur_len, max_len, values.shape[3], q.device)
    rows = slice(0, max_len)
    k = cache_rows_f32(values[0, layer, :, rows])
    v = cache_rows_f32(values[1, layer, :, rows])
    return _single_query_reference(q, k, v, scales[0, layer, :, 0, rows],
                                   scales[1, layer, :, 0, rows],
                                   _live_rows(cur_len, max_len, q.device))


def _fast_kernel():
    lib = _build.load("decode_attention_fast").lib
    if lib.mt_decode_attention_mq.argtypes is None:
        lib.mt_decode_attention_mq.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 2
                                               + [ctypes.c_int64] * 9 + [ctypes.c_void_p])
        lib.mt_decode_attention_mq.restype = ctypes.c_int
        lib.mt_fast_error_string.argtypes = [ctypes.c_int]
        lib.mt_fast_error_string.restype = ctypes.c_char_p
    return lib


def _quant_kernel():
    lib = _build.load("decode_attention_quant").lib
    if lib.mt_decode_attention_quant.argtypes is None:
        lib.mt_decode_attention_quant.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
                                                  + [ctypes.c_int64] * 9 + [ctypes.c_void_p])
        lib.mt_decode_attention_quant.restype = ctypes.c_int
        lib.mt_quant_error_string.argtypes = [ctypes.c_int]
        lib.mt_quant_error_string.restype = ctypes.c_char_p
    return lib


def fast_split_plan(batch: int, n_rows: int, num_sms: int) -> tuple[int, int]:
    """(rows_per_split, nsplit) for the grid (B, nsplit) of
    ``csrc/decode_attention_fast.cu``'s K4: about ``_FAST_BLOCKS_PER_SM``
    blocks per SM over ``n_rows`` rows, whole 128-row tiles per split, no
    empty split."""
    tiles = -(-n_rows // _TILE)
    want = -(-_FAST_BLOCKS_PER_SM * num_sms // batch)
    nsplit = max(1, min(tiles, want))
    rows_per_split = -(-tiles // nsplit) * _TILE
    return rows_per_split, -(-n_rows // rows_per_split)


def quant_split_plan(batch: int, cur_len: int, num_sms: int) -> tuple[int, int]:
    """(nsplit, group) of K2's and K3's grid (B, nsplit): K1's plan
    (``split_plan``) over tiles of ``QUANT_TILE`` rows, for the bound
    ``max_len`` of a device-length call."""
    return split_plan(batch, cur_len, num_sms, QUANT_TILE)


def _cuda_preflight(name: str, tensors, d: int) -> None:
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not built; the kernels take {_HEAD_DIMS}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: every tensor must be 16-byte aligned")


def _raise_on(err: int, name: str, error_string) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: {error_string(err).decode()} "
                           f"(cudaError {err})")


def _streamed_scales_check(name: str, s: int, h: int) -> None:
    if s % 4:
        raise ValueError(f"{name}: cache length {s} is not a multiple of 4 (the kernel copies "
                         f"the scales in runs of 4 rows)")
    if h > _MAX_HEADS:
        raise ValueError(f"{name}: {h} heads; the kernel takes at most {_MAX_HEADS}")


def _decode_attention_quant(q, values, scales, layer, cur_len, max_len, *, fmt, name, counted):
    layer = int(layer)
    cur_len, max_len = _check_quant(q, values, scales, layer, cur_len, max_len, *fmt)
    if q.device.type == "cpu":
        return decode_attention_quant_reference(q, values, scales, layer, cur_len, max_len)
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {q.device}")
    b, h, d = q.shape
    _, n_layers, _, s, _ = values.shape
    _cuda_preflight(name, (q, values, scales), d)
    _streamed_scales_check(name, s, h)
    lib = _quant_kernel()
    nsplit, group = quant_split_plan(b, max_len, _num_sms(q.device.index))
    stream = _stream_ptr(q.device)
    ws = fold_workspace(q.device, stream)
    o_part, ml_part, counters = ws.pointers(b, nsplit, group, h, d)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.mt_decode_attention_quant(
            q.data_ptr(), values.data_ptr(), scales.data_ptr(), out.data_ptr(), o_part, ml_part,
            counters, ws.length_pointer(cur_len), _CACHE_FORMATS[values.dtype],
            _DTYPE_CODES[q.dtype], b, h, d, n_layers, s, layer, max_len, nsplit, group, stream)
    _raise_on(err, name, lib.mt_quant_error_string)
    counted.launches += 1
    return out


def decode_attention_int8(q: torch.Tensor, values: torch.Tensor, scales: torch.Tensor,
                          layer: int, cur_len, max_len: Optional[int] = None) -> torch.Tensor:
    """K2: q (B, H, D) over rows [0, cur_len) of an int8 cache (values
    (2, L, B, S, H*D) int8, scales (2, L, B, 1, S) f32); returns
    (B, H, D) in q's dtype. ``cur_len``, ``max_len``: as K1's."""
    return _decode_attention_quant(q, values, scales, layer, cur_len, max_len,
                                   fmt=(torch.int8, 1), name="decode_attention_int8",
                                   counted=decode_attention_int8)


def decode_attention_int4(q: torch.Tensor, values: torch.Tensor, scales: torch.Tensor,
                          layer: int, cur_len, max_len: Optional[int] = None) -> torch.Tensor:
    """K3: as K2 over an int4 cache of plane words (values
    (2, L, B, S, H*D/8) int32)."""
    return _decode_attention_quant(q, values, scales, layer, cur_len, max_len,
                                   fmt=(torch.int32, 8), name="decode_attention_int4",
                                   counted=decode_attention_int4)


decode_attention_int8.launches = 0
decode_attention_int4.launches = 0


def _check_mq(q, kv, scales, layer, base, win_k, win_v, win_ks, win_vs):
    if q.dim() != 4 or kv.dim() != 5 or base.dim() != 1:
        raise ValueError(f"expected q (B, W, H, D), kv (2, L, B, S, packed) and base (B,); got "
                         f"{tuple(q.shape)}, {tuple(kv.shape)} and {tuple(base.shape)}")
    b, w, h, d = q.shape
    two, n_layers, bk, s, packed = kv.shape
    if kv.dtype not in _CACHE_FORMATS:
        raise TypeError(f"cache dtype {kv.dtype} is none of {list(_CACHE_FORMATS)}")
    quantized = kv.dtype in (torch.int8, torch.int32)
    div = 8 if kv.dtype == torch.int32 else 1
    if two != 2 or bk != b or packed * div != h * d or base.shape[0] != b:
        raise ValueError(f"kv {tuple(kv.shape)} / base {tuple(base.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if not 1 <= w <= _MAX_WINDOW:
        raise ValueError(f"window {w} outside [1, {_MAX_WINDOW}]")
    if q.dtype not in _DTYPE_CODES or (not quantized and kv.dtype != q.dtype):
        raise TypeError(f"q must be float32/bfloat16 and an unquantized cache of q's dtype; "
                        f"got {q.dtype} and {kv.dtype}")
    if base.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"base must be an integer tensor, got {base.dtype}")
    for name, t in (("win_k", win_k), ("win_v", win_v)):
        if tuple(t.shape) != (b, w, packed) or t.dtype != kv.dtype:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}: expected {(b, w, packed)} "
                             f"{kv.dtype}")
    quant_args = (scales, win_ks, win_vs)
    if quantized:
        if any(t is None for t in quant_args):
            raise ValueError("a quantized cache needs scales, win_ks and win_vs")
        if tuple(scales.shape) != (2, n_layers, b, 1, s) or scales.dtype != torch.float32:
            raise ValueError(f"scales {tuple(scales.shape)} {scales.dtype} do not match kv")
        for name, t in (("win_ks", win_ks), ("win_vs", win_vs)):
            if tuple(t.shape) != (b, 1, w) or t.dtype != torch.float32:
                raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}: expected {(b, 1, w)} f32")
    elif any(t is not None for t in quant_args):
        raise ValueError("scales belong to the quantized caches only")
    tensors = [t for t in (q, kv, base, win_k, win_v, *quant_args) if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError("every argument must be on q's device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("every argument must be contiguous")
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} outside [0, {n_layers})")
    if s < w:
        raise ValueError(f"cache length {s} is shorter than the window {w}")


def decode_attention_mq_reference(q: torch.Tensor, kv: torch.Tensor,
                                  scales: Optional[torch.Tensor], layer: int,
                                  base: torch.Tensor, win_k: torch.Tensor, win_v: torch.Tensor,
                                  win_ks: Optional[torch.Tensor] = None,
                                  win_vs: Optional[torch.Tensor] = None,
                                  n_rows: Optional[int] = None,
                                  p_terms: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of K4 (see ``decode_attention_mq``).
    ``n_rows`` (>= max(base), default max(base)) bounds the cache rows it
    slices; given, it spares the host a read of ``base``. ``p_terms``: see
    ``_attend_reference``."""
    b, w = q.shape[:2]
    n = int(base.max()) if n_rows is None else n_rows
    k = torch.cat([cache_rows_f32(kv[0, layer, :, :n]), cache_rows_f32(win_k)], dim=1)
    v = torch.cat([cache_rows_f32(kv[1, layer, :, :n]), cache_rows_f32(win_v)], dim=1)
    in_cache = torch.arange(n, device=q.device)[None, :] < base[:, None].to(q.device)
    causal = torch.ones((w, w), dtype=torch.bool, device=q.device).tril()
    mask = torch.cat([in_cache[:, None, :].expand(b, w, n), causal[None].expand(b, w, w)], dim=-1)
    ks = vs = None
    if scales is not None:
        ks = torch.cat([scales[0, layer, :, 0, :n], win_ks[:, 0]], dim=1)
        vs = torch.cat([scales[1, layer, :, 0, :n], win_vs[:, 0]], dim=1)
    return _attend_reference(q, k, v, ks, vs, mask, p_terms)


def mq_kernel_for(cache_dtype: torch.dtype, head_dim: int, query_dtype: torch.dtype) -> str:
    """Which of K4's kernels takes a cache of ``cache_dtype`` at
    ``head_dim`` with queries of ``query_dtype``: ``"window"``
    (``csrc/decode_attention_window.cu`` on tensor cores: a bf16 cache at
    head width 64), ``"window_quant"`` (the same file's int8/int4
    instances: bf16 queries at head width 64) or ``"tile_split"``
    (``csrc/decode_attention_fast.cu``: the f32 cache, the quantized caches
    with f32 queries and the small config's head width). Raises on what
    none is built for."""
    if cache_dtype not in _CACHE_FORMATS:
        raise TypeError(f"cache dtype {cache_dtype} is none of {list(_CACHE_FORMATS)}")
    if query_dtype not in _DTYPE_CODES:
        raise TypeError(f"query dtype {query_dtype} is none of {list(_DTYPE_CODES)}")
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not built; the kernels take {_HEAD_DIMS}")
    if head_dim == 64 and query_dtype == torch.bfloat16:
        if cache_dtype == torch.bfloat16:
            return "window"
        if cache_dtype in (torch.int8, torch.int32):
            return "window_quant"
    return "tile_split"


def _window_kernel():
    lib = _build.load("decode_attention_window").lib
    if lib.mt_decode_attention_window.argtypes is None:
        lib.mt_decode_attention_window.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int64] * 9
                                                   + [ctypes.c_void_p])
        lib.mt_decode_attention_window.restype = ctypes.c_int
        lib.mt_decode_attention_window_quant.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int] + [ctypes.c_int64] * 9 + [ctypes.c_void_p])
        lib.mt_decode_attention_window_quant.restype = ctypes.c_int
        lib.mt_window_error_string.argtypes = [ctypes.c_int]
        lib.mt_window_error_string.restype = ctypes.c_char_p
    return lib


def decode_attention_mq(q: torch.Tensor, kv: torch.Tensor, scales: Optional[torch.Tensor],
                        layer: int, base: torch.Tensor, win_k: torch.Tensor,
                        win_v: torch.Tensor, win_ks: Optional[torch.Tensor] = None,
                        win_vs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4: the window queries q (B, W, H, D) of each row b see the cache
    rows [0, base[b]) of layer ``layer`` and then, as one causal tile,
    the window rows: query w sees window rows 0..w.

    kv: (2, L, B, S, H*D) float32/bfloat16 of q's dtype (``scales`` None),
    int8 codes, or (2, L, B, S, H*D/8) int32 int4 plane words, with
    ``scales`` (2, L, B, 1, S) f32. base: (B,) int with base[b] + W <= S
    (int32 spares the card a conversion a call). win_k, win_v:
    (B, W, packed) in the cache's dtype; win_ks, win_vs (B, 1, W) f32 for
    the quantized caches. Returns (B, W, H, D) in q's dtype. On the card
    base[b] stays on the device; rows past S are never read."""
    layer = int(layer)
    _check_mq(q, kv, scales, layer, base, win_k, win_v, win_ks, win_vs)
    if q.device.type == "cpu":
        return decode_attention_mq_reference(q, kv, scales, layer, base, win_k, win_v,
                                             win_ks, win_vs)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_mq runs on cpu or cuda tensors, not {q.device}")
    b, w, h, d = q.shape
    kernel = mq_kernel_for(kv.dtype, d, q.dtype)
    base32 = base if base.dtype == torch.int32 else base.to(torch.int32)
    tensors = [t for t in (q, kv, scales, base32, win_k, win_v, win_ks, win_vs) if t is not None]
    _cuda_preflight("decode_attention_mq", tensors, d)
    _, n_layers, _, s, _ = kv.shape
    out = torch.empty_like(q)
    stream = _stream_ptr(q.device)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    if kernel in ("window", "window_quant"):
        if h > _MAX_HEADS:
            raise ValueError(f"{h} heads: the window kernel takes at most {_MAX_HEADS}")
        lib = _window_kernel()
        quant = kernel == "window_quant"
        if quant:
            _streamed_scales_check("decode_attention_mq", s, h)
        plan = quant_window_split_plan if quant else window_split_plan
        nsplit, group = plan(b, max(1, s - w), _num_sms(q.device.index))
        blocks = nsplit if quant else nsplit + 1    # the bf16 kernel's window tile: a block
        o_part, ml_part, counters = fold_workspace(q.device, stream).pointers(
            b, blocks, group, w * h, d)
        with torch.cuda.device(q.device):
            if quant:
                err = lib.mt_decode_attention_window_quant(
                    q.data_ptr(), kv.data_ptr(), scales.data_ptr(), base32.data_ptr(),
                    win_k.data_ptr(), win_v.data_ptr(), win_ks.data_ptr(), win_vs.data_ptr(),
                    out.data_ptr(), o_part, ml_part, counters, _CACHE_FORMATS[kv.dtype], b, w, h,
                    d, n_layers, s, layer, nsplit, group, stream)
            else:
                err = lib.mt_decode_attention_window(
                    q.data_ptr(), kv.data_ptr(), base32.data_ptr(), win_k.data_ptr(),
                    win_v.data_ptr(), out.data_ptr(), o_part, ml_part, counters, b, w, h, d,
                    n_layers, s, layer, nsplit, group, stream)
        _raise_on(err, "decode_attention_mq", lib.mt_window_error_string)
        decode_attention_mq.launches += 1
        if quant:
            decode_attention_mq.quant_window_launches += 1
        else:
            decode_attention_mq.window_launches += 1
        return out
    lib = _fast_kernel()
    rows_per_split, nsplit = fast_split_plan(b, s, _num_sms(q.device.index))
    parts = b * w * h * (nsplit + 1)
    o_part = torch.empty((parts, d), dtype=torch.float32, device=q.device)
    ml_part = torch.empty((parts, 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.mt_decode_attention_mq(
            q.data_ptr(), kv.data_ptr(), ptr(scales), base32.data_ptr(), win_k.data_ptr(),
            win_v.data_ptr(), ptr(win_ks), ptr(win_vs), out.data_ptr(), o_part.data_ptr(),
            ml_part.data_ptr(), _CACHE_FORMATS[kv.dtype], _DTYPE_CODES[q.dtype], b, w, h, d,
            n_layers, s, layer, rows_per_split, nsplit, stream)
    _raise_on(err, "decode_attention_mq", lib.mt_fast_error_string)
    decode_attention_mq.launches += 1
    return out


decode_attention_mq.launches = 0                # of any of its kernels
decode_attention_mq.window_launches = 0         # of them, the bf16 tensor-core kernel's
decode_attention_mq.quant_window_launches = 0   # and the int8/int4 tensor-core kernel's
