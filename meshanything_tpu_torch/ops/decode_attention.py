"""Cached attention for the decode loop: four kernels, each with its
plain PyTorch version beside it.

  K1 ``decode_attention``: single query over a bf16/f32 cache
     (``csrc/decode_attention.cu``);
  K2 ``decode_attention_int8``: single query over an int8 cache;
  K3 ``decode_attention_int4``: single query over an int4 plane cache;
  K4 ``decode_attention_mq``: W window queries per row over the confirmed
     rows of any of the four caches plus the window rows as one causal
     tile (K2-K4: ``csrc/decode_attention_fast.cu``).

They port the TPU kernels of ``meshanything_tpu/ops/decode_attention.py``
(K1-K3 ``_flash_decode_pipelined_kernel``, K4 ``_flash_decode_kernel``
with ``win_kv``). For a CUDA tensor each wrapper launches its kernel
(counted in ``<wrapper>.launches``) or raises; for a CPU tensor it
computes the same function with its ``*_reference`` plain version. There
is no other route between the two.

Cache layout contract (shared with ``ops/kvcache.py`` and
``models/shape_opt.py``): one tensor (2, L, B, S, H*D) of values, K at
index 0 and V at index 1, flat head rows; the quantized caches add
scales (2, L, B, 1, S) f32. Only the live rows are read.

Numerics of the quantized tiers (the TPU kernels' contract): the K scale
multiplies the f32 logits, the running sum is built from the unscaled
probabilities, the V scale then multiplies them, and with bf16 queries
they are rounded to bf16 before P.V, which accumulates in f32.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from meshanything_tpu_torch.ops import _build
from meshanything_tpu_torch.ops.kvcache import unpack_int4

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CACHE_FORMATS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.int32: 3}
_HEAD_DIMS = (8, 64)               # instantiated in both CUDA sources
_MAX_WINDOW = 16                   # K4 is instantiated for W <= 16
_TILE = 128                         # cache rows per tile of the split kernel
_BLOCKS_PER_SM = 4                  # split target: this many blocks per SM
_FAST_BLOCKS_PER_SM = 2             # K2-K4: larger blocks, fewer per SM


def _check(q: torch.Tensor, kv_cache: torch.Tensor, layer: int, cur_len: int) -> None:
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
    if not 1 <= cur_len <= s:
        raise ValueError(f"cur_len {cur_len} outside [1, {s}]")


def decode_attention_reference(q: torch.Tensor, kv_cache: torch.Tensor,
                               layer: int, cur_len: int) -> torch.Tensor:
    """Plain PyTorch version of K1: the same f32 math on the live rows.

    q (B, H, D); kv_cache (2, L, B, S, H*D); returns (B, H, D) in q's
    dtype. Logits in f32 scaled by 1/sqrt(D) after the dot; P.V with P
    in f32; out = acc / max(l, 1e-30)."""
    b, h, d = q.shape
    k = kv_cache[0, layer, :, :cur_len].reshape(b, cur_len, h, d).float()
    v = kv_cache[1, layer, :, :cur_len].reshape(b, cur_len, h, d).float()
    logits = torch.einsum("bhd,bshd->bhs", q.float(), k) * (1.0 / math.sqrt(d))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    acc = torch.einsum("bhs,bshd->bhd", p, v)
    return (acc / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)


def _kernel():
    lib = _build.load("decode_attention")
    fn = lib.lib.mt_decode_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_int64] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.lib.mt_error_string.argtypes = [ctypes.c_int]
        lib.lib.mt_error_string.restype = ctypes.c_char_p
    return lib.lib


def split_plan(batch: int, heads: int, cur_len: int, num_sms: int) -> tuple[int, int]:
    """(rows_per_split, nsplit) for the flash-decoding grid (B*H, nsplit):
    enough blocks to give every SM ``_BLOCKS_PER_SM``, whole tiles per
    split, and no empty split."""
    tiles = -(-cur_len // _TILE)
    want = -(-_BLOCKS_PER_SM * num_sms // (batch * heads))
    nsplit = max(1, min(tiles, want))
    rows_per_split = -(-tiles // nsplit) * _TILE
    return rows_per_split, -(-cur_len // rows_per_split)


def decode_attention(q: torch.Tensor, kv_cache: torch.Tensor,
                     layer: int, cur_len: int) -> torch.Tensor:
    """Single-query attention of q (B, H, D) over rows [0, cur_len) of
    ``kv_cache[:, layer]``; returns (B, H, D) in q's dtype.

    CUDA tensors go to the kernel (counted in ``decode_attention.launches``);
    CPU tensors to ``decode_attention_reference``."""
    layer, cur_len = int(layer), int(cur_len)
    _check(q, kv_cache, layer, cur_len)
    if q.device.type == "cpu":
        return decode_attention_reference(q, kv_cache, layer, cur_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda tensors, not {q.device}")
    b, h, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not built; the kernel takes {_HEAD_DIMS}")
    if q.data_ptr() % 16 or kv_cache.data_ptr() % 16:
        raise ValueError("q and kv_cache must be 16-byte aligned")
    lib = _kernel()
    _, n_layers, _, s, _ = kv_cache.shape
    rows_per_split, nsplit = split_plan(
        b, h, cur_len, torch.cuda.get_device_properties(q.device).multi_processor_count)
    out = torch.empty_like(q)
    o_part = torch.empty((b * h * nsplit, d), dtype=torch.float32, device=q.device)
    ml_part = torch.empty((b * h * nsplit, 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.mt_decode_attention(
            q.data_ptr(), kv_cache.data_ptr(), out.data_ptr(), o_part.data_ptr(),
            ml_part.data_ptr(), _DTYPE_CODES[q.dtype], b, h, d, n_layers, s, layer,
            cur_len, rows_per_split, nsplit, torch.cuda.current_stream(q.device).cuda_stream)
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
                      mask: torch.Tensor) -> torch.Tensor:
    """The plain math of K2-K4. q (B, W, H, D); k, v (B, N, H*D) f32
    rows; ks, vs (B, N) f32 scales or None; mask (B, W, N) bool (every
    query sees at least one row). Rows no query sees are never read, so
    NaN there does not reach the output. Returns (B, W, H, D) in q's
    dtype."""
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
    acc = torch.einsum("bwhn,bnhd->bwhd", p, v)
    return (acc / l_sum.clamp_min(1e-30)).to(q.dtype)


def _check_quant(q, values, scales, layer, cur_len, code_dtype, packed_div):
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
    if not 1 <= cur_len <= s:
        raise ValueError(f"cur_len {cur_len} outside [1, {s}]")


def decode_attention_quant_reference(q: torch.Tensor, values: torch.Tensor,
                                     scales: torch.Tensor, layer: int,
                                     cur_len: int) -> torch.Tensor:
    """Plain PyTorch version of K2 (int8 values) and K3 (int4 plane
    words): q (B, H, D) over rows [0, cur_len) of layer ``layer``."""
    rows = slice(0, cur_len)
    k = cache_rows_f32(values[0, layer, :, rows])
    v = cache_rows_f32(values[1, layer, :, rows])
    mask = torch.ones((q.shape[0], 1, cur_len), dtype=torch.bool, device=q.device)
    return _attend_reference(q[:, None], k, v, scales[0, layer, :, 0, rows],
                             scales[1, layer, :, 0, rows], mask)[:, 0]


def _fast_kernel():
    lib = _build.load("decode_attention_fast")
    if lib.lib.mt_decode_attention_quant.argtypes is None:
        fn = lib.lib.mt_decode_attention_quant
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_int64] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.lib.mt_decode_attention_mq
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 2 + [ctypes.c_int64] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.lib.mt_fast_error_string.argtypes = [ctypes.c_int]
        lib.lib.mt_fast_error_string.restype = ctypes.c_char_p
    return lib.lib


def fast_split_plan(batch: int, n_rows: int, num_sms: int) -> tuple[int, int]:
    """(rows_per_split, nsplit) for K2-K4's grid (B, nsplit): about
    ``_FAST_BLOCKS_PER_SM`` blocks per SM over ``n_rows`` rows, whole
    128-row tiles per split, no empty split."""
    tiles = -(-n_rows // _TILE)
    want = -(-_FAST_BLOCKS_PER_SM * num_sms // batch)
    nsplit = max(1, min(tiles, want))
    rows_per_split = -(-tiles // nsplit) * _TILE
    return rows_per_split, -(-n_rows // rows_per_split)


def _cuda_preflight(name: str, tensors, d: int) -> None:
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not built; the kernels take {_HEAD_DIMS}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: every tensor must be 16-byte aligned")


def _raise_on(lib, err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.mt_fast_error_string(err).decode()} (cudaError {err})")


def _decode_attention_quant(q, values, scales, layer, cur_len, *, fmt, name, counted):
    layer, cur_len = int(layer), int(cur_len)
    _check_quant(q, values, scales, layer, cur_len, *fmt)
    if q.device.type == "cpu":
        return decode_attention_quant_reference(q, values, scales, layer, cur_len)
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {q.device}")
    b, h, d = q.shape
    _cuda_preflight(name, (q, values, scales), d)
    lib = _fast_kernel()
    _, n_layers, _, s, _ = values.shape
    rows_per_split, nsplit = fast_split_plan(
        b, cur_len, torch.cuda.get_device_properties(q.device).multi_processor_count)
    out = torch.empty_like(q)
    o_part = torch.empty((b * h * nsplit, d), dtype=torch.float32, device=q.device)
    ml_part = torch.empty((b * h * nsplit, 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.mt_decode_attention_quant(
            q.data_ptr(), values.data_ptr(), scales.data_ptr(), out.data_ptr(),
            o_part.data_ptr(), ml_part.data_ptr(), _CACHE_FORMATS[values.dtype],
            _DTYPE_CODES[q.dtype], b, h, d, n_layers, s, layer, cur_len, rows_per_split, nsplit,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, name)
    counted.launches += 1
    return out


def decode_attention_int8(q: torch.Tensor, values: torch.Tensor, scales: torch.Tensor,
                          layer: int, cur_len: int) -> torch.Tensor:
    """K2: q (B, H, D) over rows [0, cur_len) of an int8 cache (values
    (2, L, B, S, H*D) int8, scales (2, L, B, 1, S) f32); returns
    (B, H, D) in q's dtype."""
    return _decode_attention_quant(q, values, scales, layer, cur_len, fmt=(torch.int8, 1),
                                   name="decode_attention_int8", counted=decode_attention_int8)


def decode_attention_int4(q: torch.Tensor, values: torch.Tensor, scales: torch.Tensor,
                          layer: int, cur_len: int) -> torch.Tensor:
    """K3: as K2 over an int4 cache of plane words (values
    (2, L, B, S, H*D/8) int32)."""
    return _decode_attention_quant(q, values, scales, layer, cur_len, fmt=(torch.int32, 8),
                                   name="decode_attention_int4", counted=decode_attention_int4)


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
                                  n_rows: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of K4 (see ``decode_attention_mq``).
    ``n_rows`` (>= max(base), default max(base)) bounds the cache rows it
    slices; given, it spares the host a read of ``base``."""
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
    return _attend_reference(q, k, v, ks, vs, mask)


def decode_attention_mq(q: torch.Tensor, kv: torch.Tensor, scales: Optional[torch.Tensor],
                        layer: int, base: torch.Tensor, win_k: torch.Tensor,
                        win_v: torch.Tensor, win_ks: Optional[torch.Tensor] = None,
                        win_vs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4: the window queries q (B, W, H, D) of each row b see the cache
    rows [0, base[b]) of layer ``layer`` and then, as one causal tile,
    the window rows: query w sees window rows 0..w.

    kv: (2, L, B, S, H*D) float32/bfloat16 of q's dtype (``scales`` None),
    int8 codes, or (2, L, B, S, H*D/8) int32 int4 plane words, with
    ``scales`` (2, L, B, 1, S) f32. base: (B,) int with base[b] + W <= S.
    win_k, win_v: (B, W, packed) in the cache's dtype; win_ks, win_vs
    (B, 1, W) f32 for the quantized caches. Returns (B, W, H, D) in q's
    dtype. On the card base[b] stays on the device; rows past S are never
    read."""
    layer = int(layer)
    _check_mq(q, kv, scales, layer, base, win_k, win_v, win_ks, win_vs)
    if q.device.type == "cpu":
        return decode_attention_mq_reference(q, kv, scales, layer, base, win_k, win_v,
                                             win_ks, win_vs)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_mq runs on cpu or cuda tensors, not {q.device}")
    b, w, h, d = q.shape
    base32 = base.to(torch.int32)
    tensors = [t for t in (q, kv, scales, base32, win_k, win_v, win_ks, win_vs) if t is not None]
    _cuda_preflight("decode_attention_mq", tensors, d)
    lib = _fast_kernel()
    _, n_layers, _, s, _ = kv.shape
    rows_per_split, nsplit = fast_split_plan(
        b, s, torch.cuda.get_device_properties(q.device).multi_processor_count)
    parts = b * w * h * (nsplit + 1)
    out = torch.empty_like(q)
    o_part = torch.empty((parts, d), dtype=torch.float32, device=q.device)
    ml_part = torch.empty((parts, 2), dtype=torch.float32, device=q.device)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    with torch.cuda.device(q.device):
        err = lib.mt_decode_attention_mq(
            q.data_ptr(), kv.data_ptr(), ptr(scales), base32.data_ptr(), win_k.data_ptr(),
            win_v.data_ptr(), ptr(win_ks), ptr(win_vs), out.data_ptr(), o_part.data_ptr(),
            ml_part.data_ptr(), _CACHE_FORMATS[kv.dtype], _DTYPE_CODES[q.dtype], b, w, h, d,
            n_layers, s, layer, rows_per_split, nsplit,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, "decode_attention_mq")
    decode_attention_mq.launches += 1
    return out


decode_attention_mq.launches = 0
