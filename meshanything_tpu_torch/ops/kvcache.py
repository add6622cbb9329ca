"""KV-cache allocation and the quantized caches' row codecs (the port of
``meshanything_tpu/ops/kvcache.py``).

Cache layout contract (shared with ``ops/decode_attention.py`` and
``models/shape_opt.py``), kept from the JAX package so the two compare
like with like: one tensor (2, L, B, S, H*D), K at index 0, V at index 1,
flat head rows, S padded to a multiple of the decode chunk. A
(..., H, D) view of it costs nothing.

Quantized caches (``attn="pallas_int8"`` / ``"pallas_int4"``) are a pair
(values, scales):

  * int8: values (2, L, B, S, H*D) int8, one symmetric scale
    max(amax, 1e-8) / 127 per flat row, codes round-half-even in
    [-127, 127];
  * int4: values (2, L, B, S, H*D/8) int32 in the "plane" packing:
    nibble p of word w holds column p*(H*D/8) + w as 4-bit two's
    complement in [-7, 7], scale max(amax, 1e-8) / 7;
  * scales (2, L, B, 1, S) f32; rows never written hold 1.0.

Under tensor parallelism (``parallel/mesh.py``) a rank's cache holds its
heads' (H/tp)*D columns, and the quantizers take the model group: a row's
amax is the max over every rank's columns (``all_reduce_max``, one
collective for all the rows of a call), so the scale is the one-process
scale of all H*D columns, equal on every rank, and the rank's int8 codes
are its columns of the one-process codes bit for bit. int4 packs the
rank's columns in the plane layout over its own width ((H/tp)*D/8 words
a row; nibble p of word w holds local column p*(H/tp)*D/8 + w), so the
rank's words are no slice of the one-process words, but ``unpack_int4``
of each rank's words, joined in rank order, is the one-process codes.
The caller stacks K and V into one call (one all-reduce a layer).
"""
from __future__ import annotations

from typing import Tuple

import torch

from meshanything_tpu_torch.parallel.collectives import all_reduce_max

QUANTIZED = ("pallas_int8", "pallas_int4")


def padded_length(seq: int, chunk: int) -> int:
    return -(-seq // chunk) * chunk


def alloc_kv_cache(num_layers: int, batch: int, seq: int, heads: int, head_dim: int,
                   dtype: torch.dtype = torch.bfloat16, chunk: int = 512,
                   device=None) -> torch.Tensor:
    return torch.zeros((2, num_layers, batch, padded_length(seq, chunk), heads * head_dim),
                       dtype=dtype, device=device)


def alloc_quantized_cache(attn: str, num_layers: int, batch: int, seq: int, hd: int,
                          chunk: int = 512, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, scales) of an int8 or int4 cache, S padded to ``chunk``."""
    s = padded_length(seq, chunk)
    if attn == "pallas_int8":
        values = torch.zeros((2, num_layers, batch, s, hd), dtype=torch.int8, device=device)
    elif attn == "pallas_int4":
        values = torch.zeros((2, num_layers, batch, s, hd // 8), dtype=torch.int32, device=device)
    else:
        raise ValueError(f"no quantized cache for attn={attn!r}")
    return values, torch.ones((2, num_layers, batch, 1, s), dtype=torch.float32, device=device)


def _row_scales(rf: torch.Tensor, qmax: float, group) -> torch.Tensor:
    """max(amax, 1e-8) / qmax of each f32 row, the amax taken over the row's
    columns on every rank of ``group`` (one all-reduce for the whole tensor)."""
    amax = all_reduce_max(rf.abs().amax(dim=-1, keepdim=True), group)
    return amax.clamp_min(1e-8) / qmax


def quantize_rows(rows: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) rows -> (int8 codes (..., D), f32 scales (..., 1)). Under a
    model group ``rows`` holds the rank's columns and the scale is the
    whole row's (see the module docstring)."""
    rf = rows.float()
    scale = _row_scales(rf, 127.0, group)
    return torch.round(rf / scale).clamp(-127, 127).to(torch.int8), scale


def quantize_rows_int4(rows: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) rows -> (int32 plane words (..., D/8), f32 scales (..., 1)),
    packed over the D columns given (a rank's own under a model group,
    whose scale is the whole row's)."""
    d = rows.shape[-1]
    if d % 8:
        raise ValueError(f"int4 plane packing needs a row width divisible by 8, got {d}")
    n = d // 8
    rf = rows.float()
    scale = _row_scales(rf, 7.0, group)
    codes = torch.round(rf / scale).clamp(-7, 7).to(torch.int64) & 15
    word = torch.zeros(rows.shape[:-1] + (n,), dtype=torch.int64, device=rows.device)
    for p in range(8):
        word |= codes[..., p * n:(p + 1) * n] << (4 * p)
    # the 32-bit pattern as a signed int32 (plane 7 sets the sign bit)
    word = torch.where(word >= 2 ** 31, word - 2 ** 32, word)
    return word.to(torch.int32), scale


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., D/8) int32 plane words -> (..., D) int32 codes in [-8, 7]."""
    w = packed.to(torch.int64) & 0xFFFFFFFF
    planes = [((w >> (4 * p)) & 15) for p in range(8)]
    codes = torch.cat(planes, dim=-1)
    return (codes - ((codes & 8) << 1)).to(torch.int32)


def quantize_rows_for(attn: str):
    return quantize_rows if attn == "pallas_int8" else quantize_rows_int4
