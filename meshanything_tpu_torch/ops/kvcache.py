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
"""
from __future__ import annotations

from typing import Tuple

import torch

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


def quantize_rows(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) rows -> (int8 codes (..., D), f32 scales (..., 1))."""
    rf = rows.float()
    scale = rf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.round(rf / scale).clamp(-127, 127).to(torch.int8), scale


def quantize_rows_int4(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) rows -> (int32 plane words (..., D/8), f32 scales (..., 1))."""
    d = rows.shape[-1]
    if d % 8:
        raise ValueError(f"int4 plane packing needs a row width divisible by 8, got {d}")
    n = d // 8
    rf = rows.float()
    scale = rf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 7.0
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
