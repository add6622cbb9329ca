"""Latent attention for the decode step of the Moonlight decoder
(``models/moonlight.py``): multi-head latent attention (MLA) in its
absorbed form over the latent cache, one kernel (``csrc/latent_attention.cu``)
with its plain PyTorch version beside it.

The latent cache is one tensor (L, B, S, W): a row a layer and position
holding the normalised latent (``latent`` values, 512 on Moonlight) and
then the rotated shared rope key (W - latent, 64), as
``models/moonlight.py`` writes it. Every head attends the same row. The
query of a head is (W,) wide: its no-rope query multiplied into the latent
space by the K half of ``kv_b_proj`` (the caller does that), then its
rotated rope query, so a logit is one dot of W values:

    logit[h, r] = scale * q[h] . row[r]          rows r in [0, cur_len)
    out[h]      = softmax_r(logit[h]) . row[:, :latent]

and the caller maps ``out`` (B, H, latent) back through the V half of
``kv_b_proj``. The logits and the softmax are f32 (on the card the bf16
products exact on tensor cores, summed in f32) and P enters the product as
two bf16 terms there (p0 = bf16(p), p1 = bf16(p - p0)); the output is
rounded once to q's dtype.

For a CUDA tensor ``latent_attention`` launches the kernel (its calls
counted in ``latent_attention.launches``; a call is two launches, the
splits and their combine) or raises; for a CPU tensor it computes
``latent_attention_reference``. There is no other route between the two.
``cur_len`` is a Python int or a 0-d int32 tensor on q's device, which the
kernel reads there (a CUDA graph of a decode step replays at every
length), as K1 reads it (``ops/decode_attention.py``); the grid is
planned for ``max_len`` (default: the cache's S for a tensor).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from meshanything_tpu_torch.ops import _build
from meshanything_tpu_torch.ops.decode_attention import (
    _lengths,
    _num_sms,
    _stream_ptr,
    fold_workspace,
)

LATENT = 512                 # csrc/latent_attention.cu kLatent: the one width built
ROPE = 64                    # csrc/latent_attention.cu kRope
TILE = 32                    # rows a tile of the kernel's stream, the unit of a split
MAX_HEADS = 16               # the rows of the kernel's tensor-core tile


def _check(q: torch.Tensor, cache: torch.Tensor, layer: int, latent: int):
    if q.dim() != 3 or cache.dim() != 4:
        raise ValueError(f"expected q (B, H, W) and cache (L, B, S, W); got "
                         f"{tuple(q.shape)} and {tuple(cache.shape)}")
    b, h, w = q.shape
    n_layers, bc, s, wc = cache.shape
    if bc != b or wc != w or not 0 < latent <= w:
        raise ValueError(f"cache {tuple(cache.shape)} does not match q {tuple(q.shape)} "
                         f"with {latent} latent values")
    if q.dtype != cache.dtype or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q and cache must share dtype float32 or bfloat16; got {q.dtype} "
                        f"and {cache.dtype}")
    if q.device != cache.device:
        raise ValueError(f"q on {q.device} but cache on {cache.device}")
    if not (q.is_contiguous() and cache.is_contiguous()):
        raise ValueError("q and cache must be contiguous")
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} outside [0, {n_layers})")


def latent_attention_reference(q: torch.Tensor, cache: torch.Tensor, layer: int, cur_len, *,
                               scale: float, latent: int,
                               max_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: q (B, H, W), cache (L, B, S, W) -> (B, H,
    latent) in q's dtype, over rows [0, cur_len) of ``cache[layer]`` (rows
    [0, max_len) taken, those past cur_len masked and never summed)."""
    _check(q, cache, layer, latent)
    cur_len, max_len = _lengths(cur_len, max_len, cache.shape[2], q.device)
    rows = cache[layer, :, :max_len].float()                         # (B, N, W)
    live = torch.arange(max_len, device=q.device) < cur_len
    rows = torch.where(live[None, :, None], rows, 0.0)
    logits = torch.einsum("bhw,bnw->bhn", q.float(), rows) * scale
    logits = torch.where(live, logits, float("-inf"))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    l_sum = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhn,bnc->bhc", p, rows[..., :latent])
    return (acc / l_sum.clamp_min(1e-30)).to(q.dtype)


def split_plan(batch: int, cur_len: int, num_sms: int) -> int:
    """Splits of the kernel's grid (B, nsplit): about one block an SM over
    the batch, at most one split a tile of ``TILE`` rows. The splits'
    partials are combined by the kernel's second launch."""
    tiles = -(-cur_len // TILE)
    return max(1, min(tiles, num_sms // batch))


def _kernel():
    lib = _build.load("latent_attention").lib
    fn = lib.mt_latent_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 7 + [ctypes.c_float,
                                                                     ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.mt_latent_attention_error_string.argtypes = [ctypes.c_int]
        lib.mt_latent_attention_error_string.restype = ctypes.c_char_p
    return lib


def latent_attention(q: torch.Tensor, cache: torch.Tensor, layer: int, cur_len, *,
                     scale: float, latent: int, max_len: Optional[int] = None) -> torch.Tensor:
    """Latent attention of q (B, H, W) over rows [0, cur_len) of
    ``cache[layer]`` (L, B, S, W) -> (B, H, latent) in q's dtype (see the
    module's text). CUDA tensors go to the kernel: bf16, W = 576 with 512
    latent values, at most 16 heads; anything else raises. CPU tensors go
    to ``latent_attention_reference``."""
    layer = int(layer)
    if q.device.type == "cpu":
        return latent_attention_reference(q, cache, layer, cur_len, scale=scale, latent=latent,
                                          max_len=max_len)
    if q.device.type != "cuda":
        raise ValueError(f"latent_attention runs on cpu or cuda tensors, not {q.device}")
    _check(q, cache, layer, latent)
    b, h, w = q.shape
    n_layers, _, s, _ = cache.shape
    if q.dtype != torch.bfloat16 or latent != LATENT or w != LATENT + ROPE or h > MAX_HEADS:
        raise ValueError(f"the kernel is built for bf16, {LATENT} latent + {ROPE} rope values "
                         f"and at most {MAX_HEADS} heads; got {q.dtype}, {latent} + "
                         f"{w - latent}, {h} heads")
    if q.data_ptr() % 16 or cache.data_ptr() % 16:
        raise ValueError("q and cache must be 16-byte aligned")
    cur_len, max_len = _lengths(cur_len, max_len, s, q.device)
    lib = _kernel()
    nsplit = split_plan(b, max_len, _num_sms(q.device.index))
    stream = _stream_ptr(q.device)
    ws = fold_workspace(q.device, stream)
    o_part, ml_part, _ = ws.pointers(b, nsplit, nsplit, h, latent)
    out = torch.empty((b, h, latent), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.mt_latent_attention(
            q.data_ptr(), cache.data_ptr(), out.data_ptr(), o_part, ml_part,
            ws.length_pointer(cur_len), b, h, n_layers, s, layer, max_len, nsplit, float(scale),
            stream)
    if err:
        raise RuntimeError(f"latent_attention kernel launch failed: "
                           f"{lib.mt_latent_attention_error_string(err).decode()} "
                           f"(cudaError {err})")
    latent_attention.launches += 1
    return out


latent_attention.launches = 0
