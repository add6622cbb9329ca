"""T4: K1's cost, part by part (the port of
``tools/pipe_compute_probe.py::build``), with its plain PyTorch version.

``k1_probe`` runs K1's body with the parts that ``mode`` names cut out,
at the same byte traffic, so that the difference of two modes' times is
the cost of the part that one of them lacks. The modes and their outputs
(the TPU tool's, per (b, h) head instead of its H-fold inflated
block-diagonal form), over tiles of ``chunk`` rows:

  full      K1 itself: on the card bit for bit ``decode_attention``;
  tap       rows loaded, nothing computed:
            ``out = sum over tiles of K[tile row 0] + V[tile row 0]``;
  qk        logits and their max per tile, no softmax, no P.V:
            ``out = sum over tiles of (max logit + V[tile row 0])``;
  softmax   no QK dot, no P.V; the logits are ``-1 + K[tile row 0, j]``
            (column j < chunk of the flat row, the same for every head)
            and feed the online softmax:
            ``acc = acc * corr + p[tile row 0] + V[tile row 0]``;
  pv        the same constant logits with the full P.V product.

Outputs other than ``full`` are the accumulator, not divided by the
softmax sum (the TPU tool divides none; K1 divides, and ``full`` must be
K1). Rows past ``cur_len`` are masked in every mode (the TPU tool's
constant-logit modes read the whole last tile; the two agree where
``cur_len`` is a multiple of ``chunk``).

Four more modes cut or change K1's own machinery on this card, in place of the TPU
tool's cuts of a flattened schedule, SMEM scalar loads and 4-D DMA
descriptors, which the CUDA K1 does not have. They are probe modes, not
options of K1:

  no_combine  ``full`` without the fold of the partials: returns them
              (``o_part`` (B, nsplit, H, D), ``ml_part`` (B, nsplit, H, 2),
              f32);
  one_split   ``full`` with no context split: one block a batch row;
  depth1      ``full`` through a ring of one slot: no copy is in flight
              while the block computes;
  tap_rows    ``tap`` with one bulk copy a row instead of one a plane's
              tile, the rows landing padded: the stream's other shape,
              which the tensor-core K4 needs for ``ldmatrix``.

On the card the tile is K1's (``K1_TILE``: 16 rows of bf16, 8 of f32). The
online softmax restarts in every context split, so ``softmax`` depends on
the split plan: ``k1_probe_plan`` gives the one the kernel uses, and the
plain version takes its ``nsplit``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple, Union

import torch

from meshanything_tpu_torch.ops import _build
from meshanything_tpu_torch.ops import decode_attention as da

MODES = ("full", "tap", "qk", "softmax", "pv", "no_combine", "one_split", "depth1", "tap_rows")
# the kernel's instance a mode runs (csrc/decode_attention.cu ``ProbeMode``); one_split is
# ``full`` on a grid of one split
_MODE_CODES = {"full": 0, "tap": 1, "qk": 2, "softmax": 3, "pv": 4, "no_combine": 5,
               "one_split": 0, "depth1": 6, "tap_rows": 7}
_FULL_MATH = ("full", "no_combine", "one_split", "depth1")
_TAP = ("tap", "tap_rows")
K1_TILE = da.K1_TILE               # the CUDA kernel's tile by dtype: its only ``chunk``
_HEAD_DIM = 64                     # the probe kernel is built for the 350M head only

Partials = Tuple[torch.Tensor, torch.Tensor]


def _check_probe(q, kv, layer, cur_len, chunk, mode) -> None:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is none of {MODES}")
    da._check(q, kv, layer, cur_len)
    if chunk < 1:
        raise ValueError(f"chunk {chunk} must be positive")
    if mode in ("softmax", "pv") and chunk > kv.shape[-1]:
        raise ValueError(f"mode {mode!r} takes its logits from the first {chunk} columns of a "
                         f"row, but a row has {kv.shape[-1]}")


def k1_probe_plan(batch: int, cur_len: int, num_sms: int, mode: str, tile: int) -> tuple[int, int]:
    """(nsplit, group) of the probe's grid: K1's own plan
    (``decode_attention.split_plan``; the splits' rows are its
    ``split_bounds``), or one split for ``one_split``."""
    if mode == "one_split":
        return 1, 1
    return da.split_plan(batch, cur_len, num_sms, tile)


def _split_partial(q, k, v, chunk: int, mode: str):
    """One context split, tile by tile as the kernel walks it. q (B, H, D)
    f32; k, v (B, n, H*D) f32 -> (acc (B, H, D), m (B, H), l (B, H))."""
    b, h, d = q.shape
    n = k.shape[1]
    acc = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h), float("-inf"), dtype=torch.float32, device=q.device)
    l_sum = torch.zeros((b, h), dtype=torch.float32, device=q.device)
    for c0 in range(0, n, chunk):
        kt, vt = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        r = kt.shape[1]
        v_tap = vt[:, 0].reshape(b, h, d)
        if mode in _TAP:
            acc = acc + kt[:, 0].reshape(b, h, d) + v_tap
            continue
        if mode in _FULL_MATH or mode == "qk":
            logits = torch.einsum("bhd,brhd->bhr", q, kt.reshape(b, r, h, d)) * (1.0 / math.sqrt(d))
        else:   # constant logits that still read K
            logits = (kt[:, 0, :r] - 1.0)[:, None, :].expand(b, h, r)
        m_cur = logits.amax(dim=-1)
        if mode == "qk":
            acc = acc + m_cur[..., None] + v_tap
            continue
        m_new = torch.maximum(m, m_cur)
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_sum = corr * l_sum + p.sum(dim=-1)
        if mode == "softmax":
            acc = acc * corr[..., None] + p[..., :1] + v_tap
        else:
            acc = acc * corr[..., None] + torch.einsum("bhr,brhd->bhd", p, vt.reshape(b, r, h, d))
        m = m_new
    if mode in _TAP or mode == "qk":      # nothing to rescale: the combine adds the splits up
        m, l_sum = torch.zeros_like(m), torch.ones_like(l_sum)
    return acc, m, l_sum


def k1_probe_reference(q: torch.Tensor, kv_cache: torch.Tensor, layer: int, cur_len: int, *,
                       chunk: int, mode: str, nsplit: int = 1,
                       normalize: bool = True) -> Union[torch.Tensor, Partials]:
    """Plain PyTorch version of T4: the same f32 math on the live rows,
    in tiles of ``chunk`` rows inside ``nsplit`` context splits cut as the
    kernel cuts them (``decode_attention.split_bounds``; default: one
    split), combined as K1 folds its partials.

    Returns (B, H, D) in q's dtype, or for ``no_combine`` the f32
    partials. ``normalize=False`` leaves ``full`` undivided by the
    softmax sum, which is the TPU tool's ``full``."""
    b, h, d = q.shape
    k = kv_cache[0, layer, :, :cur_len].float()
    v = kv_cache[1, layer, :, :cur_len].float()
    parts = [_split_partial(q.float(), k[:, r0:r1], v[:, r0:r1], chunk, mode)
             for r0, r1 in da.split_bounds(cur_len, chunk, nsplit)]
    o_part = torch.stack([p[0] for p in parts], dim=1)                       # (B, n, H, D)
    m_part = torch.stack([p[1] for p in parts], dim=1)                       # (B, n, H)
    l_part = torch.stack([p[2] for p in parts], dim=1)
    if mode == "no_combine":
        return o_part, torch.stack([m_part, l_part], dim=-1)
    w = torch.exp(m_part - m_part.amax(dim=1, keepdim=True))
    out = (o_part * w[..., None]).sum(dim=1)
    if mode in _FULL_MATH and normalize:
        out = out / (l_part * w).sum(dim=1)[..., None].clamp_min(1e-30)
    return out.to(q.dtype)


def _kernel():
    lib = _build.load("k1_probe").lib
    if lib.mt_k1_probe.argtypes is None:
        lib.mt_k1_probe.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                                    + [ctypes.c_int64] * 10 + [ctypes.c_void_p])
        lib.mt_k1_probe.restype = ctypes.c_int
        lib.mt_error_string.argtypes = [ctypes.c_int]
        lib.mt_error_string.restype = ctypes.c_char_p
    return lib


def k1_probe(q: torch.Tensor, kv_cache: torch.Tensor, layer: int, cur_len: int, *,
             chunk: int, mode: str) -> Union[torch.Tensor, Partials]:
    """K1's body with the parts ``mode`` names cut out (see the module's
    text): q (B, H, D) over rows [0, cur_len) of ``kv_cache[:, layer]``
    ((2, L, B, S, H*D), q's dtype). Returns (B, H, D) in q's dtype, or for
    ``no_combine`` the f32 partials.

    CUDA tensors go to the kernel (counted in ``k1_probe.launches``),
    whose tile is K1's: ``chunk`` must be ``K1_TILE[q.dtype]`` there, and
    the head 64 wide. CPU tensors go to ``k1_probe_reference`` (one split)."""
    layer, cur_len, chunk = int(layer), int(cur_len), int(chunk)
    _check_probe(q, kv_cache, layer, cur_len, chunk, mode)
    if q.device.type == "cpu":
        return k1_probe_reference(q, kv_cache, layer, cur_len, chunk=chunk, mode=mode)
    if q.device.type != "cuda":
        raise ValueError(f"k1_probe runs on cpu or cuda tensors, not {q.device}")
    b, h, d = q.shape
    tile = K1_TILE[q.dtype]
    if chunk != tile:
        raise ValueError(f"on the card the probe's tile is K1's: chunk must be {tile} for "
                         f"{q.dtype}, not {chunk}")
    if d != _HEAD_DIM or h > da._MAX_HEADS:
        raise ValueError(f"the probe kernel is built for head_dim {_HEAD_DIM} and at most "
                         f"{da._MAX_HEADS} heads; got head_dim {d}, {h} heads")
    if q.data_ptr() % 16 or kv_cache.data_ptr() % 16:
        raise ValueError("q and kv_cache must be 16-byte aligned")
    lib = _kernel()
    _, n_layers, _, s, _ = kv_cache.shape
    nsplit, group = k1_probe_plan(b, cur_len, da._num_sms(q.device.index), mode, tile)
    combine = mode != "no_combine"
    stream = da._stream_ptr(q.device)
    o_ptr, ml_ptr, counters = da.fold_workspace(q.device, stream).pointers(b, nsplit, group, h, d)
    out = torch.empty_like(q)
    if not combine:     # the partials are the result: tensors of the call's own
        slots = nsplit + -(-nsplit // group)
        o_part = torch.empty((b, slots, h, d), dtype=torch.float32, device=q.device)
        ml_part = torch.empty((b, slots, h, 2), dtype=torch.float32, device=q.device)
        o_ptr, ml_ptr = o_part.data_ptr(), ml_part.data_ptr()
    with torch.cuda.device(q.device):
        err = lib.mt_k1_probe(
            q.data_ptr(), kv_cache.data_ptr(), out.data_ptr(), o_ptr, ml_ptr, counters,
            da._DTYPE_CODES[q.dtype], _MODE_CODES[mode], b, h, d, n_layers, s, layer, cur_len,
            chunk, nsplit, group, stream)
    if err:
        raise RuntimeError(f"k1_probe kernel launch failed: "
                           f"{lib.mt_error_string(err).decode()} (cudaError {err})")
    k1_probe.launches += 1
    return out if combine else (o_part[:, :nsplit], ml_part[:, :nsplit])


k1_probe.launches = 0
