"""The measurement kernels: the build canary (T5) and the HBM-stream
probe (T1-T3), each with its plain PyTorch version beside it.

  T5 ``scale_shift``: ``o = 2 x + c``, 16-byte vectors over a grid-stride
     grid; the first thing every tool and the smoke run build and launch;
  T1 ``stream``: every byte of a (rows, width) array copied from device
     memory through a ring in shared memory; returns, as f32 (1, 1), the
     sum of the first element of every ``chunk``-row chunk;
  T2 ``stream_rot``: the same sum seeded with ``start``; with ``rot`` the
     walk begins at chunk ``start``;
  T3 ``dual_stream``: two arrays streamed chunk by chunk together (the
     K-plane + V-plane pattern of the decode kernels).

They port ``tools/xla_cpu_crash_repro.py::kern`` and the three kernels of
``tools/dma_wire_probe.py`` (``csrc/probes.cu`` says how). For a CUDA
tensor each wrapper launches its kernel (counted in
``<wrapper>.launches``) or raises; for a CPU tensor it computes the same
function with its ``*_reference`` plain version. There is no other route
between the two.
"""
from __future__ import annotations

import ctypes

import torch

from meshanything_tpu_torch.ops import _build

_ELEM_CODES = {torch.bfloat16: 0, torch.int8: 1}
MAX_DEPTH = 8                      # slots of the ring (csrc/probes.cu kMaxDepth)
_SLOT_BYTES = 32 * 1024            # most bytes of one ring slot
_BLOCKS_PER_SM = 2
_SMEM_BYTES = 227 * 1024           # shared memory a block (and so an SM's blocks) can use


def _kernel():
    lib = _build.load("probes").lib
    if lib.mt_scale_shift.argtypes is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.mt_scale_shift.argtypes = [vp, vp, ctypes.c_float, i64, vp]
        lib.mt_stream.argtypes = [vp, vp, i32, i64, i64, i32, i32, i32, vp]
        lib.mt_stream_rot.argtypes = [vp, vp, i32, i64, i64, i32, i32, i64, i32, i32, vp]
        lib.mt_dual_stream.argtypes = [vp, vp, vp, i32, i64, i64, i32, i32, i32, i32, vp]
        for fn in (lib.mt_scale_shift, lib.mt_stream, lib.mt_stream_rot, lib.mt_dual_stream):
            fn.restype = ctypes.c_int
        lib.mt_probes_error_string.argtypes = [ctypes.c_int]
        lib.mt_probes_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.mt_probes_error_string(err).decode()} (cudaError {err})")


def _device_kind(t: torch.Tensor, name: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {t.device}")
    return t.device.type


# ---------------------------------------------------------------------------
# T5


def scale_shift_reference(x: torch.Tensor, c: float) -> torch.Tensor:
    """Plain PyTorch version of T5: ``2 x + c`` in f32."""
    return x * 2.0 + c


def scale_shift(x: torch.Tensor, c: float) -> torch.Tensor:
    """T5: ``o = 2 x + c`` for a contiguous f32 tensor of any shape.

    CUDA tensors go to the kernel (counted in ``scale_shift.launches``);
    CPU tensors to ``scale_shift_reference``."""
    if x.dtype != torch.float32:
        raise TypeError(f"scale_shift takes float32, got {x.dtype}")
    if not x.is_contiguous() or x.numel() == 0:
        raise ValueError("scale_shift takes a contiguous, non-empty tensor")
    c = float(c)
    if _device_kind(x, "scale_shift") == "cpu":
        return scale_shift_reference(x, c)
    lib = _kernel()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.mt_scale_shift(x.data_ptr(), out.data_ptr(), c, x.numel(),
                                 torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "scale_shift")
    scale_shift.launches += 1
    return out


scale_shift.launches = 0


# ---------------------------------------------------------------------------
# T1-T3


def _check_stream(name: str, arrays, chunk: int, depth: int) -> int:
    """Checks shared by T1-T3 -> number of chunks."""
    x = arrays[0]
    if x.dim() != 2:
        raise ValueError(f"{name} takes (rows, width) arrays, got {tuple(x.shape)}")
    if x.dtype not in _ELEM_CODES:
        raise TypeError(f"{name} takes bfloat16 or int8, got {x.dtype}")
    for other in arrays[1:]:
        if other.shape != x.shape or other.dtype != x.dtype or other.device != x.device:
            raise ValueError(f"{name}: both arrays must share shape, dtype and device; got "
                             f"{tuple(x.shape)} {x.dtype} {x.device} and "
                             f"{tuple(other.shape)} {other.dtype} {other.device}")
    if not all(t.is_contiguous() for t in arrays):
        raise ValueError(f"{name}: arrays must be contiguous")
    rows = x.shape[0]
    if chunk < 1 or rows < chunk or rows % chunk:
        raise ValueError(f"{name}: {rows} rows are not a positive multiple of chunk {chunk}")
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"{name}: depth {depth} outside [1, {MAX_DEPTH}]")
    return rows // chunk


def stream_plan(chunk_bytes: int, planes: int, depth: int, nchunks: int,
                num_sms: int) -> tuple[int, int]:
    """(stage_bytes, blocks) of the stream kernels: a chunk moves in
    stages of the largest power of two that divides it and keeps a ring
    slot (one stage of each array) within 32 KiB; the grid is persistent,
    at most two blocks an SM, fewer where their rings would not fit an
    SM's shared memory together, and never more blocks than chunks."""
    if chunk_bytes % 16:
        raise ValueError(f"a chunk of {chunk_bytes} bytes is not a multiple of 16")
    barriers = 1024                               # the mbarriers, rounded up
    slot = min(_SLOT_BYTES, (_SMEM_BYTES - barriers) // depth)   # a deep ring has smaller slots
    stage = 16
    while stage * 2 * planes <= slot and chunk_bytes % (stage * 2) == 0:
        stage *= 2
    ring = depth * planes * stage + barriers
    per_sm = max(1, min(_BLOCKS_PER_SM, _SMEM_BYTES // ring))
    return stage, max(1, min(nchunks, per_sm * num_sms))


def _launch_args(name: str, arrays, chunk: int, depth: int, nchunks: int):
    x = arrays[0]
    if any(t.data_ptr() % 16 for t in arrays):
        raise ValueError(f"{name}: arrays must be 16-byte aligned")
    chunk_bytes = chunk * x.shape[1] * x.element_size()
    stage, blocks = stream_plan(
        chunk_bytes, len(arrays), depth, nchunks,
        torch.cuda.get_device_properties(x.device).multi_processor_count)
    out = torch.empty((1, 1), dtype=torch.float32, device=x.device)
    return out, _ELEM_CODES[x.dtype], chunk_bytes, stage, blocks


def _chunk_heads(x: torch.Tensor, chunk: int) -> torch.Tensor:
    return x[::chunk, 0].float().sum().reshape(1, 1)


def stream_reference(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """Plain PyTorch version of T1: the f32 sum of the first element of
    every chunk, as (1, 1)."""
    return _chunk_heads(x, chunk)


def stream(x: torch.Tensor, chunk: int, depth: int = 2) -> torch.Tensor:
    """T1: stream x (rows, width) bf16/int8 chunk by chunk (``chunk``
    rows) through a ``depth``-slot ring; returns the f32 (1, 1) sum of
    every chunk's first element.

    CUDA tensors go to the kernel (counted in ``stream.launches``); CPU
    tensors to ``stream_reference``."""
    chunk, depth = int(chunk), int(depth)
    nchunks = _check_stream("stream", (x,), chunk, depth)
    if _device_kind(x, "stream") == "cpu":
        return stream_reference(x, chunk)
    out, elem, chunk_bytes, stage, blocks = _launch_args("stream", (x,), chunk, depth, nchunks)
    lib = _kernel()
    with torch.cuda.device(x.device):
        err = lib.mt_stream(x.data_ptr(), out.data_ptr(), elem, nchunks, chunk_bytes, stage,
                            depth, blocks, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "stream")
    stream.launches += 1
    return out


stream.launches = 0


def stream_rot_reference(x: torch.Tensor, start: int, chunk: int) -> torch.Tensor:
    """Plain PyTorch version of T2: ``start`` plus T1's sum (every chunk
    is visited once whatever the order)."""
    return _chunk_heads(x, chunk) + float(start)


def stream_rot(x: torch.Tensor, start: int, chunk: int, depth: int = 2,
               rot: bool = True) -> torch.Tensor:
    """T2: as ``stream``, with the sum seeded with ``start`` (>= 0); with
    ``rot`` the walk begins at chunk ``start`` (mod the chunk count), else
    it is ``stream``'s. Successive calls with another ``start`` request
    the same bytes in another order, so their rate cannot come from
    replaying one access pattern."""
    start, chunk, depth = int(start), int(chunk), int(depth)
    nchunks = _check_stream("stream_rot", (x,), chunk, depth)
    if start < 0:
        raise ValueError(f"stream_rot: start {start} is negative")
    if _device_kind(x, "stream_rot") == "cpu":
        return stream_rot_reference(x, start, chunk)
    out, elem, chunk_bytes, stage, blocks = _launch_args("stream_rot", (x,), chunk, depth,
                                                         nchunks)
    lib = _kernel()
    with torch.cuda.device(x.device):
        err = lib.mt_stream_rot(x.data_ptr(), out.data_ptr(), elem, nchunks, chunk_bytes, stage,
                                depth, start, int(bool(rot)), blocks,
                                torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "stream_rot")
    stream_rot.launches += 1
    return out


stream_rot.launches = 0


def dual_stream_reference(x0: torch.Tensor, x1: torch.Tensor, chunk: int) -> torch.Tensor:
    """Plain PyTorch version of T3: T1's sum over both arrays."""
    return _chunk_heads(x0, chunk) + _chunk_heads(x1, chunk)


def dual_stream(x0: torch.Tensor, x1: torch.Tensor, chunk: int, depth: int = 2,
                nsem: int = 1) -> torch.Tensor:
    """T3: two separately allocated arrays of one shape streamed together,
    chunk c of both in flight at once, each ring slot reporting to one
    barrier (``nsem`` 1) or to one barrier an array (``nsem`` 2); returns
    the f32 (1, 1) sum of both arrays' chunk heads."""
    chunk, depth, nsem = int(chunk), int(depth), int(nsem)
    nchunks = _check_stream("dual_stream", (x0, x1), chunk, depth)
    if nsem not in (1, 2):
        raise ValueError(f"dual_stream: nsem {nsem} is neither 1 nor 2")
    if _device_kind(x0, "dual_stream") == "cpu":
        return dual_stream_reference(x0, x1, chunk)
    out, elem, chunk_bytes, stage, blocks = _launch_args("dual_stream", (x0, x1), chunk, depth,
                                                         nchunks)
    lib = _kernel()
    with torch.cuda.device(x0.device):
        err = lib.mt_dual_stream(x0.data_ptr(), x1.data_ptr(), out.data_ptr(), elem, nchunks,
                                 chunk_bytes, stage, depth, nsem, blocks,
                                 torch.cuda.current_stream(x0.device).cuda_stream)
    _raise_on(lib, err, "dual_stream")
    dual_stream.launches += 1
    return out


dual_stream.launches = 0
