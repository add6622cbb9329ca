"""The decode step's products with few rows, ``x @ W.T (+ b)`` (then ReLU),
as one kernel (``csrc/gemv.cu``), with its plain PyTorch version beside it.

``gemv(x, weight, bias, relu)`` takes bf16 x (..., K) of 1 to 16 rows
once flattened, weight (N, K) in ``nn.Linear``'s layout, and returns
(..., N) in bf16: the f32 sum, the bias added in f32, the optional ReLU,
one rounding. For a CUDA tensor it launches the kernel (counted in
``gemv.launches``) or raises; for a CPU tensor it computes
``gemv_reference``, ``F.linear`` followed by ``F.relu`` where asked. There
is no other route between the two.

``lin(x, m, relu=False)`` is the decode step's entry for an ``nn.Linear``
(``ops/wquant.py::lin_dispatch(False)``): it sends the product to ``gemv``
when ``takes`` holds, which reads only what the call shows (the rows, the
dtypes, the weight's contiguity, the in-features and whether autograd
records the call), and to ``models/layers.py::linear`` otherwise.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from meshanything_tpu_torch.models.layers import linear
from meshanything_tpu_torch.ops import _build
from meshanything_tpu_torch.ops.decode_attention import _stream_ptr

MAX_ROWS = 16                      # csrc/gemv.cu kMaxRows


def gemv_reference(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version: ``F.linear``, then ``F.relu`` where asked."""
    y = F.linear(x, weight, bias)
    return F.relu(y) if relu else y


def _records_grad(*tensors: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def takes(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> bool:
    """Whether the decode entry sends ``x @ weight.T (+ bias)`` to ``gemv``:
    1 to 16 rows, x, weight and bias bf16, the weight contiguous, the
    in-features a multiple of 8, and no grad recorded."""
    k = x.shape[-1] if x.dim() else 0
    rows = x.numel() // k if k else 0
    bf16 = torch.bfloat16
    return (1 <= rows <= MAX_ROWS and k % 8 == 0 and x.dtype == weight.dtype == bf16
            and (bias is None or bias.dtype == bf16) and weight.is_contiguous()
            and not _records_grad(x, weight, bias))


def _kernel():
    lib = _build.load("gemv").lib
    fn = lib.mt_gemv
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp] * 4 + [ctypes.c_int64] * 3 + [ctypes.c_int, vp]
        fn.restype = ctypes.c_int
        lib.mt_gemv_error_string.argtypes = [ctypes.c_int]
        lib.mt_gemv_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    """Raise on what the kernel does not take."""
    if weight.dim() != 2 or x.dim() < 1 or x.shape[-1] != weight.shape[1]:
        raise ValueError(f"gemv takes x (..., K) and weight (N, K); got {tuple(x.shape)} and "
                         f"{tuple(weight.shape)}")
    n, k = weight.shape
    rows = x.numel() // k if k else 0
    if not 1 <= rows <= MAX_ROWS or k % 8 or n < 1:
        raise ValueError(f"gemv takes 1 to {MAX_ROWS} rows, K a multiple of 8 and N >= 1; got "
                         f"x {tuple(x.shape)}, weight {tuple(weight.shape)}")
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"the bias {tuple(bias.shape)} does not match N = {n}")
    tensors = (x, weight) if bias is None else (x, weight, bias)
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(f"gemv takes bfloat16 x, weight and bias; got "
                        f"{[t.dtype for t in tensors]}")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"x, weight and bias on {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gemv takes contiguous tensors")
    if x.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError("gemv takes 16-byte aligned x and weight")
    if _records_grad(*tensors):
        raise RuntimeError("gemv has no backward: call it under torch.no_grad()")


def gemv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
         relu: bool = False) -> torch.Tensor:
    """``x @ weight.T (+ bias)`` (then ReLU) for bf16 x (..., K) of 1 to 16
    rows in one launch; returns (..., N) bf16.

    CUDA tensors go to the kernel (counted in ``gemv.launches``):
    contiguous, x and weight 16-byte aligned, K a multiple of 8; anything
    else raises. CPU tensors go to ``gemv_reference``."""
    if x.device.type == "cpu":
        return gemv_reference(x, weight, bias, relu)
    if x.device.type != "cuda":
        raise ValueError(f"gemv runs on cpu or cuda tensors, not {x.device}")
    _check(x, weight, bias)
    lib = _kernel()
    n, k = weight.shape
    out = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.mt_gemv(x.data_ptr(), weight.data_ptr(),
                          None if bias is None else bias.data_ptr(), out.data_ptr(),
                          x.numel() // k, n, k, int(relu), _stream_ptr(x.device))
    if err:
        raise RuntimeError(f"gemv kernel launch failed: "
                           f"{lib.mt_gemv_error_string(err).decode()} (cudaError {err})")
    gemv.launches += 1
    return out


gemv.launches = 0


def lin(x: torch.Tensor, m: nn.Linear, relu: bool = False) -> torch.Tensor:
    """The decode step's ``nn.Linear`` entry: ``gemv`` where ``takes``
    holds, else ``models/layers.py::linear`` (then ``F.relu`` where asked)."""
    if takes(x, m.weight, m.bias):
        return gemv(x, m.weight, m.bias, relu)
    y = linear(x, m.weight, m.bias)
    return F.relu(y) if relu else y
