"""The decode step's residual add and post-LayerNorm as one kernel
(``csrc/add_layer_norm.cu``), with its plain PyTorch version beside it.

``add_layer_norm(x, y, m)`` computes ``ln(x + y, m)`` (``models/layers.py``):
the sum rounded to the activation dtype, mean and variance in f32, the
result rounded once to the activation dtype. For a CUDA tensor it launches
the kernel (counted in ``add_layer_norm.launches``) or raises; for a CPU
tensor it computes ``add_layer_norm_reference``, which is that expression.
There is no other route between the two.

The kernel has no backward: a call that autograd would record raises.
The decode step and the window forward (``models/shape_opt.py::step_body``,
``models/lookahead.py``), which run under no grad, go through it; the
prefill and the trainer's ``forward_full`` keep the plain expression.
"""
from __future__ import annotations

import ctypes

import torch
from torch import nn

from meshanything_tpu_torch.models.layers import ln
from meshanything_tpu_torch.ops import _build
from meshanything_tpu_torch.ops.decode_attention import _stream_ptr

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 4096                     # csrc/add_layer_norm.cu kMaxDim


def add_layer_norm_reference(x: torch.Tensor, y: torch.Tensor, m: nn.LayerNorm) -> torch.Tensor:
    """Plain PyTorch version: ``ln(x + y, m)``."""
    return ln(x + y, m)


def _kernel():
    lib = _build.load("add_layer_norm").lib
    fn = lib.mt_add_layer_norm
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp] * 5 + [ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_double, vp]
        fn.restype = ctypes.c_int
        lib.mt_add_layer_norm_error_string.argtypes = [ctypes.c_int]
        lib.mt_add_layer_norm_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor, y: torch.Tensor, m: nn.LayerNorm) -> None:
    """Raise on what the kernel does not take."""
    weight, bias = m.weight, m.bias
    if weight is None or bias is None:
        raise ValueError("add_layer_norm takes a LayerNorm with a weight and a bias")
    if x.dim() not in (2, 3) or y.shape != x.shape:
        raise ValueError(f"add_layer_norm takes x and y of one 2-D or 3-D shape; got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    d = x.shape[-1]
    if d % 8 or not 8 <= d <= MAX_DIM or x.numel() == 0:
        raise ValueError(f"add_layer_norm takes a last dimension that is a multiple of 8 up to "
                         f"{MAX_DIM}, and at least one row; got {tuple(x.shape)}")
    if tuple(weight.shape) != (d,) or tuple(bias.shape) != (d,):
        raise ValueError(f"the norm's weight {tuple(weight.shape)} and bias {tuple(bias.shape)} "
                         f"do not match the last dimension {d}")
    if x.dtype not in _DTYPE_CODES or not x.dtype == y.dtype == weight.dtype == bias.dtype:
        raise TypeError(f"add_layer_norm takes x, y, weight and bias of one dtype, float32 or "
                        f"bfloat16; got {x.dtype}, {y.dtype}, {weight.dtype}, {bias.dtype}")
    if not x.device == y.device == weight.device == bias.device:
        raise ValueError(f"x, y, weight and bias on {x.device}, {y.device}, {weight.device}, "
                         f"{bias.device}")
    tensors = (x, y, weight, bias)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("add_layer_norm takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("add_layer_norm takes 16-byte aligned tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("add_layer_norm has no backward: call it under torch.no_grad()")


def add_layer_norm(x: torch.Tensor, y: torch.Tensor, m: nn.LayerNorm) -> torch.Tensor:
    """``ln(x + y, m)`` for x, y (..., d) in one launch; returns x's dtype.

    CUDA tensors go to the kernel (counted in ``add_layer_norm.launches``):
    2-D or 3-D, contiguous and 16-byte aligned, float32 or bfloat16 with
    the norm's parameters in the same dtype, d a multiple of 8 up to 4,096;
    anything else raises. CPU tensors go to ``add_layer_norm_reference``."""
    if x.device.type == "cpu":
        return add_layer_norm_reference(x, y, m)
    if x.device.type != "cuda":
        raise ValueError(f"add_layer_norm runs on cpu or cuda tensors, not {x.device}")
    _check(x, y, m)
    lib = _kernel()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.mt_add_layer_norm(x.data_ptr(), y.data_ptr(), m.weight.data_ptr(),
                                    m.bias.data_ptr(), out.data_ptr(), _DTYPE_CODES[x.dtype],
                                    x.numel() // x.shape[-1], x.shape[-1], m.eps,
                                    _stream_ptr(x.device))
    if err:
        raise RuntimeError(f"add_layer_norm kernel launch failed: "
                           f"{lib.mt_add_layer_norm_error_string(err).decode()} (cudaError {err})")
    add_layer_norm.launches += 1
    return out


add_layer_norm.launches = 0
