"""The router of a mixture-of-experts layer (DeepSeek-V3's ``noaux_tc``
gate over one group, ``models/moonlight.py``) as one kernel
(``csrc/router.cu``, R1), with its plain PyTorch version beside it.

For tokens h (T, d), the gate's weight (E, d) and correction bias (E,),
in f32: sigmoid scores of the logits h W^T, the top K of score plus bias
(in order of that sum), weighted by the scores alone, normalised where
``norm`` holds, scaled by ``scale`` -> (ids (T, K) int64, weights (T, K)
f32), what ``ops/experts.py::routed_experts`` reads.

``route_reference`` is that function in plain PyTorch. ``route_topk``
takes bf16 h of 1 to 16 rows: for a CUDA tensor it launches the kernel
(counted in ``route_topk.launches``) or raises; for a CPU tensor it
computes ``route_reference``. ``takes`` says whether a call fits the
kernel, from what the call shows alone (the rows, the dtypes, the
weight's layout and whether autograd records the call):
``moonlight.route``, the router of the decode step and the prefill, sends
such a call (the step's rows) to ``route_topk`` and any other (the
prefill's) to ``route_reference``.

The kernel breaks a tie between two equal choices towards the lower
expert; its f32 sums run in another order than cuBLAS's, so a choice
that lies within f32 rounding of the next may differ from the plain
version's.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from meshanything_tpu_torch.ops import _build
from meshanything_tpu_torch.ops.decode_attention import _stream_ptr

MAX_ROWS = 16                      # csrc/router.cu kMaxRows
MAX_EXPERTS = 64                   # csrc/router.cu kMaxExperts
MAX_CHOSEN = 32                    # csrc/router.cu kMaxChosen
MAX_STAGE = 160 * 1024             # csrc/router.cu kMaxStage: bytes of h a block stages


def route_reference(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, k: int, *,
                    norm: bool = True, scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: f32 logits, sigmoid scores, the top ``k`` of
    score plus bias (in order of that sum), weighted by the scores alone,
    normalised (``norm``) and scaled."""
    scores = F.linear(h.float(), weight.float()).sigmoid()
    choice = scores + bias                 # promoted to f32
    ids = choice.topk(k, dim=-1).indices
    weights = scores.gather(-1, ids)
    if norm:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    return ids, weights * scale


def takes(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, k: int) -> bool:
    """Whether ``moonlight.route`` sends the call to ``route_topk``: h (T, d)
    of 1 to 16 rows, h, weight and bias bf16, the weight (E, d) contiguous
    with E at most 64, d a multiple of 8, k at most min(E, 32), and no
    grad recorded."""
    if h.dim() != 2 or weight.dim() != 2 or h.shape[1] != weight.shape[1]:
        return False
    (t, d), e = h.shape, weight.shape[0]
    bf16 = torch.bfloat16
    return (1 <= t <= MAX_ROWS and d % 8 == 0 and t * d * 2 <= MAX_STAGE
            and 1 <= e <= MAX_EXPERTS and 1 <= k <= min(e, MAX_CHOSEN)
            and h.dtype == weight.dtype == bias.dtype == bf16 and weight.is_contiguous()
            and not (torch.is_grad_enabled()
                     and any(x.requires_grad for x in (h, weight, bias))))


def _kernel():
    lib = _build.load("router").lib
    fn = lib.mt_router
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp] * 5 + [ctypes.c_int64] * 4 + [ctypes.c_int, ctypes.c_float, vp]
        fn.restype = ctypes.c_int
        lib.mt_router_error_string.argtypes = [ctypes.c_int]
        lib.mt_router_error_string.restype = ctypes.c_char_p
    return lib


def _check(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, k: int) -> None:
    """Raise on what the kernel does not take."""
    if h.dim() != 2 or weight.dim() != 2 or h.shape[1] != weight.shape[1]:
        raise ValueError(f"route_topk takes h (T, d) and weight (E, d); got {tuple(h.shape)} "
                         f"and {tuple(weight.shape)}")
    (t, d), e = h.shape, weight.shape[0]
    if not (1 <= t <= MAX_ROWS and d % 8 == 0 and t * d * 2 <= MAX_STAGE
            and 1 <= e <= MAX_EXPERTS and 1 <= k <= min(e, MAX_CHOSEN)):
        raise ValueError(f"route_topk takes 1 to {MAX_ROWS} rows of d a multiple of 8 (T d 2 "
                         f"bytes at most {MAX_STAGE}), 1 to {MAX_EXPERTS} experts and k at "
                         f"most min(E, {MAX_CHOSEN}); got h {tuple(h.shape)}, weight "
                         f"{tuple(weight.shape)}, k {k}")
    if tuple(bias.shape) != (e,):
        raise ValueError(f"the bias {tuple(bias.shape)} does not match E = {e}")
    tensors = (h, weight, bias)
    if any(x.dtype != torch.bfloat16 for x in tensors):
        raise TypeError(f"route_topk takes bfloat16 h, weight and bias; got "
                        f"{[x.dtype for x in tensors]}")
    if any(x.device != h.device for x in tensors):
        raise ValueError(f"h, weight and bias on {[str(x.device) for x in tensors]}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("route_topk takes contiguous tensors")
    if h.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError("route_topk takes 16-byte aligned h and weight")
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        raise RuntimeError("route_topk has no backward: call it under torch.no_grad()")


def route_topk(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, k: int, *,
               norm: bool = True, scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The router (see the module's text) for bf16 h (T, d) of 1 to 16 rows
    in one launch -> (ids (T, k) int64, weights (T, k) f32).

    CUDA tensors go to the kernel (counted in ``route_topk.launches``):
    contiguous, h and weight 16-byte aligned, E at most 64; anything else
    raises. CPU tensors go to ``route_reference``."""
    if h.device.type == "cpu":
        return route_reference(h, weight, bias, k, norm=norm, scale=scale)
    if h.device.type != "cuda":
        raise ValueError(f"route_topk runs on cpu or cuda tensors, not {h.device}")
    _check(h, weight, bias, k)
    lib = _kernel()
    t, (e, d) = h.shape[0], weight.shape
    ids = torch.empty((t, k), dtype=torch.int64, device=h.device)
    weights = torch.empty((t, k), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        err = lib.mt_router(h.data_ptr(), weight.data_ptr(), bias.data_ptr(), ids.data_ptr(),
                            weights.data_ptr(), t, e, k, d, int(norm), scale,
                            _stream_ptr(h.device))
    if err:
        raise RuntimeError(f"router kernel launch failed: "
                           f"{lib.mt_router_error_string(err).decode()} (cudaError {err})")
    route_topk.launches += 1
    return ids, weights


route_topk.launches = 0
