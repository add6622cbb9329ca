"""The routed experts of a mixture-of-experts layer in the decode step
(``models/moonlight.py``), one kernel pair (``csrc/experts.cu``) with its
plain PyTorch version beside it.

For each token b and each of its K chosen experts e (``ids`` (B, K), on the
device, with their weights w (B, K) f32) the layer adds

    w[b, k] * down_e(silu(gate_e(x[b])) * up_e(x[b]))

over the stacked expert matrices gate, up (E, I, d) and down (E, d, I).
The shared experts may ride along as more slots of weight 1: a shared MLP
of width n * I is n slots of width I, slot j taking rows [j I, (j + 1) I)
of its gate and up and those columns of its down. The output is (B, d) f32,
the slots summed in order (the chosen experts in the order of ``ids``, then
the shared slots): the kernel has no float atomics, so a step's output is
the same bit for bit from run to run.

The kernel reads the ids and weights on the device, so a CUDA graph of
the step replays it whatever the routing, with no host read and no shape
that depends on it; it reads only the chosen experts' matrices, each once
a token. It also counts, in ``counts`` (layers, E) int32 on the device,
the tokens routed to each expert of layer ``layer``, and writes the ids
into the routing record ``routes`` (layers, B, S, K) int32 at layer
``layer`` and the position held in ``pos`` ((1,) int64 on the device), in
the same launch: what a comparison reads back to run the same choices.

For a CUDA tensor ``routed_experts`` launches the kernel (its calls
counted in ``routed_experts.launches``; a call is two launches, the
gate and up products then the down product) or raises; for a CPU tensor
it computes ``routed_experts_reference``. The intermediate silu(g) * u is
f32 in both.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from meshanything_tpu_torch.ops import _build
from meshanything_tpu_torch.ops.decode_attention import _stream_ptr

Shared = Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _check(x, ids, weights, gate, up, down, shared, counts, layer, routes=None, pos=None):
    if x.dim() != 2 or ids.dim() != 2 or weights.shape != ids.shape or ids.shape[0] != x.shape[0]:
        raise ValueError(f"expected x (B, d), ids and weights (B, K); got {tuple(x.shape)}, "
                         f"{tuple(ids.shape)}, {tuple(weights.shape)}")
    e, i, d = gate.shape
    if up.shape != gate.shape or tuple(down.shape) != (e, d, i) or x.shape[1] != d:
        raise ValueError(f"expert matrices gate {tuple(gate.shape)}, up {tuple(up.shape)}, "
                         f"down {tuple(down.shape)} do not match x {tuple(x.shape)}")
    if ids.dtype != torch.int64 or weights.dtype != torch.float32:
        raise TypeError(f"ids must be int64 and weights float32; got {ids.dtype}, "
                        f"{weights.dtype}")
    if not x.dtype == gate.dtype == up.dtype == down.dtype:
        raise TypeError("x and the expert matrices must share one dtype")
    if shared is not None:
        sg, su, sd = shared
        if sg.shape != su.shape or sg.shape[1] != d or sg.shape[0] % i or \
                tuple(sd.shape) != (d, sg.shape[0]):
            raise ValueError(f"shared experts gate {tuple(sg.shape)}, up {tuple(su.shape)}, "
                             f"down {tuple(sd.shape)} are not whole slots of width {i}")
        if not sg.dtype == su.dtype == sd.dtype == x.dtype:
            raise TypeError("the shared experts must share x's dtype")
    if counts is not None and (counts.dtype != torch.int32 or counts.dim() != 2
                               or counts.shape[1] != e or not 0 <= layer < counts.shape[0]):
        raise ValueError(f"counts must be (layers, {e}) int32 with layer {layer} in it; got "
                         f"{tuple(counts.shape)} {counts.dtype}")
    if routes is not None and (
            routes.dtype != torch.int32 or routes.dim() != 4 or not 0 <= layer < routes.shape[0]
            or routes.shape[1] != ids.shape[0] or routes.shape[3] != ids.shape[1]
            or pos is None or pos.dtype != torch.int64 or pos.numel() != 1):
        raise ValueError(f"routes must be (layers, {ids.shape[0]}, S, {ids.shape[1]}) int32 with "
                         f"layer {layer} in it and pos one int64; got "
                         f"{tuple(routes.shape)} {routes.dtype}, pos {pos}")


def _mlp_f32(x: torch.Tensor, g: torch.Tensor, u: torch.Tensor, dn: torch.Tensor) -> torch.Tensor:
    """down(silu(gate x) * up x) in f32 for x (d,), g, u (I, d), dn (d, I)."""
    xf = x.float()
    h = F.silu(g.float() @ xf) * (u.float() @ xf)
    return dn.float() @ h


def routed_experts_reference(x: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor,
                             gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor, *,
                             shared: Shared = None, counts: Optional[torch.Tensor] = None,
                             layer: int = 0, routes: Optional[torch.Tensor] = None,
                             pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of ``routed_experts``: the same sum, slot by
    slot in order, in f32 -> (B, d) f32; ``counts[layer]`` gains the ids,
    and ``routes[layer, :, pos]`` takes them."""
    _check(x, ids, weights, gate, up, down, shared, counts, layer, routes, pos)
    width = gate.shape[1]
    out = torch.zeros((x.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
    for b in range(x.shape[0]):
        acc = out[b]
        for k in range(ids.shape[1]):
            e = int(ids[b, k])
            acc += weights[b, k] * _mlp_f32(x[b], gate[e], up[e], down[e])
        if shared is not None:
            sg, su, sd = shared
            for j in range(sg.shape[0] // width):
                cols = slice(j * width, (j + 1) * width)
                acc += _mlp_f32(x[b], sg[cols], su[cols], sd[:, cols])
    if counts is not None:
        counts[layer].index_add_(0, ids.flatten(),
                                 torch.ones(ids.numel(), dtype=torch.int32, device=ids.device))
    if routes is not None:
        routes[layer].index_copy_(1, pos.reshape(1), ids.to(torch.int32)[:, None])
    return out


def _kernel():
    lib = _build.load("experts").lib
    fn = lib.mt_routed_experts
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int64] * 7 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int64, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.mt_routed_experts_error_string.argtypes = [ctypes.c_int]
        lib.mt_routed_experts_error_string.restype = ctypes.c_char_p
    return lib


_workspaces: dict = {}


def _hidden(device: torch.device, n: int) -> torch.Tensor:
    """The f32 buffer of the slots' silu(g) * u of a stream's calls, grown
    to the largest call (an outgrown one is kept: a captured graph may
    still write to it)."""
    key = (device.index, _stream_ptr(device))
    bufs = _workspaces.setdefault(key, [])
    if not bufs or bufs[-1].numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("routed_experts' first call on a stream at this size makes its "
                               "buffer: make it outside a CUDA-graph capture")
        bufs.append(torch.empty(max(n, 1 << 16), dtype=torch.float32, device=device))
    return bufs[-1]


def routed_experts(x: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor,
                   gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor, *,
                   shared: Shared = None, counts: Optional[torch.Tensor] = None,
                   layer: int = 0, routes: Optional[torch.Tensor] = None,
                   pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The routed experts' sum (see the module's text) -> (B, d) f32.
    CUDA tensors go to the kernel: bf16, contiguous, d and I multiples of
    8; anything else raises. CPU tensors go to ``routed_experts_reference``."""
    if x.device.type == "cpu":
        return routed_experts_reference(x, ids, weights, gate, up, down, shared=shared,
                                        counts=counts, layer=layer, routes=routes, pos=pos)
    if x.device.type != "cuda":
        raise ValueError(f"routed_experts runs on cpu or cuda tensors, not {x.device}")
    _check(x, ids, weights, gate, up, down, shared, counts, layer, routes, pos)
    n_exp, width, d = gate.shape
    b, k = ids.shape
    tensors = [x, ids, weights, gate, up, down] + list(shared or ())
    records = [t for t in (counts, routes, pos) if t is not None]
    if x.dtype != torch.bfloat16 or d % 8 or width % 8:
        raise ValueError(f"the kernel takes bf16 with d and I multiples of 8; got {x.dtype}, "
                         f"d {d}, I {width}")
    if not all(t.is_contiguous() and t.device == x.device for t in tensors + records):
        raise ValueError("routed_experts takes contiguous tensors on one device")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("routed_experts takes 16-byte aligned tensors")
    n_shared = 0 if shared is None else shared[0].shape[0] // width
    sg, su, sd = shared if shared is not None else (None, None, None)
    hidden = _hidden(x.device, b * (k + n_shared) * width)
    out = torch.empty((b, d), dtype=torch.float32, device=x.device)
    lib = _kernel()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        err = lib.mt_routed_experts(
            x.data_ptr(), ids.data_ptr(), weights.data_ptr(), gate.data_ptr(), up.data_ptr(),
            down.data_ptr(), ptr(sg), ptr(su), ptr(sd), hidden.data_ptr(), out.data_ptr(),
            b, k, n_shared, n_exp, width, d, layer, ptr(counts), ptr(routes), ptr(pos),
            0 if routes is None else routes.shape[2], _stream_ptr(x.device))
    if err:
        raise RuntimeError(f"routed_experts kernel launch failed: "
                           f"{lib.mt_routed_experts_error_string(err).decode()} (cudaError {err})")
    routed_experts.launches += 1
    return out


routed_experts.launches = 0
