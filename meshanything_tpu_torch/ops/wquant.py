"""int8 weights for the decode loop: W8A8 with dynamic activations (the
port of ``meshanything_tpu/ops/wquant.py``).

  * weights: symmetric per-output-channel scales max(amax, 1e-8) / 127,
    the amax taken over the input dimension (``nn.Linear``'s (out, in)
    layout; the JAX package reduces axis -2 of its (in, out) weights);
  * activations: symmetric per-row scales computed in f32 at each call;
  * the product is s8 x s8 -> s32, then (acc * ascale) * wscale + b in
    f32, cast back to the activation dtype.

Only the four per-layer matrices of the decode loop (qkv, out, fc1, fc2)
are quantized; prefill, the embeddings, the layer norms and lm_head stay
in the activation dtype. The JAX package leaves the s8 dot to XLA; here
it is ``torch._int_mm``, on the card and on the CPU alike.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from meshanything_tpu_torch.models.layers import lin

# torch._int_mm on CUDA (cuBLASLt int8) refuses a row count of 16 or
# less: "self.size(0) needs to be greater than 16". The decode loop's
# rows are B (1, 2, ...) or B*W (8, 16, ...), so on the card the rows are
# zero-padded to this count and the result sliced back.
_CUDA_MIN_ROWS = 17


class QuantizedLinear(NamedTuple):
    wq: torch.Tensor               # (out, in) int8
    scale: torch.Tensor            # (out,) f32
    bias: Optional[torch.Tensor]


class QuantizedLayer(NamedTuple):
    """The decode loop's matrices of one OPT layer, under the names of
    ``models.shape_opt.OPTLayer``."""
    qkv: QuantizedLinear
    out: QuantizedLinear
    fc1: QuantizedLinear
    fc2: QuantizedLinear


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) weights -> (int8 (out, in), f32 (out,) per-row scales)."""
    wf = w.float()
    scale = wf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    return torch.round(wf / scale[:, None]).clamp(-127, 127).to(torch.int8), scale


def _int_mm(a: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(M, in) int8 @ (out, in).T int8 -> (M, out) int32."""
    m = a.shape[0]
    if a.is_cuda and m < _CUDA_MIN_ROWS:
        a = torch.cat([a, a.new_zeros((_CUDA_MIN_ROWS - m, a.shape[1]))])
        return torch._int_mm(a, wq.t())[:m]
    return torch._int_mm(a, wq.t())


def linear_w8a8(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., in) @ dequant(wq).T with int8 operands; returns x's dtype."""
    xf = x.float()
    ascale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    xq = torch.round(xf / ascale).clamp(-127, 127).to(torch.int8)
    acc = _int_mm(xq.reshape(-1, x.shape[-1]), wq).reshape(x.shape[:-1] + (wq.shape[0],))
    y = acc.float() * ascale * wscale
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def _quantize_linear(m: nn.Linear) -> QuantizedLinear:
    wq, scale = quantize_weight(m.weight.detach())
    return QuantizedLinear(wq, scale, None if m.bias is None else m.bias.detach())


def quantize_opt_layers(layers) -> List[QuantizedLayer]:
    """Quantize qkv/out/fc1/fc2 of every ``OPTLayer``; the layer norms
    stay on the layers themselves."""
    return [QuantizedLayer(*(_quantize_linear(getattr(layer, name))
                             for name in QuantizedLayer._fields)) for layer in layers]


def lin_dispatch(wq: bool) -> Callable:
    """lin(x, entry) for ``nn.Linear`` entries or, with ``wq``,
    ``QuantizedLinear`` ones: the one switch of the decode and lookahead
    layer bodies."""
    if wq:
        return lambda x, e: linear_w8a8(x, e.wq, e.scale, e.bias)
    return lin
