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

Under tensor parallelism (a layer's ``tp_group``; ``parallel/mesh.py``)
each product computes what one process's computes, bit for bit:

  * column-parallel qkv and fc1: the rank holds whole output channels, so
    each channel's scale (amax over the whole input) and the replicated
    input's row scale are local; nothing changes;
  * row-parallel out and fc2: the rank holds a slice of the input
    features. A channel's weight amax is taken over every rank's slice at
    quantize time (``all_reduce_max``, once), the activation row's amax at
    each call, and the int32 accumulators are summed over the group
    (exact, where a sum of f32 partial products is not); then one
    dequantization, (acc * ascale) * wscale, and the bias once, after the
    sum (``linear_w8a8(group=)``, reached through
    ``QuantizedLinear.row_parallel`` from ``models/layers.py::row_lin``).
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from meshanything_tpu_torch.ops import gemv
from meshanything_tpu_torch.parallel.collectives import all_reduce_max, all_reduce_sum
from meshanything_tpu_torch.parallel.mesh import opt_layer_specs

# torch._int_mm on CUDA (cuBLASLt int8) refuses a row count of 16 or
# less: "self.size(0) needs to be greater than 16". The decode loop's
# rows are B (1, 2, ...) or B*W (8, 16, ...), so on the card the rows are
# zero-padded to this count and the result sliced back.
_CUDA_MIN_ROWS = 17


class QuantizedLinear(NamedTuple):
    wq: torch.Tensor               # (out, in) int8: a rank's shard under tensor parallelism
    scale: torch.Tensor            # (out,) f32: the whole row's scale
    bias: Optional[torch.Tensor]

    def row_parallel(self, x: torch.Tensor, group) -> torch.Tensor:
        """The row-parallel product over ``group`` (``x`` the rank's input
        features): ``models/layers.py::row_lin`` calls it for a quantized
        entry."""
        return linear_w8a8(x, self.wq, self.scale, self.bias, group=group)


class QuantizedLayer(NamedTuple):
    """The decode loop's matrices of one OPT layer, under the names of
    ``models.shape_opt.OPTLayer``."""
    qkv: QuantizedLinear
    out: QuantizedLinear
    fc1: QuantizedLinear
    fc2: QuantizedLinear


def quantize_weight(w: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) weights -> (int8 (out, in), f32 (out,) per-row scales);
    with ``group`` each row's amax is the max over every rank's slice of
    the row (a row-parallel shard)."""
    wf = w.float()
    scale = all_reduce_max(wf.abs().amax(dim=-1), group).clamp_min(1e-8) / 127.0
    return torch.round(wf / scale[:, None]).clamp(-127, 127).to(torch.int8), scale


def _int_mm(a: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(M, in) int8 @ (out, in).T int8 -> (M, out) int32."""
    m = a.shape[0]
    if a.is_cuda and m < _CUDA_MIN_ROWS:
        a = torch.cat([a, a.new_zeros((_CUDA_MIN_ROWS - m, a.shape[1]))])
        return torch._int_mm(a, wq.t())[:m]
    return torch._int_mm(a, wq.t())


def linear_w8a8(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                b: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
    """x (..., in) @ dequant(wq).T with int8 operands; returns x's dtype.
    ``group``: a row-parallel product, x and wq the rank's input features
    and wscale the whole rows' scales; the activation amax is the whole
    row's and the int32 accumulators are summed over the group before the
    one dequantization and the bias, so every rank holds one process's
    result."""
    xf = x.float()
    amax = all_reduce_max(xf.abs().amax(dim=-1, keepdim=True), group)
    ascale = amax.clamp_min(1e-8) / 127.0
    xq = torch.round(xf / ascale).clamp(-127, 127).to(torch.int8)
    acc = _int_mm(xq.reshape(-1, x.shape[-1]), wq).reshape(x.shape[:-1] + (wq.shape[0],))
    if group is not None:
        acc = all_reduce_sum(acc, group)
    y = acc.float() * ascale * wscale
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


# the row-parallel matrices of an OPT layer (input features split over the model axis)
_ROW_PARALLEL = {name for name, spec in opt_layer_specs().items()
                 if name in QuantizedLayer._fields and spec["weight"].dim == 1}


def _quantize_linear(m: nn.Linear, group=None) -> QuantizedLinear:
    wq, scale = quantize_weight(m.weight.detach(), group)
    return QuantizedLinear(wq, scale, None if m.bias is None else m.bias.detach())


def quantize_opt_layers(layers) -> List[QuantizedLayer]:
    """Quantize qkv/out/fc1/fc2 of every ``OPTLayer``; the layer norms
    stay on the layers themselves. Under a layer's model group
    (``tp_group``) every rank of it calls this: the row-parallel out and
    fc2 take their scales over the group (one all-reduce each)."""
    return [QuantizedLayer(*(_quantize_linear(getattr(layer, name), layer.tp_group
                                              if name in _ROW_PARALLEL else None)
                             for name in QuantizedLayer._fields)) for layer in layers]


def _lin_w8a8(x: torch.Tensor, e: QuantizedLinear, relu: bool = False) -> torch.Tensor:
    y = linear_w8a8(x, e.wq, e.scale, e.bias)
    return torch.relu(y) if relu else y


def lin_dispatch(wq: bool) -> Callable:
    """lin(x, entry, relu=False) for ``nn.Linear`` entries or, with ``wq``,
    ``QuantizedLinear`` ones: the one switch of the decode and lookahead
    layer bodies. An ``nn.Linear`` goes through ``ops/gemv.py::lin``: the
    hand-written kernel at 1 to 16 bf16 rows, ``layers.linear`` otherwise."""
    return _lin_w8a8 if wq else gemv.lin
