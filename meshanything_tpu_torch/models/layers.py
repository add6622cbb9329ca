"""NN primitives shared by every model of the port, with the JAX
package's numerics (``meshanything_tpu/models/layers.py``).

Weights live in ``nn.Linear`` / ``nn.LayerNorm`` containers (torch's
``(out, in)`` layout); the math is plain functions, so each numeric
choice is visible at its call site:

  * layer norm reduces in f32 and casts back to the input dtype;
  * a linear layer returns the input dtype;
  * attention takes f32 logits, an f32 softmax, and casts the weights to
    q's dtype before P.V.

The JAX package ran the prefill, perceiver and detokenizer attentions as
blockwise XLA (``flash_attention_causal`` / ``flash_attention_full``);
here they are dense torch attention, which is the same math.

Tensor parallelism (``parallel/mesh.py``): a block whose ``tp_group`` is
set holds its rank's shard of each split matrix and ``num_heads`` of its
heads; ``col_lin`` and ``row_lin`` are its linears (the sum over the model
group after a row-parallel one, its bias added once after the sum). With
``tp_group`` None they are ``lin``; both also take the int8 entries of
``ops/wquant.py``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from meshanything_tpu_torch.parallel.collectives import copy_to_model, reduce_from_model


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 statistics, result in x's dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
    return y.to(x.dtype)


def ln(x: torch.Tensor, m: nn.LayerNorm) -> torch.Tensor:
    return layer_norm(x, m.weight, m.bias, m.eps)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ weight.T (+ bias) in x's dtype; weight is (out, in)."""
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


def lin(x: torch.Tensor, m: nn.Linear, relu: bool = False) -> torch.Tensor:
    y = linear(x, m.weight, m.bias)
    return F.relu(y) if relu else y


def col_lin(x: torch.Tensor, m, group, lin_e=lin, relu: bool = False) -> torch.Tensor:
    """A column-parallel linear (``m`` holds the rank's output features):
    ``lin_e(x, m, relu=relu)`` (a ReLU acts on each output feature alone,
    so it stays on the rank), and under a model group x's grad summed over
    it in backward (``copy_to_model``)."""
    return lin_e(copy_to_model(x, group), m, relu=relu)


def row_lin(x: torch.Tensor, m, group, lin_e=lin) -> torch.Tensor:
    """A row-parallel linear (``m`` holds the rank's input features): the
    partial products summed over the model group in f32, the bias added
    once after the sum, rounded once to x's dtype. ``lin_e(x, m)`` without
    a group. An entry with a product of its own under a group (the int8
    ``ops/wquant.py::QuantizedLinear``, which sums int32) computes it."""
    if group is None:
        return lin_e(x, m)
    if hasattr(m, "row_parallel"):
        return m.row_parallel(x, group)
    y = reduce_from_model(linear(x, m.weight), group)
    if m.bias is not None:
        y = y + m.bias.float()
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: JAX scales by a constant of the
    operand's dtype (``jnp.asarray(s, q.dtype)``)."""
    return torch.tensor(value, dtype=dtype).item()


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              dual_sqrt_scale: bool = False, causal: bool = False) -> torch.Tensor:
    """Multi-head attention over (B, N, H, D) tensors.

    dual_sqrt_scale is the Michelangelo stabilization: q and k are both
    multiplied by 1/sqrt(sqrt(D)) before the logits (layers.py:75-78 of
    the JAX package). Otherwise q is scaled by 1/sqrt(D)."""
    d = q.shape[-1]
    if dual_sqrt_scale:
        s = in_dtype(1.0 / math.sqrt(math.sqrt(d)), q.dtype)
        q = q * s
        k = k * s
    else:
        q = q * in_dtype(1.0 / math.sqrt(d), q.dtype)
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    if causal:
        tq, sk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones((tq, sk), dtype=torch.bool, device=q.device).tril(sk - tq)
        logits = logits.masked_fill(~keep, -1e30)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", weights, v)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, n, hd = x.shape
    return x.reshape(b, n, num_heads, hd // num_heads)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, n, h, d = x.shape
    return x.reshape(b, n, h * d)


def _linear(d_in: int, d_out: int, bias: bool, factory: dict) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=bias, **factory)


class SelfAttentionBlock(nn.Module):
    """Pre-LN residual self-attention + GELU MLP (Michelangelo
    ResidualAttentionBlock, transformer_blocks.py:77-115)."""

    def __init__(self, width: int, num_heads: int, *, qkv_bias: bool, ln_eps: float,
                 dual_sqrt_scale: bool, device=None, dtype=None):
        super().__init__()
        f = {"device": device, "dtype": dtype}
        self.num_heads = num_heads
        self.tp_group = None
        self.dual_sqrt_scale = dual_sqrt_scale
        self.ln1 = nn.LayerNorm(width, eps=ln_eps, **f)
        self.qkv = _linear(width, 3 * width, qkv_bias, f)
        self.proj = _linear(width, width, True, f)
        self.ln2 = nn.LayerNorm(width, eps=ln_eps, **f)
        self.fc = _linear(width, 4 * width, True, f)
        self.fc_out = _linear(4 * width, width, True, f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.tp_group
        q, k, v = col_lin(ln(x, self.ln1), self.qkv, g).chunk(3, dim=-1)
        h = self.num_heads
        o = attention(_split_heads(q, h), _split_heads(k, h), _split_heads(v, h),
                      dual_sqrt_scale=self.dual_sqrt_scale)
        x = x + row_lin(_merge_heads(o), self.proj, g)
        return x + row_lin(gelu(col_lin(ln(x, self.ln2), self.fc, g)), self.fc_out, g)


class CrossAttentionBlock(nn.Module):
    """Michelangelo ResidualCrossAttentionBlock (transformer_blocks.py:188-226)."""

    def __init__(self, width: int, num_heads: int, *, qkv_bias: bool, ln_eps: float,
                 device=None, dtype=None):
        super().__init__()
        f = {"device": device, "dtype": dtype}
        self.num_heads = num_heads
        self.tp_group = None
        self.ln_q = nn.LayerNorm(width, eps=ln_eps, **f)
        self.ln_kv = nn.LayerNorm(width, eps=ln_eps, **f)
        self.q = _linear(width, width, qkv_bias, f)
        self.kv = _linear(width, 2 * width, qkv_bias, f)
        self.proj = _linear(width, width, True, f)
        self.ln_mlp = nn.LayerNorm(width, eps=ln_eps, **f)
        self.fc = _linear(width, 4 * width, True, f)
        self.fc_out = _linear(4 * width, width, True, f)

    def forward(self, x: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
        g = self.tp_group
        q = col_lin(ln(x, self.ln_q), self.q, g)
        k, v = col_lin(ln(data, self.ln_kv), self.kv, g).chunk(2, dim=-1)
        h = self.num_heads
        o = attention(_split_heads(q, h), _split_heads(k, h), _split_heads(v, h),
                      dual_sqrt_scale=True)
        x = x + row_lin(_merge_heads(o), self.proj, g)
        return x + row_lin(gelu(col_lin(ln(x, self.ln_mlp), self.fc, g)), self.fc_out, g)
