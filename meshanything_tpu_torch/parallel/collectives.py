"""The collectives of the port's data and tensor parallelism, written out
by hand where the JAX package leaves them to XLA (its jit inserts the
psums of a ``NamedSharding``; ``meshanything_tpu/parallel/mesh.py``).

Tensor parallelism is Megatron's: a column-parallel linear (its output
features split over the ``model`` ranks) takes a replicated input, a
row-parallel linear (its input features split) leaves a partial sum that
the ``model`` group adds up. Two autograd Functions carry the gradients
across the split:

  * ``copy_to_model``: identity forward, all-reduce backward (the input
    of a column-parallel region: each rank's grad holds its heads' part);
  * ``reduce_from_model``: all-reduce forward, identity backward (the
    output of a row-parallel linear).

The partial sums are added in f32 (a bf16 partial is widened first), and
the caller adds the row-parallel bias once, after the sum, and rounds to
the activation dtype once (``models/layers.py::row_lin``). Data
parallelism adds the grads over the ``data`` group (``all_reduce_grads``)
and gathers the rows of a result (``gather_rows``: a broadcast from each
rank, exact in every dtype, and run by gloo on CUDA tensors too, where
gloo's all-gather is not). The quantized tiers take a max over the model
group (``all_reduce_max``: a scale over all H*D columns or all input
features) and sum int32 accumulators (``all_reduce_sum``), both exact.

A process group of gloo cannot run inside a CUDA-graph capture
(``capturable``); NCCL can.
"""
from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors


def group_size(group) -> int:
    """Ranks in ``group`` (1 for None: no collective)."""
    return 1 if group is None else dist.get_world_size(group)


def capturable(group) -> bool:
    """Whether a step with collectives on ``group`` can be captured into a
    CUDA graph: no collective, or NCCL's."""
    return group is None or dist.get_backend(group) == "nccl"


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        y = x.to(torch.float32, copy=True)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, grads summed over ``group`` backward (x itself
    without a group)."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The f32 sum of every rank's ``x`` over ``group``; backward passes
    the grad through in x's dtype."""
    return _ReduceFromModel.apply(x, group)


def all_reduce_grads(params: Iterable[torch.nn.Parameter], group) -> None:
    """Sum every parameter's grad over ``group`` in place (a missing grad
    counts as zeros and is made), one flattened buffer a dtype."""
    if group_size(group) == 1:
        return
    by_dtype: dict = {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = _flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=group)
        for g, reduced in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(reduced)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` in a new tensor (x's copy without a
    group)."""
    y = x.clone()
    if group_size(group) > 1:
        dist.all_reduce(y, group=group)
    return y


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over ``group`` in a new tensor (``x``
    itself without a group: the one-process path adds no copy): exact, so
    every rank holds the same result. The quantized tiers form their
    scales from it (``ops/kvcache.py``, ``ops/wquant.py``)."""
    if group_size(group) == 1:
        return x
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (each of one shape) stacked along dim 0 in the
    group's rank order: a broadcast from each rank, bit-exact."""
    if group_size(group) == 1:
        return x
    ranks = dist.get_process_group_ranks(group)
    me = dist.get_rank(group)
    x = x.contiguous()
    parts = [x if i == me else torch.empty_like(x) for i in range(len(ranks))]
    for part, src in zip(parts, ranks):
        dist.broadcast(part, src=src, group=group)
    return torch.cat(parts, dim=0)


class _GatherRowsGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        ctx.index = dist.get_rank(group)
        return gather_rows(x, group)

    @staticmethod
    def backward(ctx, grad):
        # every rank's loss reads the whole gather: a block's grad is the sum
        # of what each rank's loss sends it
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.index * ctx.rows:(ctx.index + 1) * ctx.rows], None


def gather_rows_grad(x: torch.Tensor, group) -> torch.Tensor:
    """``gather_rows`` with autograd: the backward sums the grads of the
    gathered rows over the group and keeps this rank's block."""
    return x if group_size(group) == 1 else _GatherRowsGrad.apply(x, group)


def rank_in(group) -> int:
    """This process's index in ``group`` (0 for None)."""
    return 0 if group is None else dist.get_rank(group)


def broadcast_object(obj):
    """``obj`` as rank 0 has it (a picklable host object); ``obj`` itself
    outside a process group."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
