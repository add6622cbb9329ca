"""The (data, model) mesh of processes and the sharding of the model's
parameters (the port of ``meshanything_tpu/parallel/mesh.py``).

The reference's only parallelism is DDP folder inference (main.py:113-146;
SURVEY.md §2.4). The JAX package lays a ``jax.sharding.Mesh`` over its
chips and lets XLA insert the collectives. The port has no GSPMD: a mesh
is a grid of ``torch.distributed`` ranks, rank = data_index * model +
model_index, with a process group along each axis, and the collectives
are written out (``parallel/collectives.py``):

  * ``data`` axis: batch rows split over the ranks (inference and
    training); the grads are summed over it;
  * ``model`` axis: Megatron tensor parallelism. Each rank holds plain
    local ``nn.Linear`` shards: the fused qkv / kv and the MLP's first
    matrix are column-split (output features), the attention's out
    projection and the MLP's second matrix row-split (input features),
    with the sum over the group after them (``models/layers.py::row_lin``);
    attention runs the rank's heads alone (``num_heads // model`` of each
    block). Layer norms, embeddings, the small projections and the
    lm_head stay replicated: vocab 8195 = 5*11*149 has no useful divisor.

The spec table (``meshanything_specs``) names every parameter of
``models/meshanything.py::MeshAnything`` by its torch name, in the JAX
package's function names. A fused projection's shard is its heads' rows
of each part: the rank's rows of Q, of K and of V, not a contiguous third
of the matrix (``shard_tensor``; ``unshard_tensor`` undoes it).

The backend follows the device (``join``): gloo on the CPU, NCCL on
cards, one rank a card. Several ranks on one card run only when gloo is
asked for (``backend="gloo"``); a gloo collective cannot be captured into a
CUDA graph, so such a run's tensor-parallel decode is eager.
"""
from __future__ import annotations

import copy
import dataclasses
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from meshanything_tpu_torch.parallel.collectives import group_size
from meshanything_tpu_torch.parallel.multihost import (
    initialize_multihost,
    process_info,
    rank_device,
)


# ---------------------------------------------------------------------------
# the spec table


@dataclasses.dataclass(frozen=True)
class Split:
    """How a parameter lies over the ``model`` axis: ``dim`` None is
    replicated; 0 splits the output features (column-parallel), each of
    ``parts`` fused blocks ([Q|K|V]: 3) on its own; 1 splits the input
    features (row-parallel)."""

    dim: Optional[int]
    parts: int = 1


REP = Split(None)
ROW = Split(1)


def COL(parts: int = 1) -> Split:
    return Split(0, parts)


def _ln() -> dict:
    return {"weight": REP, "bias": REP}


def _rep_linear() -> dict:
    return {"weight": REP, "bias": REP}


def _col_linear(parts: int = 1) -> dict:
    return {"weight": COL(parts), "bias": COL(parts)}


def _row_linear() -> dict:
    # the bias is added once, after the sum over the model group
    return {"weight": ROW, "bias": REP}


def opt_layer_specs() -> dict:
    """One OPT decoder layer (``models/shape_opt.py::OPTLayer``)."""
    return {"qkv": _col_linear(3), "out": _row_linear(), "ln_attn": _ln(),
            "fc1": _col_linear(), "fc2": _row_linear(), "ln_ffn": _ln()}


def bertlike_layer_specs(qkv_key: str = "qkv", out_key: str = "attn_out") -> dict:
    """One BERT layer of the detokenizer (``models/nrd.py::BertLayer``)."""
    return {qkv_key: _col_linear(3), out_key: _row_linear(), "ln_attn": _ln(),
            "fc1": _col_linear(), "fc2": _row_linear(), "ln_ffn": _ln()}


def miche_self_block_specs() -> dict:
    """``models/layers.py::SelfAttentionBlock`` (qkv without a bias)."""
    return {"ln1": _ln(), "qkv": {"weight": COL(3)}, "proj": _row_linear(), "ln2": _ln(),
            "fc": _col_linear(), "fc_out": _row_linear()}


def _cross_block_specs() -> dict:
    """``models/layers.py::CrossAttentionBlock`` (q and kv without a bias)."""
    return {"ln_q": _ln(), "ln_kv": _ln(), "q": {"weight": COL(1)}, "kv": {"weight": COL(2)},
            "proj": _row_linear(), "ln_mlp": _ln(), "fc": _col_linear(),
            "fc_out": _row_linear()}


def perceiver_specs() -> dict:
    return {
        "query": REP,
        "input_proj": _rep_linear(),
        "cross_attn": _cross_block_specs(),
        "encoder": miche_self_block_specs(),
        "ln_post": _ln(),
        "pre_kl": _rep_linear(),
        "post_kl": _rep_linear(),
        "transformer": miche_self_block_specs(),
        "geo_decoder": {"query_proj": _rep_linear(), "cross": _cross_block_specs(),
                        "ln_post": _ln(), "output_proj": _rep_linear()},
    }


def shape_opt_specs() -> dict:
    return {"extra_embeds": REP, "input_layer": _rep_linear(), "embed_positions": REP,
            "face_positions": REP, "cond_embed": REP, "codebook": REP,
            "layers": opt_layer_specs(), "lm_head": {"weight": REP}}


def nrd_specs() -> dict:
    return {"pos_embedding": REP, "layernorm": _ln(), "point_layernorm": _ln(),
            "point_pe": REP, "cond_proj": _rep_linear(), "cond_head_proj": _rep_linear(),
            "project_down_codebook": _rep_linear(), "to_coor_logits": _rep_linear(),
            "encoder": bertlike_layer_specs()}


def meshanything_specs() -> dict:
    return {"perceiver": perceiver_specs(), "opt": shape_opt_specs(), "nrd": nrd_specs(),
            "cond_head_proj": _rep_linear(), "cond_proj": _rep_linear()}


_SPECS = meshanything_specs()


def spec_for(name: str) -> Split:
    """The Split of a parameter of ``MeshAnything`` by its name (the layer
    index of a ModuleList is skipped, as JAX's stacked layer axis is);
    a name the table does not hold raises KeyError."""
    node = _SPECS
    for part in name.split("."):
        if part.isdigit():
            continue
        if not isinstance(node, dict) or part not in node:
            raise KeyError(f"{name}: no sharding spec")
        node = node[part]
    if not isinstance(node, Split):
        raise KeyError(f"{name}: names a subtree of the spec table, not a parameter")
    return node


def shard_tensor(full: torch.Tensor, split: Split, index: int, n: int) -> torch.Tensor:
    """Rank ``index``'s shard of ``full`` over ``n`` model ranks (a view where the
    layout allows one)."""
    if split.dim is None or n == 1:
        return full
    if split.dim == 1:
        if full.shape[1] % n:
            raise ValueError(f"{full.shape[1]} input features do not split over {n} ranks")
        return full.chunk(n, dim=1)[index]
    if full.shape[0] % (split.parts * n):
        raise ValueError(f"{full.shape[0]} output features in {split.parts} parts do not "
                         f"split over {n} ranks")
    blocks = full.reshape(split.parts, n, full.shape[0] // (split.parts * n), *full.shape[1:])
    return blocks[:, index].reshape(-1, *full.shape[1:])


def unshard_tensor(shards: list, split: Split) -> torch.Tensor:
    """The full tensor of every model rank's shard, in rank order."""
    if split.dim is None or len(shards) == 1:
        return shards[0]
    if split.dim == 1:
        return torch.cat(shards, dim=1)
    rest = shards[0].shape[1:]
    blocks = [s.reshape(split.parts, -1, *rest) for s in shards]
    return torch.stack(blocks, dim=1).reshape(-1, *rest)


# ---------------------------------------------------------------------------
# processes and the mesh


def resolve_backend(device: torch.device, backend: Optional[str] = None) -> str:
    """The process group's backend for ranks on ``device``: gloo on the
    CPU; NCCL on cards, one rank a card. More ranks on this machine than
    cards need ``backend="gloo"`` asked for; NCCL or no choice raises then
    (no quiet move to another backend or device)."""
    if device.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU: the CPU runs gloo")
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    shared = local_world > torch.cuda.device_count()
    if backend == "gloo":
        return backend
    if backend not in (None, "nccl"):
        raise ValueError(f"backend {backend!r}: the port runs nccl or gloo")
    if shared:
        raise ValueError(
            f"{local_world} ranks on {torch.cuda.device_count()} card(s): NCCL takes one rank "
            "a card; ask for backend='gloo' to run several ranks on one card (its collectives "
            "cannot be captured into CUDA graphs: the tensor-parallel decode is eager)")
    return "nccl"


def join(device="cuda", backend: Optional[str] = None) -> torch.device:
    """Join the default process group from torchrun's environment with the
    backend of ``resolve_backend`` and return the rank's device
    (``multihost.rank_device``), made current on a card. One process
    joins nothing."""
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)        # before the group: NCCL binds the current card
    initialize_multihost(resolve_backend(dev, backend))
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A rank's place in the (data, model) grid: its coordinates and the
    process group along each axis (None where the axis has one rank)."""

    data: int
    model: int
    data_index: int
    model_index: int
    data_group: object
    model_group: object
    device: torch.device
    axis_names = ("data", "model")

    @property
    def shape(self) -> tuple:
        return (self.data, self.model)

    @property
    def rank(self) -> int:
        return self.data_index * self.model + self.model_index


def create_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """The (data, model) mesh over the default process group's ranks
    (every rank calls it). ``device``: the rank's device (default
    ``rank_device("cuda")``). Too few ranks raise ValueError, as JAX's
    create_mesh does with too few devices; more ranks than the mesh holds
    raise too (every rank must have a place)."""
    n = data * model
    rank, world = process_info()
    if world < n:
        raise ValueError(f"need {n} ranks, have {world}")
    if world > n:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}: every rank needs a place")
    device = rank_device("cuda") if device is None else torch.device(device)
    data_index, model_index = divmod(rank, model)
    data_group = model_group = None
    # every rank creates every group, in one order
    if model > 1:
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if d == data_index:
                model_group = g
    if data > 1:
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if m == model_index:
                data_group = g
    return Mesh(data, model, data_index, model_index, data_group, model_group, device)


# ---------------------------------------------------------------------------
# parameters


def sharded_names(model: nn.Module) -> set:
    """The names of ``model``'s parameters that the model axis splits."""
    return {name for name, _ in model.named_parameters() if spec_for(name).dim is not None}


def shard_tensors(mesh: Mesh, full: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's shard of each full tensor by parameter name, each a copy
    of its own (a replicated one whole)."""
    return {name: shard_tensor(t, spec_for(name), mesh.model_index, mesh.model).clone(
        memory_format=torch.contiguous_format) for name, t in full.items()}


def _gather_over(group, local: Dict[str, torch.Tensor], spec) -> Dict[str, torch.Tensor]:
    """The full tensors of every rank's shards over the model group
    ``group`` (``spec(name)`` a tensor's Split): each rank broadcasts its
    split shards, one flattened buffer a dtype, so the result is
    bit-exact."""
    full = dict(local)
    names = [n for n in local if spec(n).dim is not None]
    ranks = dist.get_process_group_ranks(group)
    me = dist.get_rank(group)
    for dtype in {local[n].dtype for n in names}:
        group_names = [n for n in names if local[n].dtype == dtype]
        mine = [local[n].contiguous() for n in group_names]
        flat = _flatten_dense_tensors(mine)
        shards = {n: [] for n in group_names}
        for index, src in enumerate(ranks):
            buf = flat if index == me else torch.empty_like(flat)
            dist.broadcast(buf, src=src, group=group)
            for n, t in zip(group_names, _unflatten_dense_tensors(buf, mine)):
                shards[n].append(t)
        for n in group_names:
            full[n] = unshard_tensor(shards[n], spec(n))
    return full


def gather_tensors(mesh: Mesh, local: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The full tensors of every rank's shards by parameter name (every
    rank of the model group calls it), bit-exact."""
    if mesh.model == 1:
        return dict(local)
    return _gather_over(mesh.model_group, local, spec_for)


def _rebuilt(model: nn.Module, tensors: Dict[str, torch.Tensor], heads: callable,
             group) -> nn.Module:
    """A copy of ``model``'s modules with ``tensors`` as its parameters (by
    name, no copy), each attention's head count ``heads(count)`` and the
    model group ``group`` (None: no collective)."""
    memo = {id(p): nn.Parameter(tensors[n], requires_grad=p.requires_grad)
            for n, p in model.named_parameters()}
    for m in model.modules():
        if getattr(m, "tp_group", None) is not None:
            memo[id(m.tp_group)] = None
    out = copy.deepcopy(model, memo)
    for m in out.modules():
        if hasattr(m, "tp_group"):
            m.tp_group = group
            m.num_heads = heads(m.num_heads)
        if isinstance(m, nn.Linear):
            m.out_features, m.in_features = m.weight.shape
    return out


def _check_heads(mesh: Mesh, model: nn.Module) -> None:
    """Raise unless every attention's heads split evenly over the model
    axis (JAX's fused layout splits heads only then)."""
    for name, m in model.named_modules():
        if hasattr(m, "tp_group") and m.num_heads % mesh.model:
            raise ValueError(f"{name}: {m.num_heads} heads do not split over "
                             f"{mesh.model} model ranks")


def shard_params(mesh: Mesh, model: nn.Module) -> nn.Module:
    """The rank's local module of a full ``MeshAnything``: every parameter
    a copy (split ones sliced; nothing shares storage with ``model``), each
    attention with ``num_heads // model`` heads and the model group. With
    one model rank the local module is ``model`` itself."""
    if mesh.model == 1:
        return model
    _check_heads(mesh, model)
    local = shard_tensors(mesh, {n: p.detach() for n, p in model.named_parameters()})
    return _rebuilt(model, local, lambda h: h // mesh.model, mesh.model_group)


def gather_module(local: nn.Module, group, prefix: str = "") -> nn.Module:
    """The full module of a rank's local submodule of ``MeshAnything``
    (its parameters named ``prefix + name`` in the spec table), gathered
    over the model group ``group`` (every rank of it calls this),
    bit-exact; ``local`` itself without a group."""
    n = group_size(group)
    if n == 1:
        return local
    full = _gather_over(group, {name: p.detach() for name, p in local.named_parameters()},
                        lambda name: spec_for(prefix + name))
    return _rebuilt(local, full, lambda h: h * n, None)


def gather_params(mesh: Mesh, local: nn.Module) -> nn.Module:
    """The full module of the rank's local one (every rank of the model
    group calls it; ``shard_params``' inverse, bit-exact)."""
    return gather_module(local, mesh.model_group)
