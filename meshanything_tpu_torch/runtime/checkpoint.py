"""Weights for the port: the bridge from the JAX parameter tree, and
seeded random weights.

The JAX package keeps parameters as a nested dict whose layer stacks
carry a leading L axis (``stack_layer_params``) and whose linear
weights are ``(in, out)``. The port's modules mirror that tree name for
name, so the bridge is one walk over both:

  * a ``nn.ModuleList`` takes one slice of the stacked subtree per entry;
  * a ``nn.Linear`` takes ``w`` transposed to ``(out, in)`` and ``b``;
  * a ``nn.LayerNorm`` takes ``scale`` and ``bias``;
  * any other parameter takes the leaf of its own name.

It raises on a leaf it did not consume and on a parameter it did not
fill. It takes plain numpy arrays, so the port never imports JAX.
``jax_numpy_from_params`` is the same walk backwards: the module tree to
JAX's nested numpy tree (the trained weights' cache is in JAX's layout).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from meshanything_tpu_torch.config import MeshAnythingConfig
from meshanything_tpu_torch.models.meshanything import MeshAnything


def _leaf_paths(tree, prefix=()) -> set:
    if isinstance(tree, dict):
        out = set()
        for k, v in tree.items():
            out |= _leaf_paths(v, prefix + (k,))
        return out
    return {prefix}


def _take(tree: dict, path: tuple, key: str, index, used: set, shape) -> torch.Tensor:
    if key not in tree:
        raise KeyError(f"JAX tree has no leaf {'/'.join(path + (key,))}")
    arr = np.asarray(tree[key])
    if index is not None:
        arr = arr[index]
    used.add(path + (key,))
    t = torch.from_numpy(np.array(arr))   # a writable copy
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{'/'.join(path + (key,))}: shape {tuple(t.shape)} != {tuple(shape)}")
    return t


def _fill(module: nn.Module, tree: dict, path: tuple, index, used: set, filled: set) -> None:
    """Copy the subtree at ``path`` (row ``index`` of every leaf, for a
    stacked layer) into ``module``."""
    def put(param: Optional[torch.Tensor], key: str, transpose: bool = False):
        if param is None:
            return
        shape = param.shape[::-1] if transpose else param.shape
        src = _take(tree, path, key, index, used, shape)
        with torch.no_grad():
            param.copy_(src.T if transpose else src)
        filled.add(id(param))

    if isinstance(module, nn.Linear):
        put(module.weight, "w", transpose=True)
        put(module.bias, "b")
        return
    if isinstance(module, nn.LayerNorm):
        put(module.weight, "scale")
        put(module.bias, "bias")
        return
    for name, param in module.named_parameters(recurse=False):
        put(param, name)
    for name, child in module.named_children():
        if name not in tree:
            raise KeyError(f"JAX tree has no subtree {'/'.join(path + (name,))}")
        sub = tree[name]
        if isinstance(child, nn.ModuleList):
            lengths = _stacked_lengths(sub)
            if lengths != {len(child)}:
                raise ValueError(f"{'/'.join(path + (name,))}: stacked layer counts "
                                 f"{sorted(lengths)}, module has {len(child)}")
            for i, layer in enumerate(child):
                _fill(layer, sub, path + (name,), i, used, filled)
        else:
            _fill(child, sub, path + (name,), index, used, filled)


def _stacked_lengths(tree) -> set:
    if isinstance(tree, dict):
        out = set()
        for v in tree.values():
            out |= _stacked_lengths(v)
        return out
    return {np.shape(tree)[0]}


def params_from_jax_numpy(tree: dict, cfg: MeshAnythingConfig, *, device=None) -> MeshAnything:
    """JAX parameter tree as numpy arrays
    (``jax.tree_util.tree_map(np.asarray, init_meshanything_params(...))``)
    -> the port's ``MeshAnything`` module on ``device``, in the tree's
    dtype."""
    dtype = torch.from_numpy(np.empty(0, np.asarray(tree["opt"]["cond_embed"]).dtype)).dtype
    model = MeshAnything(cfg, device="cpu", dtype=dtype)
    used, filled = set(), set()
    _fill(model, tree, (), None, used, filled)
    unused = _leaf_paths(tree) - used
    if unused:
        raise ValueError(f"JAX leaves not consumed: {sorted('/'.join(p) for p in unused)}")
    unfilled = [n for n, p in model.named_parameters() if id(p) not in filled]
    if unfilled:
        raise ValueError(f"parameters not filled from the JAX tree: {unfilled}")
    return model.to(device)


def _tree_of(module: nn.Module) -> dict:
    def arr(t: torch.Tensor, transpose: bool = False) -> np.ndarray:
        t = t.detach().cpu()
        return (t.T if transpose else t).contiguous().numpy()

    if isinstance(module, nn.Linear):
        out = {"w": arr(module.weight, transpose=True)}
        if module.bias is not None:
            out["b"] = arr(module.bias)
        return out
    if isinstance(module, nn.LayerNorm):
        return {"scale": arr(module.weight), "bias": arr(module.bias)}
    out = {name: arr(param) for name, param in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        if isinstance(child, nn.ModuleList):
            out[name] = _stack([_tree_of(layer) for layer in child])
        else:
            out[name] = _tree_of(child)
    return out


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def jax_numpy_from_params(model: MeshAnything) -> dict:
    """The inverse of ``params_from_jax_numpy``: the module tree -> JAX's
    nested numpy tree (layer stacks with a leading L axis, linear weights
    ``(in, out)``), in the module's dtype. numpy has no bfloat16, so a
    bf16 module raises: cast it to f32 first."""
    dtypes = {p.dtype for p in model.parameters()}
    if torch.bfloat16 in dtypes:
        raise ValueError("numpy has no bfloat16: cast the module to float32 first")
    return _tree_of(model)


@torch.no_grad()
def init_random_params(cfg: MeshAnythingConfig, generator: torch.Generator,
                       dtype: torch.dtype = torch.bfloat16) -> MeshAnything:
    """Seeded random weights on the generator's device, with the JAX
    initializers' scales (not their random bits): N(0, 0.02) weights and
    tables, N(0, init_scale/sqrt(width)) perceiver linears, zero biases,
    unit layer norms."""
    device = generator.device
    model = MeshAnything(cfg, device=device, dtype=torch.float32)
    perceiver_std = cfg.perceiver.init_scale * math.sqrt(1.0 / cfg.perceiver.width)
    for prefix, module in model.named_modules():
        if isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.fill_(0.0)
        elif isinstance(module, nn.Linear):
            std = perceiver_std if prefix.startswith("perceiver.") else 0.02
            module.weight.normal_(0.0, std, generator=generator)
            if module.bias is not None:
                module.bias.zero_()
        else:
            for param in module.parameters(recurse=False):
                param.normal_(0.0, 0.02, generator=generator)
    return model.to(dtype)
