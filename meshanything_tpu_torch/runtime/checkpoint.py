"""Weights for the port: the reference checkpoint, the port's own
checkpoints, the bridge from the JAX parameter tree, and seeded random
weights.

The reference checkpoint (``MeshAnything_350m.pth``, safetensors despite
the name; reference main.py:95-104) is read without the ``safetensors``
package (``load_safetensors``: the file memory-mapped, BF16 widened to
f32 exactly), converted by numpy copies of the JAX package's walk
(``convert_meshanything``, JAX ``runtime/checkpoint.py:32-253``) into
JAX's parameter tree, and bridged into the module
(``params_from_jax_numpy``): ``load_reference_checkpoint``. As in JAX, the
walk reads keys by name: a key it needs and cannot find raises
``KeyError``, a key it does not read is ignored, and named once on
stderr. The port's own checkpoints (``save_native`` / ``load_native``:
one ``torch.save`` of the parameters by name, read with
``torch.load(weights_only=True)``) take the place of JAX's orbax ones.
Over a (data, model) mesh they stay full tensors by name: the model
group's shards are gathered and rank 0 writes; every rank reads the file
and keeps its shard (JAX ``load_orbax_sharded``), so a checkpoint of one
mesh loads into any other, or into one process.

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

import json
import math
import os
import sys
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from meshanything_tpu_torch.config import (
    MeshAnythingConfig,
    NRDConfig,
    PerceiverConfig,
    ShapeOPTConfig,
)
from meshanything_tpu_torch.models.meshanything import MeshAnything
from meshanything_tpu_torch.models.perceiver import Perceiver
from meshanything_tpu_torch.parallel.mesh import gather_tensors, shard_params


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


def fill_from_jax_numpy(module: nn.Module, tree: dict) -> nn.Module:
    """Copy a JAX parameter tree of numpy arrays into ``module`` in place,
    each leaf cast to its parameter's dtype as it is copied. Raises on a
    leaf it did not consume and on a parameter it did not fill."""
    used, filled = set(), set()
    _fill(module, tree, (), None, used, filled)
    unused = _leaf_paths(tree) - used
    if unused:
        raise ValueError(f"JAX leaves not consumed: {sorted('/'.join(p) for p in unused)}")
    unfilled = [n for n, p in module.named_parameters() if id(p) not in filled]
    if unfilled:
        raise ValueError(f"parameters not filled from the JAX tree: {unfilled}")
    return module


def _leaf_dtype(leaf) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np.asarray(leaf).dtype)).dtype


def params_from_jax_numpy(tree: dict, cfg: MeshAnythingConfig, *, device=None,
                          dtype: Optional[torch.dtype] = None) -> MeshAnything:
    """JAX parameter tree as numpy arrays
    (``jax.tree_util.tree_map(np.asarray, init_meshanything_params(...))``)
    -> the port's ``MeshAnything`` module, made on ``device`` (default the
    CPU) in ``dtype`` (default the tree's) and filled leaf by leaf, each
    leaf cast as it is copied (as JAX's ``to_device_tree`` casts)."""
    dtype = dtype or _leaf_dtype(tree["opt"]["cond_embed"])
    return fill_from_jax_numpy(MeshAnything(cfg, device=device or "cpu", dtype=dtype), tree)


def perceiver_from_jax_numpy(tree: dict, cfg: PerceiverConfig, *, device=None,
                             dtype: Optional[torch.dtype] = None) -> Perceiver:
    """The perceiver alone: JAX's ``init_perceiver_params`` tree (or
    ``convert_perceiver``'s) -> the port's ``Perceiver``."""
    dtype = dtype or _leaf_dtype(tree["query"])
    return fill_from_jax_numpy(Perceiver(cfg, device=device or "cpu", dtype=dtype), tree)


def udt_from_jax_numpy(tree: dict, cfg, *, device=None,
                       dtype: Optional[torch.dtype] = None):
    """JAX's ``diffusion.init_udt_params`` tree -> the port's
    ``UDTDenoiser`` (``cfg``: a ``models/diffusion.py::DiffusionConfig``)."""
    from meshanything_tpu_torch.models.diffusion import UDTDenoiser

    dtype = dtype or _leaf_dtype(tree["ln_post"]["scale"])
    return fill_from_jax_numpy(UDTDenoiser(cfg, device=device or "cpu", dtype=dtype), tree)


def dit_from_jax_numpy(tree: dict, width: int, num_heads: int, *, device=None,
                       dtype: Optional[torch.dtype] = None):
    """JAX's ``diffusion.init_dit_block`` tree -> the port's ``DiTBlock``
    (with cross-attention where the tree has ``cross_kv``)."""
    from meshanything_tpu_torch.models.diffusion import DiTBlock

    context_dim = np.shape(tree["cross_kv"]["w"])[0] if "cross_kv" in tree else None
    dtype = dtype or _leaf_dtype(tree["ada1"]["w"])
    block = DiTBlock(width, num_heads, context_dim=context_dim, device=device or "cpu",
                     dtype=dtype)
    return fill_from_jax_numpy(block, tree)


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
def randomize_(module: nn.Module, generator: torch.Generator, linear_std=0.02) -> nn.Module:
    """Seeded random values in place, with the JAX initializers' scales (not
    their random bits): N(0, std) linear weights (``linear_std``: a number,
    or a function of the linear's name), zero biases, unit layer norms,
    N(0, 0.02) for every other parameter (tables, queries)."""
    for prefix, sub in module.named_modules():
        if isinstance(sub, nn.LayerNorm):
            sub.weight.fill_(1.0)
            sub.bias.fill_(0.0)
        elif isinstance(sub, nn.Linear):
            std = linear_std(prefix) if callable(linear_std) else linear_std
            sub.weight.normal_(0.0, std, generator=generator)
            if sub.bias is not None:
                sub.bias.zero_()
        else:
            for param in sub.parameters(recurse=False):
                param.normal_(0.0, 0.02, generator=generator)
    return module


def init_random_params(cfg: MeshAnythingConfig, generator: torch.Generator,
                       dtype: torch.dtype = torch.bfloat16) -> MeshAnything:
    """Seeded random weights on the generator's device (``randomize_``):
    N(0, init_scale/sqrt(width)) perceiver linears, N(0, 0.02) the rest."""
    model = MeshAnything(cfg, device=generator.device, dtype=torch.float32)
    perceiver_std = cfg.perceiver.init_scale * math.sqrt(1.0 / cfg.perceiver.width)
    randomize_(model, generator,
               lambda name: perceiver_std if name.startswith("perceiver.") else 0.02)
    return model.to(dtype)


def init_random_perceiver(cfg: PerceiverConfig, generator: torch.Generator) -> Perceiver:
    """The perceiver alone in f32 with ``init_random_params``' scales, on the
    generator's device."""
    model = Perceiver(cfg, device=generator.device, dtype=torch.float32)
    return randomize_(model, generator, cfg.init_scale * math.sqrt(1.0 / cfg.width))


# ---------------------------------------------------------------------------
# safetensors, read without the package

# dtype name -> (numpy dtype of the stored bytes, bytes an element)
_ST_DTYPES = {"F64": (np.float64, 8), "F32": (np.float32, 4), "F16": (np.float16, 2),
              "BF16": (np.uint16, 2), "I64": (np.int64, 8), "I32": (np.int32, 4),
              "I16": (np.int16, 2), "I8": (np.int8, 1), "U8": (np.uint8, 1),
              "BOOL": (np.bool_, 1)}


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) -> the same values in f32, exactly
    (a bf16 is the upper half of an f32)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


class SafetensorsFile(Mapping):
    """A safetensors file as a read-only mapping of name -> numpy array.

    The format: an 8-byte little-endian header length N, N bytes of JSON
    (each tensor's ``dtype``, ``shape`` and ``data_offsets`` [begin, end)
    into the data that follows; an optional ``__metadata__``), then the
    raw little-endian bytes. The data is memory-mapped: an array is a view
    of the file, except a BF16 one, which is widened to f32 when it is
    read (numpy has no bfloat16). ``metadata`` is ``__metadata__``.
    Raises ``ValueError`` on a truncated file, on offsets out of range or
    overlapping, on a size that is not the shape's, and on an unknown
    dtype."""

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path)
        if size < 8:
            raise ValueError(f"{path}: truncated safetensors file ({size} bytes, no header)")
        with open(path, "rb") as fh:
            n = int.from_bytes(fh.read(8), "little")
            if 8 + n > size:
                raise ValueError(f"{path}: truncated safetensors file (header of {n} bytes, "
                                 f"file of {size})")
            try:
                header = json.loads(fh.read(n))
            except ValueError as e:
                raise ValueError(f"{path}: the safetensors header is not JSON: {e}") from None
        if not isinstance(header, dict):
            raise ValueError(f"{path}: the safetensors header is not a JSON object")
        self.metadata = header.pop("__metadata__", None)
        data_len = size - 8 - n
        self._entries = {}
        spans = []
        for name, info in header.items():
            dtype = info.get("dtype")
            if dtype not in _ST_DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype {dtype!r}, which this "
                                 f"reader does not know ({sorted(_ST_DTYPES)})")
            shape = tuple(int(d) for d in info["shape"])
            begin, end = (int(o) for o in info["data_offsets"])
            if not 0 <= begin <= end:
                raise ValueError(f"{path}: tensor {name!r} has data_offsets {[begin, end]}")
            if end > data_len:
                raise ValueError(f"{path}: truncated safetensors file: tensor {name!r} ends at "
                                 f"{end}, the data holds {data_len} bytes")
            want = int(np.prod(shape, dtype=np.int64)) * _ST_DTYPES[dtype][1]
            if end - begin != want:
                raise ValueError(f"{path}: tensor {name!r} of shape {list(shape)} in {dtype} "
                                 f"needs {want} bytes, data_offsets give {end - begin}")
            self._entries[name] = (dtype, shape, begin, end)
            spans.append((begin, end, name))
        spans.sort()
        for (_, prev_end, prev), (begin, _, name) in zip(spans, spans[1:]):
            if begin < prev_end:
                raise ValueError(f"{path}: the data of {prev!r} and {name!r} overlap")
        self._data = (np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n, shape=(data_len,))
                      if data_len else np.zeros(0, np.uint8))

    def __getitem__(self, name: str) -> np.ndarray:
        dtype, shape, begin, end = self._entries[name]
        arr = np.asarray(self._data[begin:end]).view(_ST_DTYPES[dtype][0]).reshape(shape)
        return bf16_bits_to_f32(arr) if dtype == "BF16" else arr

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)


def load_safetensors(path: str) -> SafetensorsFile:
    """The tensors of a safetensors file, memory-mapped
    (``SafetensorsFile``); BF16 tensors read as f32."""
    return SafetensorsFile(path)


# ---------------------------------------------------------------------------
# the reference state dict -> JAX's parameter tree (numpy copies of the JAX
# package's runtime/checkpoint.py walk)

Arr = np.ndarray


def _lin(sd: Mapping[str, Arr], prefix: str, bias: bool = True) -> dict:
    p = {"w": np.ascontiguousarray(np.asarray(sd[prefix + ".weight"]).T)}
    if bias and prefix + ".bias" in sd:
        p["b"] = np.asarray(sd[prefix + ".bias"])
    return p


def _ln(sd: Mapping[str, Arr], prefix: str) -> dict:
    return {"scale": np.asarray(sd[prefix + ".weight"]), "bias": np.asarray(sd[prefix + ".bias"])}


def _deinterleave_qkv(w_t: Arr, heads: int, parts: int) -> Arr:
    """torch fused qkv/kv weight (parts*W, in), interleaved per head
    (Michelangelo's view(B, N, heads, parts*ch)) -> (in, parts*W) in the
    [Q|K|V] ([K|V]) block layout."""
    out_dim, in_dim = w_t.shape
    width = out_dim // parts
    ch = width // heads
    w = w_t.reshape(heads, parts, ch, in_dim)       # out index = h*parts*ch + p*ch + c
    w = np.transpose(w, (1, 0, 2, 3)).reshape(parts * width, in_dim)
    return np.ascontiguousarray(w.T)


def _deinterleave_qkv_bias(b_t: Arr, heads: int, parts: int) -> Arr:
    width = b_t.shape[0] // parts
    ch = width // heads
    return b_t.reshape(heads, parts, ch).transpose(1, 0, 2).reshape(parts * width)


def _miche_self_block(sd, prefix, heads, qkv_bias=False) -> dict:
    """ResidualAttentionBlock -> the self-attention block's leaves."""
    p = {
        "ln1": _ln(sd, f"{prefix}.ln_1"),
        "qkv": {"w": _deinterleave_qkv(np.asarray(sd[f"{prefix}.attn.c_qkv.weight"]), heads, 3)},
        "proj": _lin(sd, f"{prefix}.attn.c_proj"),
        "ln2": _ln(sd, f"{prefix}.ln_2"),
        "fc": _lin(sd, f"{prefix}.mlp.c_fc"),
        "fc_out": _lin(sd, f"{prefix}.mlp.c_proj"),
    }
    if qkv_bias and f"{prefix}.attn.c_qkv.bias" in sd:
        p["qkv"]["b"] = _deinterleave_qkv_bias(np.asarray(sd[f"{prefix}.attn.c_qkv.bias"]),
                                               heads, 3)
    return p


def _miche_cross_block(sd, prefix, heads, qkv_bias=False) -> dict:
    """ResidualCrossAttentionBlock -> the cross-attention block's leaves."""
    p = {
        "ln_q": _ln(sd, f"{prefix}.ln_1"),
        "ln_kv": _ln(sd, f"{prefix}.ln_2"),
        "q": {"w": np.ascontiguousarray(np.asarray(sd[f"{prefix}.attn.c_q.weight"]).T)},
        "kv": {"w": _deinterleave_qkv(np.asarray(sd[f"{prefix}.attn.c_kv.weight"]), heads, 2)},
        "proj": _lin(sd, f"{prefix}.attn.c_proj"),
        "ln_mlp": _ln(sd, f"{prefix}.ln_3"),
        "fc": _lin(sd, f"{prefix}.mlp.c_fc"),
        "fc_out": _lin(sd, f"{prefix}.mlp.c_proj"),
    }
    if qkv_bias:
        if f"{prefix}.attn.c_q.bias" in sd:
            p["q"]["b"] = np.asarray(sd[f"{prefix}.attn.c_q.bias"])
        if f"{prefix}.attn.c_kv.bias" in sd:
            p["kv"]["b"] = _deinterleave_qkv_bias(np.asarray(sd[f"{prefix}.attn.c_kv.bias"]),
                                                  heads, 2)
    return p


def convert_perceiver(sd: Mapping[str, Arr], cfg: PerceiverConfig, prefix: str = "") -> dict:
    """An AlignedShapeLatentPerceiver state dict subtree (``prefix`` e.g.
    "point_encoder.model.shape_model.") -> the perceiver's leaves."""
    g = lambda k: prefix + k  # noqa: E731
    heads = cfg.heads
    enc = [_miche_self_block(sd, g(f"encoder.self_attn.resblocks.{i}"), heads, cfg.qkv_bias)
           for i in range(cfg.num_encoder_layers)]
    dec = [_miche_self_block(sd, g(f"transformer.resblocks.{i}"), heads, cfg.qkv_bias)
           for i in range(cfg.num_decoder_layers)]
    return {
        "query": np.asarray(sd[g("encoder.query")]),
        "input_proj": _lin(sd, g("encoder.input_proj")),
        "cross_attn": _miche_cross_block(sd, g("encoder.cross_attn"), heads, cfg.qkv_bias),
        "encoder": _stack(enc),
        "ln_post": _ln(sd, g("encoder.ln_post")),
        "pre_kl": _lin(sd, g("pre_kl")),
        "post_kl": _lin(sd, g("post_kl")),
        "transformer": _stack(dec),
        "geo_decoder": {
            "query_proj": _lin(sd, g("geo_decoder.query_proj")),
            "cross": _miche_cross_block(sd, g("geo_decoder.cross_attn_decoder"), heads,
                                        cfg.qkv_bias),
            "ln_post": _ln(sd, g("geo_decoder.ln_post")),
            "output_proj": _lin(sd, g("geo_decoder.output_proj")),
        },
    }


def convert_opt(sd: Mapping[str, Arr], cfg: ShapeOPTConfig, prefix: str = "transformer.") -> dict:
    """The ShapeOPT decoder and head (HF OPT naming: self_attn.{q,k,v,
    out}_proj, self_attn_layer_norm, fc1, fc2, final_layer_norm)."""
    g = lambda k: prefix + k  # noqa: E731
    d = "model.decoder."

    def opt_layer(i):
        lp = g(f"{d}layers.{i}.")
        qw = np.asarray(sd[lp + "self_attn.q_proj.weight"]).T
        kw = np.asarray(sd[lp + "self_attn.k_proj.weight"]).T
        vw = np.asarray(sd[lp + "self_attn.v_proj.weight"]).T
        qb = np.asarray(sd[lp + "self_attn.q_proj.bias"])
        kb = np.asarray(sd[lp + "self_attn.k_proj.bias"])
        vb = np.asarray(sd[lp + "self_attn.v_proj.bias"])
        return {
            "qkv": {"w": np.ascontiguousarray(np.concatenate([qw, kw, vw], axis=1)),
                    "b": np.concatenate([qb, kb, vb])},
            "out": _lin(sd, lp + "self_attn.out_proj"),
            "ln_attn": _ln(sd, lp + "self_attn_layer_norm"),
            "fc1": _lin(sd, lp + "fc1"),
            "fc2": _lin(sd, lp + "fc2"),
            "ln_ffn": _ln(sd, lp + "final_layer_norm"),
        }

    return {
        "extra_embeds": np.asarray(sd[g(d + "extra_embeds.weight")]),
        "input_layer": _lin(sd, g(d + "input_layer")),
        "embed_positions": np.asarray(sd[g(d + "embed_positions.weight")]),
        "face_positions": np.asarray(sd[g(d + "token_embed_positions.weight")]),
        "cond_embed": np.asarray(sd[g(d + "cond_embed.weight")]),
        "codebook": np.asarray(sd[g(d + "quantize_codebooks")])[0],
        "layers": _stack([opt_layer(i) for i in range(cfg.num_layers)]),
        "lm_head": {"w": np.ascontiguousarray(np.asarray(sd[g("lm_head.weight")]).T)},
    }


def convert_bert_encoder(sd: Mapping[str, Arr], cfg: NRDConfig, prefix: str) -> dict:
    """A HF BertEncoder subtree (layer.{i}.attention...)."""
    def bert_layer(i):
        lp = f"{prefix}layer.{i}."
        qw = np.asarray(sd[lp + "attention.self.query.weight"]).T
        kw = np.asarray(sd[lp + "attention.self.key.weight"]).T
        vw = np.asarray(sd[lp + "attention.self.value.weight"]).T
        qb = np.asarray(sd[lp + "attention.self.query.bias"])
        kb = np.asarray(sd[lp + "attention.self.key.bias"])
        vb = np.asarray(sd[lp + "attention.self.value.bias"])
        return {
            "qkv": {"w": np.ascontiguousarray(np.concatenate([qw, kw, vw], axis=1)),
                    "b": np.concatenate([qb, kb, vb])},
            "attn_out": _lin(sd, lp + "attention.output.dense"),
            "ln_attn": _ln(sd, lp + "attention.output.LayerNorm"),
            "fc1": _lin(sd, lp + "intermediate.dense"),
            "fc2": _lin(sd, lp + "output.dense"),
            "ln_ffn": _ln(sd, lp + "output.LayerNorm"),
        }

    return _stack([bert_layer(i) for i in range(cfg.num_layers)])


def convert_nrd(sd: Mapping[str, Arr], cfg: NRDConfig, prefix: str = "tokenizer.") -> dict:
    """The NoiseResistantDecoder. Its BERT layers come in two namings:
    BetterTransformer's fused ``decoder.layer.{i}.in_proj_weight`` (the
    shipped checkpoint was saved from the BetterTransformer-ized module)
    and HF's ``decoder.layer.{i}.attention.self.query.weight``."""
    g = lambda k: prefix + k  # noqa: E731

    if g("decoder.layer.0.in_proj_weight") in sd:
        def bt_layer(i):
            lp = g(f"decoder.layer.{i}.")
            return {
                "qkv": {"w": np.ascontiguousarray(np.asarray(sd[lp + "in_proj_weight"]).T),
                        "b": np.asarray(sd[lp + "in_proj_bias"])},
                "attn_out": {"w": np.ascontiguousarray(np.asarray(sd[lp + "out_proj_weight"]).T),
                             "b": np.asarray(sd[lp + "out_proj_bias"])},
                "ln_attn": {"scale": np.asarray(sd[lp + "norm1_weight"]),
                            "bias": np.asarray(sd[lp + "norm1_bias"])},
                "fc1": {"w": np.ascontiguousarray(np.asarray(sd[lp + "linear1_weight"]).T),
                        "b": np.asarray(sd[lp + "linear1_bias"])},
                "fc2": {"w": np.ascontiguousarray(np.asarray(sd[lp + "linear2_weight"]).T),
                        "b": np.asarray(sd[lp + "linear2_bias"])},
                "ln_ffn": {"scale": np.asarray(sd[lp + "norm2_weight"]),
                           "bias": np.asarray(sd[lp + "norm2_bias"])},
            }
        encoder = _stack([bt_layer(i) for i in range(cfg.num_layers)])
    else:
        encoder = convert_bert_encoder(sd, cfg, prefix + "decoder.")

    return {
        "pos_embedding": np.asarray(sd[g("pos_embedding.weight")]),
        "layernorm": _ln(sd, g("layernorm")),
        "point_layernorm": _ln(sd, g("point_layernorm")),
        "point_pe": np.asarray(sd[g("point_pe.weight")]),
        "cond_proj": _lin(sd, g("cond_proj")),
        "cond_head_proj": _lin(sd, g("cond_head_proj")),
        "project_down_codebook": _lin(sd, g("project_down_codebook")),
        "to_coor_logits": _lin(sd, g("to_coor_logits.0")),
        "encoder": encoder,
    }


def convert_meshanything(sd: Mapping[str, Arr], cfg: MeshAnythingConfig) -> dict:
    """The combined reference state dict -> JAX's parameter tree."""
    return {
        "perceiver": convert_perceiver(sd, cfg.perceiver, "point_encoder.model.shape_model."),
        "opt": convert_opt(sd, cfg.opt, "transformer."),
        "nrd": convert_nrd(sd, cfg.nrd, "tokenizer."),
        "cond_head_proj": _lin(sd, "cond_head_proj"),
        "cond_proj": _lin(sd, "cond_proj"),
    }


class _ReadKeys(Mapping):
    """A state dict that records the keys read from it (``in`` reads
    nothing)."""

    def __init__(self, sd: Mapping):
        self.sd, self.read = sd, set()

    def __getitem__(self, key):
        value = self.sd[key]
        self.read.add(key)
        return value

    def __contains__(self, key) -> bool:
        return key in self.sd

    def __iter__(self):
        return iter(self.sd)

    def __len__(self) -> int:
        return len(self.sd)


def convert_state_dict(sd: Mapping[str, Arr], cfg: MeshAnythingConfig) -> Tuple[dict, list]:
    """``convert_meshanything`` -> (the tree, the sorted keys it did not
    read). A key it needs and cannot find raises ``KeyError``."""
    tracked = _ReadKeys(sd)
    tree = convert_meshanything(tracked, cfg)
    return tree, sorted(set(sd) - tracked.read)


def reference_key_shapes(cfg: MeshAnythingConfig, *, fused_nrd: bool = True) -> Dict[str, tuple]:
    """The key names and shapes of the reference state dict that
    ``convert_meshanything`` reads, from the config alone (shapes taken
    from the port's modules on the meta device). ``fused_nrd``: the NRD's
    BERT layers in BetterTransformer's naming, else HF's."""
    m = MeshAnything(cfg, device="meta")
    shapes: Dict[str, tuple] = {}

    def lin(prefix, mod):
        shapes[prefix + ".weight"] = tuple(mod.weight.shape)
        if mod.bias is not None:
            shapes[prefix + ".bias"] = tuple(mod.bias.shape)

    def norm(prefix, mod):
        shapes[prefix + ".weight"] = shapes[prefix + ".bias"] = tuple(mod.weight.shape)

    def self_block(prefix, blk):
        norm(f"{prefix}.ln_1", blk.ln1)
        lin(f"{prefix}.attn.c_qkv", blk.qkv)
        lin(f"{prefix}.attn.c_proj", blk.proj)
        norm(f"{prefix}.ln_2", blk.ln2)
        lin(f"{prefix}.mlp.c_fc", blk.fc)
        lin(f"{prefix}.mlp.c_proj", blk.fc_out)

    def cross_block(prefix, blk):
        norm(f"{prefix}.ln_1", blk.ln_q)
        norm(f"{prefix}.ln_2", blk.ln_kv)
        lin(f"{prefix}.attn.c_q", blk.q)
        lin(f"{prefix}.attn.c_kv", blk.kv)
        lin(f"{prefix}.attn.c_proj", blk.proj)
        norm(f"{prefix}.ln_3", blk.ln_mlp)
        lin(f"{prefix}.mlp.c_fc", blk.fc)
        lin(f"{prefix}.mlp.c_proj", blk.fc_out)

    per, p = "point_encoder.model.shape_model.", m.perceiver
    shapes[per + "encoder.query"] = tuple(p.query.shape)
    lin(per + "encoder.input_proj", p.input_proj)
    cross_block(per + "encoder.cross_attn", p.cross_attn)
    for i, blk in enumerate(p.encoder):
        self_block(f"{per}encoder.self_attn.resblocks.{i}", blk)
    norm(per + "encoder.ln_post", p.ln_post)
    lin(per + "pre_kl", p.pre_kl)
    lin(per + "post_kl", p.post_kl)
    for i, blk in enumerate(p.transformer):
        self_block(f"{per}transformer.resblocks.{i}", blk)
    lin(per + "geo_decoder.query_proj", p.geo_decoder.query_proj)
    cross_block(per + "geo_decoder.cross_attn_decoder", p.geo_decoder.cross)
    norm(per + "geo_decoder.ln_post", p.geo_decoder.ln_post)
    lin(per + "geo_decoder.output_proj", p.geo_decoder.output_proj)

    dec, o = "transformer.model.decoder.", m.opt
    h = cfg.opt.hidden_size
    for i, layer in enumerate(o.layers):
        lp = f"{dec}layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj"):
            shapes[f"{lp}self_attn.{name}.weight"], shapes[f"{lp}self_attn.{name}.bias"] = (
                (h, h), (h,))
        lin(lp + "self_attn.out_proj", layer.out)
        norm(lp + "self_attn_layer_norm", layer.ln_attn)
        lin(lp + "fc1", layer.fc1)
        lin(lp + "fc2", layer.fc2)
        norm(lp + "final_layer_norm", layer.ln_ffn)
    shapes[dec + "extra_embeds.weight"] = tuple(o.extra_embeds.shape)
    lin(dec + "input_layer", o.input_layer)
    shapes[dec + "embed_positions.weight"] = tuple(o.embed_positions.shape)
    shapes[dec + "token_embed_positions.weight"] = tuple(o.face_positions.shape)
    shapes[dec + "cond_embed.weight"] = tuple(o.cond_embed.shape)
    shapes[dec + "quantize_codebooks"] = (1, *o.codebook.shape)
    shapes["transformer.lm_head.weight"] = tuple(o.lm_head.weight.shape)

    tok, n = "tokenizer.", m.nrd
    for i, layer in enumerate(n.encoder):
        lp = f"{tok}decoder.layer.{i}."
        if fused_nrd:
            for name, mod in (("in_proj", layer.qkv), ("out_proj", layer.attn_out),
                              ("linear1", layer.fc1), ("linear2", layer.fc2)):
                shapes[f"{lp}{name}_weight"] = tuple(mod.weight.shape)
                shapes[f"{lp}{name}_bias"] = tuple(mod.bias.shape)
            for name, mod in (("norm1", layer.ln_attn), ("norm2", layer.ln_ffn)):
                shapes[f"{lp}{name}_weight"] = shapes[f"{lp}{name}_bias"] = tuple(mod.weight.shape)
        else:
            nh = cfg.nrd.hidden_size
            for name in ("query", "key", "value"):
                shapes[f"{lp}attention.self.{name}.weight"] = (nh, nh)
                shapes[f"{lp}attention.self.{name}.bias"] = (nh,)
            lin(lp + "attention.output.dense", layer.attn_out)
            norm(lp + "attention.output.LayerNorm", layer.ln_attn)
            lin(lp + "intermediate.dense", layer.fc1)
            lin(lp + "output.dense", layer.fc2)
            norm(lp + "output.LayerNorm", layer.ln_ffn)
    shapes[tok + "pos_embedding.weight"] = tuple(n.pos_embedding.shape)
    norm(tok + "layernorm", n.layernorm)
    norm(tok + "point_layernorm", n.point_layernorm)
    shapes[tok + "point_pe.weight"] = tuple(n.point_pe.shape)
    lin(tok + "cond_proj", n.cond_proj)
    lin(tok + "cond_head_proj", n.cond_head_proj)
    lin(tok + "project_down_codebook", n.project_down_codebook)
    lin(tok + "to_coor_logits.0", n.to_coor_logits)
    lin("cond_head_proj", m.cond_head_proj)
    lin("cond_proj", m.cond_proj)
    return shapes


def read_reference_checkpoint(path: str, cfg: MeshAnythingConfig) -> Tuple[dict, list]:
    """The reference checkpoint (safetensors) -> (JAX's parameter tree in
    numpy, the sorted keys the walk did not read)."""
    return convert_state_dict(load_safetensors(path), cfg)


def load_reference_checkpoint(path: str, cfg: MeshAnythingConfig, *, device=None,
                              dtype: Optional[torch.dtype] = None) -> MeshAnything:
    """``MeshAnything_350m.pth`` (safetensors despite the name) -> the
    port's model on ``device``, its floats cast to ``dtype`` (default:
    the file's, widened). The keys the walk does not read are ignored, as
    JAX ignores them, and named once on stderr."""
    tree, unread = read_reference_checkpoint(path, cfg)
    if unread:
        print(f"[checkpoint] {len(unread)} keys of {path} not read (ignored, as the JAX "
              f"converter ignores them): {unread}", file=sys.stderr, flush=True)
    return params_from_jax_numpy(tree, cfg, device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# the port's own checkpoints

NATIVE_FILE = "params.pt"


def save_native(model: MeshAnything, path: str, mesh=None) -> str:
    """Save the model's parameters by name (one ``torch.save`` of a dict,
    written atomically) into the directory ``path``; returns the file.
    With ``mesh`` (``parallel/mesh.py``; every rank calls) ``model`` is
    the rank's local module: the full tensors are gathered over the model
    group and rank 0 writes them."""
    out = os.path.join(path, NATIVE_FILE)
    params = {name: p.detach() for name, p in model.named_parameters()}
    if mesh is not None:
        params = gather_tensors(mesh, params)
    if mesh is None or mesh.rank == 0:
        os.makedirs(path, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        torch.save({name: p.cpu() for name, p in params.items()}, tmp)
        os.replace(tmp, out)
    if mesh is not None and dist.is_initialized():
        dist.barrier()          # the file is whole before any rank reads it
    return out


@torch.no_grad()
def load_native(path: str, cfg: MeshAnythingConfig, *, device=None,
                dtype: Optional[torch.dtype] = None, mesh=None) -> MeshAnything:
    """A checkpoint of ``save_native`` (the directory ``path``) -> the
    model on ``device`` in ``dtype`` (default: the saved one). Every
    parameter is matched by name, never by order; a name missing on
    either side, or a shape that differs, raises ``ValueError``. With
    ``mesh`` the rank's local module (``shard_params``) of the full one."""
    if mesh is not None:
        return shard_params(mesh, load_native(path, cfg, device=device, dtype=dtype))
    saved = torch.load(os.path.join(path, NATIVE_FILE), map_location="cpu", weights_only=True)
    if dtype is None:
        dtype = next(iter(saved.values())).dtype
    model = MeshAnything(cfg, device=device or "cpu", dtype=dtype)
    named = dict(model.named_parameters())
    if set(saved) != set(named):
        raise ValueError(f"{path}: parameters missing {sorted(set(named) - set(saved))}, "
                         f"unknown {sorted(set(saved) - set(named))}")
    for name, param in named.items():
        if tuple(saved[name].shape) != tuple(param.shape):
            raise ValueError(f"{path}: {name} has shape {tuple(saved[name].shape)}, the "
                             f"model's is {tuple(param.shape)}")
        param.copy_(saved[name])
    return model
