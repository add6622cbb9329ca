"""K5: one whole decode step over all layers in one launch
(``attn="megakernel"``), with its plain PyTorch version beside it.

It ports the TPU kernel ``meshanything_tpu/ops/megakernel.py::_megakernel``
(``csrc/megakernel.cu``: a persistent cooperative CUDA kernel). For a CUDA
tensor ``decode_step_megakernel`` launches it (counted in
``decode_step_megakernel.launches``) or raises; for a CPU tensor it
computes the same function with ``decode_step_megakernel_reference``.
There is no other route between the two.

Numerics (the TPU kernel's contract, not the per-layer step's):

  * weights are bf16 even in an f32 model; each product takes bf16
    operands and accumulates in f32;
  * the residual stream stays f32 across all layers and is cast to x's
    dtype only at the end; biases and LayerNorm affines are f32, and
    LN(x) = (x - mean) * rsqrt(var + eps) * scale + bias;
  * q is the f32 qkv output plus its bias times 1/sqrt(head_dim), before
    the dot; the new K/V rows are cast to the cache dtype, written at
    ``write_pos``, and read back from the cache by the sweep over rows
    [0, cur_len); o = acc / max(l, 1e-30) and h1 = ReLU(fc1 + b), both f32,
    are cast to bf16 for the next product.

The cache (2, L, B, S, D) is updated in place.

The launch (one block an SM, ``resident_blocks``) lays its shared memory
out by ``smem_plan``; its attention cuts the live rows into splits of
whole ring tiles (``split_plan``, ``tile_rows``) and folds them inside the
launch through the ticket counters and partials of the stream's
``FoldWorkspace`` (``ops/decode_attention.py``), the one K1 and the bf16 K4
use: calls of one stream run in order, so they share it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Sequence

import torch

from meshanything_tpu_torch.ops import _build
from meshanything_tpu_torch.ops.decode_attention import _stream_ptr, fold_group, fold_workspace

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (8, 64)      # taken by csrc/megakernel.cu
_GROUPS = (1, 2, 16)      # batch rows a GEMV pass serves (the kernel's instances)
_WARPS = 16               # warps per block (kWarps): attention takes one a head
_MAX_HIDDEN = 1024        # the layer norm holds a row in registers (kMaxWidth)
_MAX_SMEM = 232448        # shared memory a block may opt in to (row_stream::kMaxSmem)
_STATIC_SMEM = 2 * _MAX_HIDDEN * 4 + 256   # the kernel's static shared memory (kStaticSmem)
_MAX_DEPTH = 4            # slots of the attention ring at most (row_stream::kMaxDepth)
_ROW_PAD = 16             # bytes after each staged weight or activation row (kPad)
_TASK_BYTES = 16 * 16 * 4  # one tensor-core task's partial sums (kTaskFloats f32)


@dataclasses.dataclass
class MegakernelLayers:
    """The decode stack packed for K5: bf16 matrices (L, out, in) in the
    ``nn.Linear`` layout, so each output row is contiguous, and f32 biases
    and LayerNorm vectors (L, width)."""
    qkv_w: torch.Tensor       # (L, 3D, D)
    out_w: torch.Tensor       # (L, D, D)
    fc1_w: torch.Tensor       # (L, F, D)
    fc2_w: torch.Tensor       # (L, D, F)
    qkv_b: torch.Tensor       # (L, 3D)
    out_b: torch.Tensor       # (L, D)
    fc1_b: torch.Tensor       # (L, F)
    fc2_b: torch.Tensor       # (L, D)
    ln_attn_w: torch.Tensor   # (L, D)
    ln_attn_b: torch.Tensor
    ln_ffn_w: torch.Tensor
    ln_ffn_b: torch.Tensor

    @property
    def shape(self) -> tuple[int, int, int]:
        """(layers, hidden, ffn)."""
        n_layers, f, d = self.fc1_w.shape
        return n_layers, d, f

    def tensors(self) -> list[torch.Tensor]:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]


@torch.no_grad()
def pack_megakernel_layers(layers: Sequence) -> MegakernelLayers:
    """Stack the layers (``shape_opt.OPTLayer``: qkv/out/fc1/fc2 linears,
    ln_attn/ln_ffn layer norms) for K5. Built once per generation: at the
    350M width the bf16 matrices are 604 MB."""
    def mats(name):
        return torch.stack([getattr(m, name).weight for m in layers]).to(torch.bfloat16).contiguous()

    def vecs(name, attr):
        return torch.stack([getattr(getattr(m, name), attr) for m in layers]).float().contiguous()

    return MegakernelLayers(
        qkv_w=mats("qkv"), out_w=mats("out"), fc1_w=mats("fc1"), fc2_w=mats("fc2"),
        qkv_b=vecs("qkv", "bias"), out_b=vecs("out", "bias"), fc1_b=vecs("fc1", "bias"),
        fc2_b=vecs("fc2", "bias"), ln_attn_w=vecs("ln_attn", "weight"),
        ln_attn_b=vecs("ln_attn", "bias"), ln_ffn_w=vecs("ln_ffn", "weight"),
        ln_ffn_b=vecs("ln_ffn", "bias"))


def _check(x: torch.Tensor, packed: MegakernelLayers, kv_cache: torch.Tensor, write_pos: int,
           cur_len: int, num_heads: int) -> None:
    if x.dim() != 2 or kv_cache.dim() != 5:
        raise ValueError(f"expected x (B, D) and kv_cache (2, L, B, S, D); got "
                         f"{tuple(x.shape)} and {tuple(kv_cache.shape)}")
    b, d = x.shape
    n_layers, pd, f = packed.shape
    two, kl, kb, s, kd = kv_cache.shape
    if two != 2 or (kl, kb, kd) != (n_layers, b, d) or pd != d:
        raise ValueError(f"kv_cache {tuple(kv_cache.shape)} and layers (L={n_layers}, D={pd}) "
                         f"do not match x {tuple(x.shape)}")
    expected = {"qkv_w": (n_layers, 3 * d, d), "out_w": (n_layers, d, d),
                "fc1_w": (n_layers, f, d), "fc2_w": (n_layers, d, f),
                "qkv_b": (n_layers, 3 * d), "out_b": (n_layers, d), "fc1_b": (n_layers, f),
                "fc2_b": (n_layers, d), "ln_attn_w": (n_layers, d), "ln_attn_b": (n_layers, d),
                "ln_ffn_w": (n_layers, d), "ln_ffn_b": (n_layers, d)}
    for name, shape in expected.items():
        t = getattr(packed, name)
        want = torch.bfloat16 if name.endswith("_w") and not name.startswith("ln") else torch.float32
        if tuple(t.shape) != shape or t.dtype != want:
            raise ValueError(f"packed {name} {tuple(t.shape)} {t.dtype}: expected {shape} {want}")
    if x.dtype not in _DTYPE_CODES or kv_cache.dtype not in _DTYPE_CODES:
        raise TypeError(f"x and kv_cache must be float32 or bfloat16; got {x.dtype} and "
                        f"{kv_cache.dtype}")
    tensors = [x, kv_cache, *packed.tensors()]
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, kv_cache and the packed layers must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x, kv_cache and the packed layers must be contiguous")
    if num_heads < 1 or d % num_heads:
        raise ValueError(f"hidden size {d} is not a multiple of num_heads {num_heads}")
    if not 0 <= write_pos < s:
        raise ValueError(f"write_pos {write_pos} outside [0, {s})")
    if not 1 <= cur_len <= s:
        raise ValueError(f"cur_len {cur_len} outside [1, {s}]")


def _bf16_dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (B, K) f32 . w (N, K) bf16 -> (B, N) f32: bf16 operands (their
    products are exact in f32), f32 accumulation."""
    return a.to(torch.bfloat16).float() @ w.float().T


def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def decode_step_megakernel_reference(x: torch.Tensor, packed: MegakernelLayers,
                                     kv_cache: torch.Tensor, write_pos: int, cur_len: int, *,
                                     num_heads: int, ln_eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of K5, layer by layer, with K5's numerics (see
    the module docstring). Only rows [0, cur_len) of the cache are read."""
    b, d = x.shape
    hd = d // num_heads
    h = x.float()
    for i in range(packed.shape[0]):
        q, k_new, v_new = (_bf16_dot(h, packed.qkv_w[i]) + packed.qkv_b[i]).split(d, dim=-1)
        kv_cache[0, i, :, write_pos] = k_new.to(kv_cache.dtype)
        kv_cache[1, i, :, write_pos] = v_new.to(kv_cache.dtype)
        k = kv_cache[0, i, :, :cur_len].float().reshape(b, cur_len, num_heads, hd)
        v = kv_cache[1, i, :, :cur_len].float().reshape(b, cur_len, num_heads, hd)
        logits = torch.einsum("bhd,bshd->bhs", (q * (1.0 / math.sqrt(hd))).reshape(b, num_heads, hd), k)
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        o = torch.einsum("bhs,bshd->bhd", p, v) / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        h = _layer_norm(h + (_bf16_dot(o.reshape(b, d), packed.out_w[i]) + packed.out_b[i]),
                        packed.ln_attn_w[i], packed.ln_attn_b[i], ln_eps)
        h1 = torch.relu(_bf16_dot(h, packed.fc1_w[i]) + packed.fc1_b[i])
        h = _layer_norm(h + (_bf16_dot(h1, packed.fc2_w[i]) + packed.fc2_b[i]),
                        packed.ln_ffn_w[i], packed.ln_ffn_b[i], ln_eps)
    return h.to(x.dtype)


def _kernel():
    lib = _build.load("megakernel")
    if lib.lib.mt_megakernel.argtypes is None:
        fn = lib.lib.mt_megakernel
        fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 2 + [ctypes.c_int64] * 13
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.lib.mt_megakernel_blocks
        fn.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        lib.lib.mt_megakernel_error_string.argtypes = [ctypes.c_int]
        lib.lib.mt_megakernel_error_string.restype = ctypes.c_char_p
    return lib.lib


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"decode_step_megakernel: {what} failed: "
                           f"{lib.mt_megakernel_error_string(err).decode()} (cudaError {err})")


def row_group(batch: int) -> int:
    """Batch rows a GEMV pass serves: 1 for B=1, 2 for B=2, else 16 (groups
    of 16 cover B, the last one partly filled)."""
    return next(g for g in _GROUPS if g >= min(batch, _GROUPS[-1]))


def tile_rows(cache_dtype: torch.dtype) -> int:
    """Cache rows a tile of K5's attention ring: 16 bytes of rows a lane
    (8 bf16 or 4 f32 rows)."""
    return 16 // torch.empty((), dtype=cache_dtype).element_size()


@dataclasses.dataclass(frozen=True)
class SmemPlan:
    """K5's shared memory a block, as ``csrc/megakernel.cu::make_layout``
    lays it out: two weight buffers (a block's share of the largest
    matrix, rows padded), the staged activations, the tensor-core tasks'
    partial sums, and the attention ring over buffer 0 and what follows."""
    weight_buffer: int        # bytes of one buffer
    activations: int          # bytes of the staged GEMV input
    partial_sums: int
    ring_depth: int           # slots of the attention ring
    ring_slot: int            # bytes of a slot: K and V of one tile
    total: int                # the launch's dynamic shared memory


def smem_plan(group: int, hidden: int, ffn: int, blocks: int) -> SmemPlan:
    """The shared-memory plan of a K5 launch over ``blocks`` blocks with
    row groups of ``group``; raises where it does not fit a block's 227 KB.

    A block owns ceil(N / blocks) or fewer output rows of each matrix
    (L, N, K), K * 2 + 16 bytes a row; groups of 16 stage their input D
    columns at a time, the others the whole K; a ring slot is the K and V
    rows of one tile, 32 * D bytes in either cache dtype."""
    mats = ((3 * hidden, hidden), (hidden, hidden), (ffn, hidden), (hidden, ffn))
    rows = [-(-n // blocks) for n, _ in mats]
    weight = max(r * (k * 2 + _ROW_PAD) for r, (_, k) in zip(rows, mats))
    weight = -(-weight // 128) * 128
    kc = hidden if group == _GROUPS[-1] else max(hidden, ffn)
    act = -(-group * (kc * 2 + _ROW_PAD) // 128) * 128
    red = _WARPS * _TASK_BYTES if group == _GROUPS[-1] else 0
    slot = 32 * hidden
    budget = _MAX_SMEM - _STATIC_SMEM
    depth = min(_MAX_DEPTH, (budget - weight) // slot)
    total = max(2 * weight + act + red, weight + depth * slot)
    if depth < 2 or total > budget or (group == _GROUPS[-1] and max(rows) > 16 * _WARPS):
        raise ValueError(f"decode_step_megakernel: hidden {hidden}, ffn {ffn} over {blocks} "
                         f"blocks does not fit a block's shared memory")
    return SmemPlan(weight, act, red, depth, slot, total)


_resident: dict = {}


def resident_blocks(device: torch.device, cache_dtype: torch.dtype, group: int,
                    hidden: int, ffn: int) -> tuple[int, SmemPlan]:
    """The cooperative launch's grid, one block an SM, and its shared
    memory plan; raises if a block of that size does not fit an SM."""
    key = (device.index, cache_dtype, group, hidden, ffn)
    if key not in _resident:
        lib = _kernel()
        blocks = torch.cuda.get_device_properties(device).multi_processor_count
        plan = smem_plan(group, hidden, ffn, blocks)
        fit = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = lib.mt_megakernel_blocks(_DTYPE_CODES[cache_dtype], group, plan.total,
                                           ctypes.byref(fit))
        _raise_on(lib, err, "the occupancy query")
        if fit.value < blocks:
            raise RuntimeError(f"decode_step_megakernel: {fit.value} blocks with {plan.total} "
                               f"bytes of shared memory fit at once, not one an SM ({blocks})")
        _resident[key] = (blocks, plan)
    return _resident[key]


def split_plan(batch: int, cur_len: int, blocks: int, tile: int) -> tuple[int, int]:
    """(nsplit, group) of the attention phase: about one (b, split) task a
    block over ``batch * nsplit``, at most one split a tile so that no split
    is empty (K1's ``split_bounds`` cuts them), folded in groups of
    ``group`` splits (K1's ``fold_group``)."""
    nsplit = max(1, min(-(-cur_len // tile), blocks // batch))
    return nsplit, fold_group(nsplit)


def scratch_floats(batch: int, hidden: int, ffn: int) -> int:
    """f32 words of one launch's scratch: xs, q, y (B*D f32 each), then the
    bf16 inputs of the out projection (B*D) and of fc2 (B*F)."""
    return batch * (3 * hidden + hidden // 2 + ffn // 2)


def decode_step_megakernel(x: torch.Tensor, packed: MegakernelLayers, kv_cache: torch.Tensor,
                           write_pos: int, cur_len: int, *, num_heads: int,
                           ln_eps: float = 1e-5) -> torch.Tensor:
    """One decode step through every layer: x (B, D) is the embedded
    token, ``kv_cache`` (2, L, B, S, D) gets each layer's new K/V row at
    ``write_pos`` in place, attention sees rows [0, cur_len). Returns the
    last layer's output (B, D) in x's dtype.

    CUDA tensors go to K5 (counted in ``decode_step_megakernel.launches``);
    CPU tensors to ``decode_step_megakernel_reference``."""
    write_pos, cur_len = int(write_pos), int(cur_len)
    _check(x, packed, kv_cache, write_pos, cur_len, num_heads)
    if x.device.type == "cpu":
        return decode_step_megakernel_reference(x, packed, kv_cache, write_pos, cur_len,
                                                num_heads=num_heads, ln_eps=ln_eps)
    if x.device.type != "cuda":
        raise ValueError(f"decode_step_megakernel runs on cpu or cuda tensors, not {x.device}")
    b, d = x.shape
    n_layers, _, f = packed.shape
    hd = d // num_heads
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not built; the kernel takes {_HEAD_DIMS}")
    group = row_group(b)
    if (d % 16 or f % 8 or d > _MAX_HIDDEN or num_heads > _WARPS
            or (group == _GROUPS[-1] and f % d)):
        raise ValueError(f"hidden {d}, ffn {f}, {num_heads} heads: the kernel takes hidden a "
                         f"multiple of 16 and <= {_MAX_HIDDEN}, ffn a multiple of 8 (of the "
                         f"hidden size for batches of 3 or more), at most {_WARPS} heads")
    if any(t.data_ptr() % 16 for t in (x, kv_cache, *packed.tensors())):
        raise ValueError("decode_step_megakernel: every tensor must be 16-byte aligned")
    lib = _kernel()
    blocks, plan = resident_blocks(x.device, kv_cache.dtype, group, d, f)
    nsplit, fold = split_plan(b, cur_len, blocks, tile_rows(kv_cache.dtype))
    s = kv_cache.shape[3]
    stream = _stream_ptr(x.device)
    o_part, ml_part, counters = fold_workspace(x.device, stream).pointers(
        b, nsplit, fold, num_heads, hd)
    out = torch.empty_like(x)
    scratch = torch.empty(scratch_floats(b, d, f), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.mt_megakernel(
            x.data_ptr(), out.data_ptr(), kv_cache.data_ptr(),
            *(t.data_ptr() for t in packed.tensors()), scratch.data_ptr(), o_part, ml_part,
            counters, _DTYPE_CODES[x.dtype], _DTYPE_CODES[kv_cache.dtype], b, n_layers, s, d, f,
            num_heads, write_pos, cur_len, nsplit, fold, group, blocks, plan.total, ln_eps,
            stream)
    _raise_on(lib, err, "the launch")
    decode_step_megakernel.launches += 1
    return out


decode_step_megakernel.launches = 0
