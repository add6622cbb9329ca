"""The device-memory budget of a generation batch (the port of
``estimate_kv_bytes``, ``param_tree_bytes`` and ``check_memory_budget`` of
``meshanything_tpu/runtime/phases.py``).

The estimate is an upper bound of what a generation allocates on the
card: the weights, one KV cache, the prefill's and the decode loop's
transients, and what a tier adds (scales, packed layers, int8 matrices).
``InferencePipeline`` holds it against the card's own memory before it
allocates, so that a batch that cannot fit is refused with the flags that
would make it fit instead of failing in the middle of a run.
``tools/memory_probe.py`` measures each phase's peak on the card beside
the estimate; the constants below come from its readings.
"""
from __future__ import annotations

from typing import Optional

import torch

from meshanything_tpu_torch.config import MeshAnythingConfig

# Kept free of the card's total memory: the CUDA context and the kernels'
# code, cuBLAS workspaces, and the caching allocator's fragmentation.
HEADROOM_BYTES = 4 * 2 ** 30
# Transient bytes per element of the prefill's compact (2, L, B, C, hidden)
# K/V tensor while a quantized tier turns it into codes (f32 copies,
# scales, rounded values; int4 also the unpacked planes): the memory probe
# read 14.0 (int8, B 1 and 16) and 22.0 (int4, B 16) on an H100; the rest
# is margin for what the prefill allocates besides.
QUANTIZE_BYTES_PER_ELEMENT = {"pallas_int8": 18, "pallas_int4": 28}


def estimate_kv_bytes(cfg: MeshAnythingConfig, batch: int, bucket: int = 512,
                      int8: bool = False, extra_tokens: int = 0,
                      int4: bool = False) -> int:
    """Upper bound of the KV cache's values for a generation batch, at
    two bytes an element (bf16), one (int8) or half a byte (int4).

    extra_tokens: lookahead windows extend the cache by W slots. The
    quantized tiers' f32 row scales are not in it (``check_memory_budget``
    adds them)."""
    c = cfg.cond_length
    s_max = -(-(c + cfg.generate_length + extra_tokens) // bucket) * bucket
    o = cfg.opt
    elems = 2 * o.num_layers * batch * s_max * o.hidden_size
    if int4:
        return elems // 2
    return elems * (1 if int8 else 2)


def param_tree_bytes(model: torch.nn.Module) -> int:
    """Bytes of a module tree's parameters and buffers as they lie on
    their device."""
    tensors = list(model.parameters()) + list(model.buffers())
    return sum(t.numel() * t.element_size() for t in tensors)


def device_limit_bytes(device: torch.device) -> int:
    """The card's total memory less ``HEADROOM_BYTES``."""
    return torch.cuda.get_device_properties(device).total_memory - HEADROOM_BYTES


def check_memory_budget(cfg: MeshAnythingConfig, batch: int, bucket: int = 512,
                        attn: str = "auto", limit_bytes: Optional[int] = None,
                        param_bytes: Optional[int] = None, extra_tokens: int = 0, *,
                        wq: bool = False, device: Optional[torch.device] = None) -> int:
    """Estimate the device footprint of generating ``batch`` meshes and
    raise ValueError where it exceeds ``limit_bytes``; returns the
    estimate.

    The peak is either the decode (the weights, ONE cache, which the
    prefill writes in place, the prefill's compact K/V rows, what the
    tier adds, and the loop's transients) or encode/detok (the weights
    plus batch-scaled hidden states and the f32 score matrices of the
    dense attentions over the point cloud and over the face tokens; the
    pipeline drops the cache before detok). What a tier adds: the f32 row
    scales of the int8/int4 caches and their quantization transients;
    the packed bf16 layers of ``attn="megakernel"`` (and, from an f32
    model, the f32 stack they are cast from); the int8 layer matrices of
    ``wq``. The cache's elements take the activation dtype's size.

    param_bytes: the weights as they lie on the card
    (``param_tree_bytes(model)``). limit_bytes: default ``device``'s
    memory less ``HEADROOM_BYTES``."""
    if param_bytes is None:
        raise ValueError("check_memory_budget needs param_bytes (param_tree_bytes(model))")
    if limit_bytes is None:
        if device is None:
            raise ValueError("check_memory_budget needs limit_bytes or a device")
        limit_bytes = device_limit_bytes(device)
    o = cfg.opt
    int8, int4 = attn == "pallas_int8", attn == "pallas_int4"
    kv = estimate_kv_bytes(cfg, batch, bucket, int8, extra_tokens, int4=int4)
    itemsize = torch.empty((), dtype=cfg.activation_dtype).element_size()
    compact = 2 * o.num_layers * batch * cfg.cond_length * o.hidden_size   # elements
    if int8 or int4:
        rows = kv * (2 if int4 else 1) // o.hidden_size       # (plane, layer, row) triples
        kv += 4 * rows
        prefill = compact * QUANTIZE_BYTES_PER_ELEMENT[attn]
    else:
        kv = kv * itemsize // 2
        prefill = compact * itemsize
    tier = 0
    matrices = o.num_layers * (4 * o.hidden_size ** 2 + 2 * o.hidden_size * o.ffn_dim)
    if attn == "megakernel":
        vectors = o.num_layers * (9 * o.hidden_size + o.ffn_dim)
        tier += matrices * 2 + vectors * 4 + (matrices * itemsize if itemsize != 2 else 0)
    if wq:
        tier += matrices + 4 * o.num_layers * (6 * o.hidden_size + o.ffn_dim)
    p, n = cfg.perceiver, cfg.nrd
    ntok = n.cond_length + cfg.n_max_triangles
    # A row of encode or detok: hidden states of the point cloud and of the
    # face tokens (a few live copies: 16 bytes an element), and the f32
    # logits and probabilities of the dense attentions over them (8 bytes
    # an element, counted as if every layer's were live at once). The
    # memory probe read 152-155 MB a row at B=16 on an H100 where this
    # gives 272 MB: an upper bound, under the decode's peak at every batch.
    act_row = 16 * (p.num_points * p.width + ntok * n.hidden_size)
    act_row += 8 * (p.heads * p.total_latents * p.num_points + n.num_heads * ntok * ntok)
    overhead = min(int(0.5e9), max(param_bytes, 1) * 2)  # scaled down for test configs
    est = param_bytes + max(kv + prefill + tier + overhead, batch * act_row)
    if est > limit_bytes:
        raise ValueError(
            f"estimated device footprint {est / 1e9:.1f} GB exceeds the "
            f"{limit_bytes / 1e9:.1f} GB budget for batch={batch} "
            f"(kv cache {kv / 1e9:.1f} GB, attn={attn!r}). Reduce --batchsize_per_gpu or "
            "--n_max_triangles, or use --attn pallas_int8/pallas_int4 (smaller cache).")
    return est
