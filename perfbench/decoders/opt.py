"""The OPT decoder family: MeshAnything's shape decoder (OPT-350M's post-LN
blocks with MeshAnything's vocabulary and condition), as the benchmark
knows it. A configuration names it with ``"decoder": "opt"``; its sizes
are the configuration's ``model["opt"]``.

Everything of the benchmark that depends on the decoder's architecture is
here, under the names every family module gives (``perfbench/README.md``,
"Adding a decoder family"):

  program(model, device)      the port's configuration and model, on device
  interface(model)            the numbers and names the shared parts read
  param_spec(model)           the decoder's parameters, in draw order
  decoder_logits(...)         the plain reference, teacher-forced
  read_cache(state, row, n)   the program's cache rows, as stored
  decode_work / slice_work    bytes and FLOPs, for ``counts.py``

The reference here keeps ``reference/model.py``'s rule: float32 PyTorch,
nothing imported from the program under test. Only ``program`` imports the
port, when it is called.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

from perfbench.counts import BF16, Work, cache_rows_read
from perfbench.reference.model import Params, Spec, attend, heads, linear, ln


def program(model: dict, device):
    """(the port's ``MeshAnythingConfig``, its ``MeshAnything`` on ``device``
    in the configuration's dtype, parameters uninitialised)."""
    from meshanything_tpu_torch import config as pc
    from meshanything_tpu_torch.models.meshanything import MeshAnything

    top = {k: v for k, v in model.items() if k not in ("perceiver", "opt", "nrd")}
    cfg = pc.MeshAnythingConfig(perceiver=pc.PerceiverConfig(**model["perceiver"]),
                                opt=pc.ShapeOPTConfig(**model["opt"]),
                                nrd=pc.NRDConfig(**model["nrd"]), **top)
    net = MeshAnything(cfg, device="meta", dtype=cfg.activation_dtype).to_empty(device=device)
    return cfg, net


def interface(model: dict) -> dict:
    """What the shared parts read of the decoder: the end-of-sequence id and
    the parameter whose row of it the weights zero (``eos_row``), the
    condition's length, the vocabulary, the codebook the detokenizer sums
    rows of, and the widths the condition is projected from and into."""
    o = model["opt"]
    return {"eos": o["eos_token_id"], "eos_row": "opt.lm_head.weight",
            "cond_length": o["cond_length"], "vocab_size": o["vocab_size"],
            "codebook": "opt.codebook", "cond_dim": o["cond_dim"],
            "hidden_size": o["hidden_size"]}


def param_spec(model: dict) -> list:
    """The decoder's (name, shape, kind, std) entries, in draw order."""
    o = model["opt"]
    spec = Spec()
    d = o["hidden_size"]
    spec.table("opt.extra_embeds", (3, d))
    spec.linear("opt.input_layer", o["codebook_dim"], d, 0.02)
    spec.table("opt.embed_positions", (o["max_positions"] + o["pos_offset"], d))
    spec.table("opt.face_positions", (o["face_per_token"] + 3, d))
    spec.table("opt.cond_embed", (2, d))
    spec.table("opt.codebook", (o["codebook_size"], o["codebook_dim"]))
    for i in range(o["num_layers"]):
        q = f"opt.layers.{i}"
        spec.linear(f"{q}.qkv", d, 3 * d, 0.02)
        spec.linear(f"{q}.out", d, d, 0.02)
        spec.norm(f"{q}.ln_attn", d)
        spec.linear(f"{q}.fc1", d, o["ffn_dim"], 0.02)
        spec.linear(f"{q}.fc2", o["ffn_dim"], d, 0.02)
        spec.norm(f"{q}.ln_ffn", d)
    spec.linear("opt.lm_head", d, o["vocab_size"], 0.02, bias=False)
    return list(spec)


# ---------------------------------------------------------------------------
# the plain reference, teacher-forced


def decoder_logits(W: Params, model: dict, cond: torch.Tensor, tokens: torch.Tensor,
                   cache_probe: Optional[Callable[[int, List[tuple]], None]] = None
                   ) -> torch.Tensor:
    """Logits (T, vocab) that predict each of the T served tokens: the
    prefill's last position for tokens[0], then each decode position over
    [condition || tokens[:T-1]]: post-LN blocks, ReLU MLP, the hybrid token
    embedding (3 special rows, else the codebook row through
    ``input_layer``), the face-phase embedding, learned positions with
    OPT's offset of 2. ``cache_probe(layer, [(k, v)])``, where given,
    receives each layer's key and value rows (C + T - 1, hidden), the rows
    a decode cache holds once the last token is chosen, as the one group
    of ``read_cache``."""
    o = model["opt"]
    c, t = cond.shape[0], tokens.shape[0]
    d, h, eps = o["hidden_size"], o["num_heads"], o["ln_eps"]
    fed = tokens[:t - 1]
    gen = torch.arange(t - 1, device=tokens.device)
    code = W["opt.codebook"][(fed - 3).clamp(0, o["codebook_size"] - 1)]
    tok = torch.where((fed < 3)[:, None], W["opt.extra_embeds"][fed.clamp(0, 2)],
                      linear(code, W, "opt.input_layer"))
    phase = torch.where(fed < 3, fed, (gen - 1) % o["face_per_token"] + 3)
    tok = tok + W["opt.face_positions"][phase] + W["opt.cond_embed"][1]
    x = torch.cat([cond + W["opt.cond_embed"][0], tok])
    n = x.shape[0]
    x = x + W["opt.embed_positions"][o["pos_offset"]:o["pos_offset"] + n]
    scale = 1.0 / math.sqrt(d // h)
    for i in range(o["num_layers"]):
        q_ = f"opt.layers.{i}"
        q, k, v = linear(x, W, f"{q_}.qkv").chunk(3, dim=-1)
        if cache_probe is not None:
            cache_probe(i, [(k, v)])
        att = attend(heads(q, h), heads(k, h), heads(v, h), scale, causal_offset=0)
        x = ln(x + linear(att.flatten(1), W, f"{q_}.out"), W, f"{q_}.ln_attn", eps)
        x = ln(x + linear(F.relu(linear(x, W, f"{q_}.fc1")), W, f"{q_}.fc2"), W,
               f"{q_}.ln_ffn", eps)
    return linear(x[c - 1:], W, "opt.lm_head")


# ---------------------------------------------------------------------------
# the program's cache


def read_cache(state, row: int, n: int) -> list:
    """Positions [0, n) of batch row ``row`` of the state's KV cache, as
    stored, copied to the host a layer at a time: one group, {"values":
    (2, L, n, hidden) K and V, "scales": (2, L, n) float32 for a quantized
    cache, else None}."""
    kv = state.kv
    values, scales = (kv, None) if isinstance(kv, torch.Tensor) else kv
    if values.dtype not in (torch.bfloat16, torch.float32, torch.int8):
        raise ValueError(f"a cache of {values.dtype} is not read back here")
    out = values.new_empty((2, values.shape[1], n, values.shape[-1]), device="cpu")
    for layer in range(values.shape[1]):
        out[:, layer] = values[:, layer, row, :n].cpu()
    return [{"values": out,
             "scales": None if scales is None else scales[:, :, row, 0, :n].cpu()}]


# ---------------------------------------------------------------------------
# counts: the bf16 weights and KV cache, one token a step


def _layer_shapes(o: dict) -> list:
    """(in, out) of the four matrices of a decoder layer."""
    d, f = o["hidden_size"], o["ffn_dim"]
    return [(d, 3 * d), (d, d), (d, f), (f, d)]


def gemm_work(o: dict, rows: int) -> Work:
    """The dense-matrix products of one decode step over ``rows`` token
    rows: the four layer matrices of every layer with their biases, the
    codebook projection ``input_layer`` and ``lm_head``, each weight read
    once and each activation row read and written once."""
    d, v, cb = o["hidden_size"], o["vocab_size"], o["codebook_dim"]
    work = Work()
    for i, j in _layer_shapes(o):
        work += Work(i * j * BF16 + j * BF16 + rows * (i + j) * BF16,
                     2 * rows * i * j) * o["num_layers"]
    for i, j, bias in ((cb, d, True), (d, v, False)):
        work += Work(i * j * BF16 + (j * BF16 if bias else 0) + rows * (i + j) * BF16,
                     2 * rows * i * j)
    return work


def step_weight_bytes(o: dict) -> float:
    """Bytes of the weights a step reads through its dense-matrix
    products."""
    return gemm_work(o, 0).bytes


def attention_call(o: dict, batch: int, rows: float) -> Work:
    """One attention kernel call of one layer: ``batch`` sequences, each
    reading ``rows`` cache rows of K and V and one bf16 query row, and
    writing one bf16 output row."""
    hd = o["hidden_size"]
    return Work(batch * (2 * rows * hd * BF16 + 2 * hd * BF16), batch * 4 * rows * hd)


def prefill_work(o: dict, batch: int, c: int) -> Work:
    """The causal pass over the c condition positions: every weight once,
    the matrices' FLOPs for c rows, causal attention, the cache rows
    written, and the last position's lm_head."""
    hd, v, L = o["hidden_size"], o["vocab_size"], o["num_layers"]
    mats = Work()
    for i, j in _layer_shapes(o):
        mats += Work(i * j * BF16 + batch * c * (i + j) * BF16, 2 * batch * c * i * j)
    attn = Work(0, L * batch * 2 * c * (c + 1) * hd)
    written = L * batch * 2 * c * hd * BF16
    return mats * L + attn + Work(written + hd * v * BF16, 2 * batch * hd * v)


def decode_work(model: dict, batch: int, steps: int) -> Work:
    """The whole decode of one request as the runner's fenced ``decode_s``
    covers it: the prefill, then ``steps`` single-token steps."""
    o = model["opt"]
    c, L, hd = o["cond_length"], o["num_layers"], o["hidden_size"]
    mean_rows = cache_rows_read(c, 1, steps) / steps
    per = gemm_work(o, batch) + attention_call(o, batch, mean_rows) * L
    per += Work(L * batch * 2 * hd * BF16)                        # the row written
    return prefill_work(o, batch, c) + per * steps


def slice_work(model: dict, batch: int, sl) -> dict:
    """{"attention": Work, "gemm": Work} of the steps of a traced slice
    (``devtrace.Slice``), steps pos0 .. pos1 - 1 from the positions read
    at its edges. The parts are the configuration's ``kernels`` groups."""
    o = model["opt"]
    c, L = o["cond_length"], o["num_layers"]
    s0, s1 = sl.pos0[0], sl.pos1[0]
    n = s1 - s0
    rows = cache_rows_read(c, s0, s1 - 1) / max(n, 1)
    return {"attention": attention_call(o, batch, rows) * (L * n),
            "gemm": gemm_work(o, batch) * n}
