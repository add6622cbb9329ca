"""Phase-split generation (the port of ``meshanything_tpu/runtime/phases.py``):
``PhaseRunner``, encode | decode | detok on one model, and the
device-memory budget of a generation batch (``estimate_kv_bytes``,
``param_tree_bytes``, ``check_memory_budget``).

``PhaseRunner`` is the object that the pipeline (``runtime/pipeline.py``),
the micro-batcher (``runtime/batching.py``) and serving (``serving.py``)
share. Its decode is the single-token loop (``models/shape_opt.py``) or,
with ``lookahead`` (a window width, or "adaptive" for the 8/16 window
controller of ``models/lookahead.py``), the Jacobi window loop, from the
condition alone or from a prompt (mesh completion). On a card each
request's decode captures its CUDA graph (``runtime/decode_graph.py``)
and replays it. The runner runs one generation at a time: its ``lock``
serialises all device work of the callers' threads, because a CUDA call
from another thread during a capture would invalidate it, and every
graph of a card shares one capture stream and one fold workspace (on the
TPU, JAX runs one program at a time anyway). The JAX runner's
ahead-of-time store (``aot_dir``, ``precompile``) is not ported yet.

The budget's estimate is an upper bound of what a generation allocates on the
card: the weights, one KV cache, the prefill's and the decode loop's
transients, and what a tier adds (scales, packed layers, int8 matrices).
``InferencePipeline`` holds it against the card's own memory before it
allocates, so that a batch that cannot fit is refused with the flags that
would make it fit instead of failing in the middle of a run.
``tools/memory_probe.py`` measures each phase's peak on the card beside
the estimate; the constants below come from its readings.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
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
                        wq: bool = False, device: Optional[torch.device] = None,
                        prompt_tokens: int = 0) -> int:
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
    memory less ``HEADROOM_BYTES``. prompt_tokens: a completion prompt's
    length, whose rows the prefill's compact K/V holds beside the
    condition's."""
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
    compact = 2 * o.num_layers * batch * (cfg.cond_length + prompt_tokens) * o.hidden_size
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


ADAPTIVE_WINDOWS = (8, 16)     # the JAX runner's adaptive_windows
ADAPTIVE_CHECK_ITERS = 64


def _graph_stats(graphs) -> dict:
    """capture_s, graph_captures and graph_replays of a request's graphs."""
    graphs = list(graphs)
    return {"capture_s": sum(g.capture_s for g in graphs), "graph_captures": len(graphs),
            "graph_replays": sum(g.replayed for g in graphs)}


class PhaseRunner:
    """Encode | decode | detok on one model (see the module's text).

    ``run`` takes a padded batch on the device and returns a dict: the
    coords and raw tokens on the device, ``decode_steps``, the fenced
    seconds of each phase, the graphs' ``capture_s`` and counts, and the
    window loop's forwards and acceptance (``window_trace`` with the
    adaptive window, also kept in ``self.window_trace``). Calling the
    runner as JAX's is called returns a ``GenerateOutput`` on the CPU,
    its ``stats`` the rest of ``run``'s dict; the input may be numpy.
    """

    def __init__(self, model, cfg: MeshAnythingConfig, *, bucket: int = 512,
                 attn: str = "auto", lookahead: "int | str" = 0, wq: bool = False,
                 aot_dir: Optional[str] = None, graph: bool = True):
        from meshanything_tpu_torch.models import lookahead as la_mod
        from meshanything_tpu_torch.models import shape_opt as opt_mod

        if aot_dir is not None:
            raise NotImplementedError(
                "aot_dir: not ported yet to meshanything_tpu_torch (the ahead-of-time "
                "store and precompile belong to the warm-start slice)")
        if not (lookahead == "adaptive" or (isinstance(lookahead, int) and lookahead >= 0)):
            raise ValueError(f"lookahead must be a window width or 'adaptive', not {lookahead!r}")
        self.model = model
        self.cfg = cfg
        self.bucket = bucket
        self.attn = opt_mod.resolve_attn(attn)
        if lookahead:
            la_mod.check_attn(self.attn)
        opt_mod.check_wq(self.attn, wq)
        self.lookahead = lookahead
        self.wq = wq
        self.graph = graph
        self.device = next(model.parameters()).device
        self.param_bytes = param_tree_bytes(model)
        self.window_trace: list = []   # (iters, window, acceptance) per check, adaptive only
        self.lock = threading.Lock()

    def precompile(self, batch: int, *, sampling: bool = False) -> None:
        raise NotImplementedError(
            "precompile: not ported yet to meshanything_tpu_torch (each request captures "
            "its own decode graph)")

    def _decode_lookahead(self, cond: torch.Tensor, sampling: bool,
                          generator: Optional[torch.Generator],
                          prompt_ids: Optional[torch.Tensor]) -> dict:
        """The window loop: fixed width, or the adaptive controller over
        ADAPTIVE_WINDOWS on one state sized for the larger."""
        from meshanything_tpu_torch.models import lookahead as la_mod
        from meshanything_tpu_torch.ops.wquant import quantize_opt_layers

        cfg, m = self.cfg, self.model
        gl = cfg.generate_length
        adaptive = self.lookahead == "adaptive"
        small, big = ADAPTIVE_WINDOWS if adaptive else (self.lookahead,) * 2
        state = la_mod.init_lookahead_state(
            m.opt, cfg.opt, cond, max_new_tokens=gl, window=small, bucket=self.bucket,
            attn=self.attn, sampling=sampling, generator=generator, buf_window=big,
            prompt_ids=prompt_ids)
        wq_layers = quantize_opt_layers(m.opt.layers) if self.wq else None

        def segment(st, until=None, _window=None):
            return la_mod.lookahead_segment(m.opt, cfg.opt, st, max_new_tokens=gl,
                                            wq_layers=wq_layers, until_iters=until,
                                            sampling=sampling, graph=self.graph)

        trace = []
        if adaptive:
            state = la_mod.run_adaptive_controller(
                state, segment, windows=ADAPTIVE_WINDOWS, check_iters=ADAPTIVE_CHECK_ITERS,
                max_new_tokens=gl, trace=trace)
        else:
            state = segment(state)
        first = 1 + (0 if prompt_ids is None else prompt_ids.shape[1])   # the prefill's tokens
        steps = state.steps.clamp_max(gl)
        b = steps.shape[0]
        out = {"tokens": state.tokens[:, :gl], "decode_steps": int(steps.max()) - first,
               "window_forwards": state.iters,
               # tokens past the first, per row and window forward
               "mean_accept": float(steps.sum() - b * first) / max(state.iters * b, 1),
               **_graph_stats(state.graphs.values())}
        if adaptive:
            out["window_trace"] = trace
            self.window_trace = trace
        return out

    def run(self, pc_normal: torch.Tensor, *, sampling: bool = False,
            generator: Optional[torch.Generator] = None,
            prompt_ids: Optional[torch.Tensor] = None, timer=None) -> dict:
        """One padded batch (B, N, 6) on the device -> coords, raw tokens,
        decode steps and the seconds of each phase (fenced on the device);
        ``prompt_ids`` (B, P) continues a token prefix. On a card the batch
        is first held against the card's memory. ``timer``
        (``runtime/profiling.py::PhaseTimer``) is fed the three phases."""
        with self.lock:
            return self._generate(pc_normal, sampling, generator, prompt_ids, timer)

    def __call__(self, pc_normal, *, sampling: bool = False,
                 generator: Optional[torch.Generator] = None, prompt_ids=None, timer=None):
        """JAX's call: (B, N, 6) points and normals (numpy or a tensor) ->
        ``GenerateOutput`` with f32 coords and the raw tokens on the CPU
        and the rest of ``run``'s dict in ``stats``."""
        with self.lock:
            return self._call(pc_normal, sampling, generator, prompt_ids, timer)

    # Both run under ``lock``, and each one's frame, with the device tensors
    # it holds, is gone before the lock is released.
    def _call(self, pc_normal, sampling, generator, prompt_ids, timer):
        from meshanything_tpu_torch.models.meshanything import GenerateOutput

        if not isinstance(pc_normal, torch.Tensor):
            pc_normal = torch.from_numpy(np.asarray(pc_normal, np.float32))
        out = self._generate(pc_normal.to(self.device, torch.float32), sampling, generator,
                             prompt_ids, timer)
        coords = out.pop("coords").float().cpu()
        tokens = out.pop("tokens").cpu()
        return GenerateOutput(face_coords=coords, token_ids=tokens, stats=out)

    @torch.no_grad()
    def _generate(self, pc_normal, sampling, generator, prompt_ids, timer) -> dict:
        from meshanything_tpu_torch.models import meshanything as ma
        from meshanything_tpu_torch.models import shape_opt as opt_mod
        from meshanything_tpu_torch.runtime.profiling import fence

        cfg, m = self.cfg, self.model
        p_len = 0 if prompt_ids is None else prompt_ids.shape[1]
        if self.device.type == "cuda":
            window = ADAPTIVE_WINDOWS[1] if self.lookahead == "adaptive" else self.lookahead
            check_memory_budget(cfg, pc_normal.shape[0], self.bucket, self.attn,
                                param_bytes=self.param_bytes, extra_tokens=window, wq=self.wq,
                                device=self.device, prompt_tokens=p_len)
        if prompt_ids is not None:
            prompt_ids = torch.as_tensor(prompt_ids).to(self.device, torch.int64)
        times = {}

        def done(name: str, t0: float) -> None:
            fence(self.device)
            times[f"{name}_s"] = time.perf_counter() - t0
            if timer is not None:
                timer.record(name, times[f"{name}_s"])

        t0 = time.perf_counter()
        point_feature, cond = ma.encode(m, cfg, pc_normal)
        done("encode", t0)

        t0 = time.perf_counter()
        if self.lookahead:
            out = self._decode_lookahead(cond, sampling, generator, prompt_ids)
        else:
            state = opt_mod.init_decode_state(
                m.opt, cfg.opt, cond, max_new_tokens=cfg.generate_length, bucket=self.bucket,
                generator=generator, attn=self.attn, sampling=sampling, prompt_ids=prompt_ids)
            state = opt_mod.decode_loop(m.opt, cfg.opt, state, max_new_tokens=cfg.generate_length,
                                        wq=self.wq, sampling=sampling, graph=self.graph)
            out = {"tokens": state.tokens, "decode_steps": state.step - 1 - p_len,
                   **_graph_stats([state.graph] if state.graph is not None else [])}
            del state               # the cache and the graph go before detok allocates
        done("decode", t0)

        t0 = time.perf_counter()
        coords = ma.detokenize(m, cfg, out["tokens"], point_feature)
        done("detok", t0)
        return {"coords": coords, **out, **times}
