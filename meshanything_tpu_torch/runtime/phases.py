"""Phase-split generation (the port of ``meshanything_tpu/runtime/phases.py``):
``PhaseRunner``, encode | decode | detok on one model, and the
device-memory budget of a generation batch (``estimate_kv_bytes``,
``param_tree_bytes``, ``check_memory_budget``).

``PhaseRunner`` is the object that the pipeline (``runtime/pipeline.py``),
the micro-batcher (``runtime/batching.py``) and serving (``serving.py``)
share. Its decode is the single-token loop (``models/decoding.py``) or,
with ``lookahead`` (a window width, or "adaptive" for the 8/16 window
controller of ``models/lookahead.py``), the Jacobi window loop, from the
condition alone or from a prompt (mesh completion). On a card the decode
replays CUDA graphs (``runtime/decode_graph.py``), which the runner keeps
with their decode state for each batch size and sampling mode: a key's
first request (or ``precompile``) captures them, every later request of
the key writes its prefill into the kept state and replays them, as JAX
compiles a program once for each shape. The runner runs one generation
at a time: its ``lock`` serialises all device work of the callers'
threads, because a CUDA call from another thread during a capture would
invalidate it, and every graph of a card shares one capture stream and
one fold workspace (on the TPU, JAX runs one program at a time anyway).
``aot_dir`` is the store of built kernel libraries (``runtime/aot.py``),
the counterpart of JAX's store of compiled programs.

The budget's estimate is an upper bound of what a generation allocates on the
card: the weights, one KV cache, the prefill's and the decode loop's
transients, what a tier adds (scales, packed layers, int8 matrices), and
what the runner keeps for other batch sizes (their caches and graph
pools). A kept cache and the kept int8 matrices stay live through detok,
so the detok term holds them too.
``InferencePipeline`` holds it against the card's own memory before it
allocates, so that a batch that cannot fit is refused with the flags that
would make it fit instead of failing in the middle of a run.
``tools/memory_probe.py`` measures each phase's peak on the card beside
the estimate; the constants below come from its readings.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from meshanything_tpu_torch.config import MeshAnythingConfig
from meshanything_tpu_torch.models import decoding
from meshanything_tpu_torch.parallel.collectives import group_size
from meshanything_tpu_torch.runtime import profiling

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
    two bytes an element (bf16), one (int8) or half a byte (int4). The
    Moonlight decoder's latent cache holds ``cache_width`` values (576) a
    layer and position, where OPT's holds K and V of ``hidden_size`` each,
    and its routing record K int32 ids a MoE layer and position.

    extra_tokens: lookahead windows extend the cache by W slots. The
    quantized tiers' f32 row scales are not in it (``check_memory_budget``
    adds them)."""
    c = cfg.cond_length
    s_max = -(-(c + cfg.generate_length + extra_tokens) // bucket) * bucket
    return decoding.family(cfg).cache_bytes(cfg.opt, batch, s_max, int8, int4)


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
                        prompt_tokens: int = 0, kept_bytes: int = 0,
                        keep: bool = False) -> int:
    """Estimate the device footprint of generating ``batch`` meshes and
    raise ValueError where it exceeds ``limit_bytes``; returns the
    estimate.

    The peak is either the decode (the weights, ONE cache, which the
    prefill writes in place, the prefill's compact K/V rows, what the
    tier adds, and the loop's transients) or encode/detok (the weights
    plus batch-scaled hidden states and the f32 score matrices of the
    dense attentions over the point cloud and over the face tokens, and,
    with ``keep``, the cache and int8 matrices the runner keeps). What a
    tier adds: the f32 row
    scales of the int8/int4 caches and their quantization transients;
    the packed bf16 layers of ``attn="megakernel"`` (and, from an f32
    model, the f32 stack they are cast from); the int8 layer matrices of
    ``wq``. The cache's elements take the activation dtype's size.

    param_bytes: the weights as they lie on the card
    (``param_tree_bytes(model)``). limit_bytes: default ``device``'s
    memory less ``HEADROOM_BYTES``. prompt_tokens: a completion prompt's
    length, whose rows the prefill's compact K/V holds beside the
    condition's. kept_bytes: what the runner keeps for other batch sizes
    and modes (their states' tensors and graph pools), live throughout.
    keep: the runner keeps this generation's cache and int8 matrices past
    the decode, so they are live through detok too (encode runs before
    they are filled, but a kept state of this key holds them then: the
    detok term is the larger)."""
    if param_bytes is None:
        raise ValueError("check_memory_budget needs param_bytes (param_tree_bytes(model))")
    if limit_bytes is None:
        if device is None:
            raise ValueError("check_memory_budget needs limit_bytes or a device")
        limit_bytes = device_limit_bytes(device)
    o, decoder = cfg.opt, decoding.family(cfg)
    int8, int4 = attn == "pallas_int8", attn == "pallas_int4"
    kv = estimate_kv_bytes(cfg, batch, bucket, int8, extra_tokens, int4=int4)
    itemsize = torch.empty((), dtype=cfg.activation_dtype).element_size()
    compact = decoder.prefill_elems(o, batch, cfg.cond_length + prompt_tokens, itemsize)
    if int8 or int4:
        rows = kv * (2 if int4 else 1) // o.hidden_size       # (plane, layer, row) triples
        kv += 4 * rows
        prefill = compact * QUANTIZE_BYTES_PER_ELEMENT[attn]
    else:
        kv = kv * itemsize // 2
        prefill = compact * itemsize
    tier = 0
    matrices, channels = decoder.wq_sizes(o)
    wq_bytes = matrices + 4 * channels if wq else 0     # int8 values and f32 channel scales
    if attn == "megakernel":
        vectors = o.num_layers * (9 * o.hidden_size + o.ffn_dim)
        tier += matrices * 2 + vectors * 4 + (matrices * itemsize if itemsize != 2 else 0)
    tier += wq_bytes
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
    detok = batch * act_row + ((kv + wq_bytes) if keep else 0)
    est = param_bytes + kept_bytes + max(kv + prefill + tier + overhead, detok)
    if est > limit_bytes:
        raise ValueError(
            f"estimated device footprint {est / 1e9:.1f} GB exceeds the "
            f"{limit_bytes / 1e9:.1f} GB budget for batch={batch} "
            f"(kv cache {kv / 1e9:.1f} GB, attn={attn!r}, kept for other batch sizes "
            f"{kept_bytes / 1e9:.1f} GB). Reduce --batchsize_per_gpu or "
            "--n_max_triangles, or use --attn pallas_int8/pallas_int4 (smaller cache).")
    return est


def _graph_stats(graphs: dict, before: dict) -> dict:
    """capture_s, graph_captures and graph_replays of one request:
    ``graphs`` (key -> StepGraph) as the decode left them, ``before``
    (key -> replays) as the request found them."""
    new = [g for k, g in graphs.items() if k not in before]
    return {"capture_s": sum(g.capture_s for g in new), "graph_captures": len(new),
            "graph_replays": sum(g.replayed - before.get(k, 0) for k, g in graphs.items())}


def _graphs_of(state) -> dict:
    if hasattr(state, "graphs"):
        return dict(state.graphs)
    return {} if state.graph is None else {"step": state.graph}


def kept_state_bytes(state) -> int:
    """Bytes a kept decode state holds on its device: its tensors (the
    cache above all) and its graphs' private memory pools."""
    tensors = []
    for field in dataclasses.fields(state):
        value = getattr(state, field.name)
        tensors += value if isinstance(value, tuple) else [value]
    held = sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))
    return held + sum(getattr(g, "pool_bytes", 0) for g in _graphs_of(state).values())


@dataclasses.dataclass
class _Kept:
    state: object                   # the DecodeState / LookaheadState made for the key
    generator: Optional[torch.Generator]   # sampling: the generator its graphs registered


class PhaseRunner:
    """Encode | decode | detok on one model (see the module's text).

    ``run`` takes a padded batch on the device and returns a dict: the
    coords and raw tokens on the device, ``decode_steps``, the fenced
    seconds of each phase, the request's graph captures and replays
    (``capture_s``, ``graph_captures``, ``graph_replays``), and the
    window loop's forwards and acceptance (``window_trace`` with the
    adaptive window, also kept in ``self.window_trace``). Calling the
    runner as JAX's is called returns a ``GenerateOutput`` on the CPU,
    its ``stats`` the rest of ``run``'s dict; the input may be numpy.

    The runner keeps one decode state, with its graphs, for each batch
    size and sampling mode (its tier, window and early exit are its own):
    a request of a kept key writes its prefill into that state and
    replays the graphs captured before, so only a key's first request
    captures. ``attn="megakernel"`` (eager) keeps nothing. On a card the
    budget counts the kept states, and the least recently used ones are
    dropped before a new one would not fit. ``precompile`` builds the
    tier's kernel libraries and captures a batch size's graphs before
    the first request; ``aot_dir`` makes a directory the libraries'
    store (``runtime/aot.py``), which a later process finds them in.
    ``place`` names a rank past the first of a multi-process run ("rank 1
    of 2 (--multihost)"): the budget's error starts with it.
    """

    def __init__(self, model, cfg: MeshAnythingConfig, *, bucket: int = 512,
                 attn: str = "auto", early_exit: bool = True, lookahead: "int | str" = 0,
                 wq: bool = False, aot_dir: Optional[str] = None,
                 adaptive_windows: tuple = (8, 16), adaptive_check_iters: int = 64,
                 graph: bool = True, place: Optional[str] = None):
        from meshanything_tpu_torch.models import lookahead as la_mod

        if not (lookahead == "adaptive" or (isinstance(lookahead, int) and lookahead >= 0)):
            raise ValueError(f"lookahead must be a window width or 'adaptive', not {lookahead!r}")
        if lookahead == "adaptive" and (len(adaptive_windows) != 2
                                        or adaptive_windows[0] >= adaptive_windows[1]):
            raise ValueError(f"adaptive_windows must be (small, big): {adaptive_windows}")
        self.model = model
        self.cfg = cfg
        self.bucket = bucket
        self.attn = decoding.resolve_attn(attn)
        self.family = decoding.family(cfg)      # the shape decoder's family
        self.family.check_tier(self.attn, lookahead)
        if lookahead:
            la_mod.check_attn(self.attn)
        decoding.check_wq(self.attn, wq)
        self.place = place
        self.early_exit = early_exit
        self.lookahead = lookahead
        self.adaptive_windows = tuple(adaptive_windows)
        self.adaptive_check_iters = adaptive_check_iters
        self.wq = wq
        self.graph = graph
        self.device = next(model.parameters()).device
        self.param_bytes = param_tree_bytes(model)
        group = model.opt.layers[0].tp_group
        if self.attn == "megakernel" and group is not None:
            # a generation also holds the decoder gathered whole on each rank
            # (shape_opt.whole_decoder): at most the group's size times the local one
            self.param_bytes += param_tree_bytes(model.opt) * group_size(group)
        if aot_dir is not None:
            from meshanything_tpu_torch.runtime.aot import AotStore

            AotStore(aot_dir)
        self.window_trace: list = []   # (iters, window, acceptance) per check, adaptive only
        self.lock = threading.Lock()
        # (batch, sampling) -> the kept state, least recently used first
        self._kept: "OrderedDict[tuple, _Kept]" = OrderedDict()
        self._wq_layers = None

    @property
    def windows(self) -> tuple:
        """(window a state starts at, widest window): the adaptive pair,
        or the fixed width twice."""
        if self.lookahead == "adaptive":
            return self.adaptive_windows
        return (self.lookahead,) * 2

    def precompile(self, batch: int, *, sampling: bool = False) -> dict:
        """Build every kernel library the runner's tier launches (into the
        ``aot_dir`` store where one is set), then capture ``batch``'s decode
        graphs (every width of the adaptive window) into the state kept
        for it, from a zero condition, so that the first request replays
        them. Runs nothing on the CPU. Returns {"libraries": [paths],
        "built": [the names this call built], "graph_captures": n,
        "capture_s": s}."""
        from meshanything_tpu_torch.models import lookahead as la_mod
        from meshanything_tpu_torch.ops import _build
        from meshanything_tpu_torch.runtime import aot, decode_graph

        report = {"libraries": [], "built": [], "graph_captures": 0, "capture_s": 0.0}
        if self.device.type != "cuda":
            return report
        cfg = self.cfg
        names = self.family.libraries(cfg.opt, self.attn, self.lookahead, cfg.activation_dtype)
        loaded = set(_build._loaded)                 # loaded (or built) before this call
        libs = aot.build(names)
        report["libraries"] = [lib.path for lib in libs]
        report["built"] = [name for name, lib in zip(names, libs)
                           if lib.built and name not in loaded]
        if not self._keeps() or not decode_graph.use_graph(self.device, self.graph):
            return report
        with self.lock, torch.no_grad():
            self._budget(batch, 0, (batch, sampling))
            cond = torch.zeros((batch, cfg.cond_length, cfg.opt.hidden_size),
                               dtype=cfg.activation_dtype, device=self.device)
            generator = torch.Generator(device=self.device) if sampling else None
            state, kept, before = self._init_state(cond, sampling, generator, None)
            state.done.zero_()           # every row live: the capture needs a live step
            gl = cfg.generate_length
            if self.lookahead:
                small, big = self.windows
                for width in dict.fromkeys((small, big)):
                    st = la_mod.resize_window(state, width)
                    la_mod.lookahead_segment(self.model.opt, cfg.opt, st, max_new_tokens=gl,
                                             wq_layers=self._wq(), until_iters=st.iters + 1,
                                             sampling=sampling, graph=self.graph)
            else:
                decoding.decode_segment(self.model.opt, cfg.opt, state, max_new_tokens=gl,
                                        until=state.step + 1, early_exit=self.early_exit,
                                        wq_layers=self._wq(), sampling=sampling,
                                        graph=self.graph)
            self._finish(kept, generator)
            stats = _graph_stats(_graphs_of(state), before)
        report.update(graph_captures=stats["graph_captures"], capture_s=stats["capture_s"])
        return report

    # -- kept states ------------------------------------------------------

    def _keeps(self) -> bool:
        return self.attn != "megakernel"

    def _wq(self):
        """The int8 layer matrices, quantized once (the kept graphs read
        them)."""
        if self.wq and self._wq_layers is None:
            self._wq_layers = self.family.quantize_layers(self.model.opt.layers)
        return self._wq_layers

    def _budget(self, batch: int, prompt_tokens: int, key: tuple) -> None:
        """Hold the batch against the card's memory with the other kept
        states counted, dropping the least recently used of them while it
        does not fit (raises when it does not fit with none)."""
        if self.device.type != "cuda":
            return
        while True:
            others = [k for k in self._kept if k != key]
            try:
                check_memory_budget(
                    self.cfg, batch, self.bucket, self.attn, param_bytes=self.param_bytes,
                    extra_tokens=self.windows[1] if self.lookahead else 0, wq=self.wq,
                    device=self.device, prompt_tokens=prompt_tokens, keep=self._keeps(),
                    kept_bytes=sum(kept_state_bytes(self._kept[k].state) for k in others))
                return
            except ValueError as e:
                if not others:
                    if self.place:
                        raise ValueError(f"{self.place}: {e}") from None
                    raise
                del self._kept[others[0]]
                torch.cuda.empty_cache()      # the dropped graphs' pools go back to the card

    def _init_state(self, cond, sampling, generator, prompt_ids):
        """The request's decode state: the kept state of its key refilled
        (or a new one, kept from now on) -> (state, the _Kept record or
        None, the graphs' replays as found). A kept sampled state draws
        from its own generator, which takes the request's seed and offset
        here and gives them back in ``_finish``."""
        from meshanything_tpu_torch.models import lookahead as la_mod

        cfg, m = self.cfg, self.model
        key = (cond.shape[0], sampling)
        kept = None
        if self._keeps():
            # out of the dict until the refill succeeds: a request that raises in it
            # drops the key's state (half written), and the next one captures anew
            kept = self._kept.pop(key, None) or _Kept(
                None, torch.Generator(device=self.device) if sampling else None)
            if sampling:
                source = generator if generator is not None else _default_generator(self.device)
                kept.generator.set_state(source.get_state())
                generator = kept.generator
        before = {} if kept is None or kept.state is None else {
            k: g.replayed for k, g in _graphs_of(kept.state).items()}
        into = None if kept is None else kept.state
        if self.lookahead:
            small, big = self.windows
            state = la_mod.init_lookahead_state(
                m.opt, cfg.opt, cond, max_new_tokens=cfg.generate_length, window=small,
                bucket=self.bucket, attn=self.attn, sampling=sampling, generator=generator,
                buf_window=big, prompt_ids=prompt_ids, into=into)
        else:
            state = self.family.init_decode_state(
                m.opt, cfg.opt, cond, max_new_tokens=cfg.generate_length, bucket=self.bucket,
                generator=generator, attn=self.attn, sampling=sampling, prompt_ids=prompt_ids,
                into=into)
        if kept is not None:
            kept.state = state
            self._kept[key] = kept               # most recently used last
        return state, kept, before

    def _finish(self, kept: Optional[_Kept], generator: Optional[torch.Generator]) -> None:
        """Give the request's generator the kept generator's state (the
        draws the decode took from it)."""
        if kept is not None and kept.generator is not None:
            target = generator if generator is not None else _default_generator(self.device)
            target.set_state(kept.generator.get_state())

    # -- the phases -------------------------------------------------------

    def _decode_lookahead(self, state, sampling: bool, p_len: int) -> dict:
        """The window loop: fixed width, or the adaptive controller over
        ``adaptive_windows`` on one state sized for the larger."""
        from meshanything_tpu_torch.models import lookahead as la_mod

        cfg, m = self.cfg, self.model
        gl = cfg.generate_length
        wq_layers = self._wq()

        def segment(st, until=None, _window=None):
            return la_mod.lookahead_segment(m.opt, cfg.opt, st, max_new_tokens=gl,
                                            wq_layers=wq_layers, until_iters=until,
                                            sampling=sampling, graph=self.graph)

        trace = []
        if self.lookahead == "adaptive":
            state = la_mod.run_adaptive_controller(
                state, segment, windows=self.adaptive_windows,
                check_iters=self.adaptive_check_iters, max_new_tokens=gl, trace=trace)
        else:
            state = segment(state)
        first = 1 + p_len   # the prefill's tokens
        steps = state.steps.clamp_max(gl)
        b = steps.shape[0]
        out = {"tokens": state.tokens[:, :gl].clone(), "decode_steps": int(steps.max()) - first,
               "window_forwards": state.iters,
               # tokens past the first, per row and window forward
               "mean_accept": float(steps.sum() - b * first) / max(state.iters * b, 1)}
        if self.lookahead == "adaptive":
            out["window_trace"] = trace
            self.window_trace = trace
        return out

    def run(self, pc_normal: torch.Tensor, *, sampling: bool = False,
            generator: Optional[torch.Generator] = None,
            prompt_ids: Optional[torch.Tensor] = None, timer=None) -> dict:
        """One padded batch (B, N, 6) on the device -> coords, raw tokens,
        decode steps and the seconds of each phase (fenced on the device);
        ``prompt_ids`` (B, P) continues a token prefix. On a card the batch
        is first held against the card's memory. The request and its
        phases are spans (``runtime/profiling.py``: ``request``, ``encode``,
        ``prefill``, ``decode`` with its ``segment`` spans, ``detok``), and
        the seconds returned are their host times (``decode_s`` from the
        prefill's start to the loop's end). ``timer``
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

        cfg, m, dev = self.cfg, self.model, self.device
        b = pc_normal.shape[0]
        p_len = 0 if prompt_ids is None else prompt_ids.shape[1]
        with profiling.span("request", batch=b) as req:
            self._budget(b, p_len, (b, sampling))
            if prompt_ids is not None:
                prompt_ids = torch.as_tensor(prompt_ids).to(dev, torch.int64)
            with profiling.span("encode", device=dev, fence=dev) as encode:
                point_feature, cond = ma.encode(m, cfg, pc_normal)
            with profiling.span("prefill", device=dev, prompt_tokens=p_len) as prefill:
                state, kept, before = self._init_state(cond, sampling, generator, prompt_ids)
            with profiling.span("decode", fence=dev) as decode:
                if self.lookahead:
                    out = self._decode_lookahead(state, sampling, p_len)
                else:
                    state = decoding.decode_loop(
                        m.opt, cfg.opt, state, max_new_tokens=cfg.generate_length, wq=self.wq,
                        sampling=sampling, graph=self.graph, early_exit=self.early_exit,
                        wq_layers=self._wq())
                    out = {"tokens": state.tokens.clone(), "decode_steps": state.step - 1 - p_len}
                counts = getattr(state, "expert_counts", None)
                if counts is not None:
                    # the expert kernel's tokens per (MoE layer, expert): read once, reset
                    req.set(expert_tokens=counts.tolist())
                    counts.zero_()
                out.update(_graph_stats(_graphs_of(state), before))
                self._finish(kept, generator)
                del state       # unkept (megakernel): the cache goes before detok allocates
            with profiling.span("detok", device=dev, fence=dev) as detok:
                coords = ma.detokenize(m, cfg, out["tokens"], point_feature)
            req.set(**{k: out[k] for k in ("decode_steps", "graph_captures", "graph_replays")})
        # the decode phase runs from the prefill's start to the loop's fenced end
        times = {"encode_s": encode.seconds,
                 "decode_s": (decode.span.end_ns - prefill.span.start_ns) / 1e9,
                 "detok_s": detok.seconds}
        if timer is not None:
            for name in ("encode", "decode", "detok"):
                timer.record(name, times[f"{name}_s"])
        return {"coords": coords, **out, **times}


def _default_generator(device: torch.device) -> torch.Generator:
    """The default generator of ``device`` (what a draw without a
    generator takes)."""
    if device.type == "cuda":
        return torch.cuda.default_generators[device.index or 0]
    return torch.default_generator
