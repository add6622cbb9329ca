"""End-to-end inference: host preprocessing -> device generation -> host
postprocessing (the port of ``meshanything_tpu/runtime/pipeline.py`` and
of the three phases of ``runtime/phases.py``: encode, decode, detok).

The decode phase runs the single-token loop (``models/shape_opt.py``) or,
with ``lookahead`` (a window width, or "adaptive" for the 8/16 window
controller of ``models/lookahead.py``), the Jacobi window loop; ``attn``
picks the cache tier ("megakernel": the whole layer stack of a step in
one K5 launch, single-token loop only) and ``wq`` the int8 layer
matrices. On a card ``generate`` first holds the batch against the
card's memory (``runtime/phases.py::check_memory_budget``); a ``timer``
(``runtime/profiling.py::PhaseTimer``) is fed the three fenced phases.

On a card the decode runs as CUDA-graph replays (``decode_segment`` /
``lookahead_segment``: one captured step or window forward a request,
and a width, replayed once a step; ``runtime/decode_graph.py``), except
``attn="megakernel"``'s, which stays eager. ``graph=False`` runs the same
steps eagerly: the comparison that ``chip_smoke.py`` and the tools make,
no CLI flag. ``decode_s`` includes the capture, whose seconds are also
reported apart (``capture_s``, with the warm-up step in it).

A batch whose generation raises (a kernel fault, an out-of-memory error)
is retried ``max_retries`` times and then recorded as ``{"uid", "error":
"<Type>: <message>"}`` for each of its meshes, as JAX
``runtime/pipeline.py:165-181`` does: a folder run goes on past it. A
caller that must not pass a fault (``chip_smoke.py``) treats any record
with an ``"error"`` key as a failure.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterable, List, Sequence

import numpy as np
import torch

from meshanything_tpu_torch.config import MeshAnythingConfig
from meshanything_tpu_torch.geometry import (
    load_mesh,
    normalize_pc_cli,
    postprocess_faces,
    sample_surface_with_normals,
)
from meshanything_tpu_torch.models import lookahead as la_mod
from meshanything_tpu_torch.models import meshanything as ma
from meshanything_tpu_torch.models import shape_opt as opt_mod
from meshanything_tpu_torch.ops.wquant import quantize_opt_layers
from meshanything_tpu_torch.runtime.phases import check_memory_budget, param_tree_bytes
from meshanything_tpu_torch.runtime.profiling import PhaseTimer, fence

ADAPTIVE_WINDOWS = (8, 16)     # runtime/phases.py's adaptive_windows
ADAPTIVE_CHECK_ITERS = 64


@dataclasses.dataclass
class Sample:
    pc_normal: np.ndarray  # (N, 6) float16 normalized
    uid: str


def load_inputs(input_type: str, paths: Sequence[str], *, num_points: int = 4096,
                seed: int = 0) -> List[Sample]:
    """Dataset construction (main.py:15-58): a pc_normal .npy (N, 6) is
    subsampled to ``num_points``; a .obj/.ply mesh is surface-sampled."""
    rng = np.random.default_rng(seed)
    samples: List[Sample] = []
    for path in paths:
        uid = os.path.basename(path).rsplit(".", 1)[0]
        if input_type == "pc_normal":
            data = np.load(path)
            if data.shape[0] < num_points:
                raise ValueError(f"{path}: input pc_normal should have at least {num_points} points")
            pc = data[rng.choice(data.shape[0], num_points, replace=False)]
        elif input_type == "mesh":
            mesh = load_mesh(path)
            pc = sample_surface_with_normals(mesh.vertices, mesh.faces, num_points, rng)
        else:
            raise ValueError(f"unknown input_type {input_type!r}")
        samples.append(Sample(pc_normal=normalize_pc_cli(pc), uid=uid))
    return samples


def _graph_stats(graphs) -> dict:
    """capture_s, graph_captures and graph_replays of a request's graphs."""
    graphs = list(graphs)
    return {"capture_s": sum(g.capture_s for g in graphs), "graph_captures": len(graphs),
            "graph_replays": sum(g.replayed for g in graphs)}


class InferencePipeline:
    """Runs batches through the three phases; batches are padded up to
    ``batch_size`` with copies of their last sample."""

    def __init__(self, model: ma.MeshAnything, cfg: MeshAnythingConfig, *,
                 batch_size: int = 1, bucket: int = 512, attn: str = "auto",
                 lookahead: "int | str" = 0, wq: bool = False,
                 timer: PhaseTimer | None = None, graph: bool = True):
        if not (lookahead == "adaptive" or (isinstance(lookahead, int) and lookahead >= 0)):
            raise ValueError(f"lookahead must be a window width or 'adaptive', not {lookahead!r}")
        self.model = model
        self.cfg = cfg
        self.batch_size = batch_size
        self.bucket = bucket
        self.attn = opt_mod.resolve_attn(attn)
        if lookahead:
            la_mod.check_attn(self.attn)
        opt_mod.check_wq(self.attn, wq)
        self.lookahead = lookahead
        self.wq = wq
        self.timer = timer
        self.graph = graph
        self.device = next(model.parameters()).device
        self.param_bytes = param_tree_bytes(model)

    def _decode_lookahead(self, cond: torch.Tensor, sampling: bool,
                          generator: torch.Generator | None) -> dict:
        """The window loop: fixed width, or the adaptive controller over
        ADAPTIVE_WINDOWS on one state sized for the larger."""
        cfg, m = self.cfg, self.model
        gl = cfg.generate_length
        adaptive = self.lookahead == "adaptive"
        small, big = ADAPTIVE_WINDOWS if adaptive else (self.lookahead,) * 2
        state = la_mod.init_lookahead_state(
            m.opt, cfg.opt, cond, max_new_tokens=gl, window=small, bucket=self.bucket,
            attn=self.attn, sampling=sampling, generator=generator, buf_window=big)
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
        steps = state.steps.clamp_max(gl)
        b = steps.shape[0]
        out = {"tokens": state.tokens[:, :gl], "decode_steps": int(steps.max()) - 1,
               "window_forwards": state.iters,
               # tokens past the first, per row and window forward
               "mean_accept": float(steps.sum() - b) / max(state.iters * b, 1),
               **_graph_stats(state.graphs.values())}
        if adaptive:
            out["window_trace"] = trace
        return out

    @torch.no_grad()
    def generate(self, pc_normal: torch.Tensor, *, sampling: bool = False,
                 generator: torch.Generator | None = None) -> dict:
        """One padded batch -> coords, raw tokens, decode steps and the
        seconds of each phase (fenced on the device). On a card the batch
        is first held against the card's memory."""
        cfg, m = self.cfg, self.model
        if self.device.type == "cuda":
            window = ADAPTIVE_WINDOWS[1] if self.lookahead == "adaptive" else self.lookahead
            check_memory_budget(cfg, pc_normal.shape[0], self.bucket, self.attn,
                                param_bytes=self.param_bytes, extra_tokens=window, wq=self.wq,
                                device=self.device)
        times = {}

        def done(name: str, t0: float) -> None:
            fence(self.device)
            times[f"{name}_s"] = time.perf_counter() - t0
            if self.timer is not None:
                self.timer.record(name, times[f"{name}_s"])

        t0 = time.perf_counter()
        point_feature, cond = ma.encode(m, cfg, pc_normal)
        done("encode", t0)

        t0 = time.perf_counter()
        if self.lookahead:
            out = self._decode_lookahead(cond, sampling, generator)
        else:
            state = opt_mod.init_decode_state(
                m.opt, cfg.opt, cond, max_new_tokens=cfg.generate_length, bucket=self.bucket,
                generator=generator, attn=self.attn, sampling=sampling)
            state = opt_mod.decode_loop(m.opt, cfg.opt, state, max_new_tokens=cfg.generate_length,
                                        wq=self.wq, sampling=sampling, graph=self.graph)
            out = {"tokens": state.tokens, "decode_steps": state.step - 1,
                   **_graph_stats([state.graph] if state.graph is not None else [])}
            del state               # the cache and the graph go before detok allocates
        done("decode", t0)

        t0 = time.perf_counter()
        coords = ma.detokenize(m, cfg, out["tokens"], point_feature)
        done("detok", t0)
        return {"coords": coords, **out, **times}

    def run(self, samples: Iterable[Sample], out_dir: str, *, sampling: bool = False,
            seed: int = 0, max_retries: int = 1) -> List[dict]:
        os.makedirs(out_dir, exist_ok=True)
        samples = list(samples)
        results = []
        bs = self.batch_size
        for batch, start in enumerate(range(0, len(samples), bs)):
            chunk = samples[start:start + bs]
            pcs = np.stack([s.pc_normal for s in chunk]).astype(np.float32)
            if len(chunk) < bs:
                pcs = np.concatenate([pcs, np.repeat(pcs[-1:], bs - len(chunk), axis=0)])
            out, last_err = None, None
            for _ in range(max_retries + 1):
                generator = None
                if sampling:   # each attempt draws the batch's stream from its start
                    generator = torch.Generator(device=self.device)
                    generator.manual_seed(seed * 1_000_003 + start)
                try:
                    out = self.generate(torch.from_numpy(pcs).to(self.device),
                                        sampling=sampling, generator=generator)
                    coords = out["coords"].float().cpu().numpy()
                    break
                except Exception as e:  # a device fault or OOM: record, retry
                    out, last_err = None, e
            if out is None:
                results.extend({"uid": s.uid, "error": f"{type(last_err).__name__}: {last_err}"}
                               for s in chunk)
                continue
            device_s = out["encode_s"] + out["decode_s"] + out["detok_s"]
            for i, s in enumerate(chunk):
                t1 = time.perf_counter()
                rec = {
                    "uid": s.uid,
                    "batch": batch,
                    "faces_generated": int(np.sum(~np.isnan(coords[i, :, 0, 0]))),
                    "decode_steps": out["decode_steps"],
                    "device_time_s": device_s / len(chunk),
                    "encode_s": out["encode_s"],
                    "decode_s": out["decode_s"],
                    "detok_s": out["detok_s"],
                    "capture_s": out["capture_s"],
                    "graph_captures": out["graph_captures"],
                    "graph_replays": out["graph_replays"],
                }
                for key in ("window_forwards", "mean_accept", "window_trace"):
                    if key in out:
                        rec[key] = out[key]
                path = os.path.join(out_dir, f"{s.uid}_gen.obj")
                rec["faces_final"] = len(postprocess_faces(coords[i], path).faces)
                rec["obj_path"] = path
                rec["post_time_s"] = time.perf_counter() - t1
                results.append(rec)
        return results
