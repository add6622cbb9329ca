"""End-to-end inference: host preprocessing -> device generation -> host
postprocessing (the port of ``meshanything_tpu/runtime/pipeline.py``).

The device side is ``runtime/phases.py::PhaseRunner`` (encode | decode |
detok): the single-token loop or, with ``lookahead`` (a window width, or
"adaptive" for the 8/16 window controller), the Jacobi window loop;
``attn`` picks the cache tier ("megakernel": the whole layer stack of a
step in one K5 launch, single-token loop only) and ``wq`` the int8 layer
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

``load_inputs(marching_cubes=True)`` (``--mc``) watertights each mesh
through the distance field and marching tetrahedra first
(``geometry/sdf.py``); ``run(prompt_tokens=)`` (``--complete_from``)
continues every sample from one token prefix (mesh completion).

A batch whose generation raises (a kernel fault, an out-of-memory error)
is retried ``max_retries`` times and then recorded as ``{"uid", "error":
"<Type>: <message>"}`` for each of its meshes, as JAX
``runtime/pipeline.py:165-181`` does: a folder run goes on past it. A
caller that must not pass a fault (``chip_smoke.py``) treats any record
with an ``"error"`` key as a failure. ``run(resume=True)`` (``--resume``)
skips a sample whose OBJ exists, ``run(export=False)`` writes none,
``self.timings`` gathers every run's records (the skipped ones too) and
``write_metrics`` writes records one JSON object a line
(``--metrics_out``), as JAX's ``run`` and ``write_metrics`` do.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from meshanything_tpu_torch.config import MeshAnythingConfig
from meshanything_tpu_torch.geometry import (
    load_mesh,
    normalize_pc_cli,
    postprocess_faces,
    sample_surface_with_normals,
)
from meshanything_tpu_torch.models import meshanything as ma
from meshanything_tpu_torch.runtime.phases import PhaseRunner
from meshanything_tpu_torch.runtime.profiling import PhaseTimer


@dataclasses.dataclass
class Sample:
    pc_normal: np.ndarray  # (N, 6) float16 normalized
    uid: str


def load_inputs(input_type: str, paths: Sequence[str], *, marching_cubes: bool = False,
                num_points: int = 4096, seed: int = 0) -> List[Sample]:
    """Dataset construction (main.py:15-58): a pc_normal .npy (N, 6) is
    subsampled to ``num_points``; a mesh (.obj/.ply/.stl/.off/.glb) is
    surface-sampled, after watertighting with ``marching_cubes``."""
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
            if marching_cubes:
                from meshanything_tpu_torch.geometry.sdf import export_to_watertight

                mesh = export_to_watertight(mesh)
            pc = sample_surface_with_normals(mesh.vertices, mesh.faces, num_points, rng)
        else:
            raise ValueError(f"unknown input_type {input_type!r}")
        samples.append(Sample(pc_normal=normalize_pc_cli(pc), uid=uid))
    return samples


class InferencePipeline:
    """Runs batches through the three phases (``self.runner``, a
    ``PhaseRunner``); batches are padded up to ``batch_size`` with copies
    of their last sample."""

    def __init__(self, model: ma.MeshAnything, cfg: MeshAnythingConfig, *,
                 batch_size: int = 1, bucket: int = 512, attn: str = "auto",
                 lookahead: "int | str" = 0, wq: bool = False,
                 timer: PhaseTimer | None = None, graph: bool = True,
                 aot_dir: Optional[str] = None, place: Optional[str] = None):
        self.runner = PhaseRunner(model, cfg, bucket=bucket, attn=attn, lookahead=lookahead,
                                  wq=wq, graph=graph, aot_dir=aot_dir, place=place)
        self.batch_size = batch_size
        self.timer = timer
        self.device = self.runner.device
        self.timings: List[dict] = []

    @property
    def graph(self) -> bool:
        """Whether the decode replays captured graphs on a card (the
        runner's setting)."""
        return self.runner.graph

    @graph.setter
    def graph(self, value: bool) -> None:
        self.runner.graph = value

    def generate(self, pc_normal: torch.Tensor, *, sampling: bool = False,
                 generator: torch.Generator | None = None,
                 prompt_ids: Optional[torch.Tensor] = None) -> dict:
        """One padded batch -> coords, raw tokens, decode steps and the
        seconds of each phase (``PhaseRunner.run``)."""
        return self.runner.run(pc_normal, sampling=sampling, generator=generator,
                               prompt_ids=prompt_ids, timer=self.timer)

    def run(self, samples: Iterable[Sample], out_dir: str, *, sampling: bool = False,
            seed: int = 0, export: bool = True, resume: bool = False, max_retries: int = 1,
            prompt_tokens: Optional[np.ndarray] = None) -> List[dict]:
        """Generate every sample, a padded batch at a time, and write
        ``<uid>_gen.obj`` for each (``export``). ``resume`` skips a sample
        whose OBJ exists (recorded in ``self.timings`` as {"uid",
        "skipped": True, "obj_path"}, not returned). ``prompt_tokens``
        (P,): a completion prefix in stream order ([bos, face tokens...])
        that every sample continues (``--complete_from``)."""
        os.makedirs(out_dir, exist_ok=True)
        samples = list(samples)
        if resume:
            remaining = []
            for s in samples:
                path = os.path.join(out_dir, f"{s.uid}_gen.obj")
                if os.path.exists(path):
                    self.timings.append({"uid": s.uid, "skipped": True, "obj_path": path})
                else:
                    remaining.append(s)
            samples = remaining
        results = []
        bs = self.batch_size
        for batch, start in enumerate(range(0, len(samples), bs)):
            chunk = samples[start:start + bs]
            pcs = np.stack([s.pc_normal for s in chunk]).astype(np.float32)
            if len(chunk) < bs:
                pcs = np.concatenate([pcs, np.repeat(pcs[-1:], bs - len(chunk), axis=0)])
            prompt = None
            if prompt_tokens is not None:
                prompt = torch.as_tensor(np.asarray(prompt_tokens, np.int64))[None].repeat(bs, 1)
            out, last_err = None, None
            for _ in range(max_retries + 1):
                generator = None
                if sampling:   # each attempt draws the batch's stream from its start
                    generator = torch.Generator(device=self.device)
                    generator.manual_seed(seed * 1_000_003 + start)
                try:
                    out = self.generate(torch.from_numpy(pcs).to(self.device),
                                        sampling=sampling, generator=generator,
                                        prompt_ids=prompt)
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
                if export:
                    path = os.path.join(out_dir, f"{s.uid}_gen.obj")
                    rec["faces_final"] = len(postprocess_faces(coords[i], path).faces)
                    rec["obj_path"] = path
                rec["post_time_s"] = time.perf_counter() - t1
                results.append(rec)
        self.timings.extend(results)
        return results


def write_metrics(results: List[dict], path: str) -> None:
    """The records, one JSON object a line (``--metrics_out``)."""
    with open(path, "w") as fh:
        for r in results:
            fh.write(json.dumps(r) + "\n")
