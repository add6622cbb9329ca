"""One run of one cell: set-up, the measured window, the traced request,
the comparison, and the result line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``'s ``workloads``, its configuration in
``perfbench/configs/<config>.json``, its decoder family (the
configuration's ``decoder``) in ``perfbench/decoders/<decoder>.py``, its
traffic in ``perfbench/traffic/<cell>.json``, and each metric in
``perfbench/metrics/<metric>.py`` (a ``read(run)`` that returns the number,
or None where the run has nothing to read). The window drives the CLI's
folder path as ``runtime/pipeline.py::InferencePipeline.run`` does: the
program's ``PhaseRunner.run`` on a padded batch, then
``postprocess_faces`` for each mesh, writing its OBJ.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from types import ModuleType
from typing import Callable, List, Optional

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
# the program's kernel libraries and any compiler cache: fixed paths inside the checkout
CACHE = ROOT / "_perfbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "meshanything_tpu")
DECODERS = PACKAGE / "decoders"
# what every decoder family module gives (README.md, "Adding a decoder family")
FAMILY = ("program", "interface", "param_spec", "decoder_logits", "read_cache", "decode_work",
          "slice_work")


def _load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_benchmark(root: Path = ROOT) -> dict:
    return _load_json(root / "BENCHMARK.json")


def find_cell(bench: dict, workload: str) -> tuple:
    """(cell, configuration entry, configuration file, traffic file)."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({sorted(cells)})")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = _load_json(ROOT / entry["file"])
    traffic = _load_json(PACKAGE / "traffic" / f"{cell['traffic']}.json")
    return cell, entry, config, traffic


def metrics_for(bench: dict, cell: dict, trace: bool) -> list:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on): those that list the cell, or list no cells; a per-layer
    metric without a list goes where the metric it moves is reported."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in reported else [])]


def load_reader(name: str) -> Callable:
    path = PACKAGE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_decoder(name: str) -> ModuleType:
    """The decoder family ``name``: ``DECODERS/<name>.py``, loaded by path."""
    path = DECODERS / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no decoder family {name!r}: {path} is not a file")
    spec = importlib.util.spec_from_file_location(f"perfbench_decoder_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    missing = [f for f in FAMILY if not callable(getattr(module, f, None))]
    if missing:
        raise ValueError(f"decoder family {name!r} ({path}) lacks {missing}")
    return module


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def process_age_s() -> Optional[float]:
    """Seconds since this process started, from the kernel's record."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def use_cache_dirs() -> Path:
    """Point every compiler cache at fixed directories of the checkout;
    returns the program's kernel-library store."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    return CACHE / "kernels"


@dataclasses.dataclass
class Run:
    """What a run gathered, for the metric readers."""
    cell: dict
    config: dict                 # the configuration file
    model: dict                  # its model sizes, as run
    traffic: dict
    batch: int
    decoder: Optional[ModuleType] = None     # the configuration's decoder family
    setup_s: float = 0.0
    window_s: float = 0.0
    meshes: int = 0
    failed: int = 0
    requests: List[dict] = dataclasses.field(default_factory=list)
    slices: list = dataclasses.field(default_factory=list)
    memory_peak_bytes: int = 0

    def done(self) -> List[dict]:
        return [r for r in self.requests if "error" not in r]

    def kernels(self, group: str) -> list:
        return self.config["kernels"][group]


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def _kept_state(runner):
    """The decode state in flight or last run: the runner keeps one state
    per batch size, the cell's. ``PhaseRunner`` has no public accessor for
    it yet (PERF.md, Open questions), so this one function reads its
    private ``_kept``, for every decoder family."""
    return next(reversed(runner._kept.values())).state


def _positions(runner) -> Callable[[], list]:
    """Reads the tokens generated per row by the decode state in flight."""
    def read():
        state = _kept_state(runner)
        return [int(state.step_t)] * state.tokens.shape[0]
    return read


class Session:
    """A cell set up for one seed: the program's model with the seed's
    weights made on the device, its ``PhaseRunner`` with the tier's kernel
    libraries built (into the checkout's store) and the batch size's
    graphs captured, and the other shapes of the cell's traffic (encode,
    detok, post-process) run once. ``device`` "cpu" and ``model`` (sizes
    in place of the configuration's) are for a dry run on the CPU;
    ``tier`` (runner options over the configuration's) runs a control."""

    def __init__(self, workload: str, seed: int, *, device: Optional[str] = None,
                 model: Optional[dict] = None, tier: Optional[dict] = None,
                 log=sys.stderr):
        import torch

        from meshanything_tpu_torch.geometry.postprocess import postprocess_faces
        from meshanything_tpu_torch.models import meshanything as ma
        from meshanything_tpu_torch.runtime.phases import PhaseRunner
        from perfbench import traffic as traffic_mod, weights
        from perfbench.reference import model as ref

        self.log, self.seed, self.torch = log, seed, torch
        self.bench = load_benchmark()
        cell, _, config, traffic = find_cell(self.bench, workload)
        traffic_mod.check_traffic(traffic)
        model = model or config["model"]
        tier = {**config["tier"], **(tier or {})}
        self.dev = dev = torch.device(device or "cuda")
        family = load_decoder(config["decoder"])
        self.iface = iface = family.interface(model)
        self.run = Run(cell, config, model, traffic, int(traffic["batch"]), family)
        self.postprocess_faces = postprocess_faces
        torch.set_grad_enabled(False)

        clock = time.perf_counter()
        self.spec = ref.param_spec(model, family)
        cfg, self.net = family.program(model, dev)
        self.cfg, self.dtype = cfg, cfg.activation_dtype
        state = self.net.state_dict()
        if set(state) != {s[0] for s in self.spec}:
            raise ValueError(f"the program's parameters differ from the specification: "
                             f"{sorted(set(state) ^ {s[0] for s in self.spec})[:8]}")
        weights.fill(self.spec, state.__getitem__, seed, dev, self.dtype,
                     (iface["eos_row"], iface["eos"]))
        del state
        clock = self._lap("weights", clock)
        store = use_cache_dirs() if dev.type == "cuda" else None
        self.runner = PhaseRunner(self.net, cfg, attn=tier["attn"], wq=tier.get("wq", False),
                                  early_exit=False, aot_dir=None if store is None else str(store))
        report = self.runner.precompile(self.run.batch)
        self.say(f"[perfbench] precompile: built {report['built']}, "
                 f"{report['graph_captures']} captures in {report['capture_s']:.3f} s")
        clock = self._lap("precompile", clock)
        self.workdir = tempfile.TemporaryDirectory(prefix="perfbench-")
        self.out_dir = Path(self.workdir.name)
        warm = self.points(1 << 40)
        gen = torch.Generator(device=dev).manual_seed(seed % (1 << 63))
        fake = torch.randint(3, iface["vocab_size"], (self.run.batch, cfg.generate_length),
                             generator=gen, device=dev)
        pf, _ = ma.encode(self.net, cfg, torch.from_numpy(warm).to(dev))
        coords = ma.detokenize(self.net, cfg, fake, pf).float().cpu().numpy()
        postprocess_faces(coords[0], str(self.out_dir / "warm.obj"))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self._lap("warm-up", clock)

    def _lap(self, what: str, since: float) -> float:
        now = time.perf_counter()
        self.say(f"[perfbench] set-up {what}: {now - since:.3f} s (process age {process_age_s()})")
        return now

    def say(self, msg: str) -> None:
        print(msg, file=self.log, flush=True)

    def points(self, index: int):
        from perfbench import traffic as traffic_mod

        return traffic_mod.batch(self.run.traffic, self.seed, index,
                                 self.cfg.perceiver.num_points)

    def request(self, index: int) -> dict:
        """Request ``index`` of the closed loop: its points handed to the
        program, to its OBJs on disk."""
        torch = self.torch
        points = self.points(index)
        t0 = time.perf_counter()
        out = self.runner.run(torch.from_numpy(points).to(self.dev))
        coords = out["coords"].float().cpu().numpy()
        tokens = out["tokens"].cpu()
        posts, objs = [], []
        for r in range(points.shape[0]):
            path = str(self.out_dir / f"m{index}_{r}.obj")
            t1 = time.perf_counter()
            self.postprocess_faces(coords[r], path)
            posts.append(time.perf_counter() - t1)
            objs.append(path)
        rec = {k: out[k] for k in ("encode_s", "decode_s", "detok_s", "decode_steps",
                                   "capture_s", "graph_replays")}
        rec.update(seconds=time.perf_counter() - t0, post_s=posts, objs=objs, points=points,
                   tokens=tokens, coords=coords, rows=points.shape[0])
        return rec

    def traced_request(self, index: int, expected_replays: int) -> list:
        """Request ``index`` with slices of its decode under the profiler
        (``devtrace.SliceTracer``) -> the slices."""
        from meshanything_tpu_torch.runtime import decode_graph
        from perfbench import devtrace

        tcfg = self.run.traffic["trace"]
        tracer = devtrace.SliceTracer(tcfg["at"], tcfg["span"], expected_replays,
                                      _positions(self.runner))
        restore = tracer.install(decode_graph.StepGraph)
        try:
            self.runner.run(self.torch.from_numpy(self.points(index)).to(self.dev))
        finally:
            tracer.close()
            restore()
        return tracer.slices

    def sample(self, done: List[dict]) -> List[dict]:
        """The comparison's sample of the window's finished meshes
        (``traffic.check_sample``), the first, a row of the last request,
        with its row of the program's cache read back (the family's
        ``read_cache``): call it before the cache is written again."""
        from perfbench import check, traffic as traffic_mod

        pairs = traffic_mod.check_sample(self.run.traffic, self.seed,
                                         [r["decode_steps"] for r in done])
        rows = check.sample_rows(done, pairs)
        last = self.run.requests[-1]
        if pairs and done[pairs[0][0]] is last:
            written = self.iface["cond_length"] + last["tokens"].shape[1] - 1
            rows[0]["cache"] = self.run.decoder.read_cache(_kept_state(self.runner),
                                                           pairs[0][1], written)
        return rows

    def free(self) -> None:
        """Drop the program's model, runner and kept states."""
        self.runner = self.net = None
        gc.collect()
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()

    def reference_params(self) -> dict:
        from perfbench import weights

        return weights.reference_params(self.spec, self.seed, self.dev, self.dtype,
                                        (self.iface["eos_row"], self.iface["eos"]))

    def close(self) -> None:
        self.workdir.cleanup()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: Optional[str] = None, model: Optional[dict] = None,
             tier: Optional[dict] = None, log=sys.stderr) -> dict:
    """One run of ``workload``; returns the result line's object (see
    ``Session`` for ``device``, ``model`` and ``tier``)."""
    import torch

    from perfbench import check, devtrace

    s = Session(workload, seed, device=device, model=model, tier=tier, log=log)
    run, dev = s.run, s.dev
    age = process_age_s()
    run.setup_s = age if age is not None else time.perf_counter() - PROCESS_T0

    # -- the window: a closed loop of requests until ``seconds`` have passed
    t_w = time.perf_counter()
    while time.perf_counter() - t_w < seconds:
        try:
            rec = s.request(len(run.requests))
            run.meshes += rec["rows"]
        except Exception:           # a failed request is counted, and the loop goes on
            rec = {"error": traceback.format_exc(limit=4), "rows": run.batch}
            run.failed += run.batch
        run.requests.append(rec)
    run.window_s = time.perf_counter() - t_w
    for i, r in enumerate(run.requests):
        s.say(f"[perfbench] request {i}: " + (r["error"] if "error" in r else
              f"{r['seconds']:.4f} s, decode_steps {r['decode_steps']}, "
              f"decode_s {r['decode_s']:.4f}, capture_s {r['capture_s']:.4f}"))

    done = run.done()
    samples, sample_error = [], None
    try:
        samples = s.sample(done)
    except Exception:
        sample_error = traceback.format_exc()

    # -- the traced request: slices of its decode under the profiler
    if trace and dev.type == "cuda" and done:
        run.slices = s.traced_request(len(run.requests), done[-1]["graph_replays"])
        s.say(f"[perfbench] traced {len(run.slices)} slices: "
              + ", ".join(f"{sl.replays} replays {sl.seconds:.4f} s" for sl in run.slices))
        for name, secs in devtrace.top_device_ops(run.slices, n=40):
            s.say(f"[perfbench] device op {secs:.6f} s {name[:160]}")
        for k, sl in enumerate(run.slices):
            longest = sorted(devtrace.gaps(sl), key=lambda g: g[0] - g[1])[:4]
            s.say(f"[perfbench] slice {k} positions {sl.pos0[:2]}..{sl.pos1[:2]}, "
                  f"{len(sl.device_ops)} device ops, {sl.seconds * 1e3:.3f} ms, gaps: " + ", ".join(
                f"{(b - a) / 1e3:.3f} ms at +{(a - sl.start_us) / 1e3:.3f} ms ({name})"
                for a, b, name in longest))
    if dev.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))

    # -- the comparison, with the program's state freed
    s.free()
    numbers = {n: math.inf for n in check.NUMBERS}
    try:
        if sample_error:
            raise RuntimeError("reading the sample back failed:\n" + sample_error)
        numbers = check.compare(s.reference_params(), run.model, run.decoder, samples, dev)
    except Exception:
        s.say("[perfbench] the comparison failed:\n" + traceback.format_exc())
    correct, table = check.verdict(numbers, check.limits_of(run.config), run.failed)
    correct = correct and bool(done)
    s.close()

    # -- the result
    metrics = {}
    for m in metrics_for(s.bench, run.cell, trace):
        value = load_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": run.meshes + run.failed,
              "failed": run.failed, "metrics": metrics}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": int(run.cell["chips"]), "memory_peak_bytes": run.memory_peak_bytes}
    if run.slices:
        device_info["busy_s"] = sum(devtrace.busy_seconds(sl) for sl in run.slices)
        device_info["window_s"] = sum(devtrace.window_seconds(sl) for sl in run.slices)
        result["breakdown"] = {"device_ops": devtrace.top_device_ops(run.slices),
                               "idle_gaps": devtrace.idle_gaps(run.slices)}
    result["device"] = device_info
    if dev.type == "cuda":
        s.say(f"[perfbench] card: {_card_line()}")
    for name, v in table.items():
        s.say(f"check {name} {v['value']} limit {v['limit']}")
    result["check"] = table
    return result


PROCESS_T0 = time.perf_counter()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    bench = load_benchmark()
    cell = find_cell(bench, args.workload)[0]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"[perfbench] {args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"[perfbench] loaded in this process: {found} (the benchmark must load none of "
              f"{FORBIDDEN})", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0
