"""The rank side of the data- and tensor-parallel measurements on the
card: tasks run by every rank of a multi-process run
(``parallel/launch.py::run_ranks`` or ``torchrun``), each task writing
what the rank computed and measured into ``<out>/<task>_rank<r>.pt``.
``chip_smoke.py``'s phases ``parallel`` and ``parallel_nccl`` start the
ranks and hold them to one process's run of the same weights and inputs,
made with this module's functions.

    python -m meshanything_tpu_torch.tools.parallel_probe TASKS OUT [--backend B] [--graph]
    python -m meshanything_tpu_torch.tools.parallel_probe cli OUT -- CLI_ARGS

The weights are ``init_random_params`` from seed 0 at the full 350M
width; the depths are this module's constants. TASKS is a comma-separated
list, run in this order in one process (one start-up for all):

  dp     a (world, 1) mesh: ``generate`` of the global batch in
         ``<out>/inputs.npy`` (one row a rank, DP_FACES) in every tier of
         ``TIERS``, the decode replayed as graphs (no collective inside
         it); the gathered tokens, a rank's seconds a tier, the launches;
  tp     a (1, world) mesh, TP_FACES: the first decode step's logits of
         ``<out>/inputs.npy``'s first row, its decode (tokens, ms a step)
         and lookahead 8 (the bf16 window kernel), eager, or with
         ``--graph`` replayed as CUDA graphs (NCCL only) and then run
         eagerly too, on the same local module (the tokens the replays
         must equal); eager, also a clocked decode of CLOCKED_STEPS steps
         (the share of a step inside all-reduce calls); tokens, launches;
  tiers  a (1, world) mesh, the decoder alone on one process's condition
         of the first row (``decoder_condition``), in each tier of
         ``TP_TIERS`` (``--tiers`` picks some) at its TIER_FACES: the first
         decode step's logits, the decode or lookahead (tokens, ms a step
         or a window forward, all-reduce calls a step), eager or with
         ``--graph`` replayed and then run eagerly too; in the int8/int4
         tiers the prefill's layer-0 K/V rows with the codes and scales the
         rank's cache holds for them (``prefill_rows``); launches a tier;
  dp_tp  a (world / 2, 2) mesh: ``generate`` of ``inputs.npy``'s first
         world / 2 rows (one a data group) in the ``--fast`` tier, DP_FACES,
         replayed with ``--graph``; tokens, seconds, launches;
  train  a (1, world) mesh, f32 master weights: TRAIN["steps"] sharded
         train steps on ``make_batch`` batches from seed 0; losses, grad
         norms, ms a step;
  train_dp_tp  the same over a (world / 2, 2) mesh.

``cli`` runs ``cli.main`` of the arguments after ``--`` (``--multihost``
under torchrun), with the launches counted around it. ``--backend`` picks
the process group (gloo for several ranks on one card: the
tensor-parallel decode then runs eagerly).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

# tier name -> generate's keywords: the exact tier, --fast, the int8 and int4
# caches and the megakernel (all under data parallelism: no collective)
TIERS = {"exact": {}, "fast": {"attn": "pallas_int8", "lookahead": 8, "wq": True},
         "int8": {"attn": "pallas_int8"}, "int4": {"attn": "pallas_int4"},
         "megakernel": {"attn": "megakernel"}}
BUCKET = 512
# depth cuts of the 350M model (its widths stay): 451 decode steps a dp row,
# 181 eager tp steps, the trainer's batches
DP_FACES = 50
TP_FACES = 20
TRAIN = {"faces": 100, "batch": 2, "seq": 256, "steps": 3}
TASKS = ("dp", "tp", "tiers", "dp_tp", "train", "train_dp_tp")
# the tiers that a model group runs beside the exact one (the tiers task):
# the int8 and int4 caches (K2, K3), --fast (the int8 K4 and W8A8) and K5
TP_TIERS = {"int8": TIERS["int8"], "int4": TIERS["int4"], "fast": TIERS["fast"],
            "megakernel": TIERS["megakernel"]}
# their depth cuts: an eager int8/int4 step over gloo makes ~72 all-reduces
# (1.3-1.8 ms each on one card), so the single-token quantized tiers run 91
# steps; the others 181 steps (lookahead: a window forward a few)
TIER_FACES = {"int8": 10, "int4": 10, "fast": 20, "megakernel": 20}
# decode steps of the tp task's clocked run (the clock synchronises the card
# at each all-reduce, which slows the eager step it measures: the ms a step
# come from a run without it)
CLOCKED_STEPS = 20


def wrappers() -> dict:
    """The kernels' wrappers, each counting its launches (``aln``: the
    residual add and post-LN)."""
    from meshanything_tpu_torch.ops import add_layer_norm as aln
    from meshanything_tpu_torch.ops import decode_attention as da
    from meshanything_tpu_torch.ops import megakernel as mk

    return {"k1": da.decode_attention, "k2": da.decode_attention_int8,
            "k3": da.decode_attention_int4, "k4": da.decode_attention_mq,
            "k5": mk.decode_step_megakernel, "aln": aln.add_layer_norm}


def zero_counts() -> None:
    from meshanything_tpu_torch.runtime.decode_graph import StepGraph

    w = wrappers()
    for fn in w.values():
        fn.launches = 0
    w["k4"].window_launches = w["k4"].quant_window_launches = 0
    StepGraph.captures = StepGraph.replays = 0


def read_counts() -> dict:
    from meshanything_tpu_torch.runtime.decode_graph import StepGraph

    w = wrappers()
    return {**{k: fn.launches for k, fn in w.items()}, "k4_window": w["k4"].window_launches,
            "k4_quant_window": w["k4"].quant_window_launches,
            "graph_captures": StepGraph.captures, "graph_replays": StepGraph.replays}


def config(faces: int):
    """The 350M config cut to ``faces`` (the weights do not depend on it)."""
    from meshanything_tpu_torch.config import MeshAnythingConfig

    return MeshAnythingConfig(n_max_triangles=faces)


def model_for(cfg, device, seed: int = 0, dtype=None):
    """The seeded random weights, the same in every process."""
    import torch

    from meshanything_tpu_torch.runtime.checkpoint import init_random_params

    generator = torch.Generator(device=device).manual_seed(seed)
    return init_random_params(cfg, generator, dtype or cfg.activation_dtype)


def _sync(device) -> None:
    import torch

    torch.cuda.synchronize(device)


def run_tiers(model, cfg, pc, mesh=None, tiers=TIERS) -> dict:
    """{tier: (tokens on the CPU, seconds)} of ``generate`` over ``pc``
    (the global batch; ``mesh``: data parallel), each synchronised."""
    import torch

    from meshanything_tpu_torch.models import meshanything as ma

    device = pc.device
    out = {}
    with torch.no_grad():
        for name, kw in tiers.items():
            _sync(device)
            t0 = time.perf_counter()
            tokens = ma.generate(model, cfg, pc, bucket=BUCKET, mesh=mesh, **kw).token_ids
            _sync(device)
            out[name] = (tokens.cpu(), time.perf_counter() - t0)
    return out


def first_step_logits(model, cfg, pc):
    """(prefill's last logits, the first decode step's logits), f32 on the
    CPU: encode, prefill and one eager step of the exact tier."""
    import torch

    from meshanything_tpu_torch.models import decoding
    from meshanything_tpu_torch.models import meshanything as ma
    from meshanything_tpu_torch.models import shape_opt as opt

    with torch.no_grad():
        _, cond = ma.encode(model, cfg, pc)
        state = opt.init_decode_state(model.opt, cfg.opt, cond,
                                      max_new_tokens=cfg.generate_length, bucket=BUCKET)
        first = decoding.decode_step(model.opt, cfg.opt, state)
    return state.tokens[:, 0].cpu(), first.float().cpu()


class AllReduceClock:
    """Seconds spent inside ``torch.distributed.all_reduce`` while active:
    the card is synchronised before each call, so a call's time is its
    own (the copies and the exchange), not the kernels queued before it.
    With ``timed=False`` it only counts the calls (and synchronises
    nothing)."""

    def __init__(self, timed: bool = True):
        self.seconds = 0.0
        self.calls = 0
        self.timed = timed

    def __enter__(self):
        import torch
        import torch.distributed as dist

        self._orig = dist.all_reduce

        def timed(tensor, *a, **kw):
            if not self.timed:
                self.calls += 1
                return self._orig(tensor, *a, **kw)
            if tensor.is_cuda:
                torch.cuda.synchronize(tensor.device)
            t0 = time.perf_counter()
            out = self._orig(tensor, *a, **kw)
            if tensor.is_cuda:
                torch.cuda.synchronize(tensor.device)
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out

        dist.all_reduce = timed
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.all_reduce = self._orig


def timed_decode(model, cfg, pc, *, graph: bool = False, clock=None,
                 max_steps=None) -> dict:
    """Encode, prefill, the single-token decode (eager, or with ``graph``
    replayed; at most ``max_steps`` steps) and detok of the exact tier:
    tokens, decode steps, decode seconds, and the all-reduce seconds and
    calls of ``clock`` inside the decode."""
    import torch

    from meshanything_tpu_torch.models import decoding
    from meshanything_tpu_torch.models import meshanything as ma
    from meshanything_tpu_torch.models import shape_opt as opt

    device = pc.device
    gl = cfg.generate_length
    with torch.no_grad():
        point_feature, cond = ma.encode(model, cfg, pc)
        state = opt.init_decode_state(model.opt, cfg.opt, cond, max_new_tokens=gl, bucket=BUCKET)
        steps0 = state.step
        end = gl if max_steps is None else min(gl, steps0 + max_steps)
        _sync(device)
        reduce0, calls0 = (clock.seconds, clock.calls) if clock else (0.0, 0)
        t0 = time.perf_counter()
        state = decoding.decode_loop(model.opt, cfg.opt, state, max_new_tokens=end, graph=graph)
        _sync(device)
        seconds = time.perf_counter() - t0
        coords = ma.detokenize(model, cfg, state.tokens, point_feature)
    return {"tokens": state.tokens.cpu(), "coords": coords.float().cpu(),
            "steps": state.step - steps0, "seconds": seconds,
            "allreduce_s": (clock.seconds - reduce0) if clock else 0.0,
            "allreduce_calls": (clock.calls - calls0) if clock else 0}


def lookahead_tokens(model, cfg, pc, graph: bool = False):
    """The lookahead-8 tokens of the exact tier (eager, or replayed)."""
    import torch

    from meshanything_tpu_torch.models import meshanything as ma

    with torch.no_grad():
        return ma.generate(model, cfg, pc, bucket=BUCKET, lookahead=8, graph=graph).token_ids.cpu()


def decoder_condition(model, cfg, pc):
    """One process's condition embeddings of ``pc`` (the full model's
    encode): the tiers task holds the decoder alone, on this condition."""
    import torch

    from meshanything_tpu_torch.models import meshanything as ma

    with torch.no_grad():
        return ma.encode(model, cfg, pc)[1]


def tier_first_logits(opt_p, ocfg, cond, kw: dict, gen_len: int):
    """The first decode step's f32 logits (on the CPU) of the tier of
    generate's keywords ``kw``, eager: the single-token step of its cache
    and matrices (--fast: int8 and W8A8; the megakernel: K5 on the whole
    decoder)."""
    import torch

    from meshanything_tpu_torch.models import decoding
    from meshanything_tpu_torch.models import shape_opt as opt
    from meshanything_tpu_torch.ops.wquant import quantize_opt_layers

    with torch.no_grad():
        state = opt.init_decode_state(opt_p, ocfg, cond, max_new_tokens=gen_len, bucket=BUCKET,
                                      attn=kw.get("attn", "pallas"))
        wq_layers = quantize_opt_layers(opt_p.layers) if kw.get("wq") else None
        return decoding.decode_step(opt_p, ocfg, state, wq_layers=wq_layers).float().cpu()


def tier_decode(opt_p, ocfg, cond, kw: dict, gen_len: int, *, graph: bool = False,
                counter=None) -> dict:
    """The tier's decode of ``cond`` to ``gen_len`` tokens: the single-token
    loop, or with ``kw["lookahead"]`` the window loop (eager, or with
    ``graph`` replayed; the megakernel is eager): tokens (CPU), units
    (decode steps, or window forwards with a live row), ran (the steps or
    forwards run: a window loop on the card runs up to CHECK_EVERY - 1
    no-op forwards past its last live one), seconds, and the all-reduce
    calls that ``counter`` (``AllReduceClock(timed=False)``) saw in it."""
    import torch

    from meshanything_tpu_torch.models import decoding
    from meshanything_tpu_torch.models import lookahead as la
    from meshanything_tpu_torch.models import shape_opt as opt
    from meshanything_tpu_torch.ops.decode_attention import decode_attention_mq
    from meshanything_tpu_torch.ops.wquant import quantize_opt_layers
    from meshanything_tpu_torch.runtime.decode_graph import StepGraph

    attn, window = kw.get("attn", "pallas"), kw.get("lookahead", 0)
    device = cond.device
    with torch.no_grad():
        wq_layers = quantize_opt_layers(opt_p.layers) if kw.get("wq") else None
        if window:
            state = la.init_lookahead_state(opt_p, ocfg, cond, max_new_tokens=gen_len,
                                            window=window, bucket=BUCKET, attn=attn)
        else:
            state = opt.init_decode_state(opt_p, ocfg, cond, max_new_tokens=gen_len,
                                          bucket=BUCKET, attn=attn)
        steps0 = state.step if not window else 0
        calls0 = counter.calls if counter else 0
        k4_0 = decode_attention_mq.launches
        replays0, captures0 = StepGraph.replays, StepGraph.captures
        _sync(device)
        t0 = time.perf_counter()
        if window:
            state = la.lookahead_segment(opt_p, ocfg, state, max_new_tokens=gen_len,
                                         wq_layers=wq_layers, graph=graph)
        else:
            state = decoding.decode_loop(opt_p, ocfg, state, max_new_tokens=gen_len,
                                         graph=graph, wq_layers=wq_layers)
        _sync(device)
        seconds = time.perf_counter() - t0
    tokens = state.tokens[:, :gen_len].cpu()
    units = ran = state.iters if window else state.step - steps0
    if window and device.type == "cuda":
        # an eager forward launches K4 once a layer; a replayed one is a replay, and
        # each capture followed one eager warm-up forward
        ran = (StepGraph.replays - replays0 + StepGraph.captures - captures0 if graph
               else (decode_attention_mq.launches - k4_0) // ocfg.num_layers)
    return {"tokens": tokens, "units": units, "ran": ran, "seconds": seconds,
            "allreduce_calls": (counter.calls - calls0) if counter else 0}


def prefill_rows(opt_p, ocfg, cond, attn: str, gen_len: int) -> dict:
    """The prefill's layer-0 K/V rows (the compact activations, before they
    are quantized; (2, B, C, the rank's width)) and the codes and scales
    that the tier's decode state holds for them, on the CPU: gathered over
    the ranks they must be one process's quantization of the gathered
    rows."""
    import torch

    from meshanything_tpu_torch.models import shape_opt as opt

    c = cond.shape[1]
    width = opt_p.layers[0].num_heads * ocfg.head_dim
    with torch.no_grad():
        compact = torch.empty((2, ocfg.num_layers, cond.shape[0], c, width), dtype=cond.dtype,
                              device=cond.device)
        opt.prefill(opt_p, ocfg, cond, compact)
        state = opt.init_decode_state(opt_p, ocfg, cond, max_new_tokens=gen_len, bucket=BUCKET,
                                      attn=attn)
        values, scales = state.kv
        return {"rows": compact[:, 0].cpu(), "codes": values[:, 0, :, :c].cpu(),
                "scales": scales[:, 0, :, 0, :c].cpu()}


def train_batches(cfg) -> list:
    """TRAIN's batches, ``make_batch`` from seed 0."""
    from meshanything_tpu_torch.training.train import make_batch

    rng = np.random.default_rng(0)
    return [make_batch(cfg, rng, batch=TRAIN["batch"], seq=TRAIN["seq"])
            for _ in range(TRAIN["steps"])]


def train_run(state, step_fn, batches, device) -> dict:
    """Losses, grad norms and host ms of each step (synchronised)."""
    out = {"loss": [], "grad_norm": [], "ms": []}
    for pc, ids, labels in batches:
        _sync(device)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, pc, ids, labels)
        loss = float(metrics["loss"])
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["loss"].append(loss)
        out["grad_norm"].append(float(metrics["grad_norm"]))
    return out


def _tp_task(model, pc, mesh, graph: bool) -> dict:
    import torch

    from meshanything_tpu_torch.parallel.mesh import shard_params

    cfg = config(TP_FACES)
    local = shard_params(mesh, model)
    row = pc[:1]
    res = {}
    zero_counts()
    res["prefill_token"], res["first_logits"] = first_step_logits(local, cfg, row)
    res["decode"] = timed_decode(local, cfg, row, graph=graph)
    res["lookahead"] = lookahead_tokens(local, cfg, row, graph=graph)
    res["counts"] = read_counts()
    # not counted: the eager twins of the replays, and the clocked run
    if graph:
        res["decode_eager"] = timed_decode(local, cfg, row)["tokens"]
        res["lookahead_eager"] = lookahead_tokens(local, cfg, row)
    else:       # the clock synchronises: nothing it wraps can be captured
        with AllReduceClock() as clock:
            res["clocked"] = timed_decode(local, cfg, row, clock=clock, max_steps=CLOCKED_STEPS)
    del local
    torch.cuda.empty_cache()
    return res


def _tiers_task(model, pc, mesh, graph: bool, tiers) -> dict:
    """The tiers task (module docstring): one record a tier."""
    import torch

    from meshanything_tpu_torch.parallel.mesh import shard_params

    local = shard_params(mesh, model)
    cond = decoder_condition(model, config(max(TIER_FACES.values())), pc[:1])
    res = {}
    for tier in tiers:
        kw = TP_TIERS[tier]
        ocfg = config(TIER_FACES[tier])
        gl = ocfg.generate_length
        rec = {"faces": TIER_FACES[tier]}
        zero_counts()
        rec["first_logits"] = tier_first_logits(local.opt, ocfg.opt, cond, kw, gl)
        with AllReduceClock(timed=False) as counter:
            rec["decode"] = tier_decode(local.opt, ocfg.opt, cond, kw, gl, graph=graph,
                                        counter=counter)
        rec["counts"] = read_counts()
        # not counted: the eager twin of the replays, and the prefill's rows
        if graph and kw.get("attn") != "megakernel":
            rec["decode_eager"] = tier_decode(local.opt, ocfg.opt, cond, kw, gl)["tokens"]
        if kw.get("attn") in ("pallas_int8", "pallas_int4") and not kw.get("lookahead"):
            rec["prefill_rows"] = prefill_rows(local.opt, ocfg.opt, cond, kw["attn"], gl)
        res[tier] = rec
    del local
    torch.cuda.empty_cache()
    return {"tiers": res, "counts": _sum_tier_counts(res)}


def _sum_tier_counts(res: dict) -> dict:
    counts = [rec["counts"] for rec in res.values()]
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def _dp_tp_task(model, pc, mesh, graph: bool) -> dict:
    """The dp_tp task: --fast over a (world / 2, 2) mesh, one row a data group."""
    import torch

    from meshanything_tpu_torch.models import meshanything as ma
    from meshanything_tpu_torch.parallel.mesh import shard_params

    cfg = config(DP_FACES)
    local = shard_params(mesh, model)
    zero_counts()
    _sync(pc.device)
    t0 = time.perf_counter()
    with torch.no_grad():
        tokens = ma.generate(local, cfg, pc[:mesh.data], bucket=BUCKET, mesh=mesh, graph=graph,
                             **TIERS["fast"]).token_ids
    _sync(pc.device)
    res = {"tokens": tokens.cpu(), "seconds": time.perf_counter() - t0, "counts": read_counts()}
    del local
    torch.cuda.empty_cache()
    return res


def _train_task(device, mesh) -> dict:
    import torch

    from meshanything_tpu_torch.training.train import make_optimizer, make_sharded_train_step

    cfg = config(TRAIN["faces"])
    batches = train_batches(cfg)
    state, step_fn = make_sharded_train_step(mesh, cfg, model_for(cfg, device, 0, torch.float32),
                                             make_optimizer(1e-3, steps=100))
    torch.cuda.reset_peak_memory_stats(device)
    out = train_run(state, step_fn, batches, device)
    out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return {"train": out, "mesh": (mesh.data, mesh.model)}


def main(argv=None) -> None:
    import torch

    from meshanything_tpu_torch.parallel.mesh import create_mesh, join
    from meshanything_tpu_torch.parallel.multihost import process_info

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tasks", help=f"comma-separated, of {', '.join(TASKS)}; or cli")
    ap.add_argument("out")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    ap.add_argument("--graph", action="store_true",
                    help="tp, tiers, dp_tp: replay the decode as CUDA graphs (a collective "
                         "over NCCL)")
    ap.add_argument("--tiers", default=",".join(TP_TIERS),
                    help=f"the tiers task's tiers, comma-separated, of {', '.join(TP_TIERS)}")
    argv = sys.argv[1:] if argv is None else argv
    rest = []
    if "--" in argv:
        rest = argv[argv.index("--") + 1:]
        argv = argv[:argv.index("--")]
    args = ap.parse_args(argv)
    torch.set_grad_enabled(False)

    if args.tasks == "cli":
        from meshanything_tpu_torch import cli

        zero_counts()
        cli.main(rest)      # --multihost joins, splits the inputs and leaves the group
        res = {"counts": read_counts()}
        torch.save(res, os.path.join(args.out, f"cli_rank{os.environ.get('RANK', '0')}.pt"))
        return
    tasks = args.tasks.split(",")
    if not tasks or set(tasks) - set(TASKS):
        raise SystemExit(f"tasks {args.tasks!r}: a comma-separated list of {', '.join(TASKS)}")
    tiers = args.tiers.split(",")
    if set(tiers) - set(TP_TIERS):
        raise SystemExit(f"tiers {args.tiers!r}: a comma-separated list of {', '.join(TP_TIERS)}")

    device = join("cuda", args.backend)
    rank, world = process_info()
    model = pc = None
    if set(tasks) & {"dp", "tp", "tiers", "dp_tp"}:
        pc = torch.from_numpy(np.load(os.path.join(args.out, "inputs.npy"))).to(device)
        model = model_for(config(DP_FACES), device)
    for task in TASKS:
        if task not in tasks:
            continue
        t0 = time.perf_counter()
        if task == "dp":
            mesh = create_mesh(world, 1, device)
            zero_counts()
            res = {"tiers": run_tiers(model, config(DP_FACES), pc[:world], mesh),
                   "counts": read_counts()}
        elif task == "tp":
            res = _tp_task(model, pc, create_mesh(1, world, device), args.graph)
        elif task == "tiers":
            res = _tiers_task(model, pc, create_mesh(1, world, device), args.graph, tiers)
        elif task == "dp_tp":
            res = _dp_tp_task(model, pc, create_mesh(world // 2, 2, device), args.graph)
        else:
            model = None
            torch.cuda.empty_cache()
            shape = (1, world) if task == "train" else (world // 2, 2)
            res = _train_task(device, create_mesh(*shape, device))
        res.update(rank=rank, world=world, device=str(device),
                   backend=torch.distributed.get_backend(),
                   task_s=time.perf_counter() - t0)
        torch.save(res, os.path.join(args.out, f"{task}_rank{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
