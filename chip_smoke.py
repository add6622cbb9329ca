#!/usr/bin/env python3
"""Smoke run of the PyTorch port (meshanything_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero:

  1. device: a CUDA card is required (no CPU fallback);
  2. build: K1 (csrc/decode_attention.cu) and K2-K4
     (csrc/decode_attention_fast.cu) are compiled with nvcc, both at once;
  3. K1 against its plain PyTorch version at the production shapes
     (L=24, H=16, D=64, S=7680, layer 23; B 1 and 16; cur_len 1, 257,
     4000, 7459; f32 and bf16), with a NaN tail past cur_len and NaN in
     every other layer, which must not reach the output;
  4. K2 (int8) and K3 (int4) against their plain version at the same
     shapes with bf16 queries: NaN scales and garbage codes past cur_len
     and in the other 23 layers must not change the output (B=16 int8
     crosses the 2^31-byte K->V plane stride);
  5. K4 against its plain version over bf16, f32, int8 and int4 caches,
     B 1 and 16, W 4, 8 and 16, base 1, 256, 4000 and 7450 (row b gets
     base - b), random window rows, the same poisoning past base[b];
  6. K1-K4 and their plain versions timed with CUDA events at cur_len
     7459 / base 7450 (device time of CUDA-graph replays; K1 also eager);
  7. the main path: the CLI at the full 350M width on seeded random bf16
     weights: the exact tier twice (K1; the B=2 run cut to 400 faces),
     then F1 --fast (K4 int8 + W8A8),
     F2 --attn pallas_int4 --lookahead adaptive (K4 int4), F3 --lookahead
     8 (K4 bf16), F4 --attn pallas_int8 (K2) and F5 --attn pallas_int4
     --wq (K3); the OBJs must parse and each run must launch exactly its
     kernel, 24 times per decode step or window forward;
  8. agreement on a small input: the small config on the card (through
     the kernels) against the same weights on the CPU (plain versions),
     exact tier and fast tiers, in f32: tokens and coordinates identical.

Before the last line it prints {"kernels": [...]} and the card's name and
power limit; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
L, H, D, S, LAYER = 24, 16, 64, 7680, 23
CUR_LENS = (7459, 4000, 257, 1)   # descending: each case poisons the rows past it
BASES = (7450, 4000, 256, 1)
WINDOWS = (4, 8, 16)
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
KERNEL_LIBS = ("decode_attention", "decode_attention_fast")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check_k1(torch, da) -> float:
    """Phase 3; returns the largest error against the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    failures = []
    for batch in (1, 16):
        for name in ("float32", "bfloat16"):
            dtype = getattr(torch, name)
            kv = torch.full((2, L, batch, S, H * D), float("nan"), dtype=dtype, device="cuda")
            kv[:, LAYER] = torch.randn((2, batch, S, H * D), generator=gen, device="cuda",
                                       dtype=dtype)
            q = torch.randn((batch, H, D), generator=gen, device="cuda", dtype=dtype)
            plane_bytes = kv[0].numel() * kv.element_size()
            for cur in CUR_LENS:
                out = da.decode_attention(q, kv, LAYER, cur)
                kv[:, LAYER, :, cur:] = float("nan")
                poisoned = da.decode_attention(q, kv, LAYER, cur)
                plain = da.decode_attention_reference(q, kv, LAYER, cur)
                torch.cuda.synchronize()
                err = (out.float() - plain.float()).abs().max().item()
                tol = TOL[name]
                # |a - b| <= atol + rtol * |b| with atol = rtol = tol
                within = bool(((out.float() - plain.float()).abs()
                               <= tol + tol * plain.float().abs()).all())
                finite = bool(torch.isfinite(out).all())
                tail_ok = bool(torch.equal(out, poisoned))
                ok = within and finite and tail_ok
                worst = max(worst, err)
                emit("k1_check", batch=batch, dtype=name, cur_len=cur, max_abs_err=err,
                     atol=tol, rtol=tol, finite=finite, nan_tail_unchanged=tail_ok,
                     plane_stride_bytes=plane_bytes, ok=ok)
                if not ok:
                    failures.append((batch, name, cur))
            del kv, q
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"K1 disagrees with its plain version: {failures}")
    return worst


def _close(out, plain, tol: float) -> tuple[float, bool]:
    """(max |out - plain|, |out - plain| <= tol + tol * |plain| everywhere)."""
    diff = (out.float() - plain.float()).abs()
    return diff.max().item(), bool((diff <= tol + tol * plain.float().abs()).all())


def _events_ms(torch, run, iters: int) -> float:
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _time_sweeps(torch, sweeps: dict, calls: int) -> dict:
    """ms a call of each sweep (``calls`` calls, one per layer): device
    time of the sweep captured in one CUDA graph and replayed between two
    CUDA events, so the host's enqueue cost is not in it, in the order
    plain, kernel, kernel, plain; ``eager_ms`` is the sweep launched from
    Python."""
    graphs, eager = {}, {}
    for which, sweep in sweeps.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):   # warm-up off the capture
            sweep()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graphs[which] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[which]):
            sweep()
        eager[which] = _events_ms(torch, sweep, 4) / calls
    runs = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        runs[which].append(_events_ms(torch, graphs[which].replay, 10) / calls)
    return {"ms": sum(runs["kernel"]) / 2, "plain_ms": sum(runs["plain"]) / 2,
            "kernel_runs_ms": runs["kernel"], "plain_runs_ms": runs["plain"],
            "eager_ms": eager["kernel"], "plain_eager_ms": eager["plain"]}


def time_k1(torch, da, card: str) -> dict:
    """Phase 6 for K1: ms per call at cur_len 7459, cycling the 24 layers
    so that each call streams its rows from HBM as in the decode loop."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    cur = 7459
    times = {}
    for batch in (1, 16):
        kv = torch.randn((2, L, batch, S, H * D), generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        q = torch.randn((batch, H, D), generator=gen, device="cuda", dtype=torch.bfloat16)
        sweeps = {which: (lambda fn=fn: [fn(q, kv, i, cur) for i in range(L)])
                  for which, fn in (("kernel", da.decode_attention),
                                    ("plain", da.decode_attention_reference))}
        t = _time_sweeps(torch, sweeps, L)
        live_bytes = 2 * batch * cur * H * D * 2
        times[batch] = t
        emit("k1_time", batch=batch, cur_len=cur, dtype="bfloat16", **t,
             live_kv_bytes=live_bytes, kernel_gb_per_s=live_bytes / t["ms"] / 1e6, card=card)
        del kv, q
        torch.cuda.empty_cache()
    return times


def _quantized_cache(torch, gen, bits: int, batch: int, valid_layers=(LAYER,)):
    """Random codes in every layer (garbage outside ``valid_layers``),
    scales NaN outside ``valid_layers`` and in (1e-3, ~0.02] / (1e-3, ~0.3]
    inside, so values are O(1)."""
    hd = H * D
    if bits == 8:
        values = torch.randint(-127, 128, (2, L, batch, S, hd), generator=gen, device="cuda",
                               dtype=torch.int8)
    else:
        values = torch.randint(-2 ** 31, 2 ** 31 - 1, (2, L, batch, S, hd // 8), generator=gen,
                               device="cuda", dtype=torch.int32)
    scales = torch.full((2, L, batch, 1, S), float("nan"), device="cuda")
    top = 0.02 if bits == 8 else 0.3
    for layer in valid_layers:
        scales[:, layer] = torch.rand((2, batch, 1, S), generator=gen, device="cuda") * top + 1e-3
    return values, scales


def _garble(values, gen) -> None:
    """Overwrite cache codes in place with random ones."""
    if str(values.dtype) == "torch.int32":
        values.random_(-2 ** 31, 2 ** 31 - 1, generator=gen)
    else:
        values.random_(-127, 128, generator=gen)


def check_k23(torch, da) -> dict:
    """Phase 4; returns the largest error of K2 and K3 against the plain
    version."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst, failures = {}, []
    tol = TOL["bfloat16"]
    for name, bits, fn in (("k2", 8, da.decode_attention_int8), ("k3", 4, da.decode_attention_int4)):
        worst[name] = 0.0
        for batch in (1, 16):
            values, scales = _quantized_cache(torch, gen, bits, batch)
            q = torch.randn((batch, H, D), generator=gen, device="cuda").bfloat16()
            errs, oks = [], []
            for cur in CUR_LENS:
                out = fn(q, values, scales, LAYER, cur)
                scales[:, LAYER, :, :, cur:] = float("nan")
                _garble(values[:, LAYER, :, cur:], gen)
                poisoned = fn(q, values, scales, LAYER, cur)
                plain = da.decode_attention_quant_reference(q, values, scales, LAYER, cur)
                torch.cuda.synchronize()
                err, within = _close(out, plain, tol)
                ok = within and bool(torch.isfinite(out).all()) and bool(torch.equal(out, poisoned))
                errs.append(err)
                oks.append(ok)
                if not ok:
                    failures.append((name, batch, cur))
            worst[name] = max(worst[name], *errs)
            emit("k23_check", kernel=name, batch=batch, dtype="bfloat16", cur_lens=list(CUR_LENS),
                 max_abs_err=errs, atol=tol, rtol=tol, ok=oks,
                 plane_stride_bytes=values[0].numel() * values.element_size())
            del values, scales, q
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"K2/K3 disagree with their plain version or read past cur_len: "
                             f"{failures}")
    return worst


def _k4_cache(torch, gen, kind: str, batch: int):
    """(kv, scales) of one K4 cache kind (scales None for bf16/f32); every
    layer but LAYER is NaN (or NaN-scaled garbage)."""
    if kind in ("int8", "int4"):
        bits = 8 if kind == "int8" else 4
        kv, scales = _quantized_cache(torch, gen, bits, batch)
        return kv, scales
    dtype = getattr(torch, kind)
    kv = torch.full((2, L, batch, S, H * D), float("nan"), dtype=dtype, device="cuda")
    kv[:, LAYER] = torch.randn((2, batch, S, H * D), generator=gen, device="cuda", dtype=dtype)
    return kv, None


def check_k4(torch, da) -> float:
    """Phase 5; returns the largest error against the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst, failures = 0.0, []
    for kind in ("bfloat16", "float32", "int8", "int4"):
        qdtype = torch.float32 if kind == "float32" else torch.bfloat16
        tol = TOL["float32" if kind == "float32" else "bfloat16"]
        for batch in (1, 16):
            kv, scales = _k4_cache(torch, gen, kind, batch)
            packed = kv.shape[-1]
            for w in WINDOWS:
                if w != WINDOWS[0]:      # fresh live rows: the last case poisoned them
                    if scales is None:
                        kv[:, LAYER] = torch.randn(kv[:, LAYER].shape, generator=gen,
                                                   device="cuda", dtype=kv.dtype)
                    else:
                        top = 0.02 if kind == "int8" else 0.3
                        scales[:, LAYER] = torch.rand(scales[:, LAYER].shape, generator=gen,
                                                      device="cuda") * top + 1e-3
                q = torch.randn((batch, w, H, D), generator=gen, device="cuda").to(qdtype)
                win = torch.empty((2, batch, w, packed), dtype=kv.dtype, device="cuda")
                win_s = (None, None)
                if scales is None:
                    win.copy_(torch.randn(win.shape, generator=gen, device="cuda"))
                else:
                    _garble(win, gen)
                    win_s = tuple(torch.rand((batch, 1, w), generator=gen, device="cuda") * 0.02
                                  + 1e-3 for _ in range(2))
                errs, oks = [], []
                for base0 in BASES:
                    base = (base0 - torch.arange(batch, device="cuda")).clamp_min(1).int()
                    args = (q, kv, scales, LAYER, base, win[0], win[1], *win_s)
                    out = da.decode_attention_mq(*args)
                    for b, n in enumerate(base.tolist()):
                        if scales is None:
                            kv[:, LAYER, b, n:] = float("nan")
                        else:
                            scales[:, LAYER, b, :, n:] = float("nan")
                            _garble(kv[:, LAYER, b, n:], gen)
                    poisoned = da.decode_attention_mq(*args)
                    plain = da.decode_attention_mq_reference(*args, n_rows=base0)
                    torch.cuda.synchronize()
                    err, within = _close(out, plain, tol)
                    ok = (within and bool(torch.isfinite(out).all())
                          and bool(torch.equal(out, poisoned)))
                    errs.append(err)
                    oks.append(ok)
                    if not ok:
                        failures.append((kind, batch, w, base0))
                worst = max(worst, *errs)
                emit("k4_check", cache=kind, batch=batch, window=w, query_dtype=str(qdtype)[6:],
                     bases_row0=list(BASES), max_abs_err=errs, atol=tol, rtol=tol, ok=oks)
            del kv, scales
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"K4 disagrees with its plain version or reads past base: "
                             f"{failures}")
    return worst


def time_fast(torch, da, card: str) -> dict:
    """Phase 6 for K2, K3 and K4 (W=8): ms per call at cur_len 7459 /
    base 7450, cycling the 24 layers; GB/s of the live packed bytes (codes
    and scales, or bf16 values)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    cur, base0, w = 7459, 7450, 8
    times = {}
    for batch in (1, 16):
        q1 = torch.randn((batch, H, D), generator=gen, device="cuda").bfloat16()
        qw = torch.randn((batch, w, H, D), generator=gen, device="cuda").bfloat16()
        base = torch.full((batch,), base0, dtype=torch.int32, device="cuda")
        for kind in ("int8", "int4", "bfloat16"):
            if kind == "bfloat16":
                kv = torch.randn((2, L, batch, S, H * D), generator=gen, device="cuda",
                                 dtype=torch.bfloat16)
                scales, win_s = None, (None, None)
                win = torch.randn((2, batch, w, H * D), generator=gen, device="cuda",
                                  dtype=torch.bfloat16)
            else:
                kv, scales = _quantized_cache(torch, gen, 8 if kind == "int8" else 4, batch,
                                              valid_layers=range(L))
                win = torch.empty((2, batch, w, kv.shape[-1]), dtype=kv.dtype, device="cuda")
                _garble(win, gen)
                win_s = tuple(torch.rand((batch, 1, w), generator=gen, device="cuda") * 0.02
                              + 1e-3 for _ in range(2))
            row_bytes = kv.shape[-1] * kv.element_size() + (4 if scales is not None else 0)
            cases = []
            if kind != "bfloat16":
                single = da.decode_attention_int8 if kind == "int8" else da.decode_attention_int4
                cases.append(("k2" if kind == "int8" else "k3", cur, {
                    "kernel": lambda f=single: [f(q1, kv, scales, i, cur) for i in range(L)],
                    "plain": lambda: [da.decode_attention_quant_reference(q1, kv, scales, i, cur)
                                      for i in range(L)]}))
            mq_args = (kv, scales)
            cases.append((f"k4_{kind}", base0, {
                "kernel": lambda: [da.decode_attention_mq(qw, *mq_args, i, base, win[0], win[1],
                                                          *win_s) for i in range(L)],
                "plain": lambda: [da.decode_attention_mq_reference(
                    qw, *mq_args, i, base, win[0], win[1], *win_s, n_rows=base0)
                    for i in range(L)]}))
            for name, rows, sweeps in cases:
                t = _time_sweeps(torch, sweeps, L)
                live_bytes = 2 * batch * rows * row_bytes
                times.setdefault(name, {})[batch] = t
                emit("fast_time", kernel=name, batch=batch, rows=rows,
                     window=w if name.startswith("k4") else 1, query_dtype="bfloat16", **t,
                     live_bytes=live_bytes, kernel_gb_per_s=live_bytes / t["ms"] / 1e6, card=card)
            del kv, scales, win, cases, mq_args
            torch.cuda.empty_cache()
    return times


def write_inputs(tmp: str) -> tuple[str, str]:
    """A seeded 8192-point cloud with normals (.npy) and two small meshes."""
    import numpy as np

    from meshanything_tpu_torch.geometry import Mesh, save_obj

    rng = np.random.default_rng(0)
    n = rng.normal(size=(8192, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    pts = n * np.array([1.0, 0.6, 0.4])            # an ellipsoid's surface
    normals = n / np.array([1.0, 0.6, 0.4])
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    npy = os.path.join(tmp, "ellipsoid.npy")
    np.save(npy, np.concatenate([pts, normals], -1).astype(np.float32))

    mesh_dir = os.path.join(tmp, "meshes")
    os.makedirs(mesh_dir)
    cube_v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                       [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], float)
    cube_f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                       [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]])
    octa_v = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]], float)
    octa_f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                       [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]])
    save_obj(Mesh(cube_v, cube_f), os.path.join(mesh_dir, "cube.obj"))
    save_obj(Mesh(octa_v * rng.uniform(0.5, 1.5, 3), octa_f), os.path.join(mesh_dir, "octa.obj"))
    return npy, mesh_dir


def run_main_path(torch, da, cli, load_obj, name: str, argv: list, expect: int, kernel: str,
                  max_faces: int = 800) -> dict:
    """Phase 7: one CLI run. Every kernel's count is set to 0 just before
    it and read just after: ``kernel`` must have launched 24 times per
    decode step (K1-K3) or per window forward (K4), and no other kernel
    at all."""
    wrappers = {"k1": da.decode_attention, "k2": da.decode_attention_int8,
                "k3": da.decode_attention_int4, "k4": da.decode_attention_mq}
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    results = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    if len(results) != expect:
        raise AssertionError(f"{name}: {len(results)} results, expected {expect}")
    batches = {r["batch"]: r for r in results}
    steps = sum(r["decode_steps"] for r in batches.values())
    units = (sum(r["window_forwards"] for r in batches.values()) if kernel == "k4" else steps)
    expected = {k: (L * units if k == kernel else 0) for k in wrappers}
    if launches != expected or units == 0:
        raise AssertionError(f"{name}: launches {launches}, expected {expected}")
    for r in results:
        mesh = load_obj(r["obj_path"])
        if len(mesh.faces) and (mesh.faces.max() >= len(mesh.vertices)
                                or abs(mesh.vertices).max() > 0.5):
            raise AssertionError(f"{r['obj_path']}: malformed mesh")
        if not 0 < r["faces_generated"] <= max_faces:
            raise AssertionError(f"{r['obj_path']}: {r['faces_generated']} faces generated")
    batch_size = len(results) // len(batches)
    decode_s = sum(r["decode_s"] for r in batches.values())
    info = {
        "run": name, "argv": [a for a in argv if not a.startswith("/")], "meshes": len(results),
        "decode_steps": steps, "launches": launches, "wall_s": wall,
        "device_s_per_mesh": sum(r["device_time_s"] for r in results) / len(results),
        "wall_s_per_mesh": wall / len(results),
        "decode_tokens_per_s": steps * batch_size / decode_s,
        "faces": [r["faces_final"] for r in results],
    }
    if kernel == "k4":
        info["window_forwards"] = units
        info["mean_accept"] = [r["mean_accept"] for r in batches.values()]
        if "window_trace" in results[0]:
            info["window_trace"] = [list(t) for r in batches.values() for t in r["window_trace"]]
    emit("main_path", **info)
    return info


AGREEMENT_CASES = (
    ("exact", {}),
    ("pallas_int8", {"attn": "pallas_int8"}),
    ("pallas_int4", {"attn": "pallas_int4"}),
    ("lookahead4", {"lookahead": 4}),
    ("lookahead4_int8", {"lookahead": 4, "attn": "pallas_int8"}),
    ("lookahead4_int4", {"lookahead": 4, "attn": "pallas_int4"}),
    ("wq", {"wq": True}),
)


def small_input_agreement(torch) -> None:
    """Phase 8: small config, seeded weights, f32: the card (K1-K4) and
    the CPU (plain versions) give the same tokens and coordinates, in the
    exact tier and in each fast tier."""
    import copy

    from meshanything_tpu_torch.config import small_test_config
    from meshanything_tpu_torch.models import meshanything as ma
    from meshanything_tpu_torch.runtime.checkpoint import init_random_params

    cfg = small_test_config(n_max_triangles=8)
    model = init_random_params(cfg, torch.Generator().manual_seed(3), torch.float32)
    gpu_model = copy.deepcopy(model).cuda()
    pc = torch.randn((2, cfg.perceiver.num_points, 6), generator=torch.Generator().manual_seed(4))
    failures = []
    for name, kw in AGREEMENT_CASES:
        with torch.no_grad():
            cpu = ma.generate(model, cfg, pc, bucket=16, **kw)
            gpu = ma.generate(gpu_model, cfg, pc.cuda(), bucket=16, **kw)
        tokens_same = torch.equal(cpu.token_ids, gpu.token_ids.cpu())
        coords_same = torch.equal(torch.nan_to_num(cpu.face_coords, nan=-9.0),
                                  torch.nan_to_num(gpu.face_coords.cpu(), nan=-9.0))
        emit("small_input_agreement", case=name, tokens_identical=tokens_same,
             coords_identical=coords_same, shape=list(gpu.face_coords.shape))
        if not (tokens_same and coords_same):
            failures.append(name)
    if failures:
        raise AssertionError(f"the card and the CPU disagree on the small config: {failures}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from meshanything_tpu_torch import cli
    from meshanything_tpu_torch.geometry import load_obj
    from meshanything_tpu_torch.ops import _build
    from meshanything_tpu_torch.ops import decode_attention as da

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda)

    with ThreadPoolExecutor(len(KERNEL_LIBS)) as pool:   # one nvcc per source, all at once
        libs = list(pool.map(_build.load, KERNEL_LIBS))
    for name, lib in zip(KERNEL_LIBS, libs):
        emit("build", kernel=name, built=lib.built, seconds=lib.seconds,
             ptxas=[ln for ln in lib.log.splitlines() if "registers" in ln or "spill" in ln])

    worst = {"k1": check_k1(torch, da), **check_k23(torch, da), "k4": check_k4(torch, da)}
    times = {"k1": time_k1(torch, da, card), **time_fast(torch, da, card)}

    with tempfile.TemporaryDirectory() as tmp:
        npy, mesh_dir = write_inputs(tmp)
        common = ["--out_dir", os.path.join(tmp, "out"), "--random_weights", "--seed", "0",
                  "--dtype", "bfloat16", "--device", "cuda"]
        pc = ["--input_type", "pc_normal", "--input_path", npy, *common]
        meshes = ["--input_type", "mesh", "--input_dir", mesh_dir, "--batchsize_per_gpu", "2",
                  *common]
        short = ["--n_max_triangles", "100"]
        runs = [
            run_main_path(torch, da, cli, load_obj, "exact_pc", pc, 1, "k1"),
            # depth cut (400 faces, 3601 steps) to keep the smoke near half its time limit
            run_main_path(torch, da, cli, load_obj, "exact_meshes",
                          ["--n_max_triangles", "400", *meshes], 2, "k1", max_faces=400),
            run_main_path(torch, da, cli, load_obj, "F1", ["--fast", *pc], 1, "k4"),
            run_main_path(torch, da, cli, load_obj, "F2",
                          ["--attn", "pallas_int4", "--lookahead", "adaptive", *meshes], 2, "k4"),
            run_main_path(torch, da, cli, load_obj, "F3", ["--lookahead", "8", *pc], 1, "k4"),
            run_main_path(torch, da, cli, load_obj, "F4", ["--attn", "pallas_int8", *short, *pc],
                          1, "k2", max_faces=100),
            run_main_path(torch, da, cli, load_obj, "F5",
                          ["--attn", "pallas_int4", "--wq", *short, *meshes], 2, "k3",
                          max_faces=100),
        ]
    small_input_agreement(torch)

    launches = {k: sum(r["launches"][k] for r in runs) for k in ("k1", "k2", "k3", "k4")}
    src = "meshanything_tpu_torch/csrc/"
    tpu = "meshanything_tpu/ops/decode_attention.py:"
    rows = [("k1", "decode_attention", "decode_attention.cu", "567", times["k1"]),
            ("k2", "decode_attention_int8", "decode_attention_fast.cu", "900", times["k2"]),
            ("k3", "decode_attention_int4", "decode_attention_fast.cu", "951", times["k3"]),
            ("k4", "decode_attention_mq", "decode_attention_fast.cu", "98", times["k4_int8"])]
    kernels = []
    for key, name, source, line, t in rows:
        entry = {"name": name, "route": "cuda", "source": src + source, "replaces": tpu + line,
                 "launches": launches[key], "max_abs_err": worst[key],
                 "ms": t[1]["ms"], "plain_ms": t[1]["plain_ms"],
                 "ms_b16": t[16]["ms"], "plain_ms_b16": t[16]["plain_ms"]}
        if key == "k4":
            entry["window"] = 8
            entry["cache"] = "int8"
            for kind in ("int4", "bfloat16"):
                for b in (1, 16):
                    entry[f"ms_{kind}_b{b}"] = times[f"k4_{kind}"][b]["ms"]
                    entry[f"plain_ms_{kind}_b{b}"] = times[f"k4_{kind}"][b]["plain_ms"]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
