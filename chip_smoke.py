#!/usr/bin/env python3
"""Smoke run of the PyTorch port (meshanything_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero:

  1. device: a CUDA card is required (no CPU fallback); then the canary:
     T5 (csrc/probes.cu, built alone in seconds) against its plain
     version, exact, before the slow builds start;
  2. build: K1 (csrc/decode_attention.cu), the bf16 K4
     (csrc/decode_attention_window.cu), K2, K3 and the other K4s
     (csrc/decode_attention_fast.cu), K5 (csrc/megakernel.cu) and T4
     (csrc/k1_probe.cu) are compiled with nvcc, all five at once;
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
     base - b), random window rows, the same poisoning past base[b]; the
     bf16 cache (the tensor-core kernel) also at W 1 and at base S - W,
     so that a base ends inside a tile, on a tile edge, at 1 and at the
     cache's end, and held to 1% of each head vector's largest element
     with no absolute allowance (WINDOW_RTOL);
  5a. a K1 call and a bf16 K4 call at B 1 and 16, each captured in a CUDA
     graph and replayed 20 times: every replay must equal the eager
     result bit for bit (the fold sums in split order and leaves its
     ticket counters at zero);
  6. K1-K4 and their plain versions timed with CUDA events at cur_len
     7459 / base 7450 (device time of CUDA-graph replays; K1 also eager),
     with the one PyTorch call that computes the same function where
     there is one (scaled_dot_product_attention for K1 and bf16 K4);
  7. K5, the whole decode step, against its plain version at the full
     350M width (L=24, D=1024, F=4096, S=7680; f32 and bf16 caches) on
     every compiled row group: B 1, 2 and 16 at cur_len 1, 257, 4000 and
     7459, B=4 (a partly filled group of 16) at 4000 and B=24 (two groups
     of 16, the second partly filled) at 7459: x_out and the written K/V
     rows within tolerance, NaN past cur_len in every layer never reaching
     the output, rows below write_pos unchanged; then K5, its plain
     version and the eager 24-layer K1 layer loop of the exact tier timed
     for the same step at B 1 and 16, cur_len 7459 and 300;
  7a. the measurement kernels (probe_check): T1-T3 against their plain
     versions on integer-valued random data, where the f32 sums are
     exact in any order (bf16 and int8, chunk 512 and 64, depth 2 and 4,
     start 0 and nchunks-1, rot both ways, one or two barriers a slot,
     arrays past 2^31 bytes, and the 4 GiB arrays that are timed); T4 at
     the production shapes and at the cur_len it is timed at: `full`
     bit-equal to K1 at B 1 and 16 with NaN past the live rows, every
     other mode against its plain version; then (probe_time) T1-T3 timed
     at 4 GiB, T4 per mode at B 1 and 16, T5 at (8, 128) and at 1 GiB,
     each beside its bound and the PyTorch call computing the same
     function, and roof_gbs, the best sustained read rate seen;
  7b. the measurement path through its entry points, with every count set
     to 0 before and read after: runtime/bwprobe, tools/dma_wire_probe
     (default at 4 GiB with `dual`, then `verify`), tools/pipe_compute_probe
     and tools/build_canary; each must launch its kernels and no other;
  8. the main path: the CLI at the full 350M width on seeded random bf16
     weights: the exact tier twice (K1; the B=1 run cut to 200 faces, the
     B=2 run to 400),
     then F1 --fast (K4 int8 + W8A8),
     F2 --attn pallas_int4 --lookahead adaptive (K4 int4), F3 --lookahead
     8 (K4 bf16), F4 --attn pallas_int8 (K2) and F5 --attn pallas_int4
     --wq (K3), and InferencePipeline(attn="megakernel") on the same two
     inputs (M1 B=1, M2 B=2 cut to 400 faces; K5); the OBJs must parse
     and each run must launch exactly its kernel, 24 times per decode step
     or window forward (K5: once a decode step), and no other kernel;
  9. agreement on a small input: the small config on the card (through
     the kernels) against the same weights on the CPU (plain versions),
     exact tier, fast tiers and megakernel, in f32: tokens and coordinates
     identical;
  10. floor and budget: bwprobe's least seconds a mesh at roof_gbs beside
     the measured exact and M1 runs; check_memory_budget's estimate, as the
     pipeline made it before allocating, beside the peak bytes that each
     run of phase 8 allocated (read from the card's allocator around the
     run), which it must not be below; then tools/memory_probe's peaks by
     phase at B=16 for the bf16, int8 and int4 caches, held to the same.

Before the last line it prints {"kernels": [...]} (K1-K5 and T1-T5, each
with its time, its plain version's, its byte or operation bound, its
share of the measured roof and the library call's time where there is
one) and the card's name and power limit; the last line is
{"ok": true, "device": {...}}.
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
# The tensor-core K4 has no f32 instance to be held tightly through, and at a
# long context its outputs are small (a mean of thousands of N(0, 1) rows:
# ~0.02), so an absolute 1e-2 would pass a dropped split. It is held to 1% of
# each head vector's largest |plain| element with no absolute allowance: room
# for one bf16 step of any element (at most 2^-7 of it), not for two.
WINDOW_RTOL = 1e-2
KERNEL_LIBS = ("decode_attention", "decode_attention_window", "decode_attention_fast",
               "megakernel", "k1_probe")
PROBE_GIB = 4                     # T1-T3 are timed on arrays of this size
PROBE_CUR = 7168                  # live rows T4 is timed at (the TPU tool's)
FFN = 4096                        # the 350M model's fc1 width
K5_TIME_LENS = (7459, 300)        # a long and a short context
# (batch, cur_lens) of the K5 checks: B 1 and 2 (the M1 and M2 runs) and 16
# are the kernel's three instances at full depth of cases; B=4 leaves 12 rows
# of a 16-row group empty, B=24 loops over two groups
K5_CHECKS = ((1, CUR_LENS), (2, CUR_LENS), (16, CUR_LENS), (4, (4000,)), (24, (7459,)))
# K5 against its plain version over 24 layers: the two sum each product in
# another order, so now and then a GEMV input rounds to the other bf16
# neighbour (0.4% of it), and the layers carry such flips on until the two
# differ like two bf16 runs of one model (0.02-0.05 on O(1) outputs on the
# H100). The same step over one layer (layer 0) has few flips to carry
# (at most 8e-4 in f32 at B=16); layer 0's written K/V rows have none and
# are held to TOL.
K5_TOL = {"float32": 6e-2, "bfloat16": 6e-2}
K5_ONE_LAYER_TOL = {"float32": 2e-3, "bfloat16": 1e-2}
HBM_BYTES_PER_S = 3.35e12         # H100 SXM, NVIDIA's data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "int8": 1979e12, "float32": 67e12}  # dense


def bound(moved_bytes: float, ops: float, kind: str) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the bytes over the
    HBM rate or the operations over the peak rate of their type."""
    by_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


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


def _close(out, plain, tol: float, by_vector: bool = False,
           atol: float | None = None) -> tuple[float, bool]:
    """(max |out - plain|, |out - plain| <= atol + tol * |plain| everywhere;
    atol defaults to tol). by_vector: |plain| is the largest magnitude along
    the last axis, for outputs that are undivided sums of thousands of
    terms, whose rounding grows with the sum's terms and not with the
    element it leaves, and for bf16 outputs held to bf16 steps of their
    vector's size."""
    diff = (out.float() - plain.float()).abs()
    scale = plain.float().abs()
    if by_vector:
        scale = scale.amax(dim=-1, keepdim=True)
    return diff.max().item(), bool((diff <= (tol if atol is None else atol) + tol * scale).all())


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
    plain, kernel, library, library, kernel, plain (``library``, the
    PyTorch call computing the same function, where given); ``eager_ms``
    is the sweep launched from Python."""
    graphs, eager = {}, {}
    for which, sweep in sweeps.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):   # warm-up off the capture
            sweep()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graphs[which] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[which], stream=side):   # the stream that warmed up
            sweep()
        eager[which] = _events_ms(torch, sweep, 4) / calls
    runs = {which: [] for which in sweeps}
    for which in ("plain", "kernel", "library", "library", "kernel", "plain"):
        if which in sweeps:
            runs[which].append(_events_ms(torch, graphs[which].replay, 10) / calls)
    out = {"ms": sum(runs["kernel"]) / 2, "plain_ms": sum(runs["plain"]) / 2,
           "kernel_runs_ms": runs["kernel"], "plain_runs_ms": runs["plain"],
           "eager_ms": eager["kernel"], "plain_eager_ms": eager["plain"]}
    if "library" in sweeps:
        out.update(library_ms=sum(runs["library"]) / 2, library_runs_ms=runs["library"])
    return out


def time_k1(torch, da, card: str) -> dict:
    """Phase 6 for K1: ms per call at cur_len 7459, cycling the 24 layers
    so that each call streams its rows from HBM as in the decode loop;
    the library call is scaled_dot_product_attention over the live rows
    (heads as a strided view of the cache)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(1)
    cur = 7459
    times = {}
    for batch in (1, 16):
        kv = torch.randn((2, L, batch, S, H * D), generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        q = torch.randn((batch, H, D), generator=gen, device="cuda", dtype=torch.bfloat16)
        heads = [tuple(kv[p, i, :, :cur].view(batch, cur, H, D).transpose(1, 2) for p in (0, 1))
                 for i in range(L)]
        sweeps = {which: (lambda fn=fn: [fn(q, kv, i, cur) for i in range(L)])
                  for which, fn in (("kernel", da.decode_attention),
                                    ("plain", da.decode_attention_reference))}
        sweeps["library"] = lambda: [sdpa(q[:, :, None], k, v) for k, v in heads]
        t = _time_sweeps(torch, sweeps, L)
        live_bytes = 2 * batch * cur * H * D * 2
        # each input read once (q, live rows), the output written once; 4 flops an element
        t["bound_ms"], t["bound_by"] = bound(live_bytes + 2 * q.numel() * 2,
                                             4 * batch * cur * H * D, "bfloat16")
        times[batch] = t
        emit("k1_time", batch=batch, cur_len=cur, dtype="bfloat16", **t,
             live_kv_bytes=live_bytes, kernel_gb_per_s=live_bytes / t["ms"] / 1e6, card=card)
        del kv, q, heads, sweeps
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


def check_k4(torch, da, kinds=("bfloat16", "float32", "int8", "int4")) -> dict:
    """Phase 5 over the caches ``kinds``; returns the largest error against
    the plain version of each of K4's two kernels ({"window": ..,
    "tile_split": ..})."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst, failures = {"window": 0.0, "tile_split": 0.0}, []
    for kind in kinds:
        qdtype = torch.float32 if kind == "float32" else torch.bfloat16
        tol = TOL["float32" if kind == "float32" else "bfloat16"]
        # the tensor-core kernel also at one query and at the cache's end
        windows = (1, *WINDOWS) if kind == "bfloat16" else WINDOWS
        for batch in (1, 16):
            kv, scales = _k4_cache(torch, gen, kind, batch)
            packed = kv.shape[-1]
            for w in windows:
                bases = (S - w, *BASES) if kind == "bfloat16" else BASES
                if w != windows[0]:      # fresh live rows: the last case poisoned them
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
                kernel = da.mq_kernel_for(kv.dtype, D)
                errs, rel_errs, oks = [], [], []
                for base0 in bases:
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
                    if kernel == "window":
                        err, within = _close(out, plain, WINDOW_RTOL, by_vector=True, atol=0.0)
                    else:
                        err, within = _close(out, plain, tol)
                    # the largest error as a share of its head vector's largest |plain|
                    rel_errs.append(((out.float() - plain.float()).abs()
                                     / plain.float().abs().amax(dim=-1, keepdim=True)).max().item())
                    ok = (within and bool(torch.isfinite(out).all())
                          and bool(torch.equal(out, poisoned)))
                    errs.append(err)
                    oks.append(ok)
                    if not ok:
                        failures.append((kind, batch, w, base0))
                worst[kernel] = max(worst[kernel], *errs)
                held = ({"atol": 0.0, "rtol": WINDOW_RTOL, "rtol_of": "head vector max |plain|"}
                        if kernel == "window" else {"atol": tol, "rtol": tol})
                emit("k4_check", cache=kind, batch=batch, window=w, query_dtype=str(qdtype)[6:],
                     kernel=kernel, bases_row0=list(bases), max_abs_err=errs,
                     max_err_over_vector_max=rel_errs, **held, ok=oks)
            del kv, scales
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"K4 disagrees with its plain version or reads past base: "
                             f"{failures}")
    return worst


def check_graph_replays(torch, da, replays: int = 20) -> None:
    """Phase 5a: K1 and the bf16 K4 fold their partials in the launch that
    made them, through ticket counters that persist between calls. One
    call of each at B 1 and 16 is captured in a CUDA graph and replayed:
    every replay must equal the eager call bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    failures = []
    for batch in (1, 16):
        kv = torch.randn((2, 2, batch, S, H * D), generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        q = torch.randn((batch, H, D), generator=gen, device="cuda", dtype=torch.bfloat16)
        qw = torch.randn((batch, 8, H, D), generator=gen, device="cuda", dtype=torch.bfloat16)
        win = torch.randn((2, batch, 8, H * D), generator=gen, device="cuda",
                          dtype=torch.bfloat16)
        base = (7450 - 37 * torch.arange(batch, device="cuda")).int()
        calls = {"k1": lambda: da.decode_attention(q, kv, 1, 7459),
                 "k4_bfloat16": lambda: da.decode_attention_mq(qw, kv, None, 1, base, win[0],
                                                               win[1])}
        for name, call in calls.items():
            want = call()               # eager
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):   # the capture stream's first call: its fold counters
                call()
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                out = call()
            same = []
            for _ in range(replays):
                graph.replay()
                torch.cuda.synchronize()
                same.append(bool(torch.equal(out, want)))
            again = bool(torch.equal(call(), want))   # and an eager call after the replays
            emit("graph_replay", kernel=name, batch=batch, replays=replays,
                 bit_equal=sum(same), eager_after_bit_equal=again, ok=all(same) and again)
            if not (all(same) and again):
                failures.append((name, batch))
            del graph, out
        del kv
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"graph replays differ from the eager call: {failures}")


def time_fast(torch, da, card: str) -> dict:
    """Phase 6 for K2, K3 and K4 (W=8): ms per call at cur_len 7459 /
    base 7450, cycling the 24 layers; GB/s of the live packed bytes (codes
    and scales, or bf16 values). bf16 K4's library call is
    scaled_dot_product_attention over cache rows [0, base + W) with the
    window's causal mask (the window rows in the cache, as the JAX
    package's XLA tier puts them)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
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
            if kind == "bfloat16":
                n = base0 + w
                heads = [tuple(kv[p, i, :, :n].view(batch, n, H, D).transpose(1, 2)
                               for p in (0, 1)) for i in range(L)]
                causal = (torch.arange(n, device="cuda")[None, :]
                          <= base0 + torch.arange(w, device="cuda")[:, None])
                qh = qw.transpose(1, 2)
                cases[-1][2]["library"] = lambda: [sdpa(qh, k, v, attn_mask=causal)
                                                   for k, v in heads]
            for name, rows, sweeps in cases:
                t = _time_sweeps(torch, sweeps, L)
                live_bytes = 2 * batch * rows * row_bytes
                queries = w if name.startswith("k4") else 1
                # the live rows (and a K4 window's rows) read once, q read and out written once
                moved = live_bytes + 2 * batch * (queries if queries > 1 else 0) * row_bytes
                moved += 2 * batch * queries * H * D * 2
                # query w of a window sees base + w + 1 rows; 4 operations a row element
                seen = rows if queries == 1 else queries * rows + queries * (queries + 1) // 2
                t["bound_ms"], t["bound_by"] = bound(
                    moved, 4 * batch * seen * H * D, "bfloat16" if kind == "bfloat16" else "int8")
                times.setdefault(name, {})[batch] = t
                emit("fast_time", kernel=name, batch=batch, rows=rows,
                     window=w if name.startswith("k4") else 1, query_dtype="bfloat16", **t,
                     live_bytes=live_bytes, kernel_gb_per_s=live_bytes / t["ms"] / 1e6, card=card)
            del kv, scales, win, cases, mq_args
            heads = None
            torch.cuda.empty_cache()
    return times


def _random_packed(torch, mk, gen):
    """K5's packed layers at the full width with seeded random values:
    bf16 matrices N(0, 0.02), biases N(0, 0.1), LayerNorm scales 1 + N(0, 0.1)."""
    d = H * D

    def mat(*shape):
        return (torch.randn(shape, generator=gen, device="cuda") * 0.02).bfloat16()

    def vec(width, base=0.0):
        return torch.randn((L, width), generator=gen, device="cuda") * 0.1 + base

    return mk.MegakernelLayers(
        qkv_w=mat(L, 3 * d, d), out_w=mat(L, d, d), fc1_w=mat(L, FFN, d), fc2_w=mat(L, d, FFN),
        qkv_b=vec(3 * d), out_b=vec(d), fc1_b=vec(FFN), fc2_b=vec(d), ln_attn_w=vec(d, 1.0),
        ln_attn_b=vec(d), ln_ffn_w=vec(d, 1.0), ln_ffn_b=vec(d))


def _fill_slices(torch, kv, seed: int, rows=None):
    """Fill each (plane, layer) slice of ``kv`` from its own seeded stream;
    with ``rows``, regenerate instead and return whether rows [0, rows) of
    every slice still hold those values."""
    gen = torch.Generator(device="cuda")
    same = True
    for plane in range(2):
        for layer in range(kv.shape[1]):
            gen.manual_seed(seed * 1000 + plane * 100 + layer)
            fresh = torch.randn(kv.shape[2:], generator=gen, device="cuda", dtype=kv.dtype)
            if rows is None:
                kv[plane, layer] = fresh
            else:
                same = same and torch.equal(kv[plane, layer, :, :rows], fresh[:, :rows])
    return same


def _one_layer_case(torch, mk, packed, x, kv, wp: int, cur: int, tol: float) -> dict:
    """K5 and its plain version over layer 0 alone, on a copy of kv's
    layer 0."""
    one = mk.MegakernelLayers(*(t[:1] for t in packed.tensors()))
    kv1 = kv[:, :1].clone()
    out = mk.decode_step_megakernel(x, one, kv1, wp, cur, num_heads=H)
    rows = kv1[:, :, :, wp].clone()
    plain = mk.decode_step_megakernel_reference(x, one, kv1, wp, cur, num_heads=H)
    err, within = _close(out, plain, tol)
    row_err, rows_within = _close(rows, kv1[:, :, :, wp], tol)
    return {"one_layer_max_abs_err": err, "one_layer_kv_row_max_abs_err": row_err,
            "one_layer_ok": within and rows_within}


def check_k5(torch, mk) -> float:
    """Phase 7 (checks); returns the largest error of x_out against the
    plain version over the 24 layers."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    packed = _random_packed(torch, mk, gen)
    worst, failures = 0.0, []
    for batch, cur_lens in K5_CHECKS:
        for name in ("float32", "bfloat16"):
            dtype = getattr(torch, name)
            tol = K5_TOL[name]
            seed = 10 * batch + (name == "bfloat16")
            kv = torch.empty((2, L, batch, S, H * D), dtype=dtype, device="cuda")
            _fill_slices(torch, kv, seed)
            x = torch.randn((batch, H * D), generator=gen, device="cuda").to(dtype)
            for cur in cur_lens:
                wp = cur - 1
                out = mk.decode_step_megakernel(x, packed, kv, wp, cur, num_heads=H)
                kv[:, :, :, cur:] = float("nan")
                poisoned = mk.decode_step_megakernel(x, packed, kv, wp, cur, num_heads=H)
                rows = kv[:, :, :, wp].clone()
                plain = mk.decode_step_megakernel_reference(x, packed, kv, wp, cur, num_heads=H)
                torch.cuda.synchronize()
                err, within = _close(out, plain, tol)
                row_err, rows_within = _close(rows, kv[:, :, :, wp], tol)
                row0_err, row0_within = _close(rows[:, 0], kv[:, 0, :, wp], TOL[name])
                finite = bool(torch.isfinite(out).all())
                tail_ok = bool(torch.equal(out, poisoned))
                unchanged = _fill_slices(torch, kv, seed, rows=wp)
                one = _one_layer_case(torch, mk, packed, x, kv, wp, cur,
                                      K5_ONE_LAYER_TOL[name])
                ok = (within and rows_within and row0_within and finite and tail_ok
                      and unchanged and one["one_layer_ok"])
                worst = max(worst, err)
                emit("k5_check", batch=batch, row_group=mk.row_group(batch), dtype=name,
                     cur_len=cur, max_abs_err=err,
                     kv_row_max_abs_err=row_err, atol=tol, rtol=tol,
                     layer0_kv_row_max_abs_err=row0_err,
                     one_layer_tol=K5_ONE_LAYER_TOL[name], **one,
                     finite=finite, nan_tail_unchanged=tail_ok,
                     rows_below_write_pos_unchanged=unchanged,
                     plane_stride_bytes=kv[0].numel() * kv.element_size(), ok=ok)
                if not ok:
                    failures.append((batch, name, cur))
            del kv, x
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"K5 disagrees with its plain version: {failures}")
    return worst


def time_k5(torch, mk, da, card: str) -> dict:
    """Phase 7 (times): one decode step's layer stack on seeded random bf16
    layers and a bf16 cache, as K5, as its plain version, and as the
    exact tier's eager loop of 24 layers (linear, K/V row write, K1,
    after_attention, as ``shape_opt.decode_step`` runs them), each timed
    with CUDA events around launches from Python, in the order plain, K5,
    K1 loop, K1 loop, K5, plain. Returns {(batch, cur_len): times}."""
    from meshanything_tpu_torch.config import ShapeOPTConfig
    from meshanything_tpu_torch.models.layers import lin
    from meshanything_tpu_torch.models.shape_opt import OPTLayer

    torch.manual_seed(6)
    cfg = ShapeOPTConfig()
    layers = torch.nn.ModuleList(OPTLayer(cfg, device="cuda", dtype=torch.bfloat16)
                                 for _ in range(L))
    packed = mk.pack_megakernel_layers(layers)
    weight_bytes = sum(t.numel() * t.element_size() for t in packed.tensors())
    gen = torch.Generator(device="cuda").manual_seed(7)
    times = {}
    for batch in (1, 16):
        kv = torch.randn((2, L, batch, S, H * D), generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        x = torch.randn((batch, H * D), generator=gen, device="cuda").bfloat16()
        for cur in K5_TIME_LENS:
            wp = cur - 1

            def k1_loop(x=x, wp=wp, cur=cur):
                h = x
                for i, layer in enumerate(layers):
                    q, k, v = lin(h, layer.qkv).chunk(3, dim=-1)
                    kv[0, i, :, wp] = k
                    kv[1, i, :, wp] = v
                    o = da.decode_attention(q.reshape(batch, H, D).contiguous(), kv, i, cur)
                    h = layer.after_attention(h, o.reshape(batch, H * D))
                return h

            runs = {
                "kernel": lambda: mk.decode_step_megakernel(x, packed, kv, wp, cur, num_heads=H),
                "plain": lambda: mk.decode_step_megakernel_reference(x, packed, kv, wp, cur,
                                                                     num_heads=H),
                "k1_loop": k1_loop}
            iters = {"kernel": 20, "plain": 3, "k1_loop": 10}
            for which, run in runs.items():   # warm-up
                run()
            torch.cuda.synchronize()
            got = {which: [] for which in runs}
            for which in ("plain", "kernel", "k1_loop", "k1_loop", "kernel", "plain"):
                got[which].append(_events_ms(torch, runs[which], iters[which]))
            kv_bytes = 2 * L * batch * cur * H * D * 2          # live rows read
            moved = weight_bytes + kv_bytes + 2 * L * batch * H * D * 2 + 2 * x.numel() * 2
            ops = 2 * batch * sum(packed.tensors()[i].numel() for i in range(4))
            ops += 4 * L * batch * cur * H * D
            t = {"ms": sum(got["kernel"]) / 2, "plain_ms": sum(got["plain"]) / 2,
                 "k1_loop_ms": sum(got["k1_loop"]) / 2, "kernel_runs_ms": got["kernel"],
                 "plain_runs_ms": got["plain"], "k1_loop_runs_ms": got["k1_loop"]}
            t["bound_ms"], t["bound_by"] = bound(moved, ops, "bfloat16")
            times[(batch, cur)] = t
            emit("k5_time", batch=batch, cur_len=cur, dtype="bfloat16", **t,
                 weight_bytes=weight_bytes, live_kv_bytes=kv_bytes,
                 kernel_gb_per_s=moved / t["ms"] / 1e6, card=card)
        del kv, x
        torch.cuda.empty_cache()
    del layers, packed
    torch.cuda.empty_cache()
    return times


def _stream_cases(torch, pr, x0, x1, chunk: int, depth: int) -> dict:
    """T1-T3 on (x0, x1) against their plain versions -> {kernel: [abs errors]}."""
    nchunks = x0.shape[0] // chunk
    errs = {"t1": [], "t2": [], "t3": []}

    def err(got, want):
        return (got - want).abs().item()

    errs["t1"].append(err(pr.stream(x0, chunk, depth), pr.stream_reference(x0, chunk)))
    for start in (0, nchunks - 1):
        for rot in (True, False):
            errs["t2"].append(err(pr.stream_rot(x0, start, chunk, depth, rot),
                                  pr.stream_rot_reference(x0, start, chunk)))
    for nsem in (1, 2):
        errs["t3"].append(err(pr.dual_stream(x0, x1, chunk, depth, nsem),
                              pr.dual_stream_reference(x0, x1, chunk)))
    torch.cuda.synchronize()
    return errs


def check_streams(torch, pr) -> dict:
    """Phase 7a for T1-T3 on rows of random integers in [-8, 8], whose f32
    sums are exact in any order: every sum must equal its plain
    version's exactly. Returns the largest error per kernel (0.0)."""
    from meshanything_tpu_torch.tools.dma_wire_probe import integer_rows
    worst = {"t1": 0.0, "t2": 0.0, "t3": 0.0}
    failures = []
    cases = [(name, 32768, chunk, depth) for name in ("bfloat16", "int8")
             for chunk in (512, 64) for depth in (2, 4)]
    # past 2^31 bytes: a 32-bit byte offset would wrap onto other chunks
    cases += [("int8", 2 ** 21 + 1024, 512, 2), ("bfloat16", 2 ** 20 + 1024, 512, 2)]
    # the arrays that time_streams and the tools time, at their chunk and depth
    cases += [("bfloat16", PROBE_GIB * 2 ** 30 // (H * D * 2), 512, 2),
              ("int8", PROBE_GIB * 2 ** 30 // (H * D), 512, 2)]
    for seed, (name, rows, chunk, depth) in enumerate(cases):
        dtype = getattr(torch, name)
        x0 = integer_rows(torch, rows, dtype, "cuda", 100 + 2 * seed)
        x1 = integer_rows(torch, rows, dtype, "cuda", 101 + 2 * seed)
        errs = _stream_cases(torch, pr, x0, x1, chunk, depth)
        ok = all(e == 0.0 for es in errs.values() for e in es)
        for key, es in errs.items():
            worst[key] = max(worst[key], *es)
        emit("probe_check", kernels="t1-t3", dtype=name, rows=rows, chunk=chunk, depth=depth,
             array_bytes=x0.numel() * x0.element_size(), abs_err=errs, tolerance=0.0, ok=ok)
        if not ok:
            failures.append((name, rows, chunk, depth))
        del x0, x1
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"T1-T3 disagree with their plain versions: {failures}")
    return worst


def check_k1_probe(torch, kp, da) -> float:
    """Phase 7a for T4 at the production shapes: ``full`` equals K1 bit
    for bit, NaN past cur_len and in every other layer never reaches any
    mode's output, and every other mode is within tolerance of its plain
    version run over the kernel's own context splits (the modes that
    return the undivided accumulator: relative to the head vector's
    largest magnitude). Returns the largest
    error of the (B, H, D) outputs."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst, failures = 0.0, []
    for batch in (1, 16):
        for name in ("float32", "bfloat16"):
            dtype = getattr(torch, name)
            kv = torch.full((2, L, batch, S, H * D), float("nan"), dtype=dtype, device="cuda")
            kv[:, LAYER] = torch.randn((2, batch, S, H * D), generator=gen, device="cuda",
                                       dtype=dtype) * 0.3
            q = torch.randn((batch, H, D), generator=gen, device="cuda", dtype=dtype)
            tile = kp.K1_TILE[dtype]
            # descending, with the cur_len that every mode is timed at
            for cur in sorted({*CUR_LENS, PROBE_CUR}, reverse=True):
                kv[:, LAYER, :, cur:] = float("nan")
                full = kp.k1_probe(q, kv, LAYER, cur, chunk=tile, mode="full")
                bit_equal = bool(torch.equal(full, da.decode_attention(q, kv, LAYER, cur)))
                errs, ok = {}, bit_equal and bool(torch.isfinite(full).all())
                for mode in kp.MODES[1:]:
                    nsplit, _ = kp.k1_probe_plan(batch, cur, sms, mode, tile)
                    got = kp.k1_probe(q, kv, LAYER, cur, chunk=tile, mode=mode)
                    want = kp.k1_probe_reference(q, kv, LAYER, cur, chunk=tile, mode=mode,
                                                 nsplit=nsplit)
                    if mode == "no_combine":     # f32 partials whatever q's dtype
                        pairs, tol = list(zip(got, want)), TOL["float32"]
                    else:
                        pairs, tol = [(got, want)], TOL[name]
                    # tap, tap_rows, qk, softmax and pv return the accumulator undivided, and
                    # so does no_combine in o_part (its other tensor holds m and l)
                    undivided = mode in ("tap", "tap_rows", "qk", "softmax", "pv", "no_combine")
                    close = [_close(a, b, tol, by_vector=undivided and i == 0)
                             for i, (a, b) in enumerate(pairs)]
                    errs[mode] = max(e for e, _ in close)
                    ok = ok and all(w for _, w in close) and all(
                        bool(torch.isfinite(a).all()) for a, _ in pairs)
                    if mode != "no_combine":
                        worst = max(worst, errs[mode])
                torch.cuda.synchronize()
                emit("probe_check", kernels="t4", batch=batch, dtype=name, cur_len=cur,
                     full_bit_equal_to_k1=bit_equal, max_abs_err=errs, atol=TOL[name],
                     rtol=TOL[name], partials_tol=TOL["float32"],
                     rtol_of={"tap, tap_rows, qk, softmax, pv, o_part of no_combine":
                              "largest |plain| of the head vector",
                              "other modes": "|plain| of the element"}, ok=ok)
                if not ok:
                    failures.append((batch, name, cur))
            del kv, q
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"T4 disagrees with K1 or with its plain version: {failures}")
    return worst


def _time_calls(torch, runs: dict, iters: int) -> dict:
    """ms a call of each of ``runs`` (``kernel``, ``plain`` and, where
    given, ``library``): device time between two CUDA events around
    ``iters`` launches from Python (each call here takes about a
    millisecond, so the host keeps ahead), in the order plain, kernel,
    library, library, kernel, plain."""
    for run in runs.values():     # warm-up: the first launches after a pause run slower
        for _ in range(3):
            run()
    torch.cuda.synchronize()
    got = {which: [] for which in runs}
    for which in ("plain", "kernel", "library", "library", "kernel", "plain"):
        if which in runs:
            got[which].append(_events_ms(torch, runs[which], iters))
    out = {"ms": sum(got["kernel"]) / 2, "plain_ms": sum(got["plain"]) / 2,
           "kernel_runs_ms": got["kernel"], "plain_runs_ms": got["plain"]}
    if "library" in runs:
        out.update(library_ms=sum(got["library"]) / 2, library_runs_ms=got["library"])
    return out


def time_streams(torch, pr, card: str) -> tuple[dict, float]:
    """Phase 7a (times) for T1-T3 at PROBE_GIB GiB, chunk 512, depth 2:
    ({kernel: times}, roof_gbs). The library calls are
    ``torch.sum(x, dtype=float32)`` and a device-to-device ``copy_``;
    roof_gbs is the best sustained rate of T1-T3, ``torch.sum`` and
    ``copy_`` (its reads and writes counted), over both dtypes."""
    from meshanything_tpu_torch.tools.dma_wire_probe import integer_rows

    chunk, iters = 512, 8
    times, rates = {}, {}
    for name in ("bfloat16", "int8"):
        dtype = getattr(torch, name)
        rows = PROBE_GIB * 2 ** 30 // (H * D * torch.empty((), dtype=dtype).element_size())
        nbytes = PROBE_GIB * 2 ** 30
        nchunks = rows // chunk
        x = integer_rows(torch, rows, dtype, "cuda", 200)
        y = torch.empty_like(x)
        calls = {"n": 0}

        def numbered(fn):
            def run():
                calls["n"] += 1
                return fn(calls["n"])
            return run

        t = _time_calls(torch, {"kernel": lambda: pr.stream(x, chunk),
                                "plain": lambda: pr.stream_reference(x, chunk),
                                "library": lambda: torch.sum(x, dtype=torch.float32)}, iters)
        t["copy_ms"] = _events_ms(torch, lambda: y.copy_(x), iters)
        t["depth4_ms"] = _events_ms(torch, lambda: pr.stream(x, chunk, 4), iters)
        t["chunk64_ms"] = _events_ms(torch, lambda: pr.stream(x, 64), iters)
        t["bound_ms"], t["bound_by"] = bound(nbytes + 4, rows // chunk, "float32")
        rates[name] = {"t1": nbytes / t["ms"] / 1e6, "torch_sum": nbytes / t["library_ms"] / 1e6,
                       "copy": 2 * nbytes / t["copy_ms"] / 1e6}
        times.setdefault("t1", {})[name] = t
        emit("probe_time", kernel="t1", dtype=name, bytes=nbytes, chunk=chunk, depth=2, **t,
             gb_per_s=rates[name], card=card)

        t2 = _time_calls(torch, {
            "kernel": numbered(lambda i: pr.stream_rot(x, i % nchunks, chunk)),
            "plain": numbered(lambda i: pr.stream_rot_reference(x, i % nchunks, chunk)),
            "library": lambda: torch.sum(x, dtype=torch.float32)}, iters)
        t2["seeded_ms"] = _events_ms(torch, numbered(
            lambda i: pr.stream_rot(x, i, chunk, rot=False)), iters)
        t2["invariant_ms"] = t["ms"]
        t2["bound_ms"], t2["bound_by"] = t["bound_ms"], t["bound_by"]
        times.setdefault("t2", {})[name] = t2
        emit("probe_time", kernel="t2", dtype=name, bytes=nbytes, chunk=chunk, depth=2, **t2,
             gb_per_s={"rotated": nbytes / t2["ms"] / 1e6,
                       "seeded": nbytes / t2["seeded_ms"] / 1e6,
                       "invariant": nbytes / t["ms"] / 1e6}, card=card)

        if name == "bfloat16":   # two separate allocations, as K1's K and V planes lie apart
            y.copy_(x)
            t3 = _time_calls(torch, {
                "kernel": lambda: pr.dual_stream(x, y, chunk, 2, 1),
                "plain": lambda: pr.dual_stream_reference(x, y, chunk),
                "library": lambda: (torch.sum(x, dtype=torch.float32)
                                    + torch.sum(y, dtype=torch.float32))}, iters)
            t3["nsem2_ms"] = _events_ms(torch, lambda: pr.dual_stream(x, y, chunk, 2, 2), iters)
            t3["nsem2_depth4_ms"] = _events_ms(torch, lambda: pr.dual_stream(x, y, chunk, 4, 2),
                                               iters)
            t3["bound_ms"], t3["bound_by"] = bound(2 * nbytes + 4, 2 * rows // chunk, "float32")
            times["t3"] = {name: t3}
            emit("probe_time", kernel="t3", dtype=name, bytes=2 * nbytes, chunk=chunk, **t3,
                 gb_per_s={"nsem1_depth2": 2 * nbytes / t3["ms"] / 1e6,
                           "nsem2_depth2": 2 * nbytes / t3["nsem2_ms"] / 1e6,
                           "nsem2_depth4": 2 * nbytes / t3["nsem2_depth4_ms"] / 1e6,
                           "single_stream": nbytes / t["ms"] / 1e6}, card=card)
        del x, y
        torch.cuda.empty_cache()
    rates["bfloat16"].update(t2_rotated=PROBE_GIB * 2 ** 30 / times["t2"]["bfloat16"]["ms"] / 1e6,
                             t3_dual=2 * PROBE_GIB * 2 ** 30 / times["t3"]["bfloat16"]["ms"] / 1e6)
    roof = max(rate for by_dtype in rates.values() for rate in by_dtype.values())
    emit("roof", roof_gbs=roof, data_sheet_gbs=HBM_BYTES_PER_S / 1e9,
         share_of_data_sheet=roof / (HBM_BYTES_PER_S / 1e9), gb_per_s=rates, card=card)
    return times, roof


def time_k1_probe(torch, kp, da, card: str) -> dict:
    """Phase 7a (times) for T4: every mode at cur_len PROBE_CUR, bf16, B 1
    and 16, cycling the 24 layers (CUDA-graph replays between CUDA
    events); ``full`` beside its plain version and
    scaled_dot_product_attention. Returns {batch: times}."""
    from meshanything_tpu_torch.runtime.bwprobe import time_loop

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(9)
    cur, tile = PROBE_CUR, kp.K1_TILE[torch.bfloat16]
    times = {}
    for batch in (1, 16):
        kv = torch.empty((2, L, batch, S, H * D), dtype=torch.bfloat16, device="cuda")
        kv.normal_(0.0, 0.3, generator=gen)
        q = torch.randn((batch, H, D), generator=gen, device="cuda", dtype=torch.bfloat16)
        heads = [tuple(kv[p, i, :, :cur].view(batch, cur, H, D).transpose(1, 2) for p in (0, 1))
                 for i in range(L)]

        def probe_sweep(mode):
            return lambda: [kp.k1_probe(q, kv, i, cur, chunk=tile, mode=mode) for i in range(L)]

        t = _time_sweeps(torch, {
            "kernel": probe_sweep("full"),
            "plain": lambda: [kp.k1_probe_reference(q, kv, i, cur, chunk=tile, mode="full")
                              for i in range(L)],
            "library": lambda: [sdpa(q[:, :, None], k, v) for k, v in heads]}, L)
        live_bytes = 2 * batch * cur * H * D * 2
        t["bound_ms"], t["bound_by"] = bound(live_bytes + 2 * q.numel() * 2,
                                             4 * batch * cur * H * D, "bfloat16")
        device = torch.device("cuda")
        modes = {"full": t["ms"]}
        for mode in kp.MODES[1:]:
            modes[mode] = time_loop(probe_sweep(mode), 10, device, graph=True) * 1e3 / (10 * L)
        t["k1_ms"] = time_loop(lambda: [da.decode_attention(q, kv, i, cur) for i in range(L)],
                               10, device, graph=True) * 1e3 / (10 * L)
        t["mode_ms"] = modes
        times[batch] = t
        emit("probe_time", kernel="t4", batch=batch, cur_len=cur, dtype="bfloat16", **t,
             live_kv_bytes=live_bytes,
             mode_gb_per_s={m: live_bytes / ms / 1e6 for m, ms in modes.items()}, card=card)
        del kv, q, heads
        torch.cuda.empty_cache()
    return times


def time_canary(torch, pr, card: str) -> dict:
    """Phase 7a (times) for T5 at (8, 128), where the launch bounds it
    (CUDA-graph replays of 24 calls), and at 1 GiB f32, where the bytes
    do; the library call is ``torch.add(c, x, alpha=2)``."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    c = torch.tensor(0.5, device="cuda")
    times = {}
    x = torch.randn((8, 128), generator=gen, device="cuda")

    def err(x):
        return (pr.scale_shift(x, 0.5) - pr.scale_shift_reference(x, 0.5)).abs().max().item()

    errs = {"small": err(x)}
    t = _time_sweeps(torch, {
        "kernel": lambda: [pr.scale_shift(x, 0.5) for _ in range(L)],
        "plain": lambda: [pr.scale_shift_reference(x, 0.5) for _ in range(L)],
        "library": lambda: [torch.add(c, x, alpha=2.0) for _ in range(L)]}, L)
    t["bound_ms"], t["bound_by"] = bound(2 * x.numel() * 4, 2 * x.numel(), "float32")
    times["small"] = t
    t["max_abs_err"] = errs["small"]
    emit("probe_time", kernel="t5", shape=[8, 128], **t, tolerance=0.0, card=card)
    x = torch.randn((2 ** 28,), generator=gen, device="cuda")
    errs["large"] = err(x)
    t = _time_calls(torch, {"kernel": lambda: pr.scale_shift(x, 0.5),
                            "plain": lambda: pr.scale_shift_reference(x, 0.5),
                            "library": lambda: torch.add(c, x, alpha=2.0)}, 8)
    t["bound_ms"], t["bound_by"] = bound(2 * x.numel() * 4, 2 * x.numel(), "float32")
    times["large"] = t
    t["max_abs_err"] = errs["large"]
    emit("probe_time", kernel="t5", shape=[2 ** 28], **t, tolerance=0.0,
         gb_per_s=2 * x.numel() * 4 / t["ms"] / 1e6, card=card)
    if max(errs.values()) != 0.0:
        raise AssertionError(f"T5 disagrees with its plain version: {errs}")
    return times


def drive_measurement_path(torch, wrappers: dict) -> dict:
    """Phase 7b: the measurement path through the entry points a user
    calls, each with every count set to 0 just before and read just
    after; each must launch the kernels named for it and no other.
    Returns the launches summed over the entries."""
    from meshanything_tpu_torch.runtime import bwprobe
    from meshanything_tpu_torch.tools import build_canary, dma_wire_probe, pipe_compute_probe

    entries = (
        ("build_canary", build_canary.main, [], {"t5"}),
        ("bwprobe", bwprobe.main, [], {"t5", "t1", "k1"}),
        ("dma_wire_probe", dma_wire_probe.main, [str(PROBE_GIB), "512", "dual"],
         {"t5", "t1", "t3"}),
        ("dma_wire_probe verify", dma_wire_probe.main, [str(PROBE_GIB), "512", "verify"],
         {"t5", "t1", "t2"}),
        ("pipe_compute_probe", pipe_compute_probe.main, [], {"t5", "t4", "k1"}),
    )
    total = {k: 0 for k in wrappers}
    for name, entry, argv, expected in entries:
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        rc = entry(argv)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        launches = {k: fn.launches for k, fn in wrappers.items()}
        emit("measurement_path", entry=name, argv=argv, rc=rc, launches=launches,
             wall_s=time.perf_counter() - t0)
        launched = {k for k, n in launches.items() if n}
        if rc != 0 or launched != expected:
            raise AssertionError(f"{name}: rc {rc}, launched {sorted(launched)}, expected "
                                 f"{sorted(expected)}")
        for k, n in launches.items():
            total[k] += n
    return total


def floors_and_budget(torch, runs: list, roof_gbs: float, card: str) -> None:
    """Phase 10: bwprobe's least seconds a mesh at the measured roof beside
    the measured runs, and check_memory_budget's estimate (as the pipeline
    made it before allocating) beside the peak bytes each run of phase 8
    allocated, its weights included: the estimate must not be below the
    peak. Then the memory probe's peaks by phase at B=16 over the bf16,
    int8 and int4 caches, the readings that the estimate's constants are
    set from."""
    from meshanything_tpu_torch.config import MeshAnythingConfig
    from meshanything_tpu_torch.runtime.bwprobe import decode_bytes, exact_floor_seconds
    from meshanything_tpu_torch.runtime.checkpoint import init_random_params
    from meshanything_tpu_torch.runtime.phases import device_limit_bytes
    from meshanything_tpu_torch.tools.memory_probe import phase_peaks

    by_name = {r["run"]: r for r in runs}
    full, cut = MeshAnythingConfig(dtype="bfloat16"), MeshAnythingConfig(dtype="bfloat16",
                                                                         n_max_triangles=200)
    emit("floor", roof_gbs=roof_gbs, decode_bytes=decode_bytes(full),
         exact_bf16_b1_s=exact_floor_seconds(full, roof_gbs, 1),
         exact_bf16_b16_s=exact_floor_seconds(full, roof_gbs, 16),
         int8_b16_s=exact_floor_seconds(full, roof_gbs, 16, int8=True),
         exact_bf16_b1_200_faces_s=exact_floor_seconds(cut, roof_gbs, 1),
         measured_exact_pc_200_faces_s=by_name["exact_pc"]["device_s_per_mesh"],
         measured_m1_s=by_name["M1"]["device_s_per_mesh"], card=card)

    failures = []
    for name, run in by_name.items():
        estimate, peak = run["budget_estimate_bytes"], run["peak_run_bytes"]
        emit("budget", run=name, argv=run["argv"], estimate_bytes=estimate,
             peak_run_bytes=peak, estimate_over_peak=estimate / peak,
             limit_bytes=device_limit_bytes(torch.device("cuda")), card=card)
        if estimate < peak:
            failures.append(name)
    if failures:
        raise AssertionError(f"the memory estimate is below the measured peak: {failures}")
    model = init_random_params(full, torch.Generator(device="cuda").manual_seed(0),
                               full.activation_dtype)
    for attn in ("pallas", "pallas_int8", "pallas_int4"):
        emit("budget", **phase_peaks(model, full, 16, attn), card=card)   # raises if below


def probe_kernel_entries(times: dict, launches: dict, worst: dict) -> list:
    """The ``kernels`` entries of T1-T5: the headline numbers are T1-T3 on
    4 GiB of bf16 (chunk 512, depth 2), T4 ``full`` at B=1 and T5 at
    (8, 128); the other sizes ride along under suffixed keys."""
    src = "meshanything_tpu_torch/csrc/"
    fields = ("ms", "plain_ms", "bound_ms", "library_ms")

    def entry(key, name, source, replaces, t, **more):
        return {"name": name, "route": "cuda", "source": src + source, "replaces": replaces,
                "launches": launches[key], "max_abs_err": worst[key],
                **{f: t[f] for f in fields}, "bound_by": t["bound_by"], **more}

    wire = "tools/dma_wire_probe.py:"
    t1, t2, t3 = times["t1"], times["t2"], times["t3"]["bfloat16"]
    t4, t5 = times["t4"], times["t5"]
    return [
        entry("t1", "stream", "probes.cu", wire + "44", t1["bfloat16"], bytes=PROBE_GIB * 2 ** 30,
              copy_ms=t1["bfloat16"]["copy_ms"], depth4_ms=t1["bfloat16"]["depth4_ms"],
              chunk64_ms=t1["bfloat16"]["chunk64_ms"],
              **{f"{f}_int8": t1["int8"][f] for f in fields}),
        entry("t2", "stream_rot", "probes.cu", wire + "92", t2["bfloat16"],
              bytes=PROBE_GIB * 2 ** 30, seeded_ms=t2["bfloat16"]["seeded_ms"],
              invariant_ms=t2["bfloat16"]["invariant_ms"],
              **{f"{f}_int8": t2["int8"][f] for f in fields}),
        entry("t3", "dual_stream", "probes.cu", wire + "256", t3, bytes=2 * PROBE_GIB * 2 ** 30,
              nsem2_ms=t3["nsem2_ms"], nsem2_depth4_ms=t3["nsem2_depth4_ms"]),
        entry("t4", "k1_probe", "k1_probe.cu", "tools/pipe_compute_probe.py:57", t4[1],
              cur_len=PROBE_CUR, mode_ms=t4[1]["mode_ms"], k1_ms=t4[1]["k1_ms"],
              **{f"{f}_b16": t4[16][f] for f in fields}, mode_ms_b16=t4[16]["mode_ms"],
              k1_ms_b16=t4[16]["k1_ms"]),
        entry("t5", "scale_shift", "probes.cu", "tools/xla_cpu_crash_repro.py:86", t5["small"],
              shape=[8, 128], **{f"{f}_1gib": t5["large"][f] for f in fields}),
    ]


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


def pipeline_run(torch, input_type: str, paths: list, batch_size: int, out_dir: str,
                 **cfg_kw):
    """InferencePipeline(attn="megakernel") as a user calls it, on the
    full 350M config with seeded random bf16 weights (seed 0, as the
    CLI's --random_weights) -> a callable returning its result records."""
    def run():
        from meshanything_tpu_torch.config import MeshAnythingConfig
        from meshanything_tpu_torch.runtime.checkpoint import init_random_params
        from meshanything_tpu_torch.runtime.pipeline import InferencePipeline, load_inputs

        cfg = MeshAnythingConfig(dtype="bfloat16", **cfg_kw)
        model = init_random_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                   cfg.activation_dtype)
        samples = load_inputs(input_type, paths, num_points=cfg.perceiver.num_points, seed=0)
        pipe = InferencePipeline(model, cfg, batch_size=batch_size, attn="megakernel")
        return pipe.run(samples, out_dir, seed=0)
    return run


def run_main_path(torch, wrappers: dict, load_obj, name: str, run, expect: int, kernel: str,
                  max_faces: int = 800, argv: list = ()) -> dict:
    """Phase 8: one run of the main path (``run``: the CLI with ``argv``,
    or the pipeline). Every kernel's count is set to 0 just before it and
    read just after: ``kernel`` must have launched 24 times per decode
    step (K1-K3) or per window forward (K4), or once per decode step
    (K5), and no other kernel at all. For phase 10 the peak of allocated
    bytes that a generation of the run reached is read from the card's
    allocator, above what was allocated before the run loaded its model
    (so the weights, and whatever the run keeps beside them, are in it).
    The peak is set back each time the pipeline makes its estimate, which
    it does with its model loaded, just before a batch allocates: what
    the loader held while it made the weights is not a generation's."""
    import gc

    from meshanything_tpu_torch.runtime import pipeline

    estimates, peaks = [], []
    check = pipeline.check_memory_budget

    def recording_check(*args, **kwargs):
        peaks.append(torch.cuda.max_memory_allocated())   # the batch before; first the loader's
        torch.cuda.reset_peak_memory_stats()
        estimates.append(check(*args, **kwargs))
        return estimates[-1]

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    for fn in wrappers.values():
        fn.launches = 0
    wrappers["k4"].window_launches = 0
    t0 = time.perf_counter()
    pipeline.check_memory_budget = recording_check
    try:
        results = run()
    finally:
        pipeline.check_memory_budget = check
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    peaks.append(torch.cuda.max_memory_allocated())
    peak = max(peaks[1:]) - base
    if len(results) != expect:
        raise AssertionError(f"{name}: {len(results)} results, expected {expect}")
    batches = {r["batch"]: r for r in results}
    steps = sum(r["decode_steps"] for r in batches.values())
    units = (sum(r["window_forwards"] for r in batches.values()) if kernel == "k4" else steps)
    per_unit = 1 if kernel == "k5" else L
    expected = {k: (per_unit * units if k == kernel else 0) for k in wrappers}
    if launches != expected or units == 0:
        raise AssertionError(f"{name}: launches {launches}, expected {expected}")
    # of K4's launches, those of the tensor-core kernel: all of them where the cache is
    # bf16 at the 350M head width (F3), none where it is quantized
    window = wrappers["k4"].window_launches
    if window != (launches["k4"] if name in WINDOW_KERNEL_RUNS else 0):
        raise AssertionError(f"{name}: {window} of {launches['k4']} K4 launches took the "
                             f"window kernel")
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
        "decode_steps": steps, "launches": launches, "k4_window_launches": window,
        "wall_s": wall,
        "device_s_per_mesh": sum(r["device_time_s"] for r in results) / len(results),
        "wall_s_per_mesh": wall / len(results),
        "decode_tokens_per_s": steps * batch_size / decode_s,
        "faces": [r["faces_final"] for r in results],
        "budget_estimate_bytes": max(estimates), "peak_run_bytes": peak,
    }
    if kernel == "k4":
        info["window_forwards"] = units
        info["mean_accept"] = [r["mean_accept"] for r in batches.values()]
        if "window_trace" in results[0]:
            info["window_trace"] = [list(t) for r in batches.values() for t in r["window_trace"]]
    emit("main_path", **info)
    return info


WINDOW_KERNEL_RUNS = ("F3",)      # the runs whose K4 is the bf16 tensor-core kernel


AGREEMENT_CASES = (
    ("exact", {}),
    ("pallas_int8", {"attn": "pallas_int8"}),
    ("pallas_int4", {"attn": "pallas_int4"}),
    ("lookahead4", {"lookahead": 4}),
    ("lookahead4_int8", {"lookahead": 4, "attn": "pallas_int8"}),
    ("lookahead4_int4", {"lookahead": 4, "attn": "pallas_int4"}),
    ("wq", {"wq": True}),
    ("megakernel", {"attn": "megakernel"}),
)


def small_input_agreement(torch) -> None:
    """Phase 9: small config, seeded weights, f32: the card (K1-K5) and
    the CPU (plain versions) give the same tokens and coordinates, in the
    exact tier, in each fast tier and in the megakernel tier."""
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
    from meshanything_tpu_torch.ops import k1_probe as kp
    from meshanything_tpu_torch.ops import megakernel as mk
    from meshanything_tpu_torch.ops import probes as pr
    from meshanything_tpu_torch.tools.build_canary import canary

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)   # as the pipeline runs the model
    card = card_line()
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda)
    # the canary first: nvcc, the architecture and a launch are proven in
    # seconds, before the slow builds start
    first = canary(torch.device("cuda"))
    emit("canary", **first, tolerance=0.0)

    with ThreadPoolExecutor(len(KERNEL_LIBS)) as pool:   # one nvcc per source, all at once
        libs = list(pool.map(_build.load, KERNEL_LIBS))
    for name, lib in zip(KERNEL_LIBS, libs):
        emit("build", kernel=name, built=lib.built, seconds=lib.seconds,
             ptxas=[ln for ln in lib.log.splitlines() if "registers" in ln or "spill" in ln])

    k4_worst = check_k4(torch, da)
    worst = {"k1": check_k1(torch, da), **check_k23(torch, da), "k4": k4_worst["tile_split"],
             "k4_window": k4_worst["window"]}
    check_graph_replays(torch, da)
    times = {"k1": time_k1(torch, da, card), **time_fast(torch, da, card)}
    worst["k5"] = check_k5(torch, mk)
    k5_times = time_k5(torch, mk, da, card)
    worst.update(check_streams(torch, pr), t4=check_k1_probe(torch, kp, da))
    probe_times, roof_gbs = time_streams(torch, pr, card)
    probe_times.update(t4=time_k1_probe(torch, kp, da, card), t5=time_canary(torch, pr, card))
    worst["t5"] = max(first["max_abs_err"],
                      *(t["max_abs_err"] for t in probe_times["t5"].values()))

    wrappers = {"k1": da.decode_attention, "k2": da.decode_attention_int8,
                "k3": da.decode_attention_int4, "k4": da.decode_attention_mq,
                "k5": mk.decode_step_megakernel, "t1": pr.stream, "t2": pr.stream_rot,
                "t3": pr.dual_stream, "t4": kp.k1_probe, "t5": pr.scale_shift}
    probe_launches = drive_measurement_path(torch, wrappers)

    def cli_run(argv):
        return lambda: cli.main(argv)

    with tempfile.TemporaryDirectory() as tmp:
        npy, mesh_dir = write_inputs(tmp)
        common = ["--out_dir", os.path.join(tmp, "out"), "--random_weights", "--seed", "0",
                  "--dtype", "bfloat16", "--device", "cuda"]
        pc = ["--input_type", "pc_normal", "--input_path", npy, *common]
        meshes = ["--input_type", "mesh", "--input_dir", mesh_dir, "--batchsize_per_gpu", "2",
                  *common]
        short = ["--n_max_triangles", "100"]
        cli_runs = [
            # depth cuts (200 faces, 1801 steps; 400 faces, 3601 steps) to keep the smoke
            # near half its time limit; M1 is the full-length B=1 run
            ("exact_pc", ["--n_max_triangles", "200", *pc], 1, "k1", 200),
            ("exact_meshes", ["--n_max_triangles", "400", *meshes], 2, "k1", 400),
            ("F1", ["--fast", *pc], 1, "k4", 800),
            ("F2", ["--attn", "pallas_int4", "--lookahead", "adaptive", *meshes], 2, "k4", 800),
            ("F3", ["--lookahead", "8", *pc], 1, "k4", 800),
            ("F4", ["--attn", "pallas_int8", *short, *pc], 1, "k2", 100),
            ("F5", ["--attn", "pallas_int4", "--wq", *short, *meshes], 2, "k3", 100),
        ]
        runs = [run_main_path(torch, wrappers, load_obj, name, cli_run(argv), expect, kernel,
                              max_faces=faces, argv=argv)
                for name, argv, expect, kernel, faces in cli_runs]
        # the megakernel path has no CLI flag (nor in the JAX CLI): its entry is the pipeline
        out = os.path.join(tmp, "out_megakernel")
        mesh_paths = [os.path.join(mesh_dir, n) for n in sorted(os.listdir(mesh_dir))]
        runs += [
            run_main_path(torch, wrappers, load_obj, "M1",
                          pipeline_run(torch, "pc_normal", [npy], 1, out), 1, "k5",
                          argv=["InferencePipeline(attn='megakernel')", "pc_normal", "B=1"]),
            # the same depth cut as exact_meshes
            run_main_path(torch, wrappers, load_obj, "M2",
                          pipeline_run(torch, "mesh", mesh_paths, 2, out, n_max_triangles=400),
                          2, "k5", max_faces=400,
                          argv=["InferencePipeline(attn='megakernel')", "mesh", "B=2",
                                "n_max_triangles=400"]),
        ]
    small_input_agreement(torch)
    floors_and_budget(torch, runs, roof_gbs, card)

    launches = {k: sum(r["launches"][k] for r in runs) for k in wrappers}
    window_launches = sum(r["k4_window_launches"] for r in runs)
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
                 "ms": t[1]["ms"], "plain_ms": t[1]["plain_ms"], "bound_ms": t[1]["bound_ms"],
                 "bound_by": t[1]["bound_by"], "library_ms": t[1].get("library_ms"),
                 "ms_b16": t[16]["ms"], "plain_ms_b16": t[16]["plain_ms"],
                 "bound_ms_b16": t[16]["bound_ms"], "library_ms_b16": t[16].get("library_ms")}
        if key == "k4":
            entry["window"] = 8
            entry["cache"] = "int8"
            entry["launches"] -= window_launches     # the other kernel's are in its own entry
            for b in (1, 16):
                for field in ("ms", "plain_ms", "bound_ms"):
                    entry[f"{field}_int4_b{b}"] = times["k4_int4"][b][field]
        kernels.append(entry)
    t = times["k4_bfloat16"]
    kernels.append({
        "name": "decode_attention_mq (bf16 cache, head width 64)", "route": "cuda",
        "source": src + "decode_attention_window.cu", "replaces": tpu + "98",
        "launches": window_launches, "max_abs_err": worst["k4_window"], "window": 8,
        "ms": t[1]["ms"], "plain_ms": t[1]["plain_ms"], "bound_ms": t[1]["bound_ms"],
        "bound_by": t[1]["bound_by"], "library_ms": t[1]["library_ms"],
        "ms_b16": t[16]["ms"], "plain_ms_b16": t[16]["plain_ms"],
        "bound_ms_b16": t[16]["bound_ms"], "library_ms_b16": t[16]["library_ms"]})
    t = k5_times
    kernels.append({
        "name": "decode_step_megakernel", "route": "cuda", "source": src + "megakernel.cu",
        "replaces": "meshanything_tpu/ops/megakernel.py:86", "launches": launches["k5"],
        "max_abs_err": worst["k5"], "ms": t[(1, 7459)]["ms"], "plain_ms": t[(1, 7459)]["plain_ms"],
        "bound_ms": t[(1, 7459)]["bound_ms"], "bound_by": t[(1, 7459)]["bound_by"],
        "library_ms": None, "cur_len": 7459,
        **{f"{field}_b{b}_len{n}": t[(b, n)][field] for b in (1, 16) for n in K5_TIME_LENS
           for field in ("ms", "plain_ms", "bound_ms", "k1_loop_ms")}})
    kernels[0]["launches_measurement_path"] = probe_launches["k1"]   # bwprobe and T4's check
    kernels += probe_kernel_entries(probe_times, probe_launches, worst)
    data_sheet_gbs = HBM_BYTES_PER_S / 1e9
    for entry in kernels:
        # the share of the measured roof that the kernel reaches: its byte bound, taken
        # at roof_gbs instead of the data sheet's rate, over its time
        for key in [k for k in entry if k == "ms" or k.startswith("ms_")]:
            bound_key = "bound_ms" + key[2:]
            if entry.get(bound_key) is not None and entry["bound_by"] == "bytes":
                entry["share_of_roof" + key[2:]] = (entry[bound_key] * data_sheet_gbs / roof_gbs
                                                    / entry[key])
    print(json.dumps({"kernels": kernels, "roof_gbs": roof_gbs,
                      "data_sheet_gbs": data_sheet_gbs}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
