#!/usr/bin/env python3
"""Smoke run of the PyTorch port (meshanything_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--only phase,...]

With ``--only`` the device check, the canary and the builds run, then only
the phases named (``PHASES``), and the ``kernels`` line is not printed;
without it every phase runs.

Phases, each printing JSON lines; any failure exits non-zero:

  1. device: a CUDA card is required (no CPU fallback); then the canary:
     T5 (csrc/probes.cu, built alone in seconds) against its plain
     version, exact, before the slow builds start;
  2. build: K1 (csrc/decode_attention.cu), the tensor-core K4 over bf16,
     int8 and int4 caches (csrc/decode_attention_window.cu), K2 and K3
     (csrc/decode_attention_quant.cu), the other K4s
     (csrc/decode_attention_fast.cu), K5 (csrc/megakernel.cu), T4
     (csrc/k1_probe.cu) and the residual add and post-LN
     (csrc/add_layer_norm.cu) are compiled with nvcc, all seven at once;
  2a. add_ln: the residual add and post-LN kernel against its plain
     version (``ln(x + y, m)``) at (1, 1024), (16, 1024), (16, 8, 1024) and
     (2, 3, 64), bf16 (every element within one bf16 ulp, at least 99%
     identical) and f32 (within 2e-6 of the row's largest element), one
     launch a call; then timed at (1, 1024) and (16, 1024) bf16 over a
     step's 48 norm sites (device time of CUDA-graph replays) beside its
     byte bound, its plain version's time and F.layer_norm's on the sum
     (the library call, which the port does not make);
  3. K1 against its plain PyTorch version at the production shapes
     (L=24, H=16, D=64, S=7680, layer 23; B 1 and 16; cur_len 1, 257,
     4000, 7459; f32 and bf16), with a NaN tail past cur_len and NaN in
     every other layer, which must not reach the output;
  4. K2 (int8) and K3 (int4) against their plain version at the same
     shapes with f32 queries (held at 1e-5) and bf16 queries (held to 2%
     of each head vector's largest element, no absolute allowance:
     QUANT_RTOL, two bf16 steps, one for P's rounding): NaN scales and garbage codes past cur_len and in the
     other 23 layers must not change the output (B=16 int8 crosses the
     2^31-byte K->V plane stride);
  5. K4 against its plain version over bf16, f32, int8 and int4 caches
     (int8 and int4 with f32 and bf16 queries, held as K2 and K3), B 1 and
     16, W 4, 8 and 16, base 1, 256, 4000 and 7450 (row b gets base - b),
     random window rows, the same poisoning past base[b]; the tensor-core
     kernel (bf16 cache, and int8/int4 with bf16 queries) also at W 1 and
     at base S - W, so that a base ends inside a tile, on a tile edge, at 1
     and at the cache's end; over bf16 held to 1% of each head vector's
     largest element (WINDOW_RTOL: its P is not rounded);
  5a. a K1, a bf16 K4, a K2, a K3 and an int8 and an int4 K4 call at B 1
     and 16, each captured in a CUDA graph and replayed 20 times: every
     replay must equal the eager result bit for bit (the fold sums in
     split order and leaves its ticket counters at zero);
  5b. device_length: K1 (bf16 and f32), K2 and K3 called as the decode
     step calls them, the live length a 0-d int32 tensor that the kernel
     reads on the card and the grid planned for the whole cache, are
     bit-equal to the call planned for the length (an int) at every
     cur_len from 1 to 600 and one row either side of every tile edge up
     to S, at B 1, 2 and 16, and within tolerance of the plain version
     called with the device length; copies of the two sources that plan
     the splits from the bound instead (built beside the kernels) must
     fail that sweep;
  6. K1-K4 and their plain versions timed with CUDA events at cur_len
     7459 / base 7450 (device time of CUDA-graph replays; K1 also eager),
     with the one PyTorch call that computes the same function where
     there is one (scaled_dot_product_attention for K1 and bf16 K4); then
     K2, K3 and the int8/int4 K4 alone at B 1, 2 and 16, cur_len 7459 and
     300, W 8 and 16 (tools/attn_compare.py's quant_grid);
  7. K5, the whole decode step, against its plain version at the full
     350M width (L=24, D=1024, F=4096, S=7680; f32 and bf16 caches) on
     every compiled row group: B 1, 2 and 16 at cur_len 1, 257, 4000 and
     7459, B=4 (a partly filled group of 16) at 4000 and B=24 (two groups
     of 16, the second partly filled) at 7459: x_out and the written K/V
     rows within tolerance, NaN past cur_len in every layer never reaching
     the output, rows below write_pos unchanged; 20 more launches of one
     step at B 1 and 16 bit-equal to the first (the fold's split order);
     then K5, its plain version and the eager 24-layer K1 layer loop of
     the exact tier timed for the same step at B 1, 2, 4, 8 and 16,
     cur_len 7459 and 300;
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
     weights: the exact tier twice (K1; the B=1 run cut to 100 faces, the
     B=2 run to 400),
     then F1 --fast (K4 int8 + W8A8; 200 faces),
     F2 --attn pallas_int4 --lookahead adaptive (K4 int4; 200 faces), F3 --lookahead
     8 (K4 bf16), F4 --attn pallas_int8 (K2; 100 faces) and F5 --attn pallas_int4
     --wq (K3; 50 faces), and InferencePipeline(attn="megakernel") on the same two
     inputs (M1 B=1, M2 B=2 cut to 400 faces; K5); the OBJs must parse
     and each run must launch exactly its kernel, 24 times per decode step
     or window forward (K5: once a decode step), the residual add and
     post-LN kernel 48 times per step or forward (K5: never), and no other
     kernel, and return no error record; F3's K4 launches must all be the bf16
     tensor-core kernel's, F1's and F2's the int8/int4 one's. Every run
     but M1's and M2's decodes through CUDA-graph replays: the wrappers
     launch in each graph's warm-up step and capture (24 each, the add
     and post-LN 48), the graph
     does the rest, one replay a decode step or window forward;
  8a. graph_loop: the CLI runs of phase 8 but exact_meshes (its tier is
     exact_pc's) decode every batch a second time with the eager loop on
     the same model and input, and the two
     token streams must be identical (seconds a mesh of both, capture
     apart); a whole exact step at the full width captured and replayed
     20 times bit-equal to the same step run eagerly on a twin state, then
     traced over 24 replays (kernels a step, busy share); the sampled
     single-token and window loops on the small config, replayed against
     eager for one seed (``sampled_eager`` where the torch cannot register
     the generator); the exact tier at the full 800 faces, B=1, beside
     ``bwprobe.exact_floor_seconds``;
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
  11. serving (``serving_phase``): ServingEngine(batching=4) behind
     serve_http at the full 350M width, cut to 100 faces: four concurrent
     greedy requests coalesced into at most two batched decodes, each
     batch's tokens identical to InferencePipeline.generate on the same
     padded batch (each row alone at B=1: agreement reported); a sampled
     request twice with one seed (equal OBJs), an X-MC request, a
     completion whose stream starts with its prompt, a malformed body
     (400); a --fast engine (K4 int8, W8A8, lookahead 8) serving two
     concurrent requests; K1's and the int8 K4's launches and graph
     replays, the residual add and post-LN's (twice either's), and no
     other kernel's, counted per engine; then the CLI
     with --mc (B=2) and with --complete_from through phase 8's checks.
  12. train (``train_phase``): the trainer at the full 350M width on the
     face-grammar recipe (batch 4, lr 1e-3, k=5, one fixed batch): 100
     steps of run_training with the loss falling below half its first
     value, ms a step, positions a second, peak bytes and model FLOPs a
     second; the final checkpoint restored bit-equal, and the step-80
     checkpoint resumed to 100 bit-equal to the uninterrupted run; one step at
     7,459 positions (B=1, remat, SDPA); the trained weights in bf16
     through full_scale_probe (K1 and the bf16 K4, which must launch and
     whose graphs must replay, each counted apart, the add and post-LN
     twice as often as both together, and no other kernel):
     acceptance, agreement, seconds.
  13. checkpoint (``checkpoint_phase``): a 350M reference-format file
     (safetensors, bf16, the reference's key names and the unread
     ``embed_tokens``, written by the smoke's own writer) loaded onto the
     card (seconds, GB/s; the unread key named) and saved as a native
     checkpoint; then the CLI with --pretrained_weights and no
     --random_weights, 100 faces, through phase 8's checks: C_exact (K1),
     C_fast (--fast: the int8 K4), C_native (the native directory), whose
     tokens must be bit-equal to C_exact's.
  14. warm_start (``warm_start_phase``): main_torch.py in three processes
     (--precompile --aot_dir D with no input; then one input with D, which
     must build nothing and leave D as it was; then the same input with a
     fresh store, whose OBJ must equal the warm one's), each one's wall
     seconds and seconds to its first OBJ; in this process one
     PhaseRunner's greedy requests at B=1, B=2, B=1 capture 1, 1, 0 graphs
     and the third's tokens equal the first's and a fresh runner's; after
     precompile(1) a first request captures nothing, same tokens; a
     sampled pair with one seed on one runner equals a fresh runner's and
     the second captures nothing; a --fast ServingEngine's second request
     captures nothing. K1 and the int8 K4 launch, the add and post-LN
     twice as often, no other kernel.
  15. parallel (``parallel_phase``): K1 and the bf16 K4 at a tensor-parallel
     rank's 8 and 4 heads against their plain versions; then, as processes
     of their own on this card over gloo (``parallel/launch.py``,
     ``tools/parallel_probe.py``), at the full 350M width: a (2, 1) data-
     parallel generate in the exact tier, --fast, int8, int4 and the
     megakernel (50 faces), each rank's rows bit-equal to B=1 runs alone;
     a (1, 2) tensor-parallel eager decode (20 faces): first-step logits
     within TP_LOGIT_RTOL, greedy and lookahead-8 agreement at least
     TP_AGREEMENT_MIN, ms a step, all-reduce share; the (1, 2) sharded
     trainer (B=2, 256 tokens, 3 steps): losses within TRAIN_LOSS_RTOL and
     grad norms within TRAIN_GRAD_NORM_RTOL of one process's; the CLI with --multihost
     under torchrun (two ranks, four inputs, 20 faces), OBJs byte-equal to
     one process's. Each rank counts its launches; every kernel of the
     path must have launched.
  15a. parallel_nccl (``parallel_nccl_phase``): with two cards or more the
     DP and TP passes of phase 15 again over NCCL, one rank a card, the TP
     decode and lookahead captured as CUDA graphs, their tokens bit-equal to
     the same rank's eager runs; with one card a line says it did not run.
  16. recon (``recon_phase``): ``miche_cli`` at the full perceiver width on
     seeded random weights, ``--encode-only``, then the reconstruction at
     depth 7 (the occupancy bias set to minus the median logit of a first
     pass, printed), its fenced query and marching seconds, faces and peak
     bytes; a 10,000-query chunk card against CPU (RECON_CHUNK_TOL).
  17. diffusion (``diffusion_phase``): the CLIP ViT-L/14 and text towers at B
     1 and 2 (card against CPU, CLIP_TOL), the UDT's CFG forward eager and
     replayed, DDIM 50 steps twice bit-equal, Karras 32, image- and
     text-to-shape at B=1, ``sample_surface_torch`` against numpy. Neither
     phase may launch a kernel of K1-K5 / T1-T5.
  18. moonlight (``moonlight_phase``): the Moonlight decoder's kernels at
     its published widths against their plain versions: L1
     (csrc/latent_attention.cu) at B 1 and 2, cur_len 258 to 7459, NaN
     past the live rows, each case also with its first and then its last
     live row made to carry the heads' attention (a row read one too few
     or one too many moves the output whole), held to 1% of each head's
     largest plain element; X1 (csrc/experts.cu) at B 1 and 3, 6 chosen
     and 2 shared slots of 64 experts of 1,408, held to 1e-3 of the row's
     largest plain element, its counter and routing record exact. Then
     ``PhaseRunner.run`` on Moonlight-16B-A3B whole (``MoonlightConfig()``,
     seeded N(0, 0.02) weights, 30.6 GB) at 800 faces, every count set to
     0 just before: L1 27 and X1 26 calls in each graph's warm-up step and
     capture, no other kernel of the wrappers, and the replays covering
     the decode steps; the request's expert counter 6 a step in every MoE
     layer, the routing record equal to it.

Before the last line it prints {"kernels": [...]} (K1-K5 and T1-T5, each
with its launches on the main, checkpoint, serving and parallel paths and the train phase's decode, its time, its plain
version's, its byte or operation bound, its share of the measured roof
and the library call's time where there is one) and the card's name and
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
# The tensor-core K4 has no f32 instance to be held tightly through, and at a
# long context its outputs are small (a mean of thousands of N(0, 1) rows:
# ~0.02), so an absolute 1e-2 would pass a dropped split. It is held to 1% of
# each head vector's largest |plain| element with no absolute allowance: room
# for one bf16 step of any element (at most 2^-7 of it), not for two.
WINDOW_RTOL = 1e-2
# K2, K3 and the int8/int4 K4 with bf16 queries round P to bf16 before P.V (the
# TPU kernels' contract), and the kernel's exp and the plain version's differ in
# the last f32 bit, so a P element may round to the other bf16 neighbour: over
# a few rows that moves the output by up to one more bf16 step of its vector's
# largest element (1.06% measured on the H100 at one row and W=4). Two steps.
# (A dropped context split moves it by 15-160%; the f32-query cases are held
# at TOL["float32"].)
QUANT_RTOL = 2e-2
KERNEL_LIBS = ("decode_attention", "decode_attention_window", "decode_attention_quant",
               "decode_attention_fast", "megakernel", "k1_probe", "add_layer_norm",
               "latent_attention", "experts")
# the residual add and post-LN kernel: rows of the exact tier's step at B 1 and 16, a
# lookahead-8 window's at B=16, and a small 3-D input; timed over a step's 48 norm sites
ADD_LN_SHAPES = ((1, 1024), (16, 1024), (16, 8, 1024), (2, 3, 64))
ADD_LN_TIMED = ((1, 1024), (16, 1024))
ADD_LN_SITES = 48
ADD_LN_F32_ROW_RTOL = 2e-6        # f32: a few ulp of the row's largest element
ADD_LN_BF16_SAME_MIN = 0.99       # bf16: every element within one ulp, 99% identical
PROBE_GIB = 4                     # T1-T3 are timed on arrays of this size
PROBE_CUR = 7168                  # live rows T4 is timed at (the TPU tool's)
FFN = 4096                        # the 350M model's fc1 width
K5_TIME_LENS = (7459, 300)        # a long and a short context
K5_TIME_BATCHES = (1, 2, 4, 8, 16)   # B 4 and 8 run partly filled groups of 16
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
PEAK_OPS_PER_S = {"bfloat16": 989e12, "int8": 1979e12, "float32": 67e12,  # dense
                  "tf32": 495e12}


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
        # as the decode step calls it: the length on the device, the grid planned for S
        length = torch.tensor(cur, dtype=torch.int32, device="cuda")
        sweeps = {"kernel": lambda: [da.decode_attention(q, kv, i, length) for i in range(L)],
                  "plain": lambda: [da.decode_attention_reference(q, kv, i, cur)
                                    for i in range(L)]}
        sweeps["library"] = lambda: [sdpa(q[:, :, None], k, v) for k, v in heads]
        t = _time_sweeps(torch, sweeps, L)
        live_bytes = 2 * batch * cur * H * D * 2
        # each input read once (q, live rows), the output written once; 4 flops an element
        t["bound_ms"], t["bound_by"] = bound(live_bytes + 2 * q.numel() * 2,
                                             4 * batch * cur * H * D, "bfloat16")
        times[batch] = t
        emit("k1_time", batch=batch, cur_len=cur, cur_len_on_device=True, grid_planned_for=S,
             dtype="bfloat16", **t,
             live_kv_bytes=live_bytes, kernel_gb_per_s=live_bytes / t["ms"] / 1e6, card=card)
        del kv, q, heads, sweeps
        torch.cuda.empty_cache()
    return times


def _quantized_cache(torch, gen, bits: int, batch: int, valid_layers=(LAYER,), heads: int = H):
    """Random codes in every layer (garbage outside ``valid_layers``),
    scales NaN outside ``valid_layers`` and in (1e-3, ~0.02] / (1e-3, ~0.3]
    inside, so values are O(1); rows of ``heads`` heads."""
    hd = heads * D
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


def _held(out, plain, f32: bool, rtol: float = QUANT_RTOL) -> tuple[float, bool, dict]:
    """K2, K3 and K4 against their plain version: f32 queries at
    TOL["float32"] (the f32 instances: another summation order only), bf16
    queries by head vector at ``rtol`` with no absolute allowance (a long
    context's outputs are ~0.02, so a flat 1e-2 would pass a dropped
    split)."""
    if f32:
        tol = TOL["float32"]
        return (*_close(out, plain, tol), {"atol": tol, "rtol": tol})
    return (*_close(out, plain, rtol, by_vector=True, atol=0.0),
            {"atol": 0.0, "rtol": rtol, "rtol_of": "head vector max |plain|"})


def check_k23(torch, da) -> dict:
    """Phase 4 with f32 and bf16 queries; returns the largest error of K2
    and K3 against the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst, failures = {}, []
    for name, bits, fn in (("k2", 8, da.decode_attention_int8), ("k3", 4, da.decode_attention_int4)):
        worst[name] = 0.0
        for batch in (1, 16):
            for qdtype in (torch.float32, torch.bfloat16):
                values, scales = _quantized_cache(torch, gen, bits, batch)
                q = torch.randn((batch, H, D), generator=gen, device="cuda").to(qdtype)
                errs, oks = [], []
                for cur in CUR_LENS:
                    out = fn(q, values, scales, LAYER, cur)
                    scales[:, LAYER, :, :, cur:] = float("nan")
                    _garble(values[:, LAYER, :, cur:], gen)
                    poisoned = fn(q, values, scales, LAYER, cur)
                    plain = da.decode_attention_quant_reference(q, values, scales, LAYER, cur)
                    torch.cuda.synchronize()
                    err, within, held = _held(out, plain, qdtype == torch.float32)
                    ok = (within and bool(torch.isfinite(out).all())
                          and bool(torch.equal(out, poisoned)))
                    errs.append(err)
                    oks.append(ok)
                    if not ok:
                        failures.append((name, batch, str(qdtype)[6:], cur))
                worst[name] = max(worst[name], *errs)
                emit("k23_check", kernel=name, batch=batch, query_dtype=str(qdtype)[6:],
                     cur_lens=list(CUR_LENS), max_abs_err=errs, **held, ok=oks,
                     plane_stride_bytes=values[0].numel() * values.element_size())
                del values, scales, q
                torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"K2/K3 disagree with their plain version or read past cur_len: "
                             f"{failures}")
    return worst


KV_DTYPES = {"bfloat16": "bfloat16", "float32": "float32", "int8": "int8", "int4": "int32"}


def _add_ln_inputs(torch, gen, shape, dtype):
    """x, y of ``shape`` and a LayerNorm over the last dim with random
    weight and bias, on the card in ``dtype``."""
    d = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda") * 2.0 + 0.5
    y = torch.randn(shape, generator=gen, device="cuda")
    m = torch.nn.LayerNorm(d, eps=1e-5, device="cuda")
    m.weight.copy_(1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda"))
    m.bias.copy_(0.1 * torch.randn(d, generator=gen, device="cuda"))
    return x.to(dtype), y.to(dtype), m.to(dtype).requires_grad_(False)


def check_add_ln(torch, aln) -> float:
    """Phase add_ln, the check; returns the largest error against the
    plain version (in the output's units)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst, failures = 0.0, []
    for shape in ADD_LN_SHAPES:
        for name in ("bfloat16", "float32"):
            x, y, m = _add_ln_inputs(torch, gen, shape, getattr(torch, name))
            before = aln.add_layer_norm.launches
            out = aln.add_layer_norm(x, y, m)
            plain = aln.add_layer_norm_reference(x, y, m)
            torch.cuda.synchronize()
            diff = (out.float() - plain.float()).abs()
            same = (diff == 0).float().mean().item()
            if name == "bfloat16":
                _, exp = torch.frexp(plain.float().abs().clamp_min(
                    torch.finfo(torch.bfloat16).tiny))
                within = bool((diff <= torch.ldexp(torch.ones_like(diff), exp - 8)).all())
                ok = within and same >= ADD_LN_BF16_SAME_MIN
            else:
                row = plain.float().abs().amax(dim=-1, keepdim=True)
                within = bool((diff <= ADD_LN_F32_ROW_RTOL * row).all())
                ok = within
            ok = ok and aln.add_layer_norm.launches == before + 1
            worst = max(worst, diff.max().item())
            emit("add_ln_check", shape=list(shape), dtype=name, max_abs_err=diff.max().item(),
                 identical_share=same, within=within, ok=ok)
            if not ok:
                failures.append((shape, name))
    if failures:
        raise AssertionError(f"add_layer_norm disagrees with its plain version: {failures}")
    return worst


def time_add_ln(torch, aln, card: str) -> dict:
    """Phase add_ln, the timing: ms a call at each of ``ADD_LN_TIMED``
    (bf16), over a step's 48 norm sites, each with its own x, y and norm;
    the library call is F.layer_norm on the sum made beforehand."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    layer_norm = torch.nn.functional.layer_norm
    times = {}
    for shape in ADD_LN_TIMED:
        sites = [_add_ln_inputs(torch, gen, shape, torch.bfloat16) for _ in range(ADD_LN_SITES)]
        sums = [x + y for x, y, _ in sites]
        d = shape[-1]
        sweeps = {"kernel": lambda: [aln.add_layer_norm(x, y, m) for x, y, m in sites],
                  "plain": lambda: [aln.add_layer_norm_reference(x, y, m) for x, y, m in sites],
                  "library": lambda: [layer_norm(s, (d,), m.weight, m.bias, m.eps)
                                      for s, (_, _, m) in zip(sums, sites)]}
        t = _time_sweeps(torch, sweeps, ADD_LN_SITES)
        rows = sites[0][0].numel() // d
        # x and y read, the output written, weight and bias read once: 2 bytes an element;
        # ~8 f32 operations an element (add, two sums, the normalization's four)
        moved = 2 * (3 * rows * d + 2 * d)
        t["bound_ms"], t["bound_by"] = bound(moved, 8 * rows * d, "float32")
        times[rows] = t
        emit("add_ln_time", shape=list(shape), dtype="bfloat16", sites=ADD_LN_SITES, **t,
             bytes=moved, card=card)
        del sites, sums, sweeps
    return times


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
    the plain version of each of K4's kernels ({"window": ..,
    "window_quant": .., "tile_split": ..})."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst, failures = {"window": 0.0, "window_quant": 0.0, "tile_split": 0.0}, []
    # (cache, query dtype): the quantized caches with f32 queries too, held at
    # TOL["float32"]; every bf16 query by head vector (_held)
    cases = [(kind, qd) for kind in kinds
             for qd in ({"float32": (torch.float32,), "bfloat16": (torch.bfloat16,)}
                        .get(kind, (torch.float32, torch.bfloat16)))]
    for kind, qdtype in cases:
        kernel = da.mq_kernel_for(getattr(torch, KV_DTYPES[kind]), D, qdtype)
        # the tensor-core kernels also at one query and at the cache's end
        tensor_cores = kernel != "tile_split"
        windows = (1, *WINDOWS) if tensor_cores else WINDOWS
        for batch in (1, 16):
            kv, scales = _k4_cache(torch, gen, kind, batch)
            packed = kv.shape[-1]
            for w in windows:
                bases = (S - w, *BASES) if tensor_cores else BASES
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
                    err, within, held = _held(
                        out, plain, qdtype == torch.float32,
                        WINDOW_RTOL if kernel == "window" else QUANT_RTOL)
                    # the largest error as a share of its head vector's largest |plain|
                    rel_errs.append(((out.float() - plain.float()).abs()
                                     / plain.float().abs().amax(dim=-1, keepdim=True)).max().item())
                    ok = (within and bool(torch.isfinite(out).all())
                          and bool(torch.equal(out, poisoned)))
                    errs.append(err)
                    oks.append(ok)
                    if not ok:
                        failures.append((kind, str(qdtype)[6:], batch, w, base0))
                worst[kernel] = max(worst[kernel], *errs)
                emit("k4_check", cache=kind, batch=batch, window=w, query_dtype=str(qdtype)[6:],
                     kernel=kernel, bases_row0=list(bases), max_abs_err=errs,
                     max_err_over_vector_max=rel_errs, **held, ok=oks)
            del kv, scales
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"K4 disagrees with its plain version or reads past base: "
                             f"{failures}")
    return worst


def _replay_quant_cache(torch, gen, bits: int, batch: int):
    """A two-layer int8 or int4 cache, its scales and an 8-row window's
    codes and scales, for the graph replays."""
    hd = H * D if bits == 8 else H * D // 8
    dtype = torch.int8 if bits == 8 else torch.int32
    values = torch.empty((2, 2, batch, S, hd), dtype=dtype, device="cuda")
    win = torch.empty((2, batch, 8, hd), dtype=dtype, device="cuda")
    _garble(values, gen)
    _garble(win, gen)
    scales = torch.rand((2, 2, batch, 1, S), generator=gen, device="cuda") * 0.02 + 1e-3
    win_s = torch.rand((2, batch, 1, 8), generator=gen, device="cuda") * 0.02 + 1e-3
    return values, scales, win, win_s


def check_graph_replays(torch, da, replays: int = 20) -> None:
    """Phase 5a: K1, K2, K3 and the tensor-core K4 (bf16, int8, int4) fold
    their partials in the launch that made them, through ticket counters
    that persist between calls. One call of each at B 1 and 16 is captured
    in a CUDA graph and replayed: every replay must equal the eager call
    bit for bit."""
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
        i8 = _replay_quant_cache(torch, gen, 8, batch)
        i4 = _replay_quant_cache(torch, gen, 4, batch)
        calls = {"k1": lambda: da.decode_attention(q, kv, 1, 7459),
                 "k4_bfloat16": lambda: da.decode_attention_mq(qw, kv, None, 1, base, win[0],
                                                               win[1]),
                 "k2": lambda: da.decode_attention_int8(q, i8[0], i8[1], 1, 7459),
                 "k3": lambda: da.decode_attention_int4(q, i4[0], i4[1], 1, 7459),
                 "k4_int8": lambda: da.decode_attention_mq(qw, i8[0], i8[1], 1, base, i8[2][0],
                                                           i8[2][1], i8[3][0], i8[3][1]),
                 "k4_int4": lambda: da.decode_attention_mq(qw, i4[0], i4[1], 1, base, i4[2][0],
                                                           i4[2][1], i4[3][0], i4[3][1])}
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
        del kv, i8, i4, calls
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"graph replays differ from the eager call: {failures}")


# The device-length kernels (K1, K2, K3) read the live length on the card
# and plan the splits inside a grid planned for a bound: a copy that plans
# from the bound instead must fail the sweep below (phase device_length).
PLAN_FROM_BOUND = ("const int64_t plan_len = cur_len;", "const int64_t plan_len = a.max_len;")
DEVICE_LEN_LIBS = ("decode_attention", "decode_attention_quant")
DEVICE_LEN_BATCHES = (1, 2, 16)


def build_plan_from_bound(lib: str) -> str:
    """nvcc of ``csrc/<lib>.cu`` with the live plan taken from the bound
    (PLAN_FROM_BOUND) into the build directory; returns the library."""
    from meshanything_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC_DIR, lib + ".cu")) as fh:
        source = fh.read()
    if PLAN_FROM_BOUND[0] not in source:
        raise AssertionError(f"{lib}.cu has no {PLAN_FROM_BOUND[0]!r} to change")
    out_dir = os.path.join(_build.BUILD_DIR, "plan_from_bound")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, lib + ".cu")
    with open(path, "w") as fh:
        fh.write(source.replace(*PLAN_FROM_BOUND))
    so = os.path.join(out_dir, lib + ".so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
                           "-o", so, path], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on the plan-from-bound copy of {lib}:\n{proc.stderr}")
    return so


def _length_sweep(tile: int, batch: int, sms: int, short: int = 600) -> list:
    """cur_len of the device-length sweep: every length up to ``short``,
    one tile on either side of every tile edge up to S, and around the
    ``sms // batch`` tiles where the plan stops growing."""
    lens = set(range(1, short + 1))
    for edge in range(tile, S + 1, tile):
        lens.update((edge - 1, edge, edge + 1))
    edge = (sms // batch) * tile
    lens.update((edge - tile, edge - 1, edge, edge + 1, edge + tile))
    return sorted(n for n in lens if 1 <= n <= S)


def _mismatches(torch, call, lens) -> list:
    """The lengths at which ``call(length)`` with a 0-d int32 device length
    (grid planned for S) differs in any bit from ``call(n)`` with the int
    (grid planned for n, as the kernel was called by value)."""
    length = torch.empty((), dtype=torch.int32, device="cuda")
    differ = []
    for n in lens:
        length.fill_(n)
        differ.append((call(length) != call(n)).any())
    flags = torch.stack(differ).tolist()
    return [n for n, bad in zip(lens, flags) if bad]


def _device_length_cases(torch, da, gen, batch: int) -> dict:
    """{kernel: (tile, call(length), plain(length), held(out, plain))} at
    the 350M width over two-layer caches of length S: K1 over bf16 and
    f32, K2 and K3 with bf16 queries; ``held`` -> (max abs err, within)."""
    cases = {}
    for name in ("bfloat16", "float32"):
        dtype = getattr(torch, name)
        kv = torch.randn((2, 2, batch, S, H * D), generator=gen, device="cuda", dtype=dtype)
        q = torch.randn((batch, H, D), generator=gen, device="cuda", dtype=dtype)
        cases[f"k1_{name}"] = (
            da.K1_TILE[dtype], lambda n, q=q, kv=kv: da.decode_attention(q, kv, 1, n),
            lambda n, q=q, kv=kv: da.decode_attention_reference(q, kv, 1, n, S),
            lambda out, plain, tol=TOL[name]: _close(out, plain, tol))
    q = torch.randn((batch, H, D), generator=gen, device="cuda").bfloat16()
    for bits, fn in ((8, da.decode_attention_int8), (4, da.decode_attention_int4)):
        values, scales, _, _ = _replay_quant_cache(torch, gen, bits, batch)
        cases["k2" if bits == 8 else "k3"] = (
            da.QUANT_TILE, lambda n, fn=fn, v=values, sc=scales: fn(q, v, sc, 1, n),
            lambda n, v=values, sc=scales: da.decode_attention_quant_reference(q, v, sc, 1, n, S),
            lambda out, plain: _held(out, plain, False)[:2])
    return cases


def check_device_length(torch, da, mutated: dict) -> None:
    """Phase 5b: K1 (bf16 and f32 caches), K2 and K3 with the live length
    read on the device and the grid planned for the whole cache, as the
    decode step calls them, are bit-equal to the call planned for the
    length (the int call) at every cur_len of ``_length_sweep``, at B 1, 2
    and 16, and within their tolerance of the plain version called with
    the same device length. Then the copies that plan from the bound
    (``mutated``: {library: path}) replace the kernels and the same sweep
    up to 600 rows must find each kernel out at some batch."""
    import ctypes

    from meshanything_tpu_torch.ops import _build

    gen = torch.Generator(device="cuda").manual_seed(12)
    sms = da._num_sms(0)
    failures, caught = [], {}
    for batch in DEVICE_LEN_BATCHES:
        cases = _device_length_cases(torch, da, gen, batch)
        for name, (tile, call, plain, held) in cases.items():
            lens = _length_sweep(tile, batch, sms)
            bad = _mismatches(torch, call, lens)
            worst, off = 0.0, []
            for n in CUR_LENS:
                length = torch.tensor(n, dtype=torch.int32, device="cuda")
                err, ok = held(call(length), plain(length))
                worst = max(worst, err)
                if not ok:
                    off.append(n)
            emit("device_length", kernel=name, batch=batch, lengths=len(lens),
                 bit_equal_to_int_call=len(lens) - len(bad), mismatches=bad[:20],
                 max_abs_err_vs_plain=worst, plain_lengths=list(CUR_LENS),
                 outside_tolerance=off, ok=not (bad or off))
            if bad or off:
                failures.append((name, batch))
        if mutated:
            saved = {lib: _build._loaded[lib] for lib in mutated}
            for lib, so in mutated.items():
                _build._loaded[lib] = _build.KernelLibrary(ctypes.CDLL(so), so, True, 0.0, "")
            try:
                for name, (_, call, _, _) in cases.items():
                    bad = _mismatches(torch, call, list(range(1, 601)))
                    caught[name] = caught.get(name, 0) + len(bad)
                    emit("device_length_plan_from_bound", kernel=name, batch=batch,
                         lengths=600, mismatches=len(bad), first=bad[:10])
            finally:
                _build._loaded.update(saved)
        del cases
        torch.cuda.empty_cache()
    missed = [name for name, n in caught.items() if n == 0]
    if failures or missed:
        raise AssertionError(f"device-length calls differ from the int call or the plain "
                             f"version: {failures}; the plan-from-bound copy passed for {missed}")


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
                # as the decode step calls it: the length on the device, the grid planned for S
                length = torch.tensor(cur, dtype=torch.int32, device="cuda")
                cases.append(("k2" if kind == "int8" else "k3", cur, {
                    "kernel": lambda f=single: [f(q1, kv, scales, i, length) for i in range(L)],
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
                     cur_len_on_device=name in ("k2", "k3"),
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


def check_k5_replays(torch, mk, replays: int = 20) -> None:
    """Phase 7 (replays): K5 folds its attention splits inside the launch
    through ticket counters that persist between launches. The same step
    at B 1 and 16, cur_len 7459, is launched ``replays`` more times: every
    output must equal the first bit for bit (the fold sums in split
    order), and so must the K/V rows it writes."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    packed = _random_packed(torch, mk, gen)
    failures = []
    for batch in (1, 16):
        kv = torch.randn((2, L, batch, S, H * D), generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        x = torch.randn((batch, H * D), generator=gen, device="cuda").bfloat16()
        cur = 7459

        def step():
            return mk.decode_step_megakernel(x, packed, kv, cur - 1, cur, num_heads=H)

        want = step()
        rows = kv[:, :, :, cur - 1].clone()
        same = []
        for _ in range(replays):
            out = step()
            torch.cuda.synchronize()
            same.append(bool(torch.equal(out, want)) and bool(torch.equal(kv[:, :, :, cur - 1],
                                                                          rows)))
        emit("k5_replay", batch=batch, cur_len=cur, replays=replays, bit_equal=sum(same),
             ok=all(same))
        if not all(same):
            failures.append(batch)
        del kv, x
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"K5 launches of one step differ: batches {failures}")


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
    for batch in K5_TIME_BATCHES:
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

        # the length on the device, as K1 takes it on the main path (no fill kernel a call)
        length = torch.tensor(cur, dtype=torch.int32, device="cuda")

        def probe_sweep(mode):
            return lambda: [kp.k1_probe(q, kv, i, length, chunk=tile, mode=mode, max_len=cur)
                            for i in range(L)]

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
        t["k1_ms"] = time_loop(lambda: [da.decode_attention(q, kv, i, length, cur)
                                        for i in range(L)], 10, device, graph=True) * 1e3 / (10 * L)
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
                                                                         n_max_triangles=100)
    emit("floor", roof_gbs=roof_gbs, decode_bytes=decode_bytes(full),
         exact_bf16_b1_s=exact_floor_seconds(full, roof_gbs, 1),
         exact_bf16_b16_s=exact_floor_seconds(full, roof_gbs, 16),
         int8_b16_s=exact_floor_seconds(full, roof_gbs, 16, int8=True),
         exact_bf16_b1_100_faces_s=exact_floor_seconds(cut, roof_gbs, 1),
         measured_exact_pc_100_faces_s=by_name["exact_pc"]["device_s_per_mesh"],
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
                  max_faces: int = 800, argv: list = (), paired: bool = False) -> dict:
    """Phase 8: one run of the main path (``run``: the CLI with ``argv``,
    or the pipeline). Every kernel's count is set to 0 just before it and
    read just after: ``kernel`` must have launched 24 times per decode
    step (K1-K3) or per window forward (K4), or once per decode step
    (K5), the residual add and post-LN kernel (``aln``) twice as often as
    K1-K4 and never beside K5, and no other kernel at all. A decode that
    replays CUDA graphs (every tier's but K5's) launches through the
    wrappers in each graph's warm-up step and in its capture (24 times
    each, ``aln`` 48), and the graph does
    the rest, one replay (one host launch) a step or forward: the warm-ups
    and replays must cover the decode steps (window forwards), and past
    the last live one run at most one segment's no-op steps.

    ``paired`` (phase graph_loop): each batch is decoded a second time
    with the eager loop (``graph=False``) right after the replayed decode,
    on the same model and input, and the token streams must be identical;
    those launches are a comparison and are taken out of the counts. For
    phase 10 the peak of allocated
    bytes that a generation of the run reached is read from the card's
    allocator, above what was allocated before the run loaded its model
    (so the weights, and whatever the run keeps beside them, are in it).
    The peak is set back each time the pipeline makes its estimate, which
    it does with its model loaded, just before a batch allocates: what
    the loader held while it made the weights is not a generation's."""
    import gc

    from meshanything_tpu_torch.runtime import phases, pipeline
    from meshanything_tpu_torch.runtime.decode_graph import StepGraph

    estimates, peaks, pairs = [], [], []
    check = phases.check_memory_budget
    generate = pipeline.InferencePipeline.generate
    window_counts = ("window_launches", "quant_window_launches")

    def paired_generate(self, pc_normal, **kw):
        out = generate(self, pc_normal, **kw)
        if not out["graph_captures"]:
            return out
        before = {k: fn.launches for k, fn in wrappers.items()}
        k4_before = [getattr(wrappers["k4"], c) for c in window_counts]
        self.graph = False
        try:
            eager = generate(self, pc_normal, **kw)
        finally:     # the eager decode is a comparison: its launches do not count
            self.graph = True
            for k, n in before.items():
                wrappers[k].launches = n
            for c, n in zip(window_counts, k4_before):
                setattr(wrappers["k4"], c, n)
        pairs.append({"tokens_identical": bool(torch.equal(out["tokens"], eager["tokens"])),
                      "decode_steps": (out["decode_steps"], eager["decode_steps"]),
                      "graph_decode_s": out["decode_s"], "capture_s": out["capture_s"],
                      "eager_decode_s": eager["decode_s"],
                      "graph_device_s": out["encode_s"] + out["decode_s"] + out["detok_s"],
                      "eager_device_s": (eager["encode_s"] + eager["decode_s"]
                                         + eager["detok_s"])})
        return out

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
    wrappers["k4"].quant_window_launches = 0
    StepGraph.captures = StepGraph.replays = 0
    t0 = time.perf_counter()
    phases.check_memory_budget = recording_check
    if paired:
        pipeline.InferencePipeline.generate = paired_generate
    try:
        results = run()
    finally:
        phases.check_memory_budget = check
        pipeline.InferencePipeline.generate = generate
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    peaks.append(torch.cuda.max_memory_allocated())
    peak = max(peaks[1:]) - base
    if len(results) != expect:
        raise AssertionError(f"{name}: {len(results)} results, expected {expect}")
    # the pipeline records a batch that raised (after its retries) and goes on: here any
    # such record fails the phase, and a retried batch fails the exact launch count below
    failed = [r for r in results if "error" in r]
    if failed:
        raise AssertionError(f"{name}: generation failed: {failed}")
    batches = {r["batch"]: r for r in results}
    steps = sum(r["decode_steps"] for r in batches.values())
    units = (sum(r["window_forwards"] for r in batches.values()) if kernel == "k4" else steps)
    per_unit = 1 if kernel == "k5" else L
    captures = sum(r["graph_captures"] for r in batches.values())
    replays = sum(r["graph_replays"] for r in batches.values())
    if (captures, replays) != (StepGraph.captures, StepGraph.replays):
        raise AssertionError(f"{name}: the records' {captures} captures and {replays} replays "
                             f"are not the {StepGraph.captures} and {StepGraph.replays} made")
    # the steps (forwards) that went through the wrappers: each graph's warm-up and capture
    wrapped = 2 * captures if captures else units
    expected = {k: (per_unit * wrapped if k == kernel else 0) for k in wrappers}
    # two residual adds and post-LNs a layer in each of those steps (forwards); K5 has its own
    expected["aln"] = 2 * L * wrapped if kernel != "k5" else 0
    if launches != expected or units == 0:
        raise AssertionError(f"{name}: launches {launches}, expected {expected}")
    # every tier but K5's replays its steps: one warm-up step a graph, then one replay
    # (one host launch) a step; past the last live step at most one segment's no-ops
    replayed = kernel != "k5"
    surplus = replays + captures - units
    if replayed != bool(captures) or (replayed and not 0 <= surplus < segment_steps(kernel)):
        raise AssertionError(f"{name}: {captures} captures and {replays} replays for {units} "
                             f"{'window forwards' if kernel == 'k4' else 'decode steps'}")
    # of K4's launches, those of the tensor-core kernels: all of them the bf16 one's
    # where the cache is bf16 at the 350M head width (F3), all the int8/int4 one's where
    # it is quantized and the queries bf16 (F1, F2), none elsewhere
    window = wrappers["k4"].window_launches
    quant_window = wrappers["k4"].quant_window_launches
    if (window != (launches["k4"] if name in WINDOW_KERNEL_RUNS else 0)
            or quant_window != (launches["k4"] if name in QUANT_WINDOW_KERNEL_RUNS else 0)):
        raise AssertionError(f"{name}: of {launches['k4']} K4 launches {window} took the bf16 "
                             f"window kernel and {quant_window} the int8/int4 one")
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
        "run": name, "kernel": kernel, "argv": [a for a in argv if not a.startswith("/")],
        "meshes": len(results),
        "decode_steps": steps, "launches": launches, "k4_window_launches": window,
        "k4_quant_window_launches": quant_window, "graph_captures": captures,
        "graph_replays": replays,
        # the kernel's launches inside the replayed graphs (24 a replay; K5: none), and
        # the residual add and post-LN kernel's (48 a replay)
        "replayed_launches": per_unit * replays, "replayed_launches_add_ln": 2 * L * replays,
        "host_launches_per_unit": (replays + captures) / units if captures else None,
        "capture_s": sum(r["capture_s"] for r in batches.values()),
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
    if paired:
        differ = [p for p in pairs if not p["tokens_identical"]]
        info["pairs"] = pairs
        emit("graph_loop", run=name, argv=info["argv"], batches=len(pairs),
             tokens_identical=not differ and bool(pairs),
             graph_decode_s=sum(p["graph_decode_s"] for p in pairs),
             capture_s=sum(p["capture_s"] for p in pairs),
             eager_decode_s=sum(p["eager_decode_s"] for p in pairs),
             graph_s_per_mesh=sum(p["graph_device_s"] for p in pairs) / len(results),
             eager_s_per_mesh=sum(p["eager_device_s"] for p in pairs) / len(results),
             decode_steps=[p["decode_steps"] for p in pairs])
        if differ or not pairs:
            raise AssertionError(f"{name}: the replayed and the eager decode differ: {differ}")
    return info


def segment_steps(kernel: str) -> int:
    """Steps between the host's reads of a replayed decode: the decode
    loop's ``sync_every``, the window loop's ``CHECK_EVERY``."""
    import inspect

    from meshanything_tpu_torch.models import lookahead, shape_opt

    if kernel == "k4":
        return lookahead.CHECK_EVERY
    return inspect.signature(shape_opt.decode_loop).parameters["sync_every"].default


# the CLI runs that phase graph_loop decodes again eagerly: every tier once (exact_meshes
# repeats exact_pc's tier and would add ~1 min of eager decode to the smoke)
PAIRED_RUNS = ("exact_pc", "F1", "F2", "F3", "F4", "F5")
WINDOW_KERNEL_RUNS = ("F3",)      # the runs whose K4 is the bf16 tensor-core kernel
# and those whose K4 is its int8/int4 instances
QUANT_WINDOW_KERNEL_RUNS = ("F1", "F2", "C_fast")


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


def _state_tensors(state) -> list:
    kv = list(state.kv) if isinstance(state.kv, tuple) else [state.kv]
    return [state.tokens, *kv, state.done, state.last_token, state.step_t]


def check_step_replays(torch, card: str, replays: int = 20, traced: int = 24) -> dict:
    """Phase graph_loop, part 1: the exact tier's whole decode step at the
    full 350M width (bf16, B=1, seeded random weights) captured in a CUDA
    graph and replayed ``replays`` times beside the same step run eagerly
    on a twin state: after each replay every state tensor (token buffer,
    the whole cache, flags, last token, step counter) must be bit-equal
    to the eager twin's. Then ``runtime/profiling.py::cuda_trace`` over
    ``traced`` more replays: kernels a step and the device's busy share
    (kernel time over the replays' time between CUDA events)."""
    from meshanything_tpu_torch.config import MeshAnythingConfig
    from meshanything_tpu_torch.models import shape_opt as opt
    from meshanything_tpu_torch.runtime.checkpoint import init_random_params
    from meshanything_tpu_torch.runtime.decode_graph import StepGraph
    from meshanything_tpu_torch.runtime.profiling import cuda_trace, kernel_device_us

    cfg = MeshAnythingConfig(dtype="bfloat16")
    model = init_random_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                               cfg.activation_dtype)
    gen = torch.Generator(device="cuda").manual_seed(5)
    cond = (torch.randn((1, cfg.opt.cond_length, cfg.opt.hidden_size), generator=gen,
                        device="cuda") * 0.5).to(cfg.activation_dtype)
    gl = cfg.generate_length
    eager, replayed = (opt.init_decode_state(model.opt, cfg.opt, cond, max_new_tokens=gl)
                       for _ in range(2))
    twins = all(torch.equal(a, b) for a, b in zip(_state_tensors(eager),
                                                  _state_tensors(replayed)))
    opt.decode_step(model.opt, cfg.opt, eager)      # the twin of the capture's warm-up step
    graph = StepGraph(lambda: opt.step_body(model.opt, cfg.opt, replayed), torch.device("cuda"))
    same = []
    for _ in range(replays):
        opt.decode_step(model.opt, cfg.opt, eager)
        graph.replay(1)
        same.append(all(torch.equal(a, b) for a, b in zip(_state_tensors(eager),
                                                          _state_tensors(replayed))))
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as log_dir:
        with cuda_trace(log_dir) as prof:
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            graph.replay(traced)
            stop.record()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(kernel_device_us(e) for e in kernels) / 1e3
    span_ms = start.elapsed_time(stop)
    out = {"batch": 1, "context_rows": cfg.opt.cond_length + int(replayed.step_t) - 1,
           "replays": replays, "bit_equal": sum(same), "twins_equal_at_start": twins,
           "capture_s": graph.capture_s, "traced_steps": traced,
           "ms_per_step": span_ms / traced,
           "kernels_per_step": len(kernels) / traced,
           "device_busy_ms_per_step": busy_ms / traced if kernels else None,
           "busy_share": busy_ms / span_ms if kernels else None, "card": card,
           "ok": twins and all(same)}
    emit("graph_loop_step", **out)
    del graph, eager, replayed, model
    torch.cuda.empty_cache()
    if not out["ok"]:
        raise AssertionError(f"a replayed decode step differs from the eager step: {out}")
    return out


def check_sampled_replays(torch) -> bool:
    """Phase graph_loop, part 2: sampling draws from the request's own
    generator, registered with the graph. On the small config (f32, card)
    the sampled single-token decode and the speculative-sampling window
    loop replayed from graphs give the eager loop's tokens for the same
    seed. Returns ``sampled_eager``: true where the installed torch cannot
    register a generator and the sampled decode stays eager."""
    from meshanything_tpu_torch.config import small_test_config
    from meshanything_tpu_torch.models import lookahead as la
    from meshanything_tpu_torch.models import shape_opt as opt
    from meshanything_tpu_torch.runtime import decode_graph
    from meshanything_tpu_torch.runtime.checkpoint import init_random_params

    sampled_eager = not decode_graph.generator_capturable()
    cfg = small_test_config(n_max_triangles=8)
    model = init_random_params(cfg, torch.Generator().manual_seed(3), torch.float32).cuda()
    cond = torch.randn((2, cfg.opt.cond_length, cfg.opt.hidden_size),
                       generator=torch.Generator().manual_seed(6)).cuda() * 3
    gl = cfg.generate_length
    failures = []
    for loop in ("single_token", "lookahead4"):
        tokens = {}
        for graph in (True, False):
            generator = torch.Generator(device="cuda").manual_seed(9)
            if loop == "single_token":
                state = opt.init_decode_state(model.opt, cfg.opt, cond, max_new_tokens=gl,
                                              bucket=16, sampling=True, generator=generator)
                state = opt.decode_loop(model.opt, cfg.opt, state, max_new_tokens=gl,
                                        sampling=True, graph=graph)
                captured = state.graph is not None
            else:
                state = la.init_lookahead_state(model.opt, cfg.opt, cond, max_new_tokens=gl,
                                                window=4, bucket=16, sampling=True,
                                                generator=generator)
                state = la.lookahead_segment(model.opt, cfg.opt, state, max_new_tokens=gl,
                                             sampling=True, graph=graph)
                captured = bool(state.graphs)
            tokens[graph] = (state.tokens[:, :gl].cpu(), captured)
        same = bool(torch.equal(tokens[True][0], tokens[False][0]))
        emit("graph_loop_sampled", loop=loop, sampled_eager=sampled_eager,
             captured=tokens[True][1], tokens_identical=same)
        if not same or tokens[True][1] == sampled_eager:
            failures.append(loop)
    if failures:
        raise AssertionError(f"sampled decode: replayed and eager streams differ: {failures}")
    return sampled_eager


def graph_loop(torch, wrappers: dict, cli, load_obj, card: str, roof_gbs) -> None:
    """Phase graph_loop (its paired CLI runs are phase 8's runs, each
    decoded again eagerly: ``run_main_path(paired=True)``): a replayed
    whole step bit-equal to the eager step with its trace; the sampled
    decode; and the exact tier at the full 800 faces, B=1, under the
    graph, beside ``bwprobe.exact_floor_seconds`` at ``roof_gbs`` (the
    data sheet's rate where phase probe_time did not run)."""
    from meshanything_tpu_torch.config import MeshAnythingConfig
    from meshanything_tpu_torch.runtime.bwprobe import exact_floor_seconds

    step = check_step_replays(torch, card)
    sampled_eager = check_sampled_replays(torch)
    with tempfile.TemporaryDirectory() as tmp:
        npy, _ = write_inputs(tmp)
        argv = ["--input_type", "pc_normal", "--input_path", npy, "--out_dir",
                os.path.join(tmp, "out"), "--random_weights", "--seed", "0", "--dtype",
                "bfloat16", "--device", "cuda"]
        full = run_main_path(torch, wrappers, load_obj, "exact_pc_800",
                             lambda: cli.main(argv), 1, "k1", argv=argv)
    rate = roof_gbs if roof_gbs is not None else HBM_BYTES_PER_S / 1e9
    floor = exact_floor_seconds(MeshAnythingConfig(dtype="bfloat16"), rate, 1)
    emit("graph_loop_full", run="exact_pc_800", s_per_mesh=full["device_s_per_mesh"],
         decode_steps=full["decode_steps"], capture_s=full["capture_s"],
         exact_floor_seconds=floor, floor_rate_gbs=rate,
         floor_rate_from="roof_gbs" if roof_gbs is not None else "data sheet",
         over_floor=full["device_s_per_mesh"] / floor, sampled_eager=sampled_eager,
         step_ms=step["ms_per_step"], card=card)


SERVING_FACES = 100       # the serving phase's depth cut, F4's: 901 decode steps
SERVING_BATCH = 4         # the micro-batcher's largest batch (sizes 1, 2, 4)


class _Recorder:
    """A PhaseRunner-shaped wrapper recording each call's input, prompt,
    output tokens and stats (the micro-batcher's padded batches among
    them); ``lock`` is the wrapped runner's, which the engine takes."""

    def __init__(self, runner):
        self.runner, self.lock, self.calls = runner, runner.lock, []

    def __call__(self, pc, **kw):
        import numpy as np

        out = self.runner(pc, **kw)
        self.calls.append({"pc": np.asarray(pc), "sampling": kw.get("sampling", False),
                           "prompt": kw.get("prompt_ids"), "tokens": out.token_ids,
                           "stats": out.stats})
        return out


def _serve(serving, engine) -> tuple:
    """``serving.serve_http(engine)`` on a free port of 127.0.0.1, in a
    thread -> (port, stop); ``stop()`` shuts the server down, which closes
    the engine, and joins the thread."""
    import threading

    ready = []
    thread = threading.Thread(target=serving.serve_http, args=(engine, "127.0.0.1", 0),
                              kwargs={"ready": ready.append}, daemon=True)
    thread.start()
    t0 = time.time()
    while not ready:
        if not thread.is_alive() or time.time() - t0 > 60:
            raise AssertionError("the HTTP server did not start")
        time.sleep(0.01)

    def stop():
        ready[0].shutdown()
        thread.join(timeout=120)
        if thread.is_alive():
            raise AssertionError("the HTTP server did not stop")
    return ready[0].server_address[1], stop


def _post(port: int, body: bytes, headers: dict) -> tuple:
    """POST /generate -> (status, headers, body)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=body, method="POST",
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _concurrently(jobs: list) -> list:
    """Each (port, body, headers) request on its own thread, all at once."""
    with ThreadPoolExecutor(len(jobs)) as pool:
        return list(pool.map(lambda job: _post(*job), jobs))


def _serving_counts(wrappers: dict) -> dict:
    from meshanything_tpu_torch.runtime.decode_graph import StepGraph

    return {**{k: fn.launches for k, fn in wrappers.items()},
            "k4_window": wrappers["k4"].window_launches,
            "k4_quant_window": wrappers["k4"].quant_window_launches,
            "graph_captures": StepGraph.captures, "graph_replays": StepGraph.replays}


def _add_ln_follows(counts: dict, *attention: str) -> bool:
    """Whether the residual add and post-LN kernel launched twice for each
    launch of the attention kernels named: both run in every layer of a
    decode step or window forward that goes through the wrappers."""
    return counts["aln"] == 2 * sum(counts[k] for k in attention)


def _zero_counts(wrappers: dict) -> None:
    from meshanything_tpu_torch.runtime.decode_graph import StepGraph

    for fn in wrappers.values():
        fn.launches = 0
    wrappers["k4"].window_launches = wrappers["k4"].quant_window_launches = 0
    StepGraph.captures = StepGraph.replays = 0


def serving_phase(torch, wrappers: dict, cli, load_obj, card: str) -> tuple:
    """Phase 11: the serving path at the full 350M width on seeded random
    bf16 weights, cut to SERVING_FACES faces. ``ServingEngine(batching=4)``
    behind ``serve_http`` on 127.0.0.1 (a free port, in a thread) answers,
    in JSON mode: four concurrent greedy requests (three meshes, one of
    them twice with another seed), which must coalesce into at most two
    batched decodes; then, at once, a sampled request sent twice with one
    seed (equal OBJs), an ``X-MC`` request, a completion request
    (``X-Partial-Obj-B64``: three faces of its input) whose stream must
    start with its prompt, and a malformed body (400). A second engine
    with the ``--fast`` tier (K4 int8, W8A8, lookahead 8) serves two
    concurrent requests. The counts are set to 0 before each engine and
    read after its server stopped: K1 (exact engine) and the int8 K4
    (fast engine) must have launched, and graphs replayed, and no other
    kernel. Then every coalesced batch is decoded again through
    ``InferencePipeline.generate`` on the same padded batch (the same
    program: tokens identical), and each of its rows alone at B=1 (the
    agreement is reported, not held: cuBLAS picks other GEMMs by rows).
    Last, the CLI with ``--mc`` (B=2) and with ``--complete_from``
    through ``run_main_path``. Returns (those runs' records, the serving
    path's launches: K1 and the int8 K4 through the wrappers and in the
    replayed graphs)."""
    import base64

    import numpy as np

    from meshanything_tpu_torch import serving
    from meshanything_tpu_torch.config import MeshAnythingConfig
    from meshanything_tpu_torch.geometry import Mesh, save_obj
    from meshanything_tpu_torch.runtime.checkpoint import init_random_params
    from meshanything_tpu_torch.runtime.phases import PhaseRunner
    from meshanything_tpu_torch.runtime.pipeline import InferencePipeline

    cfg = MeshAnythingConfig(dtype="bfloat16", n_max_triangles=SERVING_FACES)
    model = init_random_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                               cfg.activation_dtype)
    failures, runs = [], []
    with tempfile.TemporaryDirectory() as tmp:
        npy, mesh_dir = write_inputs(tmp)
        cube, octa = (load_obj(os.path.join(mesh_dir, n)) for n in ("cube.obj", "octa.obj"))
        tet = Mesh(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], float),
                   np.array([[0, 2, 1], [0, 1, 3], [1, 2, 3], [0, 3, 2]]))

        def obj_bytes(mesh, name):
            path = os.path.join(tmp, name)
            save_obj(mesh, path)
            with open(path, "rb") as fh:
                return fh.read()

        bodies = {"cube": obj_bytes(cube, "cube_in.obj"), "octa": obj_bytes(octa, "octa_in.obj"),
                  "tet": obj_bytes(tet, "tet_in.obj")}
        partial = obj_bytes(Mesh(cube.vertices, cube.faces[:3]), "partial.obj")
        as_json = {"Accept": "application/json"}

        _zero_counts(wrappers)
        exact = _Recorder(PhaseRunner(model, cfg))
        engine = serving.ServingEngine(model, cfg, runner=exact, batching=SERVING_BATCH,
                                       artifacts_dir=os.path.join(tmp, "a"))
        batcher = engine._runner
        # a wider batching window than the default 0.05 s: the requests' host work
        # (sampling, clean-up) must not split the four into more batches
        batcher._max_wait = 0.5
        port, stop = _serve(serving, engine)
        try:
            greedy = _concurrently([
                (port, bodies["cube"], {**as_json, "X-Seed": "0"}),
                (port, bodies["octa"], {**as_json, "X-Seed": "0"}),
                (port, bodies["tet"], {**as_json, "X-Seed": "0"}),
                (port, bodies["cube"], {**as_json, "X-Seed": "1"})])
            greedy_calls = batcher.batch_calls
            greedy_records = list(exact.calls)
            sampled = {**as_json, "X-Seed": "7", "X-Sampling": "1"}
            rest = _concurrently([
                (port, bodies["octa"], sampled), (port, bodies["octa"], sampled),
                (port, bodies["tet"], {**as_json, "X-Seed": "0", "X-MC": "1", "X-Renders": "0"}),
                (port, bodies["cube"], {**as_json, "X-Seed": "0", "X-Partial-Obj-B64":
                                        base64.b64encode(partial).decode()}),
                (port, b"this is not a mesh", {"X-Seed": "0"})])
        finally:
            stop()
        exact_counts = _serving_counts(wrappers)
        exact_sizes = list(batcher.batch_sizes_served)

        _zero_counts(wrappers)
        fast_runner = _Recorder(PhaseRunner(model, cfg, attn="pallas_int8", lookahead=8,
                                            wq=True))
        fast = serving.ServingEngine(model, cfg, runner=fast_runner, batching=SERVING_BATCH,
                                     artifacts_dir=os.path.join(tmp, "f"))
        fast._runner._max_wait = 0.5
        port, stop = _serve(serving, fast)
        try:
            fast_out = _concurrently([(port, bodies["cube"], {**as_json, "X-Seed": "0"}),
                                      (port, bodies["octa"], {**as_json, "X-Seed": "0"})])
        finally:
            stop()
        fast_counts = _serving_counts(wrappers)
        fast_sizes = list(fast._runner.batch_sizes_served)

        statuses = ([s for s, _, _ in greedy], [s for s, _, _ in rest],
                    [s for s, _, _ in fast_out])
        if statuses != ([200] * 4, [200, 200, 200, 200, 400], [200, 200]):
            failures.append(f"statuses {statuses}: {[b[:300] for _, _, b in greedy + rest]}")
        payloads = [json.loads(b) if s == 200 else None for s, _, b in greedy + rest + fast_out]
        if greedy_calls > 2:
            failures.append(f"the four greedy requests took {greedy_calls} batched decodes")
        if payloads[4] is None or payloads[4]["output_obj"] != payloads[5]["output_obj"]:
            failures.append("the sampled pair with one seed gave different OBJs")
        completion = [c for c in exact.calls if c["prompt"] is not None]
        prompt_ok = len(completion) == 1 and torch.equal(
            completion[0]["tokens"][:, :completion[0]["prompt"].shape[1]],
            completion[0]["prompt"].cpu())
        if not prompt_ok:
            failures.append("the completion's stream does not start with its prompt")
        exact_only = {k: v for k, v in exact_counts.items()
                      if k not in ("k1", "aln", "graph_captures", "graph_replays") and v}
        fast_only = {k: v for k, v in fast_counts.items()
                     if k not in ("k4", "k4_quant_window", "aln", "graph_captures",
                                  "graph_replays") and v}
        if (exact_counts["k1"] != 2 * L * exact_counts["graph_captures"]
                or not exact_counts["graph_replays"] or exact_only
                or not _add_ln_follows(exact_counts, "k1")):
            failures.append(f"exact engine counts {exact_counts}")
        if (not fast_counts["k4_quant_window"] or fast_counts["k4"] != fast_counts[
                "k4_quant_window"] or not fast_counts["graph_replays"] or fast_only
                or not _add_ln_follows(fast_counts, "k4")):
            failures.append(f"fast engine counts {fast_counts}")

        # the coalesced batches again, through the pipeline (the same program), and
        # each row alone at B=1
        same_batch, agreement = [], []
        for rec in greedy_records:
            pipe = InferencePipeline(model, cfg, batch_size=len(rec["pc"]))
            again = pipe.generate(torch.from_numpy(rec["pc"]).cuda())["tokens"].cpu()
            same_batch.append(bool(torch.equal(again, rec["tokens"])))
            rows = len(rec["pc"])            # less the batcher's padding: copies of the last row
            while rows > 1 and np.array_equal(rec["pc"][rows - 1], rec["pc"][rows - 2]):
                rows -= 1
            for row in range(rows):
                alone = InferencePipeline(model, cfg).generate(
                    torch.from_numpy(rec["pc"][row:row + 1]).cuda())["tokens"].cpu()
                agreement.append(float((alone[0] == rec["tokens"][row]).float().mean()))
        if not same_batch or not all(same_batch):
            failures.append(f"coalesced rows differ from InferencePipeline.generate on the "
                            f"same batch: {same_batch}")

        def runner_calls(recorder):
            return [{"batch": len(c["pc"]), "sampling": c["sampling"],
                     "prompt_tokens": 0 if c["prompt"] is None else c["prompt"].shape[1],
                     **{f: c["stats"].get(f) for f in ("encode_s", "decode_s", "detok_s",
                                                       "capture_s", "decode_steps",
                                                       "window_forwards")}}
                    for c in recorder.calls]

        def by_kind(indices):
            return {f: [payloads[i][f] if payloads[i] else None for i in indices]
                    for f in ("latency_s", "artifact_export_s", "capture_s")}

        emit("serving", faces=SERVING_FACES,
             greedy=by_kind(range(4)), sampled=by_kind((4, 5)), mc=by_kind((6,)),
             completion=by_kind((7,)), fast=by_kind((9, 10)),
             statuses=statuses, greedy_batch_calls=greedy_calls,
             batch_sizes_served={"exact": exact_sizes, "fast": fast_sizes},
             coalesced_equal_pipeline=same_batch, row_alone_agreement=agreement,
             completion_prompt_echoed=prompt_ok,
             runner_calls={"exact": runner_calls(exact), "fast": runner_calls(fast_runner)},
             launches={"exact": exact_counts, "fast": fast_counts},
             replayed_launches={"k1": L * exact_counts["graph_replays"],
                                "k4_int8": L * fast_counts["graph_replays"]},
             card=card)
        if failures:
            raise AssertionError(f"serving: {failures}")
        del engine, fast, exact, fast_runner, model
        torch.cuda.empty_cache()

        # the CLI's --mc and --complete_from (the same depth cut)
        common = ["--out_dir", os.path.join(tmp, "out"), "--random_weights", "--seed", "0",
                  "--dtype", "bfloat16", "--device", "cuda", "--n_max_triangles",
                  str(SERVING_FACES)]
        partial_model_space = os.path.join(tmp, "partial_model_space.obj")
        save_obj(Mesh(cube.vertices * 0.8 - 0.4, cube.faces[:3]), partial_model_space)
        for name, argv, expect in (
                ("cli_mc", ["--input_type", "mesh", "--input_dir", mesh_dir, "--mc",
                            "--batchsize_per_gpu", "2", *common], 2),
                ("cli_complete_from", ["--input_type", "pc_normal", "--input_path", npy,
                                       "--complete_from", partial_model_space, *common], 1)):
            runs.append(run_main_path(torch, wrappers, load_obj, name,
                                      lambda argv=argv: cli.main(argv), expect, "k1",
                                      max_faces=SERVING_FACES, argv=argv))
    serving_launches = {"k1": exact_counts["k1"], "k4_int8": fast_counts["k4_quant_window"],
                        "k1_replayed": L * exact_counts["graph_replays"],
                        "k4_int8_replayed": L * fast_counts["graph_replays"],
                        "aln": exact_counts["aln"] + fast_counts["aln"],
                        "aln_replayed": 2 * L * (exact_counts["graph_replays"]
                                                 + fast_counts["graph_replays"])}
    return runs, serving_launches


TRAIN_FACES = 100         # the grammar recipe's n_max_triangles: 1,159 positions a row
TRAIN_STEPS = 100
TRAIN_RESUME_AT = 80      # the checkpoint the resumed trainer starts from
TRAIN_BATCH, TRAIN_LR, TRAIN_K = 4, 1e-3, 5
FULL_FACES = 800          # the full-length step: 7,459 positions, B=1


def _train_tensors(state) -> dict:
    """Every tensor of a TrainState by name: parameters and both moments."""
    out = {f"params/{n}": p.detach() for n, p in state.model.named_parameters()}
    out.update({f"mu/{n}": t for n, t in state.opt_state.mu.items()})
    out.update({f"nu/{n}": t for n, t in state.opt_state.nu.items()})
    return out


def _state_diff(torch, a, b) -> tuple:
    """(every tensor, the count and the step equal bit for bit, the largest
    |a - b| of any tensor, the largest of it relative to that tensor's
    largest |a|)."""
    ta, tb = _train_tensors(a), _train_tensors(b)
    if set(ta) != set(tb):
        raise AssertionError(f"train: the states hold other tensors: {sorted(set(ta) ^ set(tb))}")
    equal = (a.step, a.opt_state.count) == (b.step, b.opt_state.count)
    worst = worst_rel = 0.0
    for name, x in ta.items():
        y = tb[name]
        equal = equal and bool(torch.equal(x, y))
        d = float((x - y).abs().max())
        worst = max(worst, d)
        worst_rel = max(worst_rel, d / max(float(x.abs().max()), 1e-30))
    return equal, worst, worst_rel


def train_phase(torch, wrappers: dict, card: str) -> dict:
    """Phase 12: the trainer at the full 350M width (f32 master weights, the
    bf16 perceiver, the decoder in f32 as JAX runs it) on the face-grammar
    recipe of JAX's ``full_scale_probe`` (batch 4, lr 1e-3, k=5, one fixed
    batch, mask_padding, 1,159 positions a row), through the entry points
    a user calls:

    1. ``run_training`` for TRAIN_STEPS steps with a checkpoint at
       TRAIN_RESUME_AT and at the end: the loss finite at every step and
       the last below half the first; ms a step (host clock over steps
       10..TRAIN_RESUME_AT, the card synchronised at both ends), positions
       a second, peak allocated bytes (and the bytes allocated before the
       run, which earlier phases hold), and model FLOPs a second (3 x the
       forward's matmul FLOPs, counted by ``FlopCounterMode``: backward is
       twice the forward, remat's recomputed forward is not model work)
       against the card's dense bf16 and TF32 peaks (the step's f32
       matmuls run as TF32: ``train.tf32_on_card``);
    2. the final checkpoint restored into a trainer built from other
       weights: every parameter, both moments, the count and the step
       bit-equal to the live state; then the step-TRAIN_RESUME_AT
       checkpoint resumed by ``run_training(resume=True)`` to TRAIN_STEPS:
       bit-equal to the uninterrupted run (one stream, the same kernels:
       the card's backward is deterministic here, PERF.md);
    3. one ``make_train_step`` step (and a second, timed apart) at
       n_max_triangles=800, 7,459 positions, B=1, remat and SDPA: the
       loss finite, ms and peak bytes;
    4. the trained weights written as the probe's npz cache and decoded by
       ``full_scale_probe`` (bf16, K1 and the bf16 K4, bucket 512, graph
       replays) on the training and held-out conditions: acceptance,
       agreement, plain tokens, plain-greedy and lookahead-8 seconds. The
       counts are set to 0 just before and read just after: K1 and the
       bf16 tensor-core K4 must have launched (at the graphs' warm-ups and
       captures), the residual add and post-LN twice as often as both
       together, and no other kernel; plain greedy's graphs (K1) and
       lookahead's (K4) must both have replayed, their replays counted
       apart around each call.

    Returns the decode's launches for the ``kernels`` line."""
    import shutil

    import numpy as np
    from torch.utils.flop_counter import FlopCounterMode

    from meshanything_tpu_torch.config import MeshAnythingConfig
    from meshanything_tpu_torch.models import meshanything as ma
    from meshanything_tpu_torch.runtime.checkpoint import init_random_params, jax_numpy_from_params
    from meshanything_tpu_torch.runtime.decode_graph import StepGraph
    from meshanything_tpu_torch.training import synthetic_grammar as sg
    from meshanything_tpu_torch.training import train as tr
    from meshanything_tpu_torch.training.optim import make_optimizer

    dev = torch.device("cuda")
    cfg = MeshAnythingConfig(n_max_triangles=TRAIN_FACES)
    fixed = sg.make_grammar_batch(cfg, np.random.default_rng(0), TRAIN_BATCH, k=TRAIN_K,
                                  mask_padding=True)
    positions = TRAIN_BATCH * (cfg.cond_length + cfg.generate_length)
    failures = []

    def batches():
        while True:
            yield fixed

    def recipe():
        return make_optimizer(TRAIN_LR, steps=TRAIN_STEPS)

    with torch.enable_grad(), tempfile.TemporaryDirectory() as tmp:
        # 1. train
        losses, marks = {}, {}

        def on_metrics(n, metrics):
            losses[n] = metrics["loss"]
            if n in (10, TRAIN_RESUME_AT):
                torch.cuda.synchronize()
                marks[n] = time.perf_counter()

        torch.cuda.synchronize()
        # what earlier phases still hold counts into the peak: print it apart
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        live = tr.run_training(cfg, batches(), steps=TRAIN_STEPS, device=dev, seed=0,
                               optimizer=recipe(), ckpt_dir=os.path.join(tmp, "a"),
                               save_every=TRAIN_RESUME_AT, log_every=0, on_metrics=on_metrics)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        curve = [float(losses[n]) for n in sorted(losses)]
        step_s = (marks[TRAIN_RESUME_AT] - marks[10]) / (TRAIN_RESUME_AT - 10)
        # with grad (the counter's module hooks need it) and remat (only the
        # layer boundaries kept): the graph is dropped uncalled
        with FlopCounterMode(display=False) as counter:
            pc, ids, _ = (torch.as_tensor(a, device=dev) for a in fixed)
            ma.forward_logits(live.model, cfg, pc, ids.long(), remat=True)
        fwd_flops = counter.get_total_flops()
        model_flops = 3 * fwd_flops
        if not (all(np.isfinite(curve)) and curve[-1] < 0.5 * curve[0]):
            failures.append("the loss did not fall below half of the first step's")
        emit("train", part="train", card=card, faces=TRAIN_FACES, batch=TRAIN_BATCH,
             lr=TRAIN_LR, k=TRAIN_K, steps=TRAIN_STEPS, positions_per_step=positions,
             loss_first=curve[0], loss_last=curve[-1],
             loss_every_10=curve[9::10], run_s=run_s, ms_per_step=step_s * 1e3,
             positions_per_s=positions / step_s, peak_allocated_bytes=peak,
             allocated_before_bytes=held,
             forward_matmul_flops=fwd_flops,
             model_flops_per_step=model_flops,
             model_flops_formula="3 x forward matmul FLOPs (FlopCounterMode over "
                                 "forward_logits at the training batch)",
             model_flops_per_s=model_flops / step_s,
             share_of_bf16_peak=model_flops / step_s / PEAK_OPS_PER_S["bfloat16"],
             share_of_tf32_peak=model_flops / step_s / PEAK_OPS_PER_S["tf32"])

        # 2. save and resume
        template, _ = tr.make_train_step(
            cfg, init_random_params(cfg, torch.Generator(dev).manual_seed(1), torch.float32),
            recipe())
        restored = tr.restore_train_state(os.path.join(tmp, "a", f"step_{TRAIN_STEPS}"),
                                          template)
        restored_equal, _, _ = _state_diff(torch, live, restored)
        del template, restored
        shutil.copytree(os.path.join(tmp, "a", f"step_{TRAIN_RESUME_AT}"),
                        os.path.join(tmp, "b", f"step_{TRAIN_RESUME_AT}"))
        t0 = time.perf_counter()
        resumed = tr.run_training(cfg, batches(), steps=TRAIN_STEPS, device=dev, seed=1,
                                  optimizer=recipe(), ckpt_dir=os.path.join(tmp, "b"),
                                  resume=True, log_every=0)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        cont_equal, cont_abs, cont_rel = _state_diff(torch, live, resumed)
        if not restored_equal:
            failures.append("the restored state differs from the saved one")
        if not cont_equal:
            failures.append(f"the resumed run is {cont_rel} off the uninterrupted one")
        emit("train", part="resume", card=card, restored_bit_equal=restored_equal,
             resumed_from=TRAIN_RESUME_AT, resumed_to=resumed.step, resume_run_s=resume_s,
             continuation_bit_equal=cont_equal, continuation_max_abs_diff=cont_abs,
             continuation_max_rel_diff=cont_rel)

        # 3. one full-length step, on the resumed trainer's weights
        cfg800 = MeshAnythingConfig(n_max_triangles=FULL_FACES)
        model = resumed.model
        del resumed
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()     # the model itself included
        torch.cuda.reset_peak_memory_stats()
        state, step_fn = tr.make_train_step(cfg800, model, recipe(), remat=True, block_q=512)
        batch = tr.make_batch(cfg800, np.random.default_rng(0), 1, cfg800.generate_length)
        full = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, *batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            full.append(((time.perf_counter() - t0) * 1e3, loss))
        if not all(np.isfinite(l) for _, l in full):
            failures.append("the full-length step's loss is not finite")
        emit("train", part="full_length", card=card, faces=FULL_FACES, batch=1,
             positions=cfg800.cond_length + cfg800.generate_length, remat=True,
             attention="scaled_dot_product_attention", ms=[m for m, _ in full],
             loss=[l for _, l in full], peak_allocated_bytes=torch.cuda.max_memory_allocated(),
             allocated_before_bytes=held)
        del state, step_fn, model
        torch.cuda.empty_cache()

        # 4. decode the trained weights through the probe, from its cache
        cache = os.path.join(tmp, "grammar350m.npz")
        np.savez(cache, **sg._flatten_tree(jax_numpy_from_params(live.model)))
        del live
        torch.cuda.empty_cache()
        before = os.environ.get("GRAMMAR_PROBE_CACHE")
        os.environ["GRAMMAR_PROBE_CACHE"] = cache
        # the graph replays of each decode apart: plain greedy's graphs hold K1,
        # lookahead's the bf16 K4 (the calls run one after another on the host)
        replays = {"k1": 0, "k4_window": 0}
        plain_generate, lookahead_generate = sg.sopt.generate, sg.generate_lookahead

        def counting(fn, key):
            def call(*args, **kwargs):
                start = StepGraph.replays
                try:
                    return fn(*args, **kwargs)
                finally:
                    replays[key] += StepGraph.replays - start
            return call

        _zero_counts(wrappers)
        sg.sopt.generate = counting(plain_generate, "k1")
        sg.generate_lookahead = counting(lookahead_generate, "k4_window")
        try:
            with torch.no_grad():
                stats, t_plain, t_look = sg.full_scale_probe(
                    steps=TRAIN_STEPS, batch=TRAIN_BATCH, n_max_triangles=TRAIN_FACES,
                    lr=TRAIN_LR, window=8, seed=0, device=dev)
        finally:
            sg.sopt.generate, sg.generate_lookahead = plain_generate, lookahead_generate
            if before is None:
                os.environ.pop("GRAMMAR_PROBE_CACHE")
            else:
                os.environ["GRAMMAR_PROBE_CACHE"] = before
        counts = _serving_counts(wrappers)
    L = cfg.opt.num_layers
    others = {k: n for k, n in counts.items()
              if k not in ("k1", "k4", "k4_window", "aln", "graph_captures", "graph_replays")
              and n}
    if not (counts["k1"] and counts["k4_window"] and replays["k1"] and replays["k4_window"]):
        failures.append(f"the decode did not launch K1 and the bf16 K4 and replay both: "
                        f"{counts}, replays {replays}")
    if sum(replays.values()) != counts["graph_replays"]:
        failures.append(f"of {counts['graph_replays']} replays the decodes made {replays}")
    if others or counts["k4"] != counts["k4_window"]:
        failures.append(f"the decode launched other kernels: {others}, k4 {counts['k4']}")
    if not _add_ln_follows(counts, "k1", "k4"):
        failures.append(f"the residual add and post-LN launched {counts['aln']} times, for "
                        f"{counts['k1']} K1 and {counts['k4']} K4 launches")
    emit("train", part="decode", card=card, window=8, bucket=512, stats=stats,
         plain_greedy_s=t_plain, lookahead_8_s=t_look, launches=counts,
         graph_replays_plain=replays["k1"], graph_replays_lookahead=replays["k4_window"])
    if failures:
        raise AssertionError(f"train: {failures}")
    # each replay is one decode step or window forward: one launch a layer (two of aln)
    return {"k1": counts["k1"], "k4_window": counts["k4_window"],
            "k1_replayed": L * replays["k1"], "k4_window_replayed": L * replays["k4_window"],
            "aln": counts["aln"], "aln_replayed": 2 * L * sum(replays.values())}


CHECKPOINT_FACES = 100    # the depth cut of the checkpoint and warm-start runs: 901 steps
UNREAD_KEY = "transformer.model.decoder.embed_tokens.weight"   # in the shipped file, unread


def write_reference_checkpoint(torch, cfg, path: str, seed: int = 0) -> int:
    """A safetensors file at ``cfg``'s width in bf16, under the reference's
    key names (``reference_key_shapes``, from the config alone, and the
    shipped file's unread ``embed_tokens``), written by this few-line
    writer (no ``safetensors`` package here): seeded N(0, 0.02) weights,
    zero biases, unit norm scales, as the CLI's random weights. Returns
    the file's bytes."""
    from meshanything_tpu_torch.runtime.checkpoint import reference_key_shapes

    shapes = reference_key_shapes(cfg)
    shapes[UNREAD_KEY] = (cfg.opt.vocab_size, cfg.opt.hidden_size)
    header, offset = {}, 0
    for name, shape in shapes.items():
        size = 2 * int(torch.Size(shape).numel())
        header[name] = {"dtype": "BF16", "shape": list(shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with open(path, "wb") as fh:
        fh.write(len(head).to_bytes(8, "little") + head)
        for name, shape in shapes.items():
            if name.endswith("bias"):
                t = torch.zeros(shape, device="cuda")
            elif len(shape) == 1:                    # a layer norm's scale
                t = torch.ones(shape, device="cuda")
            else:
                t = torch.randn(shape, generator=gen, device="cuda") * 0.02
            fh.write(t.bfloat16().view(torch.int16).cpu().numpy().tobytes())
    return 8 + len(head) + offset


def checkpoint_phase(torch, wrappers: dict, cli, load_obj, card: str) -> list:
    """Phase 13: the reference checkpoint at the full 350M width. A seeded
    bf16 file in the reference's format and key names
    (``write_reference_checkpoint``) is loaded by
    ``load_reference_checkpoint`` onto the card (seconds and GB/s, the file
    just written, so in the page cache), which names the unread key; the
    model is saved as a native checkpoint. Then the CLI with
    ``--pretrained_weights <file>`` and no ``--random_weights``, cut to
    CHECKPOINT_FACES faces, through ``run_main_path``: C_exact (K1, graph
    replays), C_fast (``--fast``: the int8 K4), and C_native
    (``--pretrained_weights <dir>``), whose tokens must be bit-equal to
    C_exact's. Returns the three runs' records."""
    import contextlib
    import io

    from meshanything_tpu_torch.config import MeshAnythingConfig
    from meshanything_tpu_torch.runtime import checkpoint as ckpt
    from meshanything_tpu_torch.runtime import pipeline

    cfg = MeshAnythingConfig(dtype="bfloat16", n_max_triangles=CHECKPOINT_FACES)
    failures, runs, tokens = [], [], {}
    generate = pipeline.InferencePipeline.generate

    def recording(name):
        def gen(self, pc_normal, **kw):
            out = generate(self, pc_normal, **kw)
            tokens.setdefault(name, []).append(out["tokens"].cpu())
            return out
        return gen

    with tempfile.TemporaryDirectory() as tmp:
        npy, _ = write_inputs(tmp)
        path, native = os.path.join(tmp, "MeshAnything_350m.pth"), os.path.join(tmp, "native")
        t0 = time.perf_counter()
        file_bytes = write_reference_checkpoint(torch, cfg, path)
        write_s = time.perf_counter() - t0
        log = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(log):
            model = ckpt.load_reference_checkpoint(path, cfg, device=torch.device("cuda"),
                                                   dtype=torch.bfloat16)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if UNREAD_KEY not in log.getvalue() or {p.dtype for p in model.parameters()} != {
                torch.bfloat16}:
            failures.append(f"load: {log.getvalue()[:500]!r}")
        n_params = sum(p.numel() for p in model.parameters())
        t0 = time.perf_counter()
        ckpt.save_native(model, native)
        save_s = time.perf_counter() - t0
        del model
        torch.cuda.empty_cache()

        common = ["--input_type", "pc_normal", "--input_path", npy, "--out_dir",
                  os.path.join(tmp, "out"), "--seed", "0", "--dtype", "bfloat16", "--device",
                  "cuda", "--n_max_triangles", str(CHECKPOINT_FACES)]
        for name, argv, kernel in (
                ("C_exact", ["--pretrained_weights", path, *common], "k1"),
                ("C_fast", ["--fast", "--pretrained_weights", path, *common], "k4"),
                ("C_native", ["--pretrained_weights", native, *common], "k1")):
            pipeline.InferencePipeline.generate = recording(name)
            try:
                runs.append(run_main_path(torch, wrappers, load_obj, name,
                                          lambda argv=argv: cli.main(argv), 1, kernel,
                                          max_faces=CHECKPOINT_FACES, argv=argv))
            finally:
                pipeline.InferencePipeline.generate = generate
        native_equal = torch.equal(tokens["C_exact"][0], tokens["C_native"][0])
        if not native_equal:
            failures.append("the native checkpoint's tokens differ from the file's")
    emit("checkpoint", file_bytes=file_bytes, parameters=n_params, write_s=write_s,
         load_s=load_s, load_gb_per_s=file_bytes / load_s / 1e9, save_native_s=save_s,
         unread_named=UNREAD_KEY in log.getvalue(), native_tokens_bit_equal=native_equal,
         runs={r["run"]: {f: r[f] for f in ("decode_steps", "graph_captures", "graph_replays",
                                            "capture_s", "wall_s", "faces")} for r in runs},
         card=card)
    if failures:
        raise AssertionError(f"checkpoint: {failures}")
    return runs


def _process(args: list, out_dir: str, cwd: str) -> dict:
    """Run ``main_torch.py`` with ``args`` in a process of its own -> its
    exit code, wall seconds, seconds from its start to its first OBJ (the
    file's time), and its ``[aot]`` lines."""
    import glob

    t0 = time.time()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "main_torch.py"),
                           "--out_dir", out_dir, *args], capture_output=True, text=True,
                          timeout=600, cwd=cwd)
    wall = time.time() - t0
    objs = glob.glob(os.path.join(out_dir, "*", "*_gen.obj"))
    return {"rc": proc.returncode, "wall_s": wall,
            "first_obj_s": min(os.path.getmtime(o) for o in objs) - t0 if objs else None,
            "objs": sorted(objs), "aot": [ln for ln in proc.stderr.splitlines()
                                          if ln.startswith("[aot]")],
            "tail": proc.stderr[-1500:]}


def warm_start_phase(torch, wrappers: dict, load_obj, card: str) -> None:
    """Phase 14: the warm start at the full 350M width (seeded random bf16
    weights), cut to CHECKPOINT_FACES faces.

    Processes of ``main_torch.py``: ``--precompile --aot_dir D`` with no
    input builds K1 into a fresh D; then one pc_normal input with the same
    D must build nothing (every library found, no ``built`` line, D's
    files unchanged: no nvcc ran, not even ``--version``); then the same
    input with a fresh store (cold), whose OBJ must equal the warm one's.
    Each one's wall seconds, and to its first OBJ.

    In this process: one ``PhaseRunner`` takes greedy requests at B=1,
    B=2 and B=1 again: ``graph_captures`` 1, 1, 0, and the third's tokens
    bit-equal to the first's and to a fresh runner's; a runner after
    ``precompile(1)`` captures nothing for its first request and gives the
    same tokens; a sampled request twice with one seed on one runner (the
    second captures nothing) gives a fresh runner's tokens; a ``--fast``
    ServingEngine's second request captures nothing. The counts are set to
    0 before and read after: K1 and the int8 K4, the residual add and
    post-LN twice as often, and no other kernel."""
    import numpy as np

    from meshanything_tpu_torch import serving
    from meshanything_tpu_torch.config import MeshAnythingConfig
    from meshanything_tpu_torch.runtime.checkpoint import init_random_params
    from meshanything_tpu_torch.runtime.decode_graph import StepGraph, generator_capturable
    from meshanything_tpu_torch.runtime.phases import PhaseRunner
    from meshanything_tpu_torch.runtime.pipeline import load_inputs

    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        npy, mesh_dir = write_inputs(tmp)
        common = ["--random_weights", "--seed", "0", "--dtype", "bfloat16", "--device", "cuda",
                  "--n_max_triangles", str(CHECKPOINT_FACES)]
        store, cold_store = os.path.join(tmp, "aot"), os.path.join(tmp, "aot_cold")
        pc_input = ["--input_type", "pc_normal", "--input_path", npy]
        def listing(d):
            return ({n: os.path.getmtime(os.path.join(d, n)) for n in os.listdir(d)}
                    if os.path.isdir(d) else {})

        pre = _process(["--precompile", "--aot_dir", store, *common], os.path.join(tmp, "o1"),
                       tmp)
        stored = listing(store)
        warm = _process(["--aot_dir", store, *pc_input, *common], os.path.join(tmp, "o2"), tmp)
        after = listing(store)
        cold = _process(["--aot_dir", cold_store, *pc_input, *common], os.path.join(tmp, "o3"),
                        tmp)
        procs = {"precompile": pre, "warm": warm, "cold": cold}
        for name, p in procs.items():
            if p["rc"]:
                failures.append(f"{name}: exit {p['rc']}: {p['tail']}")
        libs = [n for n in stored if n.endswith(".so")]
        if not any(n.startswith("decode_attention-") for n in libs) or not any(
                "built decode_attention" in ln for ln in pre["aot"]):
            failures.append(f"precompile stored {sorted(stored)}: {pre['aot']}")
        if (any(" built " in ln or "rebuilding" in ln for ln in warm["aot"])
                or not any("found decode_attention" in ln for ln in warm["aot"])
                or after != stored):
            failures.append(f"the warm process built: {warm['aot']}, {sorted(after)}")
        if not any("built decode_attention" in ln for ln in cold["aot"]):
            failures.append(f"the cold process found a library: {cold['aot']}")
        same_obj = bool(warm["objs"] and cold["objs"]) and (
            open(warm["objs"][0], "rb").read() == open(cold["objs"][0], "rb").read())
        if not same_obj:
            failures.append("the warm and the cold process wrote different OBJs")

        cfg = MeshAnythingConfig(dtype="bfloat16", n_max_triangles=CHECKPOINT_FACES)
        model = init_random_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                   cfg.activation_dtype)
        rows = [load_inputs("pc_normal", [npy], num_points=cfg.perceiver.num_points,
                            seed=s)[0].pc_normal for s in (0, 1)]
        b1 = torch.from_numpy(np.stack(rows[:1]).astype(np.float32)).cuda()
        b2 = torch.from_numpy(np.stack(rows).astype(np.float32)).cuda()
        _zero_counts(wrappers)
        runner = PhaseRunner(model, cfg)
        outs = [runner.run(pc) for pc in (b1, b2, b1)]
        fresh = PhaseRunner(model, cfg).run(b1)
        pre_runner = PhaseRunner(model, cfg)
        report = pre_runner.precompile(1)
        after_pre = pre_runner.run(b1)
        exact_counts = _serving_counts(wrappers)
        _zero_counts(wrappers)
        seeded = [PhaseRunner(model, cfg)]
        seeded.append(seeded[0])
        seeded.append(PhaseRunner(model, cfg))
        sampled = [r.run(b1, sampling=True,
                         generator=torch.Generator(device="cuda").manual_seed(7))
                   for r in seeded]
        sampled_counts = _serving_counts(wrappers)
        captures = [o["graph_captures"] for o in outs]
        same = [torch.equal(outs[2]["tokens"], outs[0]["tokens"]),
                torch.equal(outs[2]["tokens"], fresh["tokens"]),
                torch.equal(after_pre["tokens"], fresh["tokens"])]
        sampled_same = [torch.equal(s["tokens"], sampled[0]["tokens"]) for s in sampled[1:]]
        capturable = generator_capturable()
        if captures != [1, 1, 0] or not all(same):
            failures.append(f"kept graphs: captures {captures}, tokens equal {same}")
        if report["graph_captures"] != 1 or after_pre["graph_captures"] != 0:
            failures.append(f"precompile {report}, then {after_pre['graph_captures']} captures")
        if not all(sampled_same) or (capturable and [s["graph_captures"] for s in sampled]
                                     != [1, 0, 1]):
            failures.append(f"sampled: equal {sampled_same}, captures "
                            f"{[s['graph_captures'] for s in sampled]}")
        for counts in (exact_counts, sampled_counts):
            other = {k: v for k, v in counts.items()
                     if k not in ("k1", "aln", "graph_captures", "graph_replays") and v}
            if (not counts["k1"] or other or (counts["graph_captures"] and counts["k1"] != 2 * L
                                              * counts["graph_captures"])
                    or not _add_ln_follows(counts, "k1")):
                failures.append(f"greedy and sampled counts {exact_counts}, {sampled_counts}")

        _zero_counts(wrappers)
        engine = serving.ServingEngine(model, cfg, attn="pallas_int8", lookahead=8, wq=True,
                                       artifacts_dir=os.path.join(tmp, "serving"))
        served = []
        for name in ("cube.obj", "octa.obj"):
            mesh = load_obj(os.path.join(mesh_dir, name))
            before = StepGraph.captures
            result = engine.generate_from_mesh(mesh.vertices, mesh.faces, seed=0,
                                               export_artifacts=False)
            served.append({"capture_s": result["capture_s"], "latency_s": result["latency_s"],
                           "graph_captures": StepGraph.captures - before,
                           "faces": result["faces_generated"]})
        engine.close()
        fast_counts = _serving_counts(wrappers)
        if [s["graph_captures"] for s in served] != [1, 0] or served[1]["capture_s"] != 0:
            failures.append(f"the --fast engine's second request captured: {served}")
        fast_other = {k: v for k, v in fast_counts.items()
                      if k not in ("k4", "k4_quant_window", "aln", "graph_captures",
                                   "graph_replays") and v}
        if (not fast_counts["k4_quant_window"] or fast_counts["k4"] != fast_counts[
                "k4_quant_window"] or fast_other or not _add_ln_follows(fast_counts, "k4")):
            failures.append(f"fast counts {fast_counts}")
        del runner, pre_runner, seeded, engine, model
        torch.cuda.empty_cache()

    def request(o):
        return {f: o[f] for f in ("capture_s", "graph_captures", "graph_replays", "decode_s",
                                  "decode_steps")}

    emit("warm_start", faces=CHECKPOINT_FACES,
         processes={k: {f: v[f] for f in ("rc", "wall_s", "first_obj_s", "aot")}
                    for k, v in procs.items()},
         store_files=sorted(stored), warm_cold_obj_equal=same_obj,
         requests=[{"batch": b, **request(o)} for b, o in zip((1, 2, 1), outs)],
         fresh=request(fresh), tokens_equal=same, precompile=report,
         after_precompile=request(after_pre),
         sampled=[request(s) for s in sampled], sampled_tokens_equal=sampled_same,
         generator_capturable=capturable, serving_fast=served,
         launches={"exact": exact_counts, "sampled": sampled_counts, "fast": fast_counts},
         card=card)
    if failures:
        raise AssertionError(f"warm_start: {failures}")

# Phase parallel: the ranks' depth cuts are tools/parallel_probe.py's DP_FACES,
# TP_FACES and TRAIN (the widths stay the 350M model's)
PARALLEL_CLI_FACES = 20
LOCAL_HEADS = (8, 4)          # a tensor-parallel rank's heads at tp = 2 and 4
# The TP=2 first decode step against one process's eager step, both bf16: the
# rank rounds each row-parallel partial product to bf16 before the f32 sum
# (one more rounding than the single matmul, two a layer, 48 in the decoder
# and 50 in the perceiver); bf16's step is 2^-8 of a value, and ~100 such
# roundings that add like a random walk move a logit by ~10 steps of 2^-8 of
# its scale (~4%). Held at 5% of the largest |logit|; a wrong shard (a head
# of another rank, a bias added twice) moves it by O(1).
TP_LOGIT_RTOL = 5e-2
# The TP=2 greedy and lookahead-8 streams against one process's eager
# streams: both are deterministic on one build and card (a sum of two ranks
# does not depend on their order) and agreed 1.000 on gloo and on NCCL. The
# bf16 roundings above can flip a near-tie argmax late in a stream (a flip
# at step k leaves about k/181 agreement); a lost or stale all-reduce spoils
# every step after it and the stream leaves the reference within a few
# tokens. Held at 0.9.
TP_AGREEMENT_MIN = 0.9
# The sharded trainer against one process's, both f32 with TF32 matmuls on
# the card (2^-11 of a product's inputs): the split matmuls add their
# partial sums in another order and the f32 all-reduce adds one more sum, so
# the losses differ by a few TF32 steps of the loss after three adam steps
# (each update of size lr, its sign flipped only on grads at rounding level).
# Held at 2e-3 relative, four TF32 steps; a rank that misses the other's
# partial sums (an all-reduce lost in the forward, or in copy_to_model's
# backward) moves the loss by O(1) from that step on.
TRAIN_LOSS_RTOL = 2e-3
# A uniform scale of the gradients (a sum counted twice, a mean where the
# sum belongs) barely moves the loss: Adam's step does not depend on it
# (but for eps) and the clip normalises it. The global norm before the clip
# shows it at once (2x, 0.5x), so the grad norms are held too: TF32 in the
# backward put them 0.4-1.2% apart in three steps (the CPU test holds them
# to JAX's in f32 at 1e-4). Held at 5%.
TRAIN_GRAD_NORM_RTOL = 5e-2


def check_local_heads(torch, da) -> dict:
    """Phase parallel, part 1: K1 and the bf16 tensor-core K4 at the head
    counts of a tensor-parallel rank (8 at tp = 2, 4 at tp = 4; cache rows
    of 1,024 and 512 bytes), head width 64, B 1 and 16: K1 at cur_len
    7459, K4 at W=8 and base 7450 - b, each against its plain version with
    the checks' tolerances and NaN past the live rows; then K2, K3 and the
    int8/int4 K4 there (``_check_local_quant``). Returns the largest
    errors."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst, failures = {"k1": 0.0, "k4_window": 0.0}, []
    assert da.mq_kernel_for(torch.bfloat16, D, torch.bfloat16) == "window"
    for heads in LOCAL_HEADS:
        for batch in (1, 16):
            kv = torch.full((2, L, batch, S, heads * D), float("nan"), dtype=torch.bfloat16,
                            device="cuda")
            kv[:, LAYER] = torch.randn((2, batch, S, heads * D), generator=gen, device="cuda",
                                       dtype=torch.bfloat16)
            q = torch.randn((batch, heads, D), generator=gen, device="cuda", dtype=torch.bfloat16)
            cur = CUR_LENS[0]
            out = da.decode_attention(q, kv, LAYER, cur)
            kv[:, LAYER, :, cur:] = float("nan")
            poisoned = da.decode_attention(q, kv, LAYER, cur)
            plain = da.decode_attention_reference(q, kv, LAYER, cur)
            torch.cuda.synchronize()
            err, within = _close(out, plain, TOL["bfloat16"])
            ok1 = within and bool(torch.isfinite(out).all()) and bool(torch.equal(out, poisoned))

            kv[:, LAYER] = torch.randn((2, batch, S, heads * D), generator=gen, device="cuda",
                                       dtype=torch.bfloat16)
            w, base0 = 8, BASES[0]
            q4 = torch.randn((batch, w, heads, D), generator=gen, device="cuda",
                             dtype=torch.bfloat16)
            win = torch.randn((2, batch, w, heads * D), generator=gen, device="cuda",
                              dtype=torch.bfloat16)
            base = (base0 - torch.arange(batch, device="cuda")).int()
            args = (q4, kv, None, LAYER, base, win[0], win[1])
            out4 = da.decode_attention_mq(*args)
            for b, n in enumerate(base.tolist()):
                kv[:, LAYER, b, n:] = float("nan")
            poisoned4 = da.decode_attention_mq(*args)
            plain4 = da.decode_attention_mq_reference(*args, n_rows=base0)
            torch.cuda.synchronize()
            err4, within4, held = _held(out4, plain4, False, WINDOW_RTOL)
            ok4 = (within4 and bool(torch.isfinite(out4).all())
                   and bool(torch.equal(out4, poisoned4)))
            worst["k1"] = max(worst["k1"], err)
            worst["k4_window"] = max(worst["k4_window"], err4)
            emit("parallel_local_heads", heads=heads, batch=batch, row_bytes=heads * D * 2,
                 k1={"cur_len": cur, "max_abs_err": err, "atol": TOL["bfloat16"],
                     "rtol": TOL["bfloat16"], "ok": ok1},
                 k4_window={"window": w, "base_row0": base0, "max_abs_err": err4, **held,
                            "ok": ok4})
            if not (ok1 and ok4):
                failures.append((heads, batch, ok1, ok4))
            del kv
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"K1 / the bf16 K4 at a rank's head count disagree: {failures}")
    worst.update(_check_local_quant(torch, da, gen))
    return worst


def _check_local_quant(torch, da, gen) -> dict:
    """K2, K3 and the int8/int4 K4 (its tensor-core instances) at a rank's
    head counts (``LOCAL_HEADS``: int8 rows of 512 and 256 bytes, int4 rows
    of 64 and 32 plane words, which the int4 unpack takes four at a time),
    bf16 queries as the model's, B 1 and 16: K2/K3 at cur_len 7459, K4 at
    W=8 and base 7450 - b, each against its plain version at QUANT_RTOL of
    each head vector's largest |plain| element, with the scales NaN and the
    codes garbled past the live rows (bit-equal outputs)."""
    worst, failures = {"k2": 0.0, "k3": 0.0, "k4_window_quant": 0.0}, []
    for heads in LOCAL_HEADS:
        for batch in (1, 16):
            for bits, key, fn in ((8, "k2", da.decode_attention_int8),
                                  (4, "k3", da.decode_attention_int4)):
                values, scales = _quantized_cache(torch, gen, bits, batch, heads=heads)
                q = torch.randn((batch, heads, D), generator=gen, device="cuda",
                                dtype=torch.bfloat16)
                cur = CUR_LENS[0]
                out = fn(q, values, scales, LAYER, cur)
                scales[:, LAYER, :, :, cur:] = float("nan")
                _garble(values[:, LAYER, :, cur:], gen)
                poisoned = fn(q, values, scales, LAYER, cur)
                plain = da.decode_attention_quant_reference(q, values, scales, LAYER, cur)
                torch.cuda.synchronize()
                err, within, held = _held(out, plain, False)
                ok = within and bool(torch.isfinite(out).all()) and bool(torch.equal(out, poisoned))

                # the int8/int4 K4: fresh live rows, W=8 bf16 queries, the window's codes
                top = 0.02 if bits == 8 else 0.3
                scales[:, LAYER] = torch.rand(scales[:, LAYER].shape, generator=gen,
                                              device="cuda") * top + 1e-3
                kind = "int8" if bits == 8 else "int4"
                assert da.mq_kernel_for(values.dtype, D, torch.bfloat16) == "window_quant", kind
                w, base0 = 8, BASES[0]
                q4 = torch.randn((batch, w, heads, D), generator=gen, device="cuda",
                                 dtype=torch.bfloat16)
                win = torch.empty((2, batch, w, values.shape[-1]), dtype=values.dtype,
                                  device="cuda")
                _garble(win, gen)
                win_s = [torch.rand((batch, 1, w), generator=gen, device="cuda") * top + 1e-3
                         for _ in range(2)]
                base = (base0 - torch.arange(batch, device="cuda")).int()
                args = (q4, values, scales, LAYER, base, win[0], win[1], *win_s)
                out4 = da.decode_attention_mq(*args)
                for b, n in enumerate(base.tolist()):
                    scales[:, LAYER, b, :, n:] = float("nan")
                    _garble(values[:, LAYER, b, n:], gen)
                poisoned4 = da.decode_attention_mq(*args)
                plain4 = da.decode_attention_mq_reference(*args, n_rows=base0)
                torch.cuda.synchronize()
                err4, within4, held4 = _held(out4, plain4, False)
                ok4 = (within4 and bool(torch.isfinite(out4).all())
                       and bool(torch.equal(out4, poisoned4)))
                worst[key] = max(worst[key], err)
                worst["k4_window_quant"] = max(worst["k4_window_quant"], err4)
                emit("parallel_local_heads_quant", heads=heads, batch=batch, cache=kind,
                     row_bytes=values.shape[-1] * values.element_size(),
                     **{key: {"cur_len": cur, "max_abs_err": err, **held, "ok": ok}},
                     k4_window_quant={"window": w, "base_row0": base0, "max_abs_err": err4,
                                      **held4, "ok": ok4})
                if not (ok and ok4):
                    failures.append((kind, heads, batch, ok, ok4))
                del values, scales
                torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"K2 / K3 / the int8/int4 K4 at a rank's head count disagree: "
                             f"{failures}")
    return worst


def _parallel_inputs(n: int, seed: int):
    """n seeded ellipsoid clouds of 8192 points with normals, each scaled
    and turned its own way: (N, 6) float32 arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    clouds = []
    for _ in range(n):
        axes = rng.uniform(0.3, 1.0, 3)
        turn, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        u = rng.normal(size=(8192, 3))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        normals = u / axes
        normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
        clouds.append(np.concatenate([(u * axes) @ turn, normals @ turn], -1).astype(np.float32))
    return clouds


def _run_group(argv: list, timeout: float) -> subprocess.CompletedProcess:
    """A command in a process group of its own (torchrun and its ranks),
    the whole group killed at the time limit."""
    import signal

    proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"{argv[:6]}... timed out after {timeout} s: {err[-3000:]}")
    return subprocess.CompletedProcess(argv, proc.returncode, out, err)


def _sum_counts(records: list) -> dict:
    return {k: sum(r["counts"][k] for r in records) for k in records[0]["counts"]}


def _references(torch, pp, pc, graph: bool) -> dict:
    """This process's runs that the ranks are held to, on the ranks'
    seeded weights (one model: the weights do not depend on the depth):
    each input's B=1 run in every tier of ``pp.TIERS`` at DP_FACES; at
    TP_FACES the first input's first decode step, eager decode, replayed
    decode (with ``graph``: the TP replays' comparison, capture included
    in both) and eager lookahead 8."""
    dp_cfg, tp_cfg = pp.config(pp.DP_FACES), pp.config(pp.TP_FACES)
    model = pp.model_for(dp_cfg, pc.device)
    row = pc[:1]
    ref = {"dp": [pp.run_tiers(model, dp_cfg, pc[i:i + 1]) for i in range(2)],
           "first": pp.first_step_logits(model, tp_cfg, row),
           "decode": pp.timed_decode(model, tp_cfg, row),
           "replayed": pp.timed_decode(model, tp_cfg, row, graph=True) if graph else None,
           "lookahead": pp.lookahead_tokens(model, tp_cfg, row)}
    del model
    torch.cuda.empty_cache()
    return ref


def _rank_results(torch, probe: list, tasks: tuple, tmp: str, backend: str, *extra: str,
                  timeout: float = 600.0, world: int = 2) -> tuple:
    """``world`` ranks of ``tools/parallel_probe.py`` running ``tasks`` in
    order, one process a rank, over ``backend`` -> ({task: each rank's
    results}, the wall seconds)."""
    from meshanything_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    run_ranks([*probe, ",".join(tasks), tmp, "--backend", backend, *extra], world,
              timeout=timeout, log_dir=tmp)
    wall = time.perf_counter() - t0
    return {task: [torch.load(os.path.join(tmp, f"{task}_rank{r}.pt"), weights_only=False)
                   for r in range(world)] for task in tasks}, wall


def _check_dp(torch, pp, ref: dict, dp: list, backend: str, failures: list) -> dict:
    """generate over a (2, 1) mesh in every tier of ``pp.TIERS``, one input
    a rank, the decode replayed: each rank's gathered rows bit-equal to
    this process's B=1 run of each input. Returns the ranks' launches."""
    for tier in pp.TIERS:
        equal = [bool(torch.equal(r["tiers"][tier][0][i], ref["dp"][i][tier][0][0]))
                 for r in dp for i in range(2)]
        emit("parallel_dp", backend=backend, tier=tier, faces=pp.DP_FACES,
             decode_steps=pp.config(pp.DP_FACES).generate_length - 1, rows_bit_equal=equal,
             rank_seconds=[r["tiers"][tier][1] for r in dp],
             alone_seconds=[a[tier][1] for a in ref["dp"]], devices=[r["device"] for r in dp])
        if not all(equal):
            failures.append((backend, "dp", tier))
    counts = _sum_counts(dp)
    emit("parallel_dp_launches", backend=backend, launches=counts,
         rank_task_s=[r["task_s"] for r in dp])
    for key in ("k1", "k2", "k3", "k4_quant_window", "k5", "aln"):
        if counts[key] == 0:
            failures.append((backend, "dp launched no", key))
    return counts


def _check_tp(torch, pp, ref: dict, tp: list, backend: str, graph: bool, failures: list,
              card: str) -> dict:
    """A (1, 2) mesh, exact tier, TP_FACES: the first decode step's logits
    within TP_LOGIT_RTOL of the largest of this process's eager step, the
    prefill's token equal, the greedy agreement of the decode (replayed
    with ``graph``, else eager) and of lookahead 8 with this process's
    eager runs at least TP_AGREEMENT_MIN; with ``graph`` the replayed
    tokens bit-equal to the same rank's eager runs (the same kernels and
    sums: a capture that replays a stale or missing all-reduce differs).
    ms a step beside this process's (eager, and with ``graph`` replayed);
    without ``graph`` the share of a step inside all-reduce (a clocked
    run). Returns the ranks' launches."""
    ref_token, ref_logits = ref["first"]
    alone, replayed = ref["decode"], ref["replayed"]
    scale = float(ref_logits.abs().max())
    for r in tp:
        err = float((r["first_logits"] - ref_logits).abs().max())
        d = r["decode"]
        greedy = float((d["tokens"] == alone["tokens"]).float().mean())
        lookahead = float((r["lookahead"] == ref["lookahead"]).float().mean())
        checks = {"logits": err <= TP_LOGIT_RTOL * scale
                  and bool(torch.isfinite(r["first_logits"]).all()),
                  "prefill_token_equal": bool(torch.equal(r["prefill_token"], ref_token)),
                  "greedy_agreement": greedy >= TP_AGREEMENT_MIN,
                  "lookahead8_agreement": lookahead >= TP_AGREEMENT_MIN}
        if graph:
            checks["replayed_decode_equals_eager"] = bool(torch.equal(d["tokens"],
                                                                      r["decode_eager"]))
            checks["replayed_lookahead_equals_eager"] = bool(torch.equal(r["lookahead"],
                                                                         r["lookahead_eager"]))
        clocked = {}
        if "clocked" in r:
            c = r["clocked"]
            clocked = {"clocked_ms_a_step": c["seconds"] / c["steps"] * 1e3,
                       "allreduce_share_clocked": c["allreduce_s"] / c["seconds"],
                       "allreduce_calls_a_step": c["allreduce_calls"] / c["steps"]}
        emit("parallel_tp", backend=backend, graph=graph, mesh=f"dp1 x tp{len(tp)}",
             rank=r["rank"], device=r["device"],
             faces=pp.TP_FACES, decode_steps=d["steps"], first_logits_max_abs_err=err,
             largest_logit=scale, rtol_of_largest=TP_LOGIT_RTOL, greedy_agreement=greedy,
             lookahead8_agreement=lookahead, agreement_min=TP_AGREEMENT_MIN, checks=checks,
             ok=all(checks.values()), ms_a_step=d["seconds"] / d["steps"] * 1e3,
             alone_eager_ms_a_step=alone["seconds"] / alone["steps"] * 1e3,
             alone_replayed_ms_a_step=(replayed["seconds"] / replayed["steps"] * 1e3
                                       if replayed else None), **clocked, card=card)
        failed = [name for name, ok in checks.items() if not ok]
        if failed:
            failures.append((backend, "tp", r["rank"], failed, err, greedy, lookahead))
    counts = _sum_counts(tp)
    emit("parallel_tp_launches", backend=backend, launches=counts,
         rank_task_s=[r["task_s"] for r in tp])
    for key in ("k1", "k4_window", "aln") + (("graph_captures", "graph_replays") if graph
                                             else ()):
        if counts[key] == 0:
            failures.append((backend, "tp launched no", key))
    return counts


def _tier_references(torch, pp, pc, tiers) -> dict:
    """This process's runs of the decoder alone that the tiers task's ranks
    are held to, on the ranks' weights and one process's condition of the
    first input: each tier's first decode step's logits (eager) and decode
    at its TIER_FACES (replayed, as one process runs it; the megakernel
    eager)."""
    model = pp.model_for(pp.config(pp.DP_FACES), pc.device)
    cond = pp.decoder_condition(model, pp.config(pp.DP_FACES), pc[:1])
    ref = {}
    for tier in tiers:
        kw = pp.TP_TIERS[tier]
        ocfg = pp.config(pp.TIER_FACES[tier])
        gl = ocfg.generate_length
        ref[tier] = {"first_logits": pp.tier_first_logits(model.opt, ocfg.opt, cond, kw, gl),
                     "decode": pp.tier_decode(model.opt, ocfg.opt, cond, kw, gl, graph=True)}
    del model
    torch.cuda.empty_cache()
    return ref


# the kernel that each tier of the tiers task must launch
TIER_KERNELS = {"int8": "k2", "int4": "k3", "fast": "k4_quant_window", "megakernel": "k5"}


def _check_tiers(torch, pp, ref: dict, ranks: list, backend: str, graph: bool, failures: list,
                 card: str) -> dict:
    """The tiers task over a (1, world) mesh, the decoder alone on one
    process's condition, each tier against this process's run of the same
    tier: the first decode step's logits within TP_LOGIT_RTOL of the
    largest, the decode's (or lookahead's) greedy agreement at least
    TP_AGREEMENT_MIN, the megakernel's tokens bit-equal (the whole decoder
    on every rank), in the int8/int4 tiers the codes and scales of the
    prefill's layer-0 rows gathered over the ranks bit-equal to this
    process's quantization of the gathered rows (a rank's own scale would
    pass the agreement, not this), with ``graph`` the replayed tokens
    bit-equal to the same rank's eager run; each tier's kernel launched.
    Prints ms a step (a window forward) and all-reduce calls a step.
    Returns the ranks' launches."""
    from meshanything_tpu_torch.ops.kvcache import quantize_rows_for, unpack_int4

    world = len(ranks)
    for tier in ranks[0]["tiers"]:
        kw, alone = pp.TP_TIERS[tier], ref[tier]
        scale = float(alone["first_logits"].abs().max())
        rows_check = None
        recs = [r["tiers"][tier] for r in ranks]
        if "prefill_rows" in recs[0]:
            rows = torch.cat([rec["prefill_rows"]["rows"] for rec in recs], dim=-1).cuda()
            codes, scales = (t.cpu() for t in quantize_rows_for(kw["attn"])(rows))
            if kw["attn"] == "pallas_int8":
                got = torch.cat([rec["prefill_rows"]["codes"] for rec in recs], dim=-1)
                codes_equal = bool(torch.equal(got, codes))
            else:
                got = torch.cat([unpack_int4(rec["prefill_rows"]["codes"]) for rec in recs],
                                dim=-1)
                codes_equal = bool(torch.equal(got, unpack_int4(codes)))
            rows_check = {"codes_bit_equal": codes_equal, "scales_bit_equal": all(
                bool(torch.equal(rec["prefill_rows"]["scales"], scales[..., 0])) for rec in recs)}
        for r, rec in zip(ranks, recs):
            d = rec["decode"]
            err = float((rec["first_logits"] - alone["first_logits"]).abs().max())
            agreement = float((d["tokens"] == alone["decode"]["tokens"]).float().mean())
            checks = {"logits": err <= TP_LOGIT_RTOL * scale
                      and bool(torch.isfinite(rec["first_logits"]).all()),
                      "agreement": agreement >= TP_AGREEMENT_MIN,
                      "launched": rec["counts"][TIER_KERNELS[tier]] > 0,
                      # the residual add and post-LN kernel in every tier but K5's
                      "add_ln": (rec["counts"]["aln"] > 0) != (kw.get("attn") == "megakernel")}
            if kw.get("attn") == "megakernel":
                checks["tokens_bit_equal"] = bool(torch.equal(d["tokens"],
                                                              alone["decode"]["tokens"]))
            if rows_check is not None:
                checks.update(rows_check)
            if "decode_eager" in rec:
                checks["replayed_equals_eager"] = bool(torch.equal(d["tokens"],
                                                                   rec["decode_eager"]))
            # a step or window forward run (a window loop runs no-op forwards past its end)
            unit = "window_forward" if kw.get("lookahead") else "step"
            emit("parallel_tier", backend=backend, graph=graph, mesh=f"dp1 x tp{world}",
                 tier=tier, rank=r["rank"], device=r["device"], faces=rec["faces"],
                 **{f"{unit}s": d["units"], f"{unit}s_run": d["ran"],
                    f"ms_a_{unit}": d["seconds"] / d["ran"] * 1e3,
                    f"alone_ms_a_{unit}": alone["decode"]["seconds"] / alone["decode"]["ran"]
                    * 1e3},
                 allreduce_calls=d["allreduce_calls"],
                 allreduce_calls_a_eager_unit=(None if graph and kw.get("attn") != "megakernel"
                                               else d["allreduce_calls"] / d["ran"]),
                 alone_replayed=kw.get("attn") != "megakernel",
                 first_logits_max_abs_err=err, largest_logit=scale,
                 rtol_of_largest=TP_LOGIT_RTOL, agreement=agreement,
                 agreement_min=TP_AGREEMENT_MIN, launches=rec["counts"], checks=checks,
                 ok=all(checks.values()), card=card)
            failed = [name for name, ok in checks.items() if not ok]
            if failed:
                failures.append((backend, "tiers", tier, r["rank"], failed, err, agreement))
    counts = _sum_counts(ranks)
    emit("parallel_tiers_launches", backend=backend, launches=counts,
         rank_task_s=[r["task_s"] for r in ranks])
    return counts


def _check_dp_tp(torch, pp, ref: dict, ranks: list, failures: list, card: str) -> dict:
    """The dp_tp task: ``--fast`` over a (world / 2, 2) mesh, one input a
    data group, DP_FACES, replayed: every rank's gathered rows agree with
    this process's B=1 ``--fast`` run of each input at least
    TP_AGREEMENT_MIN (the model group's prefill sums in another order), and
    the int8 K4 launched. Returns the ranks' launches."""
    for r in ranks:
        rows = r["tokens"].shape[0]
        agreement = [float((r["tokens"][i] == ref["dp"][i]["fast"][0][0]).float().mean())
                     for i in range(rows)]
        ok = min(agreement) >= TP_AGREEMENT_MIN and r["counts"]["k4_quant_window"] > 0
        emit("parallel_dp_tp", backend="nccl", mesh=f"dp{rows} x tp2", tier="fast",
             rank=r["rank"], device=r["device"], faces=pp.DP_FACES, agreement=agreement,
             agreement_min=TP_AGREEMENT_MIN, seconds=r["seconds"],
             alone_seconds=[a["fast"][1] for a in ref["dp"][:rows]], launches=r["counts"],
             ok=ok, card=card)
        if not ok:
            failures.append(("dp_tp", r["rank"], agreement))
    return _sum_counts(ranks)


def _train_reference(torch, pp, device) -> dict:
    """One process's trainer on the ranks' weights and batches."""
    from meshanything_tpu_torch.training.train import make_optimizer, make_train_step

    cfg = pp.config(pp.TRAIN["faces"])
    state, step_fn = make_train_step(cfg, pp.model_for(cfg, device, 0, torch.float32),
                                     make_optimizer(1e-3, steps=100))
    out = pp.train_run(state, step_fn, pp.train_batches(cfg), device)
    del state, step_fn
    torch.cuda.empty_cache()
    return out


def _check_train(pp, alone: dict, train: list, failures: list, card: str) -> None:
    """The sharded trainer (its mesh in the records): losses within
    TRAIN_LOSS_RTOL and grad norms within TRAIN_GRAD_NORM_RTOL of one
    process's, step by step."""
    def rel(ours, theirs):
        return [abs(a - b) / abs(b) for a, b in zip(ours, theirs)]

    for r in train:
        t = r["train"]
        loss_rel, norm_rel = rel(t["loss"], alone["loss"]), rel(t["grad_norm"], alone["grad_norm"])
        ok = max(loss_rel) <= TRAIN_LOSS_RTOL and max(norm_rel) <= TRAIN_GRAD_NORM_RTOL
        mesh = "dp{} x tp{}".format(*r["mesh"])
        emit("parallel_train", rank=r["rank"], mesh=mesh, backend=r["backend"], **pp.TRAIN,
             loss=t["loss"], alone_loss=alone["loss"], loss_rel_diff=loss_rel,
             rtol=TRAIN_LOSS_RTOL, grad_norm=t["grad_norm"], alone_grad_norm=alone["grad_norm"],
             grad_norm_rel_diff=norm_rel, grad_norm_rtol=TRAIN_GRAD_NORM_RTOL, ok=ok,
             ms=t["ms"], alone_ms=alone["ms"], peak_bytes=t["peak_bytes"],
             task_s=r["task_s"], card=card)
        if not ok:
            failures.append(("train", mesh, r["rank"], max(loss_rel), max(norm_rel)))


def _dp_inputs(tmp: str):
    """Two of ``_parallel_inputs``' clouds, normalized as the CLI does,
    saved for the ranks as ``inputs.npy``: (the four clouds, the two on
    the card)."""
    import numpy as np
    import torch

    from meshanything_tpu_torch.geometry import normalize_pc_cli

    clouds = _parallel_inputs(4, seed=7)
    pcs = np.stack([normalize_pc_cli(c[:4096]) for c in clouds[:2]]).astype(np.float32)
    np.save(os.path.join(tmp, "inputs.npy"), pcs)
    return clouds, torch.from_numpy(pcs).to("cuda")


def parallel_phase(torch, da, cli, load_obj, card: str) -> tuple:
    """Phase parallel (``meshanything_tpu_torch/parallel/``): the data- and
    tensor-parallel paths at the full 350M width on seeded random bf16
    weights, their ranks started on this card as processes of their own
    over gloo (``parallel/launch.py``; two ranks on one card need gloo,
    which captures no collective), each through
    ``tools/parallel_probe.py`` with the counts set to 0 before and read
    after in the rank:

    1. K1, K2, K3 and the bf16, int8 and int4 K4 at a rank's head counts
    (``check_local_heads``); then this process's references
    (``_references``, ``_tier_references``, ``_train_reference``) and one
    start of two ranks running the probe's dp, tp, tiers and train in turn;
    2. dp (``_check_dp``): ``generate`` over a (2, 1) mesh, one input a
       rank, 50 faces, in the exact tier (graph replays), ``--fast``, the
       int8 and int4 caches and the megakernel: each rank's gathered rows
       bit-equal to this process's B=1 run of each input; a rank's seconds
       a tier;
    3. tp (``_check_tp``): a (1, 2) mesh, exact tier, eager, 20 faces: the
       first decode step's logits within TP_LOGIT_RTOL of the largest of
       one process's eager step, the prefill's token equal, the greedy
       agreement of the decode and of eager lookahead 8 (the bf16 K4 over
       8 heads) at least TP_AGREEMENT_MIN; ms a step, and the share of a
       step inside all-reduce from a second, clocked decode of
       ``tools/parallel_probe.py::CLOCKED_STEPS`` steps (the clock
       synchronises the card at each call, so its steps are slower);
    3b. tiers (``_check_tiers``): the same (1, 2) mesh, the decoder alone on
       one process's condition, eager, in the int8 and int4 caches (K2, K3;
       10 faces), ``--fast`` (the int8 K4 and W8A8, lookahead 8; 20 faces)
       and the megakernel (K5 on the whole decoder; 20 faces): first-step
       logits, agreement, the megakernel's tokens bit-equal, the int8/int4
       prefill codes and scales bit-equal gathered; ms and all-reduce
       calls a step;
    4. train (``_check_train``): ``make_sharded_train_step`` over (1, 2),
       f32 masters, B=2, 256 tokens, 3 steps: losses within
       TRAIN_LOSS_RTOL and grad norms within TRAIN_GRAD_NORM_RTOL of one
       process's trainer on the same batches; ms a step;
    5. the CLI with ``--multihost`` under torchrun, two ranks, four
       inputs, 20 faces: the union of the OBJs complete and byte-equal to
       this process's CLI run, rank 1's records in ``.1``.

    dp and tp must launch the residual add and post-LN kernel, and each
    tier of tiers must launch it unless it is the megakernel's, which must
    not. The NCCL passes are phase ``parallel_nccl``. A failing rank fails
    the phase. Returns (the ranks' launches for the ``kernels`` line, the
    largest errors of part 1)."""
    import numpy as np

    from meshanything_tpu_torch.tools import parallel_probe as pp

    device = torch.device("cuda")
    worst = check_local_heads(torch, da)
    probe = [sys.executable, "-m", "meshanything_tpu_torch.tools.parallel_probe"]
    failures, launches = [], {}
    t_phase = time.perf_counter()

    with tempfile.TemporaryDirectory() as tmp:
        clouds, pc = _dp_inputs(tmp)
        ref = _references(torch, pp, pc, graph=False)
        tier_ref = _tier_references(torch, pp, pc, pp.TP_TIERS)
        alone_train = _train_reference(torch, pp, device)
        tasks = ("dp", "tp", "tiers", "train")
        ranks, wall = _rank_results(torch, probe, tasks, tmp, "gloo")
        emit("parallel_ranks", backend="gloo", tasks=list(tasks), wall_s=wall)
        launches["dp"] = _check_dp(torch, pp, ref, ranks["dp"], "gloo", failures)
        launches["tp"] = _check_tp(torch, pp, ref, ranks["tp"], "gloo", False, failures, card)
        launches["tiers"] = _check_tiers(torch, pp, tier_ref, ranks["tiers"], "gloo", False,
                                         failures, card)
        _check_train(pp, alone_train, ranks["train"], failures, card)

        # 5. --multihost under torchrun against one process's CLI
        folder = os.path.join(tmp, "cli_in")
        os.makedirs(folder)
        for i, c in enumerate(clouds):
            np.save(os.path.join(folder, f"shape{i}.npy"), c)
        common = ["--input_dir", folder, "--input_type", "pc_normal", "--random_weights",
                  "--seed", "0", "--n_max_triangles", str(PARALLEL_CLI_FACES), "--device", "cuda"]
        t0 = time.perf_counter()
        single = cli.main([*common, "--out_dir", os.path.join(tmp, "single")])
        single_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        done = _run_group([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", "2", *probe[1:], "cli", tmp, "--", "--multihost",
                           *common, "--out_dir", os.path.join(tmp, "multi"),
                           "--metrics_out", os.path.join(tmp, "multi.jsonl")], timeout=400)
        multi_s = time.perf_counter() - t0
        if done.returncode != 0:
            raise AssertionError(f"parallel: torchrun --multihost failed: {done.stderr[-4000:]}")

        def objs(root):
            out = {}
            for sub in os.listdir(root):
                for name in os.listdir(os.path.join(root, sub)):
                    if name.endswith(".obj"):
                        path = os.path.join(root, sub, name)
                        load_obj(path)          # parses
                        out[name] = open(path, "rb").read()
            return out

        multi, alone_objs = objs(os.path.join(tmp, "multi")), objs(os.path.join(tmp, "single"))
        per_rank = [[json.loads(line)["uid"] for line in open(path)]
                    for path in (os.path.join(tmp, "multi.jsonl"),
                                 os.path.join(tmp, "multi.jsonl.1"))]
        complete = len(multi) == len(clouds) == len(single) and multi == alone_objs
        counts = _sum_counts([torch.load(os.path.join(tmp, f"cli_rank{r}.pt"),
                                         weights_only=False) for r in range(2)])
        emit("parallel_multihost", inputs=len(clouds), faces=PARALLEL_CLI_FACES,
             objs=sorted(multi), complete_and_byte_equal=complete, records_by_rank=per_rank,
             folders=len(os.listdir(os.path.join(tmp, "multi"))), torchrun_wall_s=multi_s,
             single_process_wall_s=single_s, launches=counts)
        if not complete or per_rank != [["shape0", "shape2"], ["shape1", "shape3"]]:
            failures.append(("multihost", sorted(multi), per_rank))
        if counts["k1"] == 0:
            failures.append(("multihost launched no", "k1"))
        launches["cli"] = counts

    emit("parallel_done", seconds=time.perf_counter() - t_phase, card=card)
    if failures:
        raise AssertionError(f"parallel: {failures}")
    return _sum_counts([{"counts": c} for c in launches.values()]), worst


def parallel_nccl_phase(torch, card: str) -> dict:
    """Phase parallel_nccl, one rank a card over NCCL, the TP decode and
    lookahead replayed as CUDA graphs with the step's collectives (the
    all-reduced sums, the quantized tiers' max-reductions and W8A8's int32
    sums) captured in them, each replay's tokens bit-equal to the same
    rank's eager run; held as phase parallel holds them (this process's
    references on ``cuda:0``):

      * two cards or more: phase parallel's dp, tp and tiers passes over a
        (2, 1) and a (1, 2) mesh (``cuda:0`` and ``cuda:1``);
      * four cards or more: TP (1, 4) in the exact tier (tp) and in
        ``--fast`` (tiers), DP x TP (2, 2) in ``--fast`` (``_check_dp_tp``)
        and the sharded trainer at (1, 4) and (2, 2) against one process's
        (``_check_train``).

    With one card it prints that it did not run (and with two or three,
    that the four-card passes did not). Returns the ranks' launches."""
    cards = torch.cuda.device_count()
    if cards < 2:
        emit("parallel_nccl", run=False,
             reason="one card: dp and tp over NCCL, one rank a card, with the TP step "
                    "captured, need two cards; not run, no claim made")
        return {}
    from meshanything_tpu_torch.tools import parallel_probe as pp

    probe = [sys.executable, "-m", "meshanything_tpu_torch.tools.parallel_probe"]
    failures, launches = [], {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        _, pc = _dp_inputs(tmp)
        ref = _references(torch, pp, pc, graph=True)
        tier_ref = _tier_references(torch, pp, pc, pp.TP_TIERS)
        tasks = ("dp", "tp", "tiers")
        ranks, wall = _rank_results(torch, probe, tasks, tmp, "nccl", "--graph")
        emit("parallel_ranks", backend="nccl", world=2, tasks=list(tasks), wall_s=wall)
        launches["dp"] = _check_dp(torch, pp, ref, ranks["dp"], "nccl", failures)
        launches["tp"] = _check_tp(torch, pp, ref, ranks["tp"], "nccl", True, failures, card)
        launches["tiers"] = _check_tiers(torch, pp, tier_ref, ranks["tiers"], "nccl", True,
                                         failures, card)
        if cards >= 4:
            alone_train = _train_reference(torch, pp, torch.device("cuda"))
            tasks = ("tp", "tiers", "dp_tp", "train", "train_dp_tp")
            ranks, wall = _rank_results(torch, probe, tasks, tmp, "nccl", "--graph", "--tiers",
                                        "fast", world=4)
            emit("parallel_ranks", backend="nccl", world=4, tasks=list(tasks), wall_s=wall)
            launches["tp4"] = _check_tp(torch, pp, ref, ranks["tp"], "nccl", True, failures,
                                        card)
            launches["tiers4"] = _check_tiers(torch, pp, tier_ref, ranks["tiers"], "nccl", True,
                                              failures, card)
            launches["dp_tp"] = _check_dp_tp(torch, pp, ref, ranks["dp_tp"], failures, card)
            _check_train(pp, alone_train, ranks["train"] + ranks["train_dp_tp"], failures, card)
        else:
            emit("parallel_nccl_four", run=False,
                 reason=f"{cards} cards: TP (1, 4), DP x TP (2, 2) and the trainer at (1, 4) "
                        "and (2, 2) need four; not run, no claim made")
    emit("parallel_nccl", run=True, cards=cards, seconds=time.perf_counter() - t_phase,
         card=card)
    if failures:
        raise AssertionError(f"parallel_nccl: {failures}")
    return _sum_counts([{"counts": c} for c in launches.values()])


RECON_CHUNK_TOL = 1e-4     # recon: a 10,000-query chunk, card against CPU, f32 with TF32 off:
                           # |card - cpu| within this times max(1, largest |cpu logit|)
CLIP_TOL = 1e-4            # diffusion: the CLIP embeddings card against CPU, the same way
DIFF_DEPTH = 6             # sample_shapes_*'s octree depth (its default); cut first if the
                           # recon and diffusion phases run over their 90 s
SURFACE_FACES = 99_904     # sample_surface_torch's mesh: a UV sphere, 224 bands x 224 segments


def _kernel_launches(wrappers: dict) -> int:
    return sum(fn.launches for fn in wrappers.values())


def _tf32(torch) -> bool:
    return bool(torch.backends.cuda.matmul.allow_tf32)


def _torus_surface(path: str, n: int = 8192) -> str:
    """A seeded torus point cloud with its normals (.npz, points + normals)."""
    import numpy as np

    rng = np.random.default_rng(0)
    u, v = rng.uniform(0, 2 * np.pi, (2, n))
    big, small = 0.6, 0.25
    normals = np.stack([np.cos(u) * np.cos(v), np.sin(u) * np.cos(v), np.sin(v)], -1)
    centers = np.stack([big * np.cos(u), big * np.sin(u), np.zeros(n)], -1)
    np.savez(path, points=(centers + small * normals).astype(np.float32),
             normals=normals.astype(np.float32))
    return path


def query_flops(cfg, queries: int) -> float:
    """FLOPs of the occupancy decoder over ``queries`` points (2 a
    multiply-add): the query projection, the cross-attention block (q,
    proj, the 4x MLP, the scores and P.V over the latents) and the output;
    the latents' k/v projection once a QUERY_BLOCK."""
    from meshanything_tpu_torch.models.perceiver import QUERY_BLOCK

    w, n_lat = cfg.width, cfg.total_latents
    per_query = 2 * (cfg.fourier_dim * w + 10 * w * w + 2 * n_lat * w + w)
    blocks = -(-queries // QUERY_BLOCK)
    return float(queries * per_query + blocks * 2 * n_lat * 2 * w * w)


def recon_phase(torch, wrappers: dict, card: str) -> None:
    """Phase recon: ``miche_cli`` at the full perceiver width (768, 8 + 16
    layers) on seeded random weights (seed 0, f32): ``--encode-only`` on a
    seeded 8192-point torus through ``main``, then the reconstruction at
    the CLI's defaults (depth 7: 129^3 = 2,146,689 queries in chunks of
    10,000, bounds 1.1) through ``get_args`` / ``load_perceiver`` /
    ``run``, after one change that random weights need: the occupancy
    output bias set to minus the median logit of a first query pass over
    the same grid (printed as ``bias_set_to``), so about half the grid is
    inside and the OBJ has faces. Prints the fenced query seconds, the
    marching seconds, the faces and the peak bytes; holds one 10,000-query
    chunk card against CPU (RECON_CHUNK_TOL, signs equal above it). No
    kernel of K1-K5 / T1-T5 may launch."""
    import copy

    import numpy as np

    from meshanything_tpu_torch import miche_cli
    from meshanything_tpu_torch.config import PerceiverConfig
    from meshanything_tpu_torch.models import perceiver as per
    from meshanything_tpu_torch.runtime import recon

    launches = _kernel_launches(wrappers)
    failures = []
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = PerceiverConfig()
    with tempfile.TemporaryDirectory() as tmp:
        surface = _torus_surface(os.path.join(tmp, "torus.npz"))
        common = ["--input", surface, "--random_weights", "--device", "cuda"]
        latents_path = os.path.join(tmp, "latents.npy")
        t0 = time.perf_counter()
        miche_cli.main([*common, "--encode-only", "--out", latents_path])
        encode_s = time.perf_counter() - t0
        latents = np.load(latents_path)
        emit("recon_encode_only", seconds=encode_s, shape=list(latents.shape),
             finite=bool(np.isfinite(latents).all()), card=card)
        if latents.shape != (1, cfg.num_latents, cfg.embed_dim) or not np.isfinite(latents).all():
            failures.append(("encode-only latents", latents.shape))

        obj = os.path.join(tmp, "recon.obj")
        args = miche_cli.get_args([*common, "--out", obj])
        perceiver = miche_cli.load_perceiver(args, cfg, dev)
        surf = miche_cli.load_surface(args.input, args.num_points, args.seed)
        surf[:, 2] *= -1                          # as run() flips it
        with torch.no_grad():
            feats = per.encode_latents(perceiver, cfg, torch.from_numpy(surf)[None].to(dev))
            decoded = per.decode_latents(perceiver, cfg,
                                         per.encode_kl_mode(perceiver, feats[:, 1:]))
        xyz, _, _, _ = recon.grid(args.bounds, args.octree_depth)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = recon.occupancy_logits(perceiver, cfg, decoded, xyz, args.num_chunks)
        first_s = time.perf_counter() - t0
        median = float(np.median(first))
        with torch.no_grad():
            perceiver.geo_decoder.output_proj.bias.fill_(-median)
        torch.cuda.reset_peak_memory_stats()
        before_bytes = torch.cuda.memory_allocated()
        record = miche_cli.run(args, perceiver, cfg)
        peak = torch.cuda.max_memory_allocated()
        with open(obj, "rb") as fh:
            text = fh.read()
        obj_faces, obj_verts = text.count(b"\nf "), text.count(b"\nv ") + text.startswith(b"v ")
        flops = query_flops(cfg, record["queries"])
        emit("recon", depth=args.octree_depth, queries=record["queries"],
             num_chunks=args.num_chunks, bounds=args.bounds, first_pass_query_s=first_s,
             crosses_without_bias=bool(first.min() < 0 < first.max()), bias_set_to=-median,
             query_s=record["query_s"], march_s=record["march_s"], faces=record["faces"],
             obj_faces=obj_faces, obj_vertices=obj_verts, peak_bytes=peak,
             allocated_before_bytes=before_bytes, query_tflop=flops / 1e12,
             query_tflops_per_s=flops / record["query_s"] / 1e12, f32_peak_tflops=67.0,
             tf32=_tf32(torch), card=card)
        if not record["faces"] > 0 or obj_faces != record["faces"] or obj_verts == 0:
            failures.append(("recon OBJ", record["faces"], obj_faces, obj_verts))

        mid = len(xyz) // 2 - args.num_chunks // 2
        chunk = xyz[mid:mid + args.num_chunks]
        card_logits = recon.occupancy_logits(perceiver, cfg, decoded, chunk, args.num_chunks)
        cpu = copy.deepcopy(perceiver).cpu()
        cpu_logits = recon.occupancy_logits(cpu, cfg, decoded.cpu(), chunk, args.num_chunks)
        err = float(np.abs(card_logits - cpu_logits).max())
        tol = RECON_CHUNK_TOL * max(1.0, float(np.abs(cpu_logits).max()))
        big = np.abs(cpu_logits) > tol
        signs = bool((np.sign(card_logits[big]) == np.sign(cpu_logits[big])).all())
        emit("recon_chunk_check", queries=len(chunk), max_abs_err=err, tolerance=tol,
             signs_equal_above_tolerance=signs, tf32=_tf32(torch))
        if err > tol or not signs:
            failures.append(("recon chunk card vs cpu", err, tol, signs))
    launched = _kernel_launches(wrappers) - launches
    emit("recon_done", seconds=time.perf_counter() - t_phase, kernel_launches=launched, card=card)
    if launched:
        failures.append(("a kernel launched on the recon path", launched))
    if failures:
        raise AssertionError(f"recon: {failures}")


def udt_flops(cfg, batch: int, n_cond: int = 1) -> float:
    """FLOPs of one UDT forward over [t ‖ context ‖ x] (2 a multiply-add):
    2L + 1 blocks (qkv, proj and the 4x MLP: 12 w^2 a token; scores and
    P.V: 4 n w a token), the L skip projections (2 w^2 a token) and the
    input / output / context projections."""
    w, n = cfg.width, 1 + n_cond + cfg.n_ctx
    blocks = 2 * cfg.layers + 1
    per_token = blocks * (24 * w * w + 4 * n * w) + cfg.layers * 4 * w * w
    io = (2 * cfg.n_ctx * w * (cfg.input_channels + cfg.output_channels)
          + 2 * n_cond * cfg.context_dim * w)
    return float(batch * (n * per_token + io))


def _uv_sphere(np, bands: int = 224, segments: int = 224):
    """A unit UV sphere, outward faces: 2 x ``segments`` x (``bands`` - 1)
    of them (SURFACE_FACES)."""
    theta = np.linspace(0, np.pi, bands + 1)[1:-1]
    phi = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ring = np.stack([np.sin(theta)[:, None] * np.cos(phi), np.sin(theta)[:, None] * np.sin(phi),
                     np.cos(theta)[:, None] + 0 * phi], -1).reshape(-1, 3)
    v = np.concatenate([[[0, 0, 1.0]], ring, [[0, 0, -1.0]]])
    s, last = np.arange(segments), len(v) - 1
    faces = [np.stack([np.zeros(segments, int), 1 + s, 1 + (s + 1) % segments], -1)]
    for r in range(bands - 2):
        a, b = 1 + r * segments + s, 1 + r * segments + (s + 1) % segments
        faces += [np.stack([a, a + segments, b], -1), np.stack([b, a + segments, b + segments], -1)]
    base = 1 + (bands - 2) * segments
    faces.append(np.stack([base + s, np.full(segments, last), base + (s + 1) % segments], -1))
    return v, np.concatenate(faces)


def _embed_err(a, b) -> float:
    """|card - cpu| over max(1, largest |cpu|)."""
    b = b.float()
    return float((a.float().cpu() - b).abs().max() / max(1.0, float(b.abs().max())))


def diffusion_phase(torch, wrappers: dict, card: str) -> None:
    """Phase diffusion, at the published widths on seeded random weights
    (N(0, 0.02) CLIP, the UDT's init_scale/sqrt(width) linears), f32, TF32
    off: the CLIP ViT-L/14 image tower (224 px, width 1024, 24 layers) and
    text tower (width 768, 12 layers, 77 positions) at B = 1 and 2 (ms a
    call; the image and text embeddings card against CPU within CLIP_TOL);
    the UDT at ``DiffusionConfig()`` (ms of a CFG forward at B = 1, the
    50-step DDIM sample at CFG 3.0 twice from one generator, bit-equal, ms a
    step; a 32-step Karras sample); ``sample_shapes_from_image`` and
    ``sample_shapes_from_text`` end to end at B = 1 with the full-width
    perceiver (seconds a shape, octree depth DIFF_DEPTH); and
    ``sample_surface_torch`` at 4096 samples on a SURFACE_FACES-face sphere
    against the numpy sampler's time. No kernel of K1-K5 / T1-T5 may
    launch."""
    import copy
    import math

    import numpy as np

    from meshanything_tpu_torch.config import PerceiverConfig
    from meshanything_tpu_torch.geometry import sample_surface_torch, sample_surface_with_normals
    from meshanything_tpu_torch.models import clip_cond as cc
    from meshanything_tpu_torch.models import clip_diffuser as cd
    from meshanything_tpu_torch.models import diffusion as dm
    from meshanything_tpu_torch.runtime.checkpoint import init_random_perceiver, randomize_

    launches = _kernel_launches(wrappers)
    failures = []
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    tcfg, vcfg, dcfg, pcfg = (cc.CLIPTextConfig(), cc.CLIPVisionConfig(), dm.DiffusionConfig(),
                              PerceiverConfig())
    text = randomize_(cc.CLIPTextTower(tcfg, device=dev), gen)
    vision = randomize_(cc.CLIPVisionTower(vcfg, device=dev), gen)
    image = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 240, 320)).astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.integers(1, 49406, (2, tcfg.max_positions))).to(dev)
    ids[:, 0] = 49406                            # bos
    ids[0, 9:] = ids[1, 20:] = tcfg.eos_token_id  # eos, and eos as the pad

    with torch.no_grad():
        towers = {}
        for b in (1, 2):
            pixels = cc.preprocess_image(image[:b], vcfg.image_size)
            for name, run in (("image", lambda: vision.features(pixels)),
                              ("text", lambda: text.features(ids[:b]))):
                run()
                towers[f"{name}_ms_b{b}"] = _events_ms(torch, run, 10)
        cpu_v, cpu_t = copy.deepcopy(vision).cpu(), copy.deepcopy(text).cpu()
        img_err = _embed_err(cc.image_embedding(vision, image[:1]),
                             cc.image_embedding(cpu_v, image[:1].cpu()))
        txt_err = _embed_err(cc.text_embedding(text, ids[:1]),
                             cc.text_embedding(cpu_t, ids[:1].cpu()))
        del cpu_v, cpu_t
    emit("diffusion_clip", **towers, image_err=img_err, text_err=txt_err, tolerance=CLIP_TOL,
         image_input=[240, 320], tf32=_tf32(torch), card=card)
    if img_err > CLIP_TOL or txt_err > CLIP_TOL:
        failures.append(("clip card vs cpu", img_err, txt_err))

    udt = randomize_(dm.UDTDenoiser(dcfg, device=dev), gen,
                     dcfg.init_scale * math.sqrt(1.0 / dcfg.width))
    with torch.no_grad():
        cond = cc.image_embedding(vision, image[:1])
        x = torch.randn((2, dcfg.n_ctx, dcfg.input_channels), generator=gen, device=dev)
        t2 = torch.full((2,), 500, device=dev)
        c2 = torch.cat([torch.zeros_like(cond), cond])
        eager = udt(x, t2, c2)
        cfg_forward_ms = _events_ms(torch, lambda: udt(x, t2, c2), 10)
        # the same forward captured once and replayed: its device time, no host launches
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            udt(x, t2, c2)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            replayed = udt(x, t2, c2)
        cfg_forward_graph_ms = _events_ms(torch, graph.replay, 10)
        graph_equal = bool(torch.equal(replayed, eager))
        del graph
    shape = (pcfg.num_latents, pcfg.embed_dim)
    samples, ddim_s = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples.append(dm.ddim_sample(udt, cond, shape=shape, steps=50, guidance_scale=3.0,
                                      generator=torch.Generator(device=dev).manual_seed(7)))
        torch.cuda.synchronize()
        ddim_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    karras = dm.karras_sample(udt, cond, shape=shape, steps=32, guidance_scale=3.0,
                              generator=torch.Generator(device=dev).manual_seed(7))
    torch.cuda.synchronize()
    karras_s = time.perf_counter() - t0
    equal = bool(torch.equal(samples[0], samples[1]))
    finite = bool(torch.isfinite(samples[0]).all() and torch.isfinite(karras).all())
    emit("diffusion_udt", cfg_forward_ms_b2=cfg_forward_ms,
         cfg_forward_graph_ms_b2=cfg_forward_graph_ms, graph_equal_eager=graph_equal,
         cfg_forward_gflop=udt_flops(dcfg, 2) / 1e9, ddim_steps=50, guidance=3.0,
         ddim_s=ddim_s, ddim_ms_a_step=[s * 20 for s in ddim_s], ddim_bit_equal=equal,
         karras_steps=32, karras_s=karras_s, finite=finite, tf32=_tf32(torch), card=card)
    if not equal or not finite:
        failures.append(("ddim/karras", equal, finite))

    perceiver = init_random_perceiver(pcfg, gen)
    runs = {"image": lambda g: cd.sample_shapes_from_image(
                udt, perceiver, pcfg, vision, image[:1], generator=g, octree_depth=DIFF_DEPTH),
            "text": lambda g: cd.sample_shapes_from_text(
                udt, perceiver, pcfg, text, ids[:1], generator=g, octree_depth=DIFF_DEPTH)}
    torch.cuda.reset_peak_memory_stats()
    for name, run in runs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meshes = run(torch.Generator(device=dev).manual_seed(11))
        seconds = time.perf_counter() - t0
        mesh = meshes[0]
        ok = len(meshes) == 1 and (mesh is None or (
            np.isfinite(mesh.vertices).all() and mesh.faces.max() < len(mesh.vertices)))
        emit("diffusion_sample_shapes", cond=name, seconds_a_shape=seconds, depth=DIFF_DEPTH,
             faces=None if mesh is None else len(mesh.faces), well_formed=bool(ok))
        if not ok:
            failures.append(("sample_shapes", name))
    emit("diffusion_peak", peak_bytes=torch.cuda.max_memory_allocated(),
         allocated_bytes=torch.cuda.memory_allocated())

    v, f = _uv_sphere(np)
    vt, ft = torch.from_numpy(v).float().to(dev), torch.from_numpy(f).to(dev)
    sgen = torch.Generator(device=dev).manual_seed(3)
    torch_ms = _events_ms(torch, lambda: sample_surface_torch(sgen, vt, ft, 4096), 20)
    t0 = time.perf_counter()
    for seed in range(5):
        sample_surface_with_normals(v, f, 4096, np.random.default_rng(seed))
    numpy_ms = (time.perf_counter() - t0) / 5 * 1e3
    pts = sample_surface_torch(sgen, vt, ft, 4096).cpu().numpy()
    radius = np.linalg.norm(pts[:, :3], axis=1)
    unit = np.abs(np.linalg.norm(pts[:, 3:], axis=1) - 1).max()
    outward = float((np.sum(pts[:, 3:] * pts[:, :3], 1) / radius).min())
    ok = radius.max() <= 1 + 1e-5 and radius.min() > 0.999 and unit < 1e-5 and outward > 0.99
    emit("diffusion_surface_sampler", faces=len(f), samples=4096, torch_ms=torch_ms,
         numpy_ms=numpy_ms, radius=[float(radius.min()), float(radius.max())],
         normal_unit_err=float(unit), min_outward_cos=outward, ok=bool(ok), card=card)
    if len(f) != SURFACE_FACES or not ok:
        failures.append(("sample_surface_torch", len(f), ok))
    launched = _kernel_launches(wrappers) - launches
    emit("diffusion_done", seconds=time.perf_counter() - t_phase, kernel_launches=launched,
         card=card)
    if launched:
        failures.append(("a kernel launched on the diffusion path", launched))
    if failures:
        raise AssertionError(f"diffusion: {failures}")


MOON_CUR_LENS = (258, 1000, 3860, 7459)   # the latent cache's live rows over a mesh's decode
MOON_RTOL = 1e-2      # L1's bf16 output: one bf16 step of a head's largest element
X1_RTOL = 1e-3        # X1's f32 output: f32 sums of 2,048 and 1,408 products in another order


def _steer(cache, q, layer: int, row: int, scale: float) -> None:
    """Make cache row ``row`` of ``layer`` carry every head's attention: the
    sum of the heads' queries, scaled so its logit is about 10 above the
    others' (so reading one row more or fewer moves the output whole)."""
    direction = q.float().sum(dim=1)                                  # (B, W)
    gain = 10.0 / (scale * (q.float() * direction[:, None]).sum(-1).mean(-1))
    cache[layer, :, row] = (direction * gain[:, None]).to(cache.dtype)


def check_moonlight_kernels(torch, la, ex) -> dict:
    """L1 and X1 against their plain versions at Moonlight's widths (phase
    18) -> the worst error of each, as a share of its tolerance."""
    dev = torch.device("cuda")
    worst = {"l1": 0.0, "x1": 0.0}
    failures = []
    heads, latent, rope, seq, layers = 16, 512, 64, 7680, 3
    scale = 192 ** -0.5
    for batch in (1, 2):
        g = torch.Generator(device=dev).manual_seed(batch)
        base = torch.randn(layers, batch, seq, latent + rope, generator=g, device=dev).bfloat16()
        q = (torch.randn(batch, heads, latent + rope, generator=g, device=dev) * 0.05).bfloat16()
        for cur in MOON_CUR_LENS:
            for steer in (None, 0, cur - 1):
                cache = base.clone()
                if steer is not None:
                    _steer(cache, q, 1, steer, scale)
                cache[1, :, cur:] = float("nan")
                want = la.latent_attention_reference(q, cache, 1, cur, scale=scale,
                                                     latent=latent).float()
                length = torch.tensor(cur, dtype=torch.int32, device=dev)
                got = la.latent_attention(q, cache, 1, length, scale=scale, latent=latent).float()
                tol = MOON_RTOL * want.abs().amax(dim=-1, keepdim=True)
                share = float(((got - want).abs() / tol).nan_to_num(float("inf")).max())
                worst["l1"] = max(worst["l1"], share)
                emit("moonlight_l1", batch=batch, cur_len=cur, steered_row=steer,
                     err_over_tol=share)
                if not share <= 1.0:
                    failures.append(("l1", batch, cur, steer, share))
    n_exp, k, d, width, moe_layers = 64, 6, 2048, 1408, 26
    for batch in (1, 3):
        g = torch.Generator(device=dev).manual_seed(10 + batch)

        def w(*shape):
            return (torch.randn(*shape, generator=g, device=dev) * 0.02).bfloat16()

        x = torch.randn(batch, d, generator=g, device=dev).bfloat16()
        mats = (w(n_exp, width, d), w(n_exp, width, d), w(n_exp, d, width))
        shared = (w(2 * width, d), w(2 * width, d), w(d, 2 * width))
        ids = torch.stack([torch.randperm(n_exp, generator=g, device=dev)[:k]
                           for _ in range(batch)])
        weights = torch.rand(batch, k, generator=g, device=dev)
        counts = torch.zeros(moe_layers, n_exp, dtype=torch.int32, device=dev)
        routes = torch.full((moe_layers, batch, seq, k), -1, dtype=torch.int32, device=dev)
        pos = torch.tensor([4321], dtype=torch.int64, device=dev)
        got = ex.routed_experts(x, ids, weights, *mats, shared=shared, counts=counts, layer=7,
                                routes=routes, pos=pos)
        want = ex.routed_experts_reference(x, ids, weights, *mats, shared=shared)
        torch.cuda.synchronize()
        tol = X1_RTOL * want.abs().amax(dim=-1, keepdim=True)
        share = float(((got - want).abs() / tol).max())
        worst["x1"] = max(worst["x1"], share)
        counted = counts[7].tolist() == torch.bincount(ids.flatten(), minlength=n_exp).tolist() \
            and int(counts.sum()) == batch * k
        recorded = torch.equal(routes[7, :, 4321], ids.int()) and \
            int((routes != -1).sum()) == batch * k
        emit("moonlight_x1", batch=batch, slots=k + 2, err_over_tol=share, counted=counted,
             recorded=recorded)
        if not (share <= 1.0 and counted and recorded):
            failures.append(("x1", batch, share, counted, recorded))
    if failures:
        raise AssertionError(f"moonlight kernels: {failures}")
    return worst


def _moonlight_model(torch, cfg, seed: int = 0):
    """Moonlight-16B-A3B whole under MeshAnything's interface on the card,
    bf16: every matrix and table N(0, 0.02), norm weights 1, biases 0, the
    correction bias N(0, 0.05), eos's row of lm_head 0 (no request stops
    early)."""
    from meshanything_tpu_torch.models import moonlight
    from meshanything_tpu_torch.models.meshanything import MeshAnything

    net = MeshAnything(cfg, device="meta", dtype=torch.bfloat16).to_empty(device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    norms = {id(m.weight) for m in net.modules()
             if isinstance(m, (torch.nn.LayerNorm, moonlight.RMSNorm))}
    for name, p in net.named_parameters():
        if id(p) in norms:
            p.fill_(1.0)
        elif name.endswith("e_score_correction_bias"):
            p.normal_(0.0, 0.05, generator=g)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.normal_(0.0, 0.02, generator=g)
    net.opt.lm_head.weight[cfg.opt.eos_token_id].zero_()
    return net


def moonlight_phase(torch, wrappers: dict, card: str) -> None:
    """Phase 18 (see the module's text)."""
    import gc

    from meshanything_tpu_torch.config import MeshAnythingConfig, MoonlightConfig
    from meshanything_tpu_torch.ops import experts as ex
    from meshanything_tpu_torch.ops import latent_attention as la
    from meshanything_tpu_torch.runtime import profiling
    from meshanything_tpu_torch.runtime.decode_graph import StepGraph
    from meshanything_tpu_torch.runtime.phases import PhaseRunner

    worst = check_moonlight_kernels(torch, la, ex)
    cfg = MeshAnythingConfig(opt=MoonlightConfig())
    o = cfg.opt
    net = _moonlight_model(torch, cfg)
    gen = torch.Generator().manual_seed(3)
    pc = torch.randn(1, cfg.perceiver.num_points, 6, generator=gen)
    pc[..., 3:] /= pc[..., 3:].norm(dim=-1, keepdim=True)
    runner = PhaseRunner(net, cfg, early_exit=False)
    torch.cuda.synchronize()
    _zero_counts(wrappers)
    StepGraph.captures = StepGraph.replays = 0
    t0 = time.perf_counter()
    out = runner.run(pc.cuda())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    captures, replays, steps = out["graph_captures"], out["graph_replays"], out["decode_steps"]
    wrapped = 2 * captures                  # each graph's warm-up step and its capture
    expected = {k: 0 for k in wrappers}
    expected.update(l1=o.num_layers * wrapped, x1=o.num_moe_layers * wrapped)
    state = next(reversed(runner._kept.values())).state
    request = [sp for sp in profiling.spans() if sp.name == "request"][-1]
    counts = torch.tensor(request.attrs["expert_tokens"])
    live = o.cond_length + steps            # positions whose routes a step or the prefill wrote
    routes = state.routes[:, 0, o.cond_length:live].long().cpu()
    recorded = torch.stack([torch.bincount(r.flatten(), minlength=o.n_routed_experts)
                            for r in routes])
    surplus = replays + captures - steps
    emit("moonlight", run="phase_runner_800", card=card, wall_s=wall, decode_s=out["decode_s"],
         decode_steps=steps, graph_captures=captures, graph_replays=replays, launches=launches,
         replayed_launches={"l1": o.num_layers * replays, "x1": o.num_moe_layers * replays},
         expert_tokens_per_layer=counts.sum(dim=1).tolist()[:3],
         faces=int(out["coords"].shape[1]), worst=worst,
         peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    failures = []
    if launches != expected or not captures:
        failures.append(f"launches {launches}, expected {expected}")
    if StepGraph.captures != captures or StepGraph.replays != replays or \
            not 0 <= surplus < segment_steps("k1"):
        failures.append(f"{captures} captures and {replays} replays for {steps} steps")
    if steps != cfg.generate_length - 1 or counts.shape != (o.num_moe_layers, o.n_routed_experts):
        failures.append(f"decode_steps {steps}, counter {tuple(counts.shape)}")
    elif not (counts.sum(dim=1) == counts.sum(dim=1)[0]).all() or \
            int(counts[0].sum()) != o.num_experts_per_tok * (captures + replays):
        # the counter counts every step the kernel ran: each graph's warm-up, then its replays
        failures.append(f"expert tokens a layer {counts.sum(dim=1).tolist()}")
    if not bool((recorded <= counts).all()) or \
            int(recorded.sum()) != o.num_moe_layers * o.num_experts_per_tok * steps:
        failures.append("the routing record disagrees with the expert counter")
    del runner, net, state
    gc.collect()
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"moonlight: {failures}")


PHASES = ("add_ln", "k4_check", "k1_check", "k23_check", "graph_replay", "device_length", "k1_time",
          "fast_time", "k5_check", "k5_replay", "k5_time", "probe_check", "probe_time",
          "measurement_path", "main_path", "graph_loop", "agreement", "floor", "serving",
          "train", "checkpoint", "warm_start", "parallel", "parallel_nccl", "recon", "diffusion",
          "moonlight")


def parse_only(argv: list) -> set:
    """``--only a,b`` -> the phases to run (the device check, the canary
    and the builds always run); no argument: every phase, and the
    ``kernels`` line, which needs them all."""
    if not argv:
        return set(PHASES)
    if len(argv) != 2 or argv[0] != "--only":
        raise SystemExit(f"usage: chip_smoke.py [--only phase,...]; phases: {', '.join(PHASES)}")
    only = set(argv[1].split(","))
    unknown = only - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}; phases: {', '.join(PHASES)}")
    if "floor" in only and not {"main_path", "probe_time"} <= only:
        raise SystemExit("floor needs main_path and probe_time")
    if "graph_loop" in only and "main_path" not in only:
        raise SystemExit("graph_loop needs main_path (its paired runs are the main path's)")
    return only


def main(argv=None) -> int:
    import torch

    only = parse_only(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from meshanything_tpu_torch import cli
    from meshanything_tpu_torch.geometry import load_obj
    from meshanything_tpu_torch.ops import _build
    from meshanything_tpu_torch.ops import add_layer_norm as aln
    from meshanything_tpu_torch.ops import decode_attention as da
    from meshanything_tpu_torch.ops import experts as ex
    from meshanything_tpu_torch.ops import k1_probe as kp
    from meshanything_tpu_torch.ops import latent_attention as la
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

    mutants = DEVICE_LEN_LIBS if "device_length" in only else ()
    with ThreadPoolExecutor(len(KERNEL_LIBS) + len(mutants)) as pool:   # one nvcc a source
        mutated = pool.map(build_plan_from_bound, mutants)
        libs = list(pool.map(_build.load, KERNEL_LIBS))
        mutated = dict(zip(mutants, mutated))
    for name, lib in zip(KERNEL_LIBS, libs):
        emit("build", kernel=name, built=lib.built, seconds=lib.seconds,
             ptxas=[ln for ln in lib.log.splitlines() if "registers" in ln or "spill" in ln])

    worst, times, probe_times = {}, {}, {}
    clock = [time.perf_counter()]

    def tick(name: str) -> None:
        """The seconds of the phase that just ran (the device check, the
        canary and the builds before the first are in none)."""
        if name in only:
            now = time.perf_counter()
            emit("phase_seconds", name=name, seconds=now - clock[0])
            clock[0] = now

    if "add_ln" in only:
        worst["add_ln"] = check_add_ln(torch, aln)
        times["add_ln"] = time_add_ln(torch, aln, card)
    tick("add_ln")
    if "k4_check" in only:
        k4_worst = check_k4(torch, da)
        worst.update(k4=k4_worst["tile_split"], k4_window=k4_worst["window"],
                     k4_window_quant=k4_worst["window_quant"])
    tick("k4_check")
    if "k1_check" in only:
        worst["k1"] = check_k1(torch, da)
    tick("k1_check")
    if "k23_check" in only:
        worst.update(check_k23(torch, da))
    tick("k23_check")
    if "graph_replay" in only:
        check_graph_replays(torch, da)
    tick("graph_replay")
    if "device_length" in only:
        check_device_length(torch, da, mutated)
    tick("device_length")
    if "k1_time" in only:
        times["k1"] = time_k1(torch, da, card)
    tick("k1_time")
    if "fast_time" in only:
        from meshanything_tpu_torch.tools.attn_compare import quant_grid
        times.update(time_fast(torch, da, card))
        times["quant_grid"] = quant_grid(torch, da, card)
    tick("fast_time")
    if "k5_check" in only:
        worst["k5"] = check_k5(torch, mk)
    tick("k5_check")
    if "k5_replay" in only:
        check_k5_replays(torch, mk)
    tick("k5_replay")
    if "k5_time" in only:
        times["k5"] = time_k5(torch, mk, da, card)
    tick("k5_time")
    if "probe_check" in only:
        worst.update(check_streams(torch, pr), t4=check_k1_probe(torch, kp, da))
    tick("probe_check")
    roof_gbs = None
    if "probe_time" in only:
        probe_times, roof_gbs = time_streams(torch, pr, card)
        probe_times.update(t4=time_k1_probe(torch, kp, da, card), t5=time_canary(torch, pr, card))
        worst["t5"] = max(first["max_abs_err"],
                          *(t["max_abs_err"] for t in probe_times["t5"].values()))
    tick("probe_time")

    wrappers = {"k1": da.decode_attention, "k2": da.decode_attention_int8,
                "k3": da.decode_attention_int4, "k4": da.decode_attention_mq,
                "k5": mk.decode_step_megakernel, "t1": pr.stream, "t2": pr.stream_rot,
                "t3": pr.dual_stream, "t4": kp.k1_probe, "t5": pr.scale_shift,
                "aln": aln.add_layer_norm, "l1": la.latent_attention, "x1": ex.routed_experts}
    if "measurement_path" in only:
        probe_launches = drive_measurement_path(torch, wrappers)
    tick("measurement_path")
    runs = []
    if "main_path" in only:
        runs = drive_main_path(torch, wrappers, cli, load_obj, paired="graph_loop" in only)
    tick("main_path")
    if "graph_loop" in only:
        graph_loop(torch, wrappers, cli, load_obj, card, roof_gbs)
    tick("graph_loop")
    if "agreement" in only:
        small_input_agreement(torch)
    tick("agreement")
    if "floor" in only:
        floors_and_budget(torch, runs, roof_gbs, card)
    tick("floor")
    serving_launches = {}
    if "serving" in only:
        serving_runs, serving_launches = serving_phase(torch, wrappers, cli, load_obj, card)
        runs += serving_runs
    tick("serving")

    train_launches = {}
    if "train" in only:
        train_launches = train_phase(torch, wrappers, card)
    tick("train")
    if "checkpoint" in only:
        runs += checkpoint_phase(torch, wrappers, cli, load_obj, card)
    tick("checkpoint")
    if "warm_start" in only:
        warm_start_phase(torch, wrappers, load_obj, card)
    tick("warm_start")
    parallel_launches, parallel_worst = {}, {}
    if "parallel" in only:
        parallel_launches, parallel_worst = parallel_phase(torch, da, cli, load_obj, card)
    tick("parallel")
    if "parallel_nccl" in only:
        for key, n in parallel_nccl_phase(torch, card).items():
            parallel_launches[key] = parallel_launches.get(key, 0) + n
    tick("parallel_nccl")
    if "recon" in only:
        recon_phase(torch, wrappers, card)
    tick("recon")
    if "diffusion" in only:
        diffusion_phase(torch, wrappers, card)
    tick("diffusion")
    if "moonlight" in only:
        moonlight_phase(torch, wrappers, card)
    tick("moonlight")
    if only == set(PHASES):
        print(json.dumps(kernels_line(runs, times, probe_times, probe_launches, worst, roof_gbs,
                                      serving_launches, train_launches, parallel_launches,
                                      parallel_worst)), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def drive_main_path(torch, wrappers: dict, cli, load_obj, paired: bool = False) -> list:
    """Phase 8: the CLI runs and the pipeline runs, each through
    ``run_main_path`` (``paired``: each CLI run's batches decoded again
    eagerly, for phase graph_loop); returns their records."""
    def cli_run(argv):
        return lambda: cli.main(argv)

    with tempfile.TemporaryDirectory() as tmp:
        npy, mesh_dir = write_inputs(tmp)
        common = ["--out_dir", os.path.join(tmp, "out"), "--random_weights", "--seed", "0",
                  "--dtype", "bfloat16", "--device", "cuda"]
        pc = ["--input_type", "pc_normal", "--input_path", npy, *common]
        meshes = ["--input_type", "mesh", "--input_dir", mesh_dir, "--batchsize_per_gpu", "2",
                  *common]
        cli_runs = [
            # depth cuts (100 faces, 901 steps; 200, 1801; 400, 3601; 50, 451) against the
            # smoke's limit of 1,200 s, which it aims to end within half of: the paired eager
            # decodes of phase graph_loop take most of this phase's time (F5's int4 + W8A8
            # eager step ~0.1 s, so F5 is cut furthest). M1 and graph_loop's exact run are
            # the full-length B=1 runs
            ("exact_pc", ["--n_max_triangles", "100", *pc], 1, "k1", 100),
            ("exact_meshes", ["--n_max_triangles", "400", *meshes], 2, "k1", 400),
            ("F1", ["--fast", "--n_max_triangles", "200", *pc], 1, "k4", 200),
            ("F2", ["--attn", "pallas_int4", "--lookahead", "adaptive", "--n_max_triangles",
                    "200", *meshes], 2, "k4", 200),
            ("F3", ["--lookahead", "8", *pc], 1, "k4", 800),
            ("F4", ["--attn", "pallas_int8", "--n_max_triangles", "100", *pc], 1, "k2", 100),
            ("F5", ["--attn", "pallas_int4", "--wq", "--n_max_triangles", "50", *meshes], 2,
             "k3", 50),
        ]
        runs = [run_main_path(torch, wrappers, load_obj, name, cli_run(argv), expect, kernel,
                              max_faces=faces, argv=argv, paired=paired and name in PAIRED_RUNS)
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
    return runs


def kernels_line(runs: list, times: dict, probe_times: dict, probe_launches: dict, worst: dict,
                 roof_gbs: float, serving_launches: dict, train_launches: dict,
                 parallel_launches: dict, parallel_worst: dict) -> dict:
    """The ``kernels`` line: K1-K5, the residual add and post-LN
    (``add_layer_norm``) and T1-T5, each with its launches on the
    main path, the serving path and the train phase's decode (``launches``;
    the serving path's and the train phase's also apart:
    ``launches_serving``, ``launches_train``), its largest error, its time, its plain
    version's, its bound, the library call's time where there is one, and
    its share of the measured roof."""
    launches = {k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]}
    window_launches = sum(r["k4_window_launches"] for r in runs)
    quant_window_launches = sum(r["k4_quant_window_launches"] for r in runs)
    # the launches inside the replayed CUDA graphs, which no wrapper counts
    replayed = {k: sum(r["replayed_launches"] for r in runs if r["kernel"] == k)
                for k in launches}
    replayed["k4_window"] = sum(r["replayed_launches"] for r in runs
                                if r["run"] in WINDOW_KERNEL_RUNS)
    replayed["k4"] -= replayed["k4_window"]
    src = "meshanything_tpu_torch/csrc/"
    tpu = "meshanything_tpu/ops/decode_attention.py:"
    # K2, K3 and the int8/int4 K4 beyond the headline shapes: {kernel: {b1_len300_w8: ms}}
    grid = {}
    for rec in times["quant_grid"]:
        key = f"b{rec['batch']}_len{rec['cur_len']}" + (
            f"_w{rec['window']}" if rec["kernel"].startswith("k4") else "")
        grid.setdefault(rec["kernel"], {})[key] = {f: rec[f] for f in ("ms", "bound_ms")}
    rows = [("k1", "decode_attention", "decode_attention.cu", "567", times["k1"]),
            ("k2", "decode_attention_int8", "decode_attention_quant.cu", "900", times["k2"]),
            ("k3", "decode_attention_int4", "decode_attention_quant.cu", "951", times["k3"]),
            ("k4", "decode_attention_mq (int8/int4 cache, bf16 queries, head width 64)",
             "decode_attention_window.cu", "98", times["k4_int8"])]
    kernels = []
    for key, name, source, line, t in rows:
        entry = {"name": name, "route": "cuda", "source": src + source, "replaces": tpu + line,
                 "launches": launches[key], "replayed_launches": replayed[key],
                 "max_abs_err": worst[key],
                 "ms": t[1]["ms"], "plain_ms": t[1]["plain_ms"], "bound_ms": t[1]["bound_ms"],
                 "bound_by": t[1]["bound_by"], "library_ms": t[1].get("library_ms"),
                 "ms_b16": t[16]["ms"], "plain_ms_b16": t[16]["plain_ms"],
                 "bound_ms_b16": t[16]["bound_ms"], "library_ms_b16": t[16].get("library_ms")}
        if key in ("k2", "k3"):
            entry["grid"] = grid[key]
        if key == "k4":
            entry["window"] = 8
            entry["cache"] = "int8"
            entry["max_abs_err"] = worst["k4_window_quant"]
            entry["launches"] = quant_window_launches
            # decode_attention_fast.cu's K4 (f32 cache, f32 queries, head width 8)
            entry["launches_other_k4_kernel"] = (launches["k4"] - window_launches
                                                 - quant_window_launches)
            for b in (1, 16):
                for field in ("ms", "plain_ms", "bound_ms"):
                    entry[f"{field}_int4_b{b}"] = times["k4_int4"][b][field]
            entry["grid"] = {"int8": grid["k4_int8"], "int4": grid["k4_int4"]}
        kernels.append(entry)
    t = times["k4_bfloat16"]
    kernels.append({
        "name": "decode_attention_mq (bf16 cache, head width 64)", "route": "cuda",
        "source": src + "decode_attention_window.cu", "replaces": tpu + "98",
        "launches": window_launches, "replayed_launches": replayed["k4_window"],
        "max_abs_err": worst["k4_window"], "window": 8,
        "ms": t[1]["ms"], "plain_ms": t[1]["plain_ms"], "bound_ms": t[1]["bound_ms"],
        "bound_by": t[1]["bound_by"], "library_ms": t[1]["library_ms"],
        "ms_b16": t[16]["ms"], "plain_ms_b16": t[16]["plain_ms"],
        "bound_ms_b16": t[16]["bound_ms"], "library_ms_b16": t[16]["library_ms"]})
    t = times["k5"]
    kernels.append({
        "name": "decode_step_megakernel", "route": "cuda", "source": src + "megakernel.cu",
        "replaces": "meshanything_tpu/ops/megakernel.py:86", "launches": launches["k5"],
        "max_abs_err": worst["k5"], "ms": t[(1, 7459)]["ms"], "plain_ms": t[(1, 7459)]["plain_ms"],
        "bound_ms": t[(1, 7459)]["bound_ms"], "bound_by": t[(1, 7459)]["bound_by"],
        "library_ms": None, "cur_len": 7459,
        **{f"{field}_b{b}_len{n}": t[(b, n)][field] for b in K5_TIME_BATCHES for n in K5_TIME_LENS
           for field in ("ms", "plain_ms", "bound_ms", "k1_loop_ms")}})
    kernels[0]["launches_measurement_path"] = probe_launches["k1"]   # bwprobe and T4's check
    # the serving path: K1 in the exact engine, the int8 K4 in the --fast engine
    for entry, key in ((kernels[0], "k1"), (kernels[3], "k4_int8")):
        entry["launches"] += serving_launches[key]
        entry["launches_serving"] = serving_launches[key]
        entry["replayed_launches_serving"] = serving_launches[key + "_replayed"]
    # the train phase's decode: K1 in plain greedy, the bf16 K4 in lookahead 8
    for entry, key in ((kernels[0], "k1"), (kernels[4], "k4_window")):
        entry["launches"] += train_launches[key]
        entry["launches_train"] = train_launches[key]
        entry["replayed_launches_train"] = train_launches[key + "_replayed"]
    # the parallel phase's ranks: K1-K3, the int8/int4 and bf16 K4 and K5
    for entry, key in ((kernels[0], "k1"), (kernels[1], "k2"), (kernels[2], "k3"),
                       (kernels[3], "k4_quant_window"), (kernels[4], "k4_window"),
                       (kernels[5], "k5")):
        entry["launches"] += parallel_launches[key]
        entry["launches_parallel"] = parallel_launches[key]
    for entry, key in ((kernels[0], "k1"), (kernels[1], "k2"), (kernels[2], "k3"),
                       (kernels[3], "k4_window_quant"), (kernels[4], "k4_window")):
        entry["max_abs_err_local_heads"] = parallel_worst[key]
    t = times["add_ln"]
    # the main path's, the serving path's, the train phase's decode and the parallel ranks'
    # launches, as K1's are counted (not phase add_ln's own checks and sweeps)
    aln = {"main": launches["aln"], "serving": serving_launches["aln"],
           "train": train_launches["aln"], "parallel": parallel_launches["aln"]}
    kernels.append({
        "name": "add_layer_norm", "route": "cuda", "source": src + "add_layer_norm.cu",
        "replaces": None, "launches": sum(aln.values()),
        "replayed_launches": sum(r["replayed_launches_add_ln"] for r in runs),
        "launches_serving": aln["serving"],
        "replayed_launches_serving": serving_launches["aln_replayed"],
        "launches_train": aln["train"], "replayed_launches_train": train_launches["aln_replayed"],
        "launches_parallel": aln["parallel"], "max_abs_err": worst["add_ln"],
        "ms": t[1]["ms"], "plain_ms": t[1]["plain_ms"], "bound_ms": t[1]["bound_ms"],
        "bound_by": t[1]["bound_by"], "library_ms": t[1]["library_ms"],
        "ms_b16": t[16]["ms"], "plain_ms_b16": t[16]["plain_ms"],
        "bound_ms_b16": t[16]["bound_ms"], "library_ms_b16": t[16]["library_ms"]})
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
    return {"kernels": kernels, "roof_gbs": roof_gbs, "data_sheet_gbs": data_sheet_gbs}


if __name__ == "__main__":
    sys.exit(main())
