"""Device-memory bandwidth probe and the decode's speed-of-light model
(the port of ``meshanything_tpu/runtime/bwprobe.py``).

The autoregressive decode is bound by memory bandwidth: every step reads
the weights once per batch and the live KV cache once per sequence. This
module measures the read rate the card sustains four ways:

  * ``stream``: ``x <- x * c`` over a large bf16 buffer (read + write);
  * ``matmul``: a pair of (8, d) x (d, N) ``torch.matmul`` products shaped
    like the decode step's weight traffic (read-dominated);
  * ``kernel``: K1, the flash-decode CUDA kernel, at full context;
  * ``wire``: T1, the stream probe that drives the copy machinery with no
    arithmetic in the way (``ops/probes.py::stream``);

and derives the exact-mode least seconds a mesh

  floor(B) = (weight_bytes * steps / B + kv_bytes_per_mesh) / rate.

On a card every rate is device time between two CUDA events around a
long loop of launches (K1, whose calls are short, inside one CUDA graph),
so the host's enqueue cost is not in it. On the CPU (``--device cpu``,
the plain versions, small sizes) it is the host clock, and the number is
no device metric.

    python -m meshanything_tpu_torch.runtime.bwprobe [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable

import torch

from meshanything_tpu_torch.config import MeshAnythingConfig


def time_loop(run: Callable[[], object], iters: int, device: torch.device, *,
              graph: bool = False) -> float:
    """Seconds for ``iters`` calls of ``run`` after one warm-up call:
    device time between CUDA events on a card (``graph``: the calls
    captured once in a CUDA graph and replayed), host clock on the CPU."""
    run()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        return time.perf_counter() - t0
    torch.cuda.synchronize(device)
    replay = None
    if graph:
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):     # warm-up off the capture
            run()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        replay = torch.cuda.CUDAGraph()
        with torch.cuda.graph(replay, stream=side):   # the stream that warmed up
            for _ in range(iters):
                run()
        replay.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    if replay is not None:
        replay.replay()
    else:
        for _ in range(iters):
            run()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / 1e3


def measure_stream_bw(gbytes: float = 2.0, iters: int = 40,
                      device: torch.device | str = "cuda") -> float:
    """Read+write stream bandwidth: ``x <- x * c`` in place over a bf16
    buffer of ``gbytes`` GB, ``iters`` times. Returns GB/s counting reads
    AND writes."""
    device = torch.device(device)
    n = max(1024, (int(gbytes * 1e9 / 2) // 1024) * 1024)
    x = torch.ones((n,), dtype=torch.bfloat16, device=device)
    t = time_loop(lambda: x.mul_(1.0), iters, device)
    return (2 * n * 2) * iters / t / 1e9


def measure_matmul_bw(rows: int = 16384, cols: int = 65536, iters: int = 50,
                      device: torch.device | str = "cuda") -> float:
    """Weight-streaming bandwidth: two bf16 matrices (2 GB each at the
    default size) chained through an 8-row activation, so each product is
    bound by reading its weights like the decode step. Returns GB/s."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    w1 = (torch.randn((rows, cols), generator=gen, device=device) * 0.003).bfloat16()
    w2 = (torch.randn((cols, rows), generator=gen, device=device) * 0.003).bfloat16()
    x = torch.ones((8, rows), dtype=torch.bfloat16, device=device)

    def run():
        y = torch.matmul(torch.matmul(x, w1), w2)
        x.copy_(y / y.abs().amax().clamp_min(1e-3))

    t = time_loop(run, iters, device)
    return (rows * cols + cols * rows) * 2 * iters / t / 1e9


def measure_kernel_bw(ctx: int = 7168, iters: int = 3000, layers: int = 24,
                      device: torch.device | str = "cuda") -> float:
    """K1's KV-sweep bandwidth at full context: B=1, 16 heads of 64, the
    calls cycling over ``layers`` layers of a bf16 cache (29 MB of live
    rows a call; 24 layers are 0.7 GB, so no call finds its rows in the
    50 MB L2). Returns GB/s of live rows."""
    from meshanything_tpu_torch.ops.decode_attention import decode_attention

    device = torch.device(device)
    b, h, dh = 1, 16, 64
    kv = torch.zeros((2, layers, b, ctx, h * dh), dtype=torch.bfloat16, device=device)
    q = torch.ones((b, h, dh), dtype=torch.bfloat16, device=device)
    sweeps = max(1, iters // layers)

    def sweep():
        for layer in range(layers):
            decode_attention(q, kv, layer, ctx)

    t = time_loop(sweep, sweeps, device, graph=True)
    return 2 * ctx * h * dh * 2 * layers * sweeps / t / 1e9


def measure_wire_bw(gib: float = 4.0, chunk: int = 512, depth: int = 2, iters: int = 8,
                    dtype: torch.dtype = torch.bfloat16,
                    device: torch.device | str = "cuda") -> float:
    """T1's rate: every byte of a (rows, 1024) array of ``gib`` GiB
    through the stream probe, ``iters`` times. Returns GB/s."""
    from meshanything_tpu_torch.ops.probes import stream

    device = torch.device(device)
    width = 1024
    itemsize = torch.empty((), dtype=dtype).element_size()
    rows = int(gib * 2 ** 30 / (width * itemsize))
    rows = max(chunk, rows - rows % chunk)
    x = torch.zeros((rows, width), dtype=dtype, device=device)
    t = time_loop(lambda: stream(x, chunk, depth), iters, device)
    return rows * width * itemsize * iters / t / 1e9


def decode_bytes(cfg: MeshAnythingConfig, int8: bool = False) -> dict:
    """Exact byte counts of the full-length decode (the physics)."""
    o = cfg.opt
    d = o.hidden_size
    steps = cfg.generate_length
    c = o.cond_length
    # per-step weight reads: qkv(3d^2) + out(d^2) + fc1/fc2(8d^2) per
    # layer, + lm_head, + biases/LN (negligible but counted)
    per_layer = (12 * d * d + (3 * d + d + 4 * d + d) + 4 * d)
    weight_elems = o.num_layers * per_layer + d * o.vocab_size
    weight_bytes_per_step = weight_elems * 2  # bf16
    # KV: step t reads (c + t) rows of 2 * L * d elements
    rows_total = steps * c + steps * (steps - 1) // 2
    elem = 1 if int8 else 2
    kv_bytes_per_mesh = rows_total * 2 * o.num_layers * d * elem
    return {
        "steps": steps,
        "weight_bytes_per_step": weight_bytes_per_step,
        "weight_bytes_total": weight_bytes_per_step * steps,
        "kv_bytes_per_mesh": kv_bytes_per_mesh,
    }


def exact_floor_seconds(cfg: MeshAnythingConfig, bw_gbs: float, batch: int = 1,
                        int8: bool = False, acceptance: float = 1.0) -> float:
    """Least seconds a mesh at the measured bandwidth.

    acceptance > 1 models lookahead: weight reads and KV sweeps are
    shared across `acceptance` tokens per forward."""
    b = decode_bytes(cfg, int8)
    total = (b["weight_bytes_total"] / batch + b["kv_bytes_per_mesh"]) / acceptance
    return total / (bw_gbs * 1e9)


def main(argv=None) -> int:
    from meshanything_tpu_torch.tools.build_canary import canary, resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "bwprobe")
    torch.set_grad_enabled(False)
    s = 1.0 if device.type == "cuda" else 1 / 256   # the CPU rehearses at a small size
    first = canary(device)     # the build-and-launch route works before anything is measured
    card = first["card"]
    print(json.dumps(first), flush=True)

    def iters(n: int) -> int:
        return max(1, int(n * s))

    rates = {}
    for name, label, fn in (
            ("stream", "stream r+w BW (x <- x*c, bf16)", lambda: measure_stream_bw(
                2.0 * s, iters(40), device)),
            ("matmul", "matmul weight-stream BW", lambda: measure_matmul_bw(
                max(8, int(16384 * s)), max(8, int(65536 * s)), iters(50), device)),
            ("kernel", "K1 KV-sweep BW", lambda: measure_kernel_bw(
                max(1, int(7168 * s)), iters(3000), 24, device)),
            ("wire", "T1 wire BW", lambda: measure_wire_bw(
                4.0 * s, 512 if s >= 1 else 8, 2, iters(8), torch.bfloat16, device))):
        rates[name] = fn()
        print(f"{label + ':':36s}{rates[name]:9.1f} GB/s", flush=True)
        print(json.dumps({"measurement": name, "gb_per_s": rates[name], "device": args.device,
                          "card": card}), flush=True)
    bw = max(rates.values())
    cfg = MeshAnythingConfig()
    byts = decode_bytes(cfg)
    print(f"weight bytes/step: {byts['weight_bytes_per_step'] / 1e6:.1f} MB; "
          f"KV bytes/mesh: {byts['kv_bytes_per_mesh'] / 1e12:.2f} TB")
    floors = {}
    for batch in (1, 8, 16):
        floors[f"exact_bf16_floor_b{batch}"] = exact_floor_seconds(cfg, bw, batch)
    for batch in (8, 16):
        floors[f"int8_kv_floor_b{batch}"] = exact_floor_seconds(cfg, bw, batch, int8=True)
    for name, seconds in floors.items():
        print(f"{name}: {seconds:6.3f} s/mesh  (BW {bw:.0f} GB/s)")
    print(json.dumps({"floors_s_per_mesh": floors, "bw_gb_per_s": bw, "device": args.device,
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
