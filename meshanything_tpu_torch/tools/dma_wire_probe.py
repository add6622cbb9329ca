"""What read rate does this card's device memory sustain? (The port of
``tools/dma_wire_probe.py``.)

Every bound in PERF.md divides bytes by the data-sheet rate. This probe
measures the rate a kernel can actually reach, with no arithmetic in the
way, over a (rows, 1024) array the size of a decode cache:

  1. ``torch_sum``: ``torch.sum(x, dtype=float32)``, PyTorch's own
     reduction, and ``copy``: a device-to-device ``copy_`` (read + write);
  2. ``stream``: T1 (``ops/probes.py::stream``), every byte copied into
     shared memory by the copy machinery, one element a chunk tapped.

    python -m meshanything_tpu_torch.tools.dma_wire_probe [gib] [chunk] [verify|dual]
                                                          [--device cpu]

``verify`` times T1 called the same way every time (invariant), T2 with
the walk rotated by the call's number, and T2 seeded with the call's
number but walking as T1 does: the three agree unless the rate comes from
replaying one access pattern. ``dual`` adds T3: two arrays streamed
together, as the decode kernels stream the K and the V plane, with one
and two barriers a slot and a ring of 2 and 4 slots.

Rates are device time between CUDA events around 8 calls. Each kernel's
result is held against its plain version on integer-valued data, where
the f32 sums are exact in any order. One JSON line a measurement, with
the card's name and power limit, then ``DMA-WIRE-PROBE-OK``.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

WIDTH = 1024   # the 350M model's row: 16 heads x 64
N_ITER = 8


def integer_rows(torch, rows: int, dtype, device, seed: int):
    """A (rows, WIDTH) array of random integers in [-8, 8]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.empty((rows, WIDTH), dtype=dtype, device=device)
    x.random_(-8, 9, generator=gen)
    return x


@torch.no_grad()      # restores the caller's grad mode on return
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("gib", nargs="?", type=float, default=None,
                    help="array size in GiB (default 4 on the card, 1/64 on the CPU)")
    ap.add_argument("chunk", nargs="?", type=int, default=512)
    ap.add_argument("what", nargs="?", choices=("verify", "dual"), default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from meshanything_tpu_torch.ops import probes
    from meshanything_tpu_torch.runtime.bwprobe import time_loop
    from meshanything_tpu_torch.tools.build_canary import canary, resolve_device

    device = resolve_device(args.device, "dma_wire_probe")
    first = canary(device)
    card = first["card"]
    print(json.dumps(first), flush=True)
    gib = args.gib if args.gib is not None else (4.0 if device.type == "cuda" else 1 / 64)
    chunk = args.chunk

    def report(name: str, dtype_name: str, nbytes: int, run, want=None) -> None:
        """Check one call against ``want`` (a tensor, or a function giving
        the plain version's result for the call just made), then time."""
        got = run()
        if callable(want):
            want = want()
        if want is not None and not torch.equal(got, want):
            raise AssertionError(f"{name} ({dtype_name}) returned {got.item()}, its plain "
                                 f"version {want.item()}")
        seconds = time_loop(run, N_ITER, device)
        print(json.dumps({
            "tool": "dma_wire_probe", "measurement": name, "dtype": dtype_name,
            "gb_per_s": N_ITER * nbytes / seconds / 1e9, "ms_per_pass": seconds / N_ITER * 1e3,
            "bytes": nbytes, "chunk": chunk, "device": device.type, "card": card}), flush=True)

    def sized(dtype):
        itemsize = torch.empty((), dtype=dtype).element_size()
        rows = int(gib * 2 ** 30 / (WIDTH * itemsize))
        rows = max(chunk, rows - rows % chunk)
        return rows, rows * WIDTH * itemsize

    if args.what == "verify":
        rows, nbytes = sized(torch.bfloat16)
        nchunks = rows // chunk
        x = integer_rows(torch, rows, torch.bfloat16, device, 0)
        want = probes.stream_reference(x, chunk)
        calls = {"n": 0}

        def numbered(fn):
            def run():
                calls["n"] += 1
                return fn(calls["n"])
            return run

        report("invariant", "bf16", nbytes, lambda: probes.stream(x, chunk), want)
        report("rotated (start = call number)", "bf16", nbytes,
               numbered(lambda i: probes.stream_rot(x, i % nchunks, chunk)),
               lambda: probes.stream_rot_reference(x, calls["n"] % nchunks, chunk))
        report("seeded (start = call number, same walk)", "bf16", nbytes,
               numbered(lambda i: probes.stream_rot(x, i, chunk, rot=False)),
               lambda: probes.stream_rot_reference(x, calls["n"], chunk))
        print("DMA-WIRE-PROBE-OK")
        return 0

    for dtype, name in ((torch.bfloat16, "bf16"), (torch.int8, "int8")):
        rows, nbytes = sized(dtype)
        x = integer_rows(torch, rows, dtype, device, 1)
        report("torch_sum", name, nbytes, lambda: torch.sum(x, dtype=torch.float32))
        y = torch.empty_like(x)
        report("copy (read + write)", name, 2 * nbytes, lambda: y.copy_(x))
        del y
        report("stream", name, nbytes, lambda: probes.stream(x, chunk),
               probes.stream_reference(x, chunk))
        del x

    if args.what == "dual":
        rows, nbytes = sized(torch.bfloat16)
        # two separate allocations: two far-apart regions of device memory
        x0 = integer_rows(torch, rows, torch.bfloat16, device, 2)
        x1 = integer_rows(torch, rows, torch.bfloat16, device, 3)
        want = probes.dual_stream_reference(x0, x1, chunk)
        for label, kw in (("dual 1-sem depth=2", {"nsem": 1}), ("dual 2-sem depth=2", {"nsem": 2}),
                          ("dual 2-sem depth=4", {"nsem": 2, "depth": 4})):
            report(label, "bf16", 2 * nbytes,
                   lambda kw=kw: probes.dual_stream(x0, x1, chunk, **kw), want)
    print("DMA-WIRE-PROBE-OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
