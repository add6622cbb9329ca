"""Where does K1's time go? (The port of ``tools/pipe_compute_probe.py``.)

T4 (``ops/k1_probe.py``) is K1's body compiled once per mode with parts
cut out at the same byte traffic; this tool times each mode at the decode
shape (B=16, 16 heads of 64, 24 layers, a cache of 7,680 rows, 7,168 of
them live, bf16), 800 calls cycling over the layers so that every call
streams its rows from device memory:

  full        K1 itself (asserted bit-equal to ``decode_attention`` first)
  tap         rows streamed, nothing computed
  qk          + the QK dot and each tile's max
  softmax     + the online softmax on constant logits (no dot, no P.V)
  pv          + the P.V product on constant logits (no dot)
  no_combine  full without the fold of the partials
  one_split   full without the context split
  depth1      full through a ring of one slot (no copy in flight while
              the block computes)

    python -m meshanything_tpu_torch.tools.pipe_compute_probe [modes...]
                                               [--batch 16] [--device cpu]

The times are device time of CUDA-graph replays between CUDA events. One
JSON line a mode (µs a call, GB/s of live rows) with the card's name and
power limit, then ``PIPE-COMPUTE-PROBE-OK``. On the CPU the plain
versions run at a small size, which rehearses the tool and times nothing
of the card.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

N_CALLS = 800


@torch.no_grad()      # restores the caller's grad mode on return
def main(argv=None) -> int:
    from meshanything_tpu_torch.ops.k1_probe import K1_TILE, MODES, k1_probe

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("modes", nargs="*", default=list(MODES), help=f"any of {MODES}")
    ap.add_argument("--batch", type=int, default=None, help="default 16 (2 on the CPU)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    unknown = [m for m in args.modes if m not in MODES]
    if unknown:
        ap.error(f"unknown modes {unknown}; the probe has {MODES}")

    from meshanything_tpu_torch.ops.decode_attention import decode_attention
    from meshanything_tpu_torch.runtime.bwprobe import time_loop
    from meshanything_tpu_torch.tools.build_canary import canary, resolve_device

    device = resolve_device(args.device, "pipe_compute_probe")
    first = canary(device)
    card = first["card"]
    print(json.dumps(first), flush=True)
    if device.type == "cuda":
        batch, heads, dim, layers, seq, cur = args.batch or 16, 16, 64, 24, 7680, 7168
        chunk = K1_TILE[torch.bfloat16]
        calls = N_CALLS
    else:
        batch, heads, dim, layers, seq, cur, chunk = args.batch or 2, 4, 8, 2, 64, 48, 16
        calls = 4
    gen = torch.Generator(device=device).manual_seed(0)
    kv = torch.empty((2, layers, batch, seq, heads * dim), dtype=torch.bfloat16, device=device)
    kv.normal_(0.0, 0.3, generator=gen)
    q = torch.randn((batch, heads, dim), generator=gen, device=device).bfloat16()

    if not torch.equal(k1_probe(q, kv, 3 % layers, cur, chunk=chunk, mode="full"),
                       decode_attention(q, kv, 3 % layers, cur)):
        raise AssertionError("the probe's full mode is not K1 bit for bit")

    live_bytes = 2 * batch * cur * heads * dim * kv.element_size()
    sweeps = max(1, calls // layers)
    for mode in args.modes:
        def sweep(mode=mode):
            for layer in range(layers):
                k1_probe(q, kv, layer, cur, chunk=chunk, mode=mode)

        seconds = time_loop(sweep, sweeps, device, graph=True)
        per_call = seconds / (sweeps * layers)
        print(json.dumps({
            "tool": "pipe_compute_probe", "mode": mode, "batch": batch, "cur_len": cur,
            "chunk": chunk, "us_per_call": per_call * 1e6,
            "gb_per_s": live_bytes / per_call / 1e9, "live_bytes": live_bytes,
            "calls": sweeps * layers, "device": device.type, "card": card}), flush=True)
    print("PIPE-COMPUTE-PROBE-OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
