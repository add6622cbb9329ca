"""The build-and-launch canary: T5 (``ops/probes.py::scale_shift``,
``o = 2 x + c``) is built with nvcc and launched once, and must equal its
plain version exactly.

    python -m meshanything_tpu_torch.tools.build_canary [--device cpu]

It takes about a second of nvcc. If the compiler is missing, the
architecture is wrong or a launch fails, this is where a run stops, with
that message, before the slow builds start; the other tools and the smoke
run call ``canary`` first. (The TPU tool whose kernel this ports,
``tools/xla_cpu_crash_repro.py``, compiled a stream of distinct programs
to find a crash of XLA's CPU compiler; that fault has no counterpart
here.) Prints one JSON line and ``BUILD-CANARY-OK``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def resolve_device(name: str, tool: str):
    """``torch.device(name)``; a card that is asked for and absent is an
    error, never a reason to carry on on the CPU."""
    import torch

    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{tool}: --device cuda, but torch.cuda.is_available() is false")
    return torch.device(name)


def canary(device) -> dict:
    """Build (on a card) and run T5 at (8, 128) against its plain version;
    raises unless they are equal. Returns the record the tools print."""
    import torch

    from meshanything_tpu_torch.ops import _build
    from meshanything_tpu_torch.ops.probes import scale_shift, scale_shift_reference
    from meshanything_tpu_torch.runtime.profiling import card_line

    record = {"tool": "build_canary", "device": device.type, "card": card_line(device)}
    if device.type == "cuda":
        lib = _build.load("probes")
        record.update(built=lib.built, build_seconds=lib.seconds)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((8, 128), generator=gen, device=device)
    before = scale_shift.launches
    t0 = time.perf_counter()
    out = scale_shift(x, 0.5)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    record["first_call_seconds"] = time.perf_counter() - t0
    record["launches"] = scale_shift.launches - before
    record["max_abs_err"] = (out - scale_shift_reference(x, 0.5)).abs().max().item()
    if record["max_abs_err"] != 0.0:
        raise AssertionError("the canary kernel disagrees with its plain version by "
                             f"{record['max_abs_err']}")
    if device.type == "cuda" and record["launches"] != 1:
        raise AssertionError("the canary did not launch its kernel")
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    print(json.dumps(canary(resolve_device(args.device, "build_canary"))), flush=True)
    print("BUILD-CANARY-OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
