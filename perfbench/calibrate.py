"""The readings that a configuration's limits are set from: for each seed,
one request of the cell at its own size through the program, and through
each of the configuration's ``controls`` (the program with a
lower-precision path of its own switched on), each judged by the
comparison, in one process.

    python perfbench/calibrate.py exact-b1 12 [first_seed [program|controls]]

Prints one JSON line a seed and tier: the comparison's numbers, the
verdict under the configuration's limits, and the ``check.profile`` of
the tokens and bins and the cache's errors by layer that the numbers were
read from. The lower reading of a number is the largest that the program
gives over the seeds, the upper the smallest that a control gives;
``PERF.md`` sets each limit between them.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from perfbench import harness  # noqa: E402


def readings(workload: str, seed: int, tier=None, log=sys.stderr) -> dict:
    """The comparison of one request of ``workload`` run with ``tier``
    (runner options over the configuration's; None: as configured)."""
    from perfbench import check

    s = harness.Session(workload, seed, tier=tier, log=log)
    try:
        t0 = time.perf_counter()
        rec = s.request(0)
        seconds = time.perf_counter() - t0
        s.run.requests.append(rec)
        rows = s.sample(s.run.done())
        s.free()
        profiles: list = []
        numbers = check.compare(s.reference_params(), s.run.model, s.run.decoder, rows, s.dev,
                                profiles)
        correct, _ = check.verdict(numbers, check.limits_of(s.run.config), 0)
        return {"numbers": numbers, "correct": correct, "profiles": profiles,
                "decode_steps": rec["decode_steps"], "request_s": seconds}
    finally:
        s.close()


def tiers(workload: str, which: str) -> list:
    """(label, tier) of the program and, with ``which`` "controls", of
    each control."""
    config = harness.find_cell(harness.load_benchmark(), workload)[2]
    out = [("program", None)] if which in ("program", "all") else []
    if which in ("controls", "all"):
        out += [(json.dumps(t, sort_keys=True), t) for t in config["controls"]]
    return out


def main(argv) -> int:
    workload, n = argv[0], int(argv[1])
    first = int(argv[2]) if len(argv) > 2 else 4_000_000_000
    which = argv[3] if len(argv) > 3 else "all"
    for seed in range(first, first + n):
        for label, tier in tiers(workload, which):
            got = readings(workload, seed, tier)
            print(json.dumps({"workload": workload, "seed": seed, "tier": label, **got}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
