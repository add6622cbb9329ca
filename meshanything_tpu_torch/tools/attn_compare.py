"""K1-K4 of two trees of this repository, and the CLI runs through K1 and
the bf16 K4, timed on one card in one run.

Two calls of the GPU machine may land on two cards with other power
limits, so a kernel is compared with an earlier commit's only inside one
run. This tool takes the root of a second checkout (``git archive`` of the
other commit, unpacked into a directory that ``.gitignore`` lists) and
runs, in the order other, this, this, other, each tree's own
``chip_smoke.py`` phases ``k1_time`` and ``fast_time`` (ms a call of
K1-K4 at cur_len 7459 / base 7450, bf16 queries, B 1 and 16, beside each
tree's plain versions and the library call) and then two CLI runs at the
full 350M width on seeded random bf16 weights, as the smoke makes them:
the exact tier (K1, 200 faces) and ``--lookahead 8`` (K4 over the bf16
cache, 800 faces), every run in a process of its own that imports that
tree's package and builds its kernels:

    python -m meshanything_tpu_torch.tools.attn_compare OTHER_ROOT

It prints each run's JSON lines with the tree's label in front, then one
``attn_compare`` line a kernel and batch (ms a call) and a CLI run
(ms a mesh of fenced device time) with the four readings, then
``ATTN-COMPARE-OK``. It needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_RUN = """
import sys
sys.path.insert(0, {root!r})
import torch
import chip_smoke as cs
from meshanything_tpu_torch.ops import decode_attention as da
torch.set_grad_enabled(False)
card = cs.card_line()
cs.time_k1(torch, da, card)
cs.time_fast(torch, da, card)
import json, os, tempfile
from meshanything_tpu_torch import cli
with tempfile.TemporaryDirectory() as tmp:
    npy, _ = cs.write_inputs(tmp)
    common = ["--input_type", "pc_normal", "--input_path", npy, "--out_dir",
              os.path.join(tmp, "out"), "--random_weights", "--seed", "0", "--dtype", "bfloat16",
              "--device", "cuda"]
    for name, argv in (("exact_pc", ["--n_max_triangles", "200"]), ("F3", ["--lookahead", "8"])):
        r = cli.main([*argv, *common])[0]
        print(json.dumps({{"phase": "cli_run", "kernel": name, "batch": 1,
                          "ms": r["device_time_s"] * 1e3, "decode_steps": r["decode_steps"],
                          "bound_ms": None, "card": card}}), flush=True)
"""


def _times(root: str) -> dict:
    """{(kernel, batch): ms} of one tree, from a fresh process."""
    proc = subprocess.run([sys.executable, "-c", _RUN.format(root=root)], cwd=root,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: exit {proc.returncode}\n{proc.stdout[-2000:]}\n"
                           f"{proc.stderr[-4000:]}")
    out = {}
    for line in proc.stdout.splitlines():
        if not line.startswith("{"):
            continue
        rec = json.loads(line)
        if rec.get("phase") in ("k1_time", "fast_time", "cli_run"):
            out[(rec.get("kernel", "k1"), rec["batch"])] = rec
    return out


def summarize(runs: list) -> list:
    """One record a (kernel, batch) of ``runs`` ([(label, {key: record})]
    in the order they were made): each tree's readings in that order and
    the ratio of their sums; library call, bound and card from the first
    run of this tree."""
    this = next(recs for label, recs in runs if label == "this")
    out = []
    for key in runs[0][1]:
        by = {"other": [], "this": []}
        for label, recs in runs:
            by[label].append(recs[key]["ms"])
        rec = this[key]
        out.append({
            "tool": "attn_compare", "kernel": key[0], "batch": key[1],
            "other_ms": by["other"], "this_ms": by["this"],
            "other_over_this": sum(by["other"]) / sum(by["this"]),
            "library_ms": rec.get("library_ms"), "bound_ms": rec["bound_ms"],
            "card": rec["card"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of the other tree (a checkout of another commit)")
    args = ap.parse_args(argv)
    this = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    roots = {"other": os.path.abspath(args.other), "this": this}
    runs = []
    for label in ("other", "this", "this", "other"):
        recs = _times(roots[label])
        runs.append((label, recs))
        for rec in recs.values():
            print(label, json.dumps(rec), flush=True)
    for rec in summarize(runs):
        print(json.dumps(rec), flush=True)
    print("ATTN-COMPARE-OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
