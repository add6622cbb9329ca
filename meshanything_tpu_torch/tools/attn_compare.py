"""K1-K4 of two trees of this repository, and CLI runs through them, timed
on one card in one run.

Two calls of the GPU machine may land on two cards with other power
limits, so a kernel is compared with an earlier commit's only inside one
run. This tool takes the root of a second checkout (``git archive`` of the
other commit, unpacked into a directory that ``.gitignore`` lists) and
runs, in the order other, this, this, other, in a process of its own that
imports that tree's package and builds its kernels:

  * each tree's own ``chip_smoke.py`` phases ``k1_time`` and ``fast_time``
    (ms a call of K1-K4 at cur_len 7459 / base 7450, bf16 queries, B 1
    and 16, W 8, beside each tree's plain versions and the library call);
  * ``quant_grid`` below, one source run in both trees: ms a call of K1,
    K2, K3 and the int8/int4 K4 at B 1, 2 and 16, cur_len 7459 and 300, W 8
    and 16, beside the bound (K1-K3 with the length on the device, the
    grid planned for the whole cache, in a tree whose wrappers take one:
    against an older tree, the price of the device length);
  * the CLI runs named by ``--cli`` at the full 350M width on seeded random
    bf16 weights, as the smoke makes them (default: the exact tier, K1,
    200 faces, and ``--lookahead 8``, the bf16 K4, 800 faces):

    python -m meshanything_tpu_torch.tools.attn_compare OTHER_ROOT [--cli exact_pc,F3]

It prints each run's JSON lines with the tree's label in front, then one
``attn_compare`` line a kernel and shape (ms a call) and a CLI run (ms a
mesh of fenced device time) with the four readings, then
``ATTN-COMPARE-OK``. It needs a card.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
INT8_OPS_PER_S = 1979e12           # dense
BF16_OPS_PER_S = 989e12            # dense


def quant_grid(torch, da, card, batches=(1, 2, 16), lens=(7459, 300), windows=(8, 16)):
    """ms a call of K1 (bf16 cache), K2, K3 and the int8/int4 K4 with bf16
    queries at every (batch, cur_len, window), at the 350M width: device
    time of 10 CUDA-graph replays of a sweep over the 24 layers (so that
    each call streams its rows from device memory), between CUDA events.
    K1-K3 take the live length as the tree's decode step gives it: a 0-d
    int32 device tensor with the grid planned for the whole cache where
    the wrappers take one (``max_len``), else the int (planned for it).
    K4 runs at base = cur_len - 9 (7450 for 7459). The bound is the larger
    of the live rows (K2-K4: codes and scales), window rows, queries and
    outputs over 3.35 TB/s and four operations a seen element over the
    bf16 (K1) or int8 peak. Prints a ``quant_time`` line a case and
    returns them. Self-contained (it imports nothing of this repository):
    ``attn_compare`` runs its source in either tree."""
    import inspect as _inspect
    import json as _json

    layers, heads, head_dim, seq = 24, 16, 64, 7680   # the 350M model, the smoke's cache
    hd = heads * head_dim
    gen = torch.Generator(device="cuda").manual_seed(21)
    records = []
    on_device = "max_len" in _inspect.signature(da.decode_attention).parameters

    def length(cur):
        return torch.tensor(cur, dtype=torch.int32, device="cuda") if on_device else cur

    def graph_ms(sweep):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):      # warm-up on the capture stream
            sweep()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            sweep()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            graph.replay()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / (10 * layers)

    def record(kernel, batch, cur, w, ms, moved, seen, ops_per_s=INT8_OPS_PER_S):
        by_bytes = moved / HBM_BYTES_PER_S * 1e3
        by_ops = 4 * batch * seen * hd / ops_per_s * 1e3
        bound_ms = max(by_bytes, by_ops)
        rec = {"phase": "quant_time", "kernel": kernel, "batch": batch, "cur_len": cur,
               "window": w, "cur_len_on_device": on_device and w == 1, "ms": ms,
               "bound_ms": bound_ms,
               "bound_by": "bytes" if by_bytes >= by_ops else "operations",
               "share_of_data_sheet": bound_ms / ms, "moved_bytes": moved, "card": card}
        print(_json.dumps(rec), flush=True)
        records.append(rec)

    for batch in batches:
        kv = torch.randn((2, layers, batch, seq, hd), generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        q1 = torch.randn((batch, heads, head_dim), generator=gen, device="cuda").bfloat16()
        for cur in lens:
            n = length(cur)
            ms = graph_ms(lambda: [da.decode_attention(q1, kv, i, n) for i in range(layers)])
            # "k1_grid": apart from the k1_time phase's K1 rows
            record("k1_grid", batch, cur, 1, ms, 2 * batch * cur * hd * 2 + 2 * batch * hd * 2,
                   cur, BF16_OPS_PER_S)
        del kv
        torch.cuda.empty_cache()
    for bits in (8, 4):
        packed = hd if bits == 8 else hd // 8
        dtype = torch.int8 if bits == 8 else torch.int32
        lo, hi = (-127, 128) if bits == 8 else (-2 ** 31, 2 ** 31 - 1)
        single = da.decode_attention_int8 if bits == 8 else da.decode_attention_int4
        for batch in batches:
            values = torch.randint(lo, hi, (2, layers, batch, seq, packed), generator=gen,
                                   device="cuda", dtype=dtype)
            scales = (torch.rand((2, layers, batch, 1, seq), generator=gen, device="cuda")
                      * (0.02 if bits == 8 else 0.3) + 1e-3)
            row_bytes = packed * values.element_size() + 4     # codes and scale, one plane
            q1 = torch.randn((batch, heads, head_dim), generator=gen, device="cuda").bfloat16()
            for cur in lens:
                n = length(cur)
                ms = graph_ms(lambda: [single(q1, values, scales, i, n) for i in range(layers)])
                record("k2" if bits == 8 else "k3", batch, cur, 1, ms,
                       2 * batch * cur * row_bytes + 2 * batch * hd * 2, cur)
            for w in windows:
                qw = torch.randn((batch, w, heads, head_dim), generator=gen,
                                 device="cuda").bfloat16()
                win = torch.randint(lo, hi, (2, batch, w, packed), generator=gen, device="cuda",
                                    dtype=dtype)
                win_s = torch.rand((2, batch, 1, w), generator=gen, device="cuda") * 0.02 + 1e-3
                for cur in lens:
                    base0 = cur - 9
                    base = torch.full((batch,), base0, dtype=torch.int32, device="cuda")
                    ms = graph_ms(lambda: [da.decode_attention_mq(
                        qw, values, scales, i, base, win[0], win[1], win_s[0], win_s[1])
                        for i in range(layers)])
                    moved = 2 * batch * (base0 + w) * row_bytes + 2 * batch * w * hd * 2
                    record(f"k4_int{bits}", batch, cur, w, ms, moved,
                           w * base0 + w * (w + 1) // 2)
                del qw, win, win_s
            del values, scales
            torch.cuda.empty_cache()
    return records


CLI_RUNS = {
    # name: (argv, input): as chip_smoke.py's drive_main_path makes them
    "exact_pc": (["--n_max_triangles", "200"], "pc"),
    "F1": (["--fast"], "pc"),
    "F2": (["--attn", "pallas_int4", "--lookahead", "adaptive"], "meshes"),
    "F3": (["--lookahead", "8"], "pc"),
    "F4": (["--attn", "pallas_int8", "--n_max_triangles", "100"], "pc"),
    "F5": (["--attn", "pallas_int4", "--wq", "--n_max_triangles", "100"], "meshes"),
}

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
HBM_BYTES_PER_S, INT8_OPS_PER_S, BF16_OPS_PER_S = {hbm!r}, {ops!r}, {bf16_ops!r}
{grid}
quant_grid(torch, da, card)
import json, os, tempfile
from meshanything_tpu_torch import cli
with tempfile.TemporaryDirectory() as tmp:
    npy, mesh_dir = cs.write_inputs(tmp)
    common = ["--out_dir", os.path.join(tmp, "out"), "--random_weights", "--seed", "0",
              "--dtype", "bfloat16", "--device", "cuda"]
    inputs = {{"pc": ["--input_type", "pc_normal", "--input_path", npy],
               "meshes": ["--input_type", "mesh", "--input_dir", mesh_dir,
                          "--batchsize_per_gpu", "2"]}}
    for name, argv, which in {cli_runs!r}:
        records = cli.main([*argv, *inputs[which], *common])
        ms = sum(r["device_time_s"] for r in records) / len(records) * 1e3
        print(json.dumps({{"phase": "cli_run", "kernel": name, "batch": len(records),
                          "ms": ms, "decode_steps": records[0]["decode_steps"],
                          "bound_ms": None, "card": card}}), flush=True)
"""


def _key(rec: dict) -> tuple:
    return (rec.get("kernel", "k1"), rec["batch"], rec.get("cur_len", rec.get("rows")),
            rec.get("window", 1))


def child_program(root: str, cli_runs: list) -> str:
    """The program one tree's process runs: its smoke's timing phases,
    ``quant_grid`` (this file's source) and the CLI runs ``cli_runs``."""
    return _RUN.format(root=root, hbm=HBM_BYTES_PER_S, ops=INT8_OPS_PER_S,
                       bf16_ops=BF16_OPS_PER_S,
                       grid=inspect.getsource(quant_grid),
                       cli_runs=[(name, *CLI_RUNS[name]) for name in cli_runs])


def _times(root: str, cli_runs: list) -> dict:
    """{key: record} of one tree, from a fresh process."""
    proc = subprocess.run([sys.executable, "-c", child_program(root, cli_runs)], cwd=root,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: exit {proc.returncode}\n{proc.stdout[-2000:]}\n"
                           f"{proc.stderr[-4000:]}")
    out = {}
    for line in proc.stdout.splitlines():
        if not line.startswith("{"):
            continue
        rec = json.loads(line)
        if rec.get("phase") in ("k1_time", "fast_time", "quant_time", "cli_run"):
            out[_key(rec)] = rec
    return out


def summarize(runs: list) -> list:
    """One record a key of ``runs`` ([(label, {key: record})] in the order
    they were made): each tree's readings in that order and the ratio of
    their sums; library call, bound and card from the first run of this
    tree."""
    this = next(recs for label, recs in runs if label == "this")
    out = []
    for key in runs[0][1]:
        by = {"other": [], "this": []}
        for label, recs in runs:
            if key in recs:
                by[label].append(recs[key]["ms"])
        if not (by["other"] and by["this"]):
            continue
        rec = this[key]
        out.append({
            "tool": "attn_compare", "kernel": key[0], "batch": key[1], "cur_len": key[2],
            "window": key[3], "other_ms": by["other"], "this_ms": by["this"],
            "other_over_this": (sum(by["other"]) / len(by["other"]))
            / (sum(by["this"]) / len(by["this"])),
            "library_ms": rec.get("library_ms"), "bound_ms": rec["bound_ms"],
            "card": rec["card"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of the other tree (a checkout of another commit)")
    ap.add_argument("--cli", default="exact_pc,F3",
                    help=f"comma-separated CLI runs of {sorted(CLI_RUNS)}, or 'none'")
    args = ap.parse_args(argv)
    cli_runs = [] if args.cli == "none" else args.cli.split(",")
    unknown = set(cli_runs) - set(CLI_RUNS)
    if unknown:
        ap.error(f"unknown CLI runs {sorted(unknown)}")
    this = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    roots = {"other": os.path.abspath(args.other), "this": this}
    runs = []
    for label in ("other", "this", "this", "other"):
        recs = _times(roots[label], cli_runs)
        runs.append((label, recs))
        for rec in recs.values():
            print(label, json.dumps(rec), flush=True)
    for rec in summarize(runs):
        print(json.dumps(rec), flush=True)
    print("ATTN-COMPARE-OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
