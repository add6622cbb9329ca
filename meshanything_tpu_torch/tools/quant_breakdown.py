"""Where the time of K2, K3 and the int8/int4 K4 goes: variants of
``csrc/decode_attention_quant.cu`` and ``csrc/decode_attention_window.cu``,
each with one part taken out, built side by side and timed on the card.

    python -m meshanything_tpu_torch.tools.quant_breakdown [variant ...] [--sass]

The variants compute wrong results on purpose (no arithmetic, codes not
widened, partials not folded); only their times mean something, and only
beside the unchanged kernels of the same run. Each turns on some of the
``kCut*`` constants at the top of the sources by text substitution, which
must apply, so a variant that no longer matches fails loudly.
``long_splits`` keeps the kernels and launches them with at least four
32-row tiles a split (fewer splits at small batch: a smaller fold). The times
are ``tools/attn_compare.py::quant_grid``'s (CUDA-graph replays of a
24-layer sweep, bf16 queries) at B 1, 2 and 16, cur_len 7459, W 8: one
``quant_time`` line a (variant, kernel, batch) with the variant's name,
then the card's name and power limit. ``--sass`` also prints, for the
unchanged kernels, each kernel function's instructions by opcode as
``cuobjdump -sass`` lists them (static counts: the tile loop unrolled).
"""
from __future__ import annotations

import collections
import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from meshanything_tpu_torch.ops import _build

SOURCES = ("decode_attention_quant", "decode_attention_window")


def _cut(name: str) -> tuple[tuple[str, ...], str, str]:
    """Turn one of the kernels' kCut* constants on, in both sources."""
    return SOURCES, f"constexpr bool {name} = false;", f"constexpr bool {name} = true;"


VARIANTS = {
    "kernel": [],
    "stream_only": [_cut("kCutMath")],       # tiles streamed (and scales), nothing computed
    "no_unpack": [_cut("kCutUnpack")],       # int4 tiles not unpacked (int8: the kernel)
    "no_convert": [_cut("kCutConvert")],     # codes not widened
    "no_fold": [_cut("kCutFold")],           # partials left unfolded
    "long_splits": [],                       # the kernels as they are, fewer and longer splits
}

# Variants of the launch plan, not of the kernels: at least this many tiles a split
# (fewer splits at small batch: a smaller fold, a longer stream a block).
PLAN_MIN_TILES = {"long_splits": 4}


def _capped(plan, min_tiles: int):
    """A split plan with at most ceil(tiles / min_tiles) splits."""
    def capped(batch, n_rows, num_sms):
        tiles = -(-n_rows // 32)
        return plan(batch, n_rows, min(num_sms, batch * max(1, -(-tiles // min_tiles))))
    return capped


def variant_source(source: str, name: str, lib: str) -> str:
    for libs, old, new in VARIANTS[name]:
        if lib not in libs:
            continue
        if old not in source:
            raise ValueError(f"variant {name}: {old!r} is not in {lib}")
        source = source.replace(old, new)
    return source


def build(name: str, lib: str, out_dir: str) -> tuple[str, str, str]:
    with open(os.path.join(_build.CSRC_DIR, lib + ".cu")) as fh:
        source = variant_source(fh.read(), name, lib)
    path = os.path.join(out_dir, f"{lib}-{name}.cu")
    with open(path, "w") as fh:
        fh.write(source)
    so = os.path.join(out_dir, f"{lib}-{name}.so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
                           "-o", so, path], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name} of {lib}:\n{proc.stdout}{proc.stderr}")
    return name, lib, so


def sass_histogram(so: str) -> dict:
    """{kernel function: {opcode: count}} of a built library."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    out, current = {}, None
    for line in text.splitlines():
        fn = re.match(r"\s*Function : (\S+)", line)
        if fn:
            current = out.setdefault(fn.group(1), collections.Counter())
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if op and current is not None:
            current[op.group(1).split(".")[0]] += 1
    return {fn: dict(c.most_common()) for fn, c in out.items()}


def main(argv=None) -> int:
    import torch

    from meshanything_tpu_torch.ops import decode_attention as da
    from meshanything_tpu_torch.tools.attn_compare import quant_grid

    argv = sys.argv[1:] if argv is None else argv
    sass = "--sass" in argv
    names = [a for a in argv if a != "--sass"] or list(VARIANTS)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; variants: {', '.join(VARIANTS)}")
    if not torch.cuda.is_available():
        print("quant_breakdown: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    out_dir = os.path.join(_build.BUILD_DIR, "quant_breakdown")
    os.makedirs(out_dir, exist_ok=True)
    jobs = [(n, lib) for n in names for lib in SOURCES]
    with ThreadPoolExecutor(len(jobs)) as pool:   # one nvcc per (variant, source), all at once
        built = list(pool.map(lambda job: build(*job, out_dir), jobs))
    libs = collections.defaultdict(dict)
    for name, lib, so in built:
        libs[name][lib] = so
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    if sass and "kernel" in libs:
        for lib, so in libs["kernel"].items():
            for fn, ops in sass_histogram(so).items():
                print(json.dumps({"sass": lib, "function": fn, "instructions": sum(ops.values()),
                                  "by_opcode": ops}), flush=True)
    plans = (da.quant_split_plan, da.quant_window_split_plan)
    with torch.no_grad():
        for name in names:
            # load the variant in place of the kernels for the wrappers' next calls
            for lib, so in libs[name].items():
                _build._loaded[lib] = _build.KernelLibrary(ctypes.CDLL(so), so, True, 0.0, "")
            da._workspaces.clear()   # fresh fold counters and partials for each variant
            if name in PLAN_MIN_TILES:
                da.quant_split_plan, da.quant_window_split_plan = (
                    _capped(plan, PLAN_MIN_TILES[name]) for plan in plans)
            print(json.dumps({"variant": name}), flush=True)
            try:
                quant_grid(torch, da, card, batches=(1, 2, 16), lens=(7459,), windows=(8,))
            finally:
                da.quant_split_plan, da.quant_window_split_plan = plans
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
