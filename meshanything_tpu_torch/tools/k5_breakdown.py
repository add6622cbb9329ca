"""Where K5's time goes: variants of ``csrc/megakernel.cu``, each with
one part taken out or one per-instance choice flipped, built side by
side and timed on the card.

    python -m meshanything_tpu_torch.tools.k5_breakdown [variant ...]

The variants compute wrong results on purpose (barriers, loads or whole
phases removed); only their times mean something, and only beside the
unchanged kernel of the same run. Each turns on some of the kernel's
``kCut*`` constants by text substitution, which must apply to the current
source, so a variant that no longer matches the kernel fails loudly. One JSON line per (variant, B, cur_len): device ms a
step (24 layers, bf16 cache, seeded random bf16 layers, CUDA events over
20 launches), then the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from meshanything_tpu_torch.ops import _build

L, HIDDEN, HEADS, FFN, S = 24, 1024, 16, 4096, 7680
BATCHES = (1, 2, 4, 8, 16)
CUR_LENS = (1, 300, 7459)


def _cut(name: str) -> tuple[str, str]:
    """Turn one of the kernel's kCut* constants on."""
    return f"constexpr bool {name} = false;", f"constexpr bool {name} = true;"


_NO_WORK = [_cut("kCutWeights"), _cut("kCutGemv"), _cut("kCutAttention")]

VARIANTS = {
    "kernel": [],
    # parts taken out
    "no_barriers": [_cut("kCutBarriers")],            # grid barriers -> block barriers
    "no_weight_prefetch": [_cut("kCutPrefetch")],     # weights started at their own phase
    "no_weight_loads": [_cut("kCutWeights")],         # GEMVs on whatever shared memory holds
    "no_gemv": [_cut("kCutGemv")],                    # the weights still stream
    "no_attention": [_cut("kCutAttention")],
    "no_fold": [_cut("kCutFold")],                    # attention's partials never folded
    "barriers_ln_only": _NO_WORK,
    "ln_only": [*_NO_WORK, _cut("kCutBarriers")],
    "empty": [*_NO_WORK, _cut("kCutBarriers"), _cut("kCutNorm")],
}


def variant_source(source: str, name: str) -> str:
    for old, new in VARIANTS[name]:
        if old not in source:
            raise ValueError(f"variant {name}: {old!r} is not in the kernel source")
        source = source.replace(old, new)
    return source


def build(name: str, source: str, out_dir: str) -> tuple[str, str]:
    path = os.path.join(out_dir, f"{name}.cu")
    with open(path, "w") as fh:
        fh.write(variant_source(source, name))
    so = os.path.join(out_dir, f"{name}.so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
                           "-o", so, path],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stdout}{proc.stderr}")
    return name, so


def main(names=None) -> int:
    import torch

    from meshanything_tpu_torch.ops import decode_attention as da
    from meshanything_tpu_torch.ops import megakernel as mk

    if not torch.cuda.is_available():
        print("k5_breakdown: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    names = names or list(VARIANTS)
    with open(os.path.join(_build.CSRC_DIR, "megakernel.cu")) as fh:
        source = fh.read()
    out_dir = os.path.join(_build.BUILD_DIR, "k5_breakdown")
    os.makedirs(out_dir, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as pool:   # one nvcc per variant, all at once
        built = list(pool.map(lambda n: build(n, source, out_dir), names))

    gen = torch.Generator(device="cuda").manual_seed(1)

    def mat(*shape):
        return (torch.randn(shape, generator=gen, device="cuda") * 0.02).bfloat16()

    def vec(width, base=0.0):
        return torch.randn((L, width), generator=gen, device="cuda") * 0.1 + base

    d = HIDDEN
    packed = mk.MegakernelLayers(
        qkv_w=mat(L, 3 * d, d), out_w=mat(L, d, d), fc1_w=mat(L, FFN, d), fc2_w=mat(L, d, FFN),
        qkv_b=vec(3 * d), out_b=vec(d), fc1_b=vec(FFN), fc2_b=vec(d), ln_attn_w=vec(d, 1.0),
        ln_attn_b=vec(d), ln_ffn_w=vec(d, 1.0), ln_ffn_b=vec(d))
    caches = {b: torch.randn((2, L, b, S, d), generator=gen, device="cuda", dtype=torch.bfloat16)
              for b in BATCHES}
    xs = {b: torch.randn((b, d), generator=gen, device="cuda").bfloat16() for b in BATCHES}
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        for name, so in built:
            # load the variant in place of the kernel for the wrapper's next calls
            _build._loaded["megakernel"] = _build.KernelLibrary(ctypes.CDLL(so), so, True, 0.0, "")
            mk._resident.clear()
            da._workspaces.clear()   # fresh fold counters: a cut variant may leave them set
            for b in BATCHES:
                for cur in CUR_LENS:
                    def run():
                        mk.decode_step_megakernel(xs[b], packed, caches[b], cur - 1, cur,
                                                  num_heads=HEADS)
                    run()
                    torch.cuda.synchronize()
                    start.record()
                    for _ in range(20):
                        run()
                    stop.record()
                    torch.cuda.synchronize()
                    print(json.dumps({"variant": name, "batch": b, "cur_len": cur,
                                      "ms": start.elapsed_time(stop) / 20}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    print(card.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
