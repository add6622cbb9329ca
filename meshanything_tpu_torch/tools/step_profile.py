"""One decode step of the full 350M model on the card, per tier: wall
time, device busy time and kernel launches a step, and the largest
device items.

    python -m meshanything_tpu_torch.tools.step_profile

Seeded random bf16 weights and condition embeddings; the cache rows hold
the prefill's values below the condition length and zeros above it, which
costs the same. For each tier (the exact K1 step and the K5 megakernel
step), batch and context: 8 warm-up steps, then the wall time of 24 steps
(host clock around ``torch.cuda.synchronize``), then torch.profiler over
24 more for the device's busy time (the sum of kernel times) and the
launches. One JSON line each, then the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

TIERS = ("pallas", "megakernel")
BATCHES = (1, 2)
CONTEXTS = (300, 3858)   # rows a step attends to: early and mean of an 800-face run
STEPS = 24


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_steps(torch, opt, model, cfg, state, mega, steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    def step():
        opt.decode_step(model.opt, cfg.opt, state, mega_layers=mega)

    for _ in range(8):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(_device_us(e) for e in kernels)
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + _device_us(e)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy_us / 1e3 / steps if kernels else None,
            "kernels_per_step": len(kernels) / steps,
            "top_device_ms_per_step": {n[:60]: us / 1e3 / steps for n, us in top}}


def main() -> int:
    import torch

    from meshanything_tpu_torch.config import MeshAnythingConfig
    from meshanything_tpu_torch.models import shape_opt as opt
    from meshanything_tpu_torch.ops.megakernel import pack_megakernel_layers
    from meshanything_tpu_torch.runtime.checkpoint import init_random_params

    if not torch.cuda.is_available():
        print("step_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = MeshAnythingConfig()
    model = init_random_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                               cfg.activation_dtype)
    mega = pack_megakernel_layers(model.opt.layers)
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for batch in BATCHES:
            cond = torch.randn((batch, cfg.opt.cond_length, cfg.opt.hidden_size), generator=gen,
                               device="cuda").to(cfg.activation_dtype) * 0.5
            for attn in TIERS:
                for context in CONTEXTS:
                    state = opt.init_decode_state(model.opt, cfg.opt, cond,
                                                  max_new_tokens=cfg.generate_length,
                                                  attn=attn)
                    # jump ahead: the 24 profiled steps attend to about context +- 12 rows
                    state.step = max(1, context - cfg.opt.cond_length - 44)
                    out = profile_steps(torch, opt, model, cfg, state,
                                        mega if attn == "megakernel" else None, STEPS)
                    print(json.dumps({"tier": attn, "batch": batch,
                                      "context_rows": context, **out}), flush=True)
                    del state
                    torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    print(card.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
