"""One decode step (or window forward) of the full 350M model on the card,
per tier, run eagerly and replayed from a CUDA graph: wall time, device
busy time, kernels and host launches a step, and the largest device items.

    python -m meshanything_tpu_torch.tools.step_profile [tier ...]

Tiers (``TIERS``): the exact K1 step, the int8 (K2) and int4 (K3) steps,
the int4 step with W8A8 layer matrices (``--wq``), the bf16 window
forward at W=8 (K4, ``--lookahead 8``), and the K5 megakernel step, which
runs eagerly only (its decode loop is not captured). Seeded random bf16
weights and condition embeddings; the cache rows hold the prefill's values
below the condition length and zeros above it, which costs the same. For
each tier, batch and context, and for each of eager and graph: 8 warm-up
steps, then the wall time of 24 steps (host clock around
``torch.cuda.synchronize``), then torch.profiler over 24 more for the
device's busy time (the sum of kernel times), the kernels a step and the
host's launches a step (``cudaLaunchKernel`` and its kin, or
``cudaGraphLaunch``: one a replayed step). One JSON line each, then the
card's name and power limit. A replayed step's wall time is the time the
card takes for it: the host enqueues replays ahead of the card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

# name: (attn, wq, window)
TIERS = {
    "exact": ("pallas", False, 0),
    "int8": ("pallas_int8", False, 0),
    "int4": ("pallas_int4", False, 0),
    "int4_wq": ("pallas_int4", True, 0),
    "window8": ("pallas", False, 8),
    "megakernel": ("megakernel", False, 0),
}
BATCHES = (1, 2)
CONTEXTS = (300, 3858)   # rows a step attends to: early and mean of an 800-face run
STEPS = 24
_HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                  "cudaGraphLaunch")


def profile_steps(torch, step, steps: int) -> dict:
    """Wall, device busy, kernels and host launches a call of ``step``."""
    from torch.profiler import ProfilerActivity, profile

    from meshanything_tpu_torch.runtime.profiling import kernel_device_us

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
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = [e for e in events if e.name in _HOST_LAUNCHES]
    busy_us = sum(kernel_device_us(e) for e in kernels)
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + kernel_device_us(e)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    busy_ms = busy_us / 1e3 / steps if kernels else None
    return {"wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy_ms,
            "busy_share": busy_ms / wall_ms if kernels else None,
            "kernels_per_step": len(kernels) / steps,
            "host_launches_per_step": len(launches) / steps,
            "top_device_ms_per_step": {n[:60]: us / 1e3 / steps for n, us in top}}


def _state(torch, model, cfg, cond, attn: str, window: int, context: int):
    """A decode (or window) state whose next step attends to about
    ``context`` rows."""
    from meshanything_tpu_torch.models import lookahead as la
    from meshanything_tpu_torch.models import shape_opt as opt

    gl = cfg.generate_length
    if window:
        state = la.init_lookahead_state(model.opt, cfg.opt, cond, max_new_tokens=gl,
                                        window=window, attn=attn)
        state.steps.fill_(max(1, context - cfg.opt.cond_length - 44))
        return state
    state = opt.init_decode_state(model.opt, cfg.opt, cond, max_new_tokens=gl, attn=attn)
    # jump ahead: the profiled steps attend to about context +- 24 rows
    state.step = max(1, context - cfg.opt.cond_length - 44)
    state.step_t.fill_(state.step)
    return state


def _step_fn(torch, model, cfg, state, wq_layers, window: int, graph: bool):
    """A callable running one step of ``state``: eagerly, or a replay of
    the step captured here (after its warm-up step)."""
    from meshanything_tpu_torch.models import decoding
    from meshanything_tpu_torch.models import lookahead as la
    from meshanything_tpu_torch.models import shape_opt as opt
    from meshanything_tpu_torch.runtime.decode_graph import StepGraph

    gl = cfg.generate_length
    if window:
        def body():
            la._window_step(model.opt, cfg.opt, state, max_new_tokens=gl, wq_layers=wq_layers)
        captured = body
    else:
        def body():
            decoding.decode_step(model.opt, cfg.opt, state, wq_layers=wq_layers)

        def captured():
            opt.step_body(model.opt, cfg.opt, state, wq_layers=wq_layers)
    if not graph:
        return body
    g = StepGraph(captured, torch.device("cuda"))
    return lambda: g.replay(1)


def main(argv=None) -> int:
    import torch

    from meshanything_tpu_torch.config import MeshAnythingConfig
    from meshanything_tpu_torch.ops.wquant import quantize_opt_layers
    from meshanything_tpu_torch.runtime.checkpoint import init_random_params

    argv = sys.argv[1:] if argv is None else argv
    names = argv or list(TIERS)
    unknown = set(names) - set(TIERS)
    if unknown:
        raise SystemExit(f"unknown tiers {sorted(unknown)}; tiers: {', '.join(TIERS)}")
    if not torch.cuda.is_available():
        print("step_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = MeshAnythingConfig()
    model = init_random_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                               cfg.activation_dtype)
    wq_layers = quantize_opt_layers(model.opt.layers) if "int4_wq" in names else None
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for batch in BATCHES:
            cond = torch.randn((batch, cfg.opt.cond_length, cfg.opt.hidden_size), generator=gen,
                               device="cuda").to(cfg.activation_dtype) * 0.5
            for name in names:
                attn, wq, window = TIERS[name]
                for context in CONTEXTS:
                    for graph in ((False,) if attn == "megakernel" else (False, True)):
                        state = _state(torch, model, cfg, cond, attn, window, context)
                        step = _step_fn(torch, model, cfg, state, wq_layers if wq else None,
                                        window, graph)
                        out = profile_steps(torch, step, STEPS)
                        print(json.dumps({"tier": name, "attn": attn, "wq": wq,
                                          "window": window, "graph": graph, "batch": batch,
                                          "context_rows": context, **out}), flush=True)
                        del state, step
                        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    print(card.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
