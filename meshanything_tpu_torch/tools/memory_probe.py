"""Peak device memory of a generation, phase by phase, beside the
budget's estimate (the port of ``tools/memory_probe.py``, which read the
TPU compiler's buffer assignment; here the card's allocator is read).

    python -m meshanything_tpu_torch.tools.memory_probe [batch] [attn] [window] [--wq]
      e.g.  python -m meshanything_tpu_torch.tools.memory_probe 16 pallas
            python -m meshanything_tpu_torch.tools.memory_probe 16 pallas_int4
            python -m meshanything_tpu_torch.tools.memory_probe 1 pallas_int8 8 --wq

The full 350M model on seeded random bf16 weights runs encode, the
prefill into a full-length cache, 70 decode steps (or 12 window forwards
with ``window``) and detok, as ``InferencePipeline.generate`` orders them:
the runner keeps the decode state (the cache, and the int8 matrices with
``--wq``) for the next request of the batch size, so they stay live
through detok. After each phase it reads the peak of
``torch.cuda.max_memory_allocated`` above the weights. The peaks come
with the allocations, not with the steps, so a short decode shows them.
One JSON line: the four peaks, ``check_memory_budget``'s estimate above
the weights, which must not be below any of them, the bytes a row of
encode or detok took, and the bytes a quantized prefill's transients took
per element of its compact K/V tensor (the constants of
``runtime/phases.py`` are set from these two readings). Then
``MEMORY-PROBE-OK``. Needs a card: host memory is not what the budget
guards. The smoke run's ``budget`` phase calls ``phase_peaks`` at B=16 for
the bf16, int8 and int4 caches, so the readings are retaken in every run.
"""
from __future__ import annotations

import argparse
import json
import sys


def phase_peaks(model, cfg, batch: int, attn: str, window: int = 0, wq: bool = False) -> dict:
    """Run encode, prefill, a short decode and detok of ``batch`` rows on
    the card that holds ``model`` -> the record ``main`` prints (without
    the card's name). The decode state and int8 matrices stay live
    through detok, as the runner keeps them. Raises where the estimate is
    below a peak."""
    import torch

    from meshanything_tpu_torch.models import decoding
    from meshanything_tpu_torch.models import lookahead as la
    from meshanything_tpu_torch.models import meshanything as ma
    from meshanything_tpu_torch.models import shape_opt as opt
    from meshanything_tpu_torch.ops.wquant import quantize_opt_layers
    from meshanything_tpu_torch.runtime.phases import check_memory_budget, param_tree_bytes

    device = next(model.parameters()).device
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)       # the weights and what the caller holds
    peaks = {}

    def phase_done(name: str) -> None:
        torch.cuda.synchronize(device)
        peaks[name] = torch.cuda.max_memory_allocated(device) - base
        torch.cuda.reset_peak_memory_stats(device)

    torch.cuda.reset_peak_memory_stats(device)
    pc = torch.randn((batch, cfg.perceiver.num_points, 6), device=device,
                     generator=torch.Generator(device=device).manual_seed(1))
    point_feature, cond = ma.encode(model, cfg, pc)
    phase_done("encode")
    gl = cfg.generate_length
    if window:
        state = la.init_lookahead_state(model.opt, cfg.opt, cond, max_new_tokens=gl,
                                        window=window, bucket=512, attn=attn,
                                        sampling=False, generator=None, buf_window=window)
        phase_done("prefill")
        cache = torch.cuda.memory_allocated(device) - base
        wq_layers = quantize_opt_layers(model.opt.layers) if wq else None
        state = la.lookahead_segment(model.opt, cfg.opt, state, max_new_tokens=gl,
                                     wq_layers=wq_layers, until_iters=12, sampling=False)
        tokens = state.tokens[:, :gl].clone()
    else:
        state = opt.init_decode_state(model.opt, cfg.opt, cond, max_new_tokens=gl, bucket=512,
                                      generator=None, attn=attn, sampling=False)
        phase_done("prefill")
        cache = torch.cuda.memory_allocated(device) - base
        wq_layers = quantize_opt_layers(model.opt.layers) if wq else None
        state = decoding.decode_loop(model.opt, cfg.opt, state, max_new_tokens=70, wq=wq,
                                     sampling=False, wq_layers=wq_layers)
        tokens = state.tokens.clone()
    phase_done("decode")
    torch.cuda.reset_peak_memory_stats(device)   # the decode's transients are gone
    kept = torch.cuda.memory_allocated(device) - base     # the kept state through detok
    ma.detokenize(model, cfg, tokens, point_feature)
    phase_done("detok")

    params = param_tree_bytes(model)
    estimate = check_memory_budget(cfg, batch, 512, attn, param_bytes=params, device=device,
                                   extra_tokens=window, wq=wq, keep=True) - params
    record = {"tool": "memory_probe", "batch": batch, "attn": attn, "window": window,
              "wq": wq, "param_bytes": params, "peak_bytes_above_weights": peaks,
              "estimate_bytes_above_weights": estimate,
              "estimate_over_peak": estimate / max(peaks.values()),
              "kept_through_detok_bytes": kept,
              # encode and detok (above what is kept) scale with the batch alone
              "encode_detok_bytes_per_row": max(peaks["encode"], peaks["detok"] - kept) / batch}
    if attn in ("pallas_int8", "pallas_int4"):
        # what the prefill held at its peak beyond what it left behind (the cache)
        compact = 2 * cfg.opt.num_layers * batch * cfg.cond_length * cfg.opt.hidden_size
        record["prefill_transient_bytes_per_element"] = (peaks["prefill"] - cache) / compact
    if estimate < max(peaks.values()):
        raise AssertionError(f"the estimate {estimate} is below a measured peak {peaks}")
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=16)
    ap.add_argument("attn", nargs="?", default="pallas")
    ap.add_argument("window", nargs="?", type=int, default=0)
    ap.add_argument("--wq", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from meshanything_tpu_torch.config import MeshAnythingConfig
    from meshanything_tpu_torch.models.decoding import resolve_attn
    from meshanything_tpu_torch.runtime.checkpoint import init_random_params
    from meshanything_tpu_torch.tools.build_canary import canary, resolve_device

    device = resolve_device("cuda", "memory_probe")
    torch.set_grad_enabled(False)
    card = canary(device)["card"]
    cfg = MeshAnythingConfig(dtype="bfloat16")
    model = init_random_params(cfg, torch.Generator(device=device).manual_seed(0),
                               cfg.activation_dtype)
    record = phase_peaks(model, cfg, args.batch, resolve_attn(args.attn), args.window, args.wq)
    print(json.dumps({**record, "card": card}), flush=True)
    print("MEMORY-PROBE-OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
