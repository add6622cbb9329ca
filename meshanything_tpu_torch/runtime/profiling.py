"""Tracing and profiling: per-phase timers, a ``torch.profiler`` trace and
the device's memory counters (the port of
``meshanything_tpu/runtime/profiling.py``).
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import time
from collections import defaultdict
from typing import Dict, List, Optional, Union

import torch

Fence = Union[torch.Tensor, torch.device, "torch.cuda.Event", None]


def fence(on: Fence) -> None:
    """Wait for the device work ``on`` stands for: a CUDA event's own
    work, or everything queued on a CUDA tensor's or a CUDA device's
    card. CPU tensors and devices need no fence."""
    if on is None:
        return
    if isinstance(on, torch.cuda.Event):
        on.synchronize()
        return
    device = on.device if isinstance(on, torch.Tensor) else on
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Accumulates seconds per named phase (encode / decode / detok /
    postprocess): host wall clock around a block, read after a fence on a
    CUDA tensor, device or event."""

    def __init__(self):
        self.records: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str, block_on: Fence = None):
        """Time the block on the host clock; ``block_on`` (a CUDA tensor,
        device or event) is fenced before the clock is read."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            fence(block_on)
            self.records[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        """Add a duration measured elsewhere."""
        self.records[name].append(float(seconds))

    def summary(self) -> Dict[str, dict]:
        out = {}
        for name, xs in self.records.items():
            xs_sorted = sorted(xs)
            out[name] = {
                "count": len(xs),
                "total_s": sum(xs),
                "mean_s": sum(xs) / len(xs),
                "p50_s": xs_sorted[len(xs) // 2],
                "max_s": xs_sorted[-1],
            }
        return out

    def dump(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.summary(), indent=2)
        if path:
            with open(path, "w") as fh:
                fh.write(s)
        return s


@contextlib.contextmanager
def cuda_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (host, and the
    card where there is one) and write it to ``log_dir/trace.json`` for
    chrome://tracing or Perfetto. Yields the profiler, whose
    ``key_averages()`` sum the time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def kernel_device_us(evt) -> float:
    """A profiler event's own device time in µs (its name differs across
    torch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def device_memory_stats() -> dict:
    """Live and peak allocated bytes of every visible card ({} without
    one), from the caching allocator's counters."""
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": ms.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": ms.get("allocated_bytes.all.peak", 0),
        }
    return stats


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, to
    stand beside every measurement; "cpu" for a CPU run."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
