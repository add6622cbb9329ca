"""The yardstick's arithmetic: the chip's published peaks, and the shares of
them that the decode and its kernels reach.

The bytes and operations themselves are counted from shapes by the run's
decoder family (``decoders/<decoder>.py``: ``decode_work`` for a request,
``slice_work`` for a traced slice, one ``Work`` for each of the
configuration's ``kernels`` groups). The OPT family's counts are copied
from the program's ``runtime/bwprobe.py::decode_bytes`` /
``exact_floor_seconds`` and corrected: bounds divide by the published
peaks (``PEAKS``), not by a measured rate.

Each input byte is counted once a call and each output byte once, whatever
a kernel reads again.
"""
from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAKS = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}
BF16 = 2


@dataclass(frozen=True)
class Work:
    """What a piece of work needs: bytes moved and bf16 FLOPs."""
    bytes: float = 0.0
    flops: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.flops + other.flops)

    def __mul__(self, k: float) -> "Work":
        return Work(self.bytes * k, self.flops * k)

    def least_seconds(self) -> float:
        """The larger of the compute bound and the memory bound."""
        return max(self.flops / PEAKS["bf16_flops"], self.bytes / PEAKS["hbm_bytes_per_s"])

    def bound(self) -> str:
        compute = self.flops / PEAKS["bf16_flops"]
        return "compute" if compute > self.bytes / PEAKS["hbm_bytes_per_s"] else "bytes"


def cache_rows_read(c: int, first_step: int, last_step: int) -> int:
    """Cache rows that single-token steps ``first_step`` .. ``last_step``
    (inclusive) read: step s writes row c + s - 1 and reads c + s rows."""
    n = last_step - first_step + 1
    return n * c + (first_step + last_step) * n // 2


def roof_share(run, part: str, kernel_seconds: float):
    """Percent of the roofline that the kernels of ``part`` (a group of the
    configuration's ``kernels``, a part of the family's ``slice_work``)
    reach over the traced slices: their least time on the published peaks
    over their summed device time; None where the trace holds none of
    them."""
    if not run.slices or kernel_seconds <= 0:
        return None
    least = sum(run.decoder.slice_work(run.model, run.batch, sl)[part].least_seconds()
                for sl in run.slices)
    return 100.0 * least / kernel_seconds


def decode_mfu(run):
    """Percent of the chip's peak that the whole decode reaches: its least
    time on the published peaks (the family's ``decode_work``) over the
    fenced ``decode_s``, summed over the window's requests."""
    done = run.done()
    if not done:
        return None
    least = sum(run.decoder.decode_work(run.model, run.batch, r["decode_steps"]).least_seconds()
                for r in done)
    return 100.0 * least / sum(r["decode_s"] for r in done)
