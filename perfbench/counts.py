"""The yardstick's arithmetic: the chip's published peaks, and the bytes and
operations that the decode and its kernels need, counted from shapes.

Copied from the program's ``runtime/bwprobe.py::decode_bytes`` /
``exact_floor_seconds`` and corrected: bounds divide by the published
peaks (``PEAKS``), not by a measured rate. It counts what the benchmark's
cells run: the bf16 weights and KV cache, one token a step. The quantized
cache's scales, W8A8's int8 matrices and the window tier's forwards come
with the cells that run them.

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


def _layer_shapes(o: dict) -> list:
    """(in, out) of the four matrices of a decoder layer."""
    d, f = o["hidden_size"], o["ffn_dim"]
    return [(d, 3 * d), (d, d), (d, f), (f, d)]


def gemm_work(o: dict, rows: int) -> Work:
    """The dense-matrix products of one decode step over ``rows`` token
    rows: the four layer matrices of every layer with their biases, the
    codebook projection ``input_layer`` and ``lm_head``, each weight read
    once and each activation row read and written once."""
    d, v, cb = o["hidden_size"], o["vocab_size"], o["codebook_dim"]
    work = Work()
    for i, j in _layer_shapes(o):
        work += Work(i * j * BF16 + j * BF16 + rows * (i + j) * BF16,
                     2 * rows * i * j) * o["num_layers"]
    for i, j, bias in ((cb, d, True), (d, v, False)):
        work += Work(i * j * BF16 + (j * BF16 if bias else 0) + rows * (i + j) * BF16,
                     2 * rows * i * j)
    return work


def step_weight_bytes(o: dict) -> float:
    """Bytes of the weights a step reads through its dense-matrix
    products."""
    return gemm_work(o, 0).bytes


def attention_call(o: dict, batch: int, rows: float) -> Work:
    """One attention kernel call of one layer: ``batch`` sequences, each
    reading ``rows`` cache rows of K and V and one bf16 query row, and
    writing one bf16 output row."""
    hd = o["hidden_size"]
    return Work(batch * (2 * rows * hd * BF16 + 2 * hd * BF16), batch * 4 * rows * hd)


def cache_rows_read(c: int, first_step: int, last_step: int) -> int:
    """Cache rows that single-token steps ``first_step`` .. ``last_step``
    (inclusive) read: step s writes row c + s - 1 and reads c + s rows."""
    n = last_step - first_step + 1
    return n * c + (first_step + last_step) * n // 2


def prefill_work(o: dict, batch: int, c: int) -> Work:
    """The causal pass over the c condition positions: every weight once,
    the matrices' FLOPs for c rows, causal attention, the cache rows
    written, and the last position's lm_head."""
    hd, v, L = o["hidden_size"], o["vocab_size"], o["num_layers"]
    mats = Work()
    for i, j in _layer_shapes(o):
        mats += Work(i * j * BF16 + batch * c * (i + j) * BF16, 2 * batch * c * i * j)
    attn = Work(0, L * batch * 2 * c * (c + 1) * hd)
    written = L * batch * 2 * c * hd * BF16
    return mats * L + attn + Work(written + hd * v * BF16, 2 * batch * hd * v)


def decode_work(cfg: dict, batch: int, steps: int) -> Work:
    """The whole decode of one request as the runner's fenced ``decode_s``
    covers it: the prefill, then ``steps`` single-token steps."""
    o = cfg["opt"]
    c, L, hd = o["cond_length"], o["num_layers"], o["hidden_size"]
    mean_rows = cache_rows_read(c, 1, steps) / steps
    per = gemm_work(o, batch) + attention_call(o, batch, mean_rows) * L
    per += Work(L * batch * 2 * hd * BF16)                        # the row written
    return prefill_work(o, batch, c) + per * steps


def slice_work(cfg: dict, batch: int, sl) -> dict:
    """{"attention": Work, "gemm": Work} of the steps of a traced slice
    (``devtrace.Slice``), steps pos0 .. pos1 - 1 from the positions read
    at its edges."""
    o = cfg["opt"]
    c, L = o["cond_length"], o["num_layers"]
    s0, s1 = sl.pos0[0], sl.pos1[0]
    n = s1 - s0
    rows = cache_rows_read(c, s0, s1 - 1) / max(n, 1)
    return {"attention": attention_call(o, batch, rows) * (L * n),
            "gemm": gemm_work(o, batch) * n}


def roof_share(run, part: str, kernel_seconds: float):
    """Percent of the roofline that the kernels of ``part`` reach over the
    traced slices: their least time on the published peaks over their
    summed device time; None where the trace holds none of them."""
    if not run.slices or kernel_seconds <= 0:
        return None
    least = sum(slice_work(run.model, run.batch, sl)[part].least_seconds() for sl in run.slices)
    return 100.0 * least / kernel_seconds


def decode_mfu(run):
    """Percent of the chip's peak that the whole decode reaches: its least
    time on the published peaks over the fenced ``decode_s``, summed over
    the window's requests."""
    done = run.done()
    if not done:
        return None
    least = sum(decode_work(run.model, run.batch, r["decode_steps"]).least_seconds()
                for r in done)
    return 100.0 * least / sum(r["decode_s"] for r in done)
