"""Dynamic micro-batching for serving: coalesce concurrent requests (the
port of ``meshanything_tpu/runtime/batching.py``, with its semantics).

Each decode step reads every layer's weights once whatever the batch, so
a batch of meshes costs far less than its meshes one by one. The
reference serves strictly one request at a time (app.py); this batcher
keeps the per-request API while packing concurrent requests into one
padded batched generation.

Design:
  * requests enqueue (pc, generator) + a Future; a single worker thread
    drains the queue, waiting up to ``max_wait_s`` after the first
    arrival to let a batch accumulate (classic dynamic batching);
  * batches pad UP to the next size in ``batch_sizes`` (repeating the
    last row), so a lone request runs at B=1 instead of paying a padded
    largest-batch decode;
  * only greedy batch-1 requests coalesce: sampled requests, prompt
    (completion) requests and already-batched inputs go straight through
    to the wrapped runner on the caller's thread;
  * a failure inside a batch propagates to every member's Future, so
    callers see the exception exactly as in the unbatched path.

Sampled requests pass through because a batched decode draws every row
from one generator, which would discard every other request's seed
(its advertised seed would have no effect on its stream). Per-seed
reproducibility is part of the API contract (reference app.py seeds each
request).

The wrapped runner (``runtime/phases.py::PhaseRunner``) serialises the
device work of the worker and of pass-through callers, and keeps a decode
state and its graphs for each batch size it runs: the padded sizes here
are those keys, so a size's first batch captures and the later ones
replay.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Sequence

import numpy as np


class BatchingRunner:
    """Wraps a PhaseRunner-shaped callable with dynamic micro-batching.

    Call signature matches PhaseRunner: ``(pc, sampling=, generator=,
    prompt_ids=)`` with pc of batch 1; returns that row's GenerateOutput
    (its ``stats`` the batched call's)."""

    def __init__(self, runner, *, batch_sizes: Sequence[int] = (1, 2, 4, 8),
                 max_wait_s: float = 0.05):
        self._runner = runner
        self._sizes = sorted(batch_sizes)
        self._max_batch = self._sizes[-1]
        self._max_wait = max_wait_s
        self._q: "queue.Queue" = queue.Queue()
        self.batch_calls = 0          # observability: batched launches
        self.rows_served = 0
        self.batch_sizes_served: list = []   # the padded size of each batched launch
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def __call__(self, pc, *, sampling: bool = False, generator=None, prompt_ids=None,
                 timer=None):
        if prompt_ids is not None or sampling or np.asarray(pc).shape[0] != 1:
            # pass-through: variable prompt shapes, per-seed sampling
            # (see module docstring), or already-batched pcs
            if prompt_ids is not None:
                return self._runner(pc, sampling=sampling, generator=generator,
                                    prompt_ids=prompt_ids)
            return self._runner(pc, sampling=sampling, generator=generator)
        fut: Future = Future()
        self._q.put((np.asarray(pc), False, generator, fut))
        return fut.result()

    def close(self) -> None:
        """Stop the worker thread (idempotent). Without this the daemon
        worker blocks in queue.get forever, keeping the wrapped runner —
        and its weights — alive for the life of the process."""
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join(timeout=10)

    # ------------------------------------------------------------------
    def _loop(self):
        while True:
            first = self._q.get()
            if first is None:  # close() sentinel
                return
            batch = [first]
            stop = False
            deadline = time.time() + self._max_wait
            while len(batch) < self._max_batch:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                try:
                    item = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:  # close() raced an in-flight batch
                    stop = True
                    break
                batch.append(item)
            self._run_group(batch, sampling=False)  # only greedy enqueues
            if stop:
                return

    def _pad_size(self, n: int) -> int:
        for s in self._sizes:
            if s >= n:
                return s
        return self._max_batch

    def _run_group(self, group, sampling: bool):
        from meshanything_tpu_torch.models.meshanything import GenerateOutput

        try:
            pcs = np.concatenate([g[0] for g in group])
            size = self._pad_size(len(pcs))
            if size > len(pcs):
                pcs = np.concatenate(
                    [pcs, np.repeat(pcs[-1:], size - len(pcs), axis=0)])
            generator = next((g[2] for g in group if g[2] is not None), None)
            out = self._runner(pcs, sampling=sampling, generator=generator)
            self.batch_calls += 1
            self.rows_served += len(group)
            self.batch_sizes_served.append(size)
            for i, (_, _, _, fut) in enumerate(group):
                fut.set_result(GenerateOutput(face_coords=out.face_coords[i: i + 1],
                                              token_ids=out.token_ids[i: i + 1],
                                              stats=out.stats))
        except Exception as e:  # propagate to every member
            for _, _, _, fut in group:
                if not fut.done():
                    fut.set_exception(e)
