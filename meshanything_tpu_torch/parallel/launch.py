"""Start the ranks of a multi-process run on this machine, as ``torchrun
--nproc_per_node N`` would: each process gets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and a free
``MASTER_PORT`` of 127.0.0.1. Used by ``parallel/dryrun.py``, the tests
and ``chip_smoke.py``'s phase ``parallel``.

A failing rank fails the run: the others are killed, as they are when the
time limit passes; every process started is gone when ``run_ranks``
returns or raises.
"""
from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import tempfile
import time
from typing import List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    """A TCP port of 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class RankResult:
    rank: int
    returncode: int
    stdout: str
    stderr: str


def rank_env(rank: int, world: int, port: int, extra: Optional[dict] = None) -> dict:
    """torchrun's environment for ``rank`` of ``world`` on this machine,
    with the repository importable."""
    env = dict(os.environ)
    env.update({"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
                "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
                "MASTER_PORT": str(port),
                "PYTHONPATH": os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)})
    env.update(extra or {})
    return env


def start_ranks(argv: Sequence[str], world: int, log_dir: str, *,
                env: Optional[dict] = None) -> list:
    """Start ``world`` processes of ``argv`` (each rank's output into
    files of ``log_dir``) -> [(process, stdout file, stderr file)]; wait
    for them with ``wait_ranks``."""
    port = free_port()
    procs = []
    for rank in range(world):
        out = open(os.path.join(log_dir, f"rank{rank}.out"), "w+")
        err = open(os.path.join(log_dir, f"rank{rank}.err"), "w+")
        procs.append((subprocess.Popen(list(argv), env=rank_env(rank, world, port, env),
                                       cwd=REPO, stdout=out, stderr=err), out, err))
    return procs


def wait_ranks(procs: list, timeout: float = 600.0) -> List[RankResult]:
    """Wait for every rank of ``start_ranks``; the first to fail, or the
    time limit, kills the rest and raises RuntimeError with the failed
    ranks' output. Returns every rank's result."""
    deadline = time.monotonic() + timeout
    failed = False
    try:
        while any(p.poll() is None for p, _, _ in procs):
            if any(p.poll() not in (None, 0) for p, _, _ in procs) or time.monotonic() > deadline:
                failed = True
                break
            time.sleep(0.05)
    finally:
        for p, _, _ in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    results = []
    for rank, (p, out, err) in enumerate(procs):
        out.seek(0)
        err.seek(0)
        results.append(RankResult(rank, p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    bad = [r for r in results if r.returncode != 0]
    if failed or bad:
        why = "timed out" if not bad else "failed"
        detail = "\n".join(f"--- rank {r.rank} rc {r.returncode}\n{r.stdout[-2000:]}\n"
                           f"{r.stderr[-4000:]}" for r in (bad or results))
        raise RuntimeError(f"{len(procs)} ranks: {why}\n{detail}")
    return results


def run_ranks(argv: Sequence[str], world: int, *, env: Optional[dict] = None,
              timeout: float = 600.0, log_dir: Optional[str] = None) -> List[RankResult]:
    """``start_ranks`` then ``wait_ranks``: every rank's result, in rank
    order; raises where a rank failed or the time limit passed. The
    ranks' output files go to ``log_dir``, or to a temporary directory."""
    if log_dir is not None:
        return wait_ranks(start_ranks(argv, world, log_dir, env=env), timeout)
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        return wait_ranks(start_ranks(argv, world, tmp, env=env), timeout)
