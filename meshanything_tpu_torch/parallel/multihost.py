"""Multi-process data parallelism of folder runs (the port of
``meshanything_tpu/parallel/multihost.py``).

The reference spans cards by launching ``accelerate`` with DDP
(main.py:113-118,144-146): each rank loads the model, the dataloader
shards by rank, results are written per rank. Here the ranks are
processes started by ``torchrun`` (or anything that sets its
environment):

  * ``initialize_multihost()`` joins the default ``torch.distributed``
    process group from torchrun's ``RANK`` / ``WORLD_SIZE`` /
    ``MASTER_ADDR`` / ``MASTER_PORT``;
  * folder inference shards the *file list* per rank
    (``shard_files_for_host``): no collective runs during the decode, so
    the group is a gloo one by default, used for the rank, the world and a
    closing barrier;
  * each rank decodes on ``rank_device("cuda")`` (``cuda:LOCAL_RANK %
    device_count()``) and writes its own outputs (uids are unique).

On a single process everything degrades to a no-op, so ``--multihost`` is
always safe to pass.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def initialize_multihost(backend: str = "gloo", *, master_addr: Optional[str] = None,
                         master_port: Optional[int] = None, world_size: Optional[int] = None,
                         rank: Optional[int] = None) -> bool:
    """Join the default process group.

    Arguments default to torchrun's environment (``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``). Returns True once a
    group is joined (or was joined before), False for the graceful
    single-process no-op: one process and no address given."""
    if dist.is_initialized():
        return True
    master_addr = master_addr or os.environ.get("MASTER_ADDR")
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size <= 1 and master_addr is None:
        return False  # one process: nothing to join
    if master_port is None:
        master_port = int(os.environ.get("MASTER_PORT", "29500"))
    dist.init_process_group(backend, init_method=f"tcp://{master_addr or 'localhost'}:{master_port}",
                            world_size=world_size, rank=rank)
    return True


def process_info() -> tuple:
    """(rank, world size): (0, 1) outside a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def local_rank() -> int:
    """The rank among the processes of this machine (torchrun's
    ``LOCAL_RANK``; 0 without it)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def rank_device(kind: str = "cuda") -> torch.device:
    """The device a rank runs on: ``cuda:LOCAL_RANK % device_count()`` for
    ``kind`` "cuda" (several ranks share a card when there are more ranks
    than cards), the CPU for "cpu". A CUDA device without a card raises."""
    kind = torch.device(kind).type
    if kind == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {kind}: CUDA is not available (no fallback to the CPU)")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def shard_files_for_host(paths: Sequence[str], process_index: Optional[int] = None,
                         process_count: Optional[int] = None) -> List[str]:
    """Deterministic per-rank slice of the input list (the analogue of
    DDP's per-rank dataloader shard, main.py:146).

    Strided assignment (rank, rank+P, rank+2P, ...) keeps the load balanced
    when file sizes correlate with their sort position."""
    if process_index is None or process_count is None:
        pi, pc = process_info()
        process_index = pi if process_index is None else process_index
        process_count = pc if process_count is None else process_count
    if process_count <= 1:
        return list(paths)
    return list(paths[process_index::process_count])


def finish_multihost() -> None:
    """The closing barrier of a folder run, then leave the group (no-op
    outside one)."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
