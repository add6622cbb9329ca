"""``--multihost`` folder runs of the PyTorch port
(``meshanything_tpu_torch/parallel/multihost.py``, ``cli.py``): the
strided file split, the single-process no-op, and a real run of the CLI
over two gloo processes on the CPU (torchrun's environment, one torch
thread each, no JAX in them) whose OBJs equal the single-process CLI's
byte for byte, with one metrics file a rank."""
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

import meshanything_tpu_torch.cli as cli
from meshanything_tpu.parallel.multihost import shard_files_for_host as jax_shard_files
from meshanything_tpu_torch.config import small_test_config
from meshanything_tpu_torch.parallel import multihost
from meshanything_tpu_torch.parallel.launch import run_ranks

N_MAX = 2

WORKER = r"""
import sys
import torch
import meshanything_tpu_torch.cli as cli
from meshanything_tpu_torch.config import small_test_config

torch.set_num_threads(1)
cli.build_config = lambda args: small_test_config(n_max_triangles=%d)
cli.main(sys.argv[1:])
""" % N_MAX


def test_shard_files_for_host_partition():
    """An exact, strided partition, as JAX's shard_files_for_host (JAX's
    test_shard_files_for_host_partition)."""
    paths = [f"f{i}.npy" for i in range(10)]
    shards = [multihost.shard_files_for_host(paths, pi, 4) for pi in range(4)]
    assert sorted(p for s in shards for p in s) == sorted(paths)
    assert shards[0] == ["f0.npy", "f4.npy", "f8.npy"]
    assert shards[3] == ["f3.npy", "f7.npy"]
    assert shards == [jax_shard_files(paths, pi, 4) for pi in range(4)]
    assert multihost.shard_files_for_host(paths, 0, 1) == paths


def test_initialize_multihost_single_process_noop(monkeypatch):
    """One process and no address: nothing is joined, (0, 1), the CPU."""
    for key in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert multihost.initialize_multihost() is False
    assert multihost.process_info() == (0, 1)
    assert multihost.shard_files_for_host(["a", "b"]) == ["a", "b"]
    assert multihost.rank_device("cpu") == torch.device("cpu")
    multihost.finish_multihost()        # outside a group: a no-op


def _inputs(tmp_path, n):
    rng = np.random.default_rng(0)
    folder = tmp_path / "in"
    folder.mkdir()
    for i in range(n):
        pts = rng.normal(size=(96, 3))
        pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
        np.save(folder / f"s{i}.npy", np.concatenate([pts * 0.5, pts], axis=1).astype(np.float16))
    return folder


def _args(folder, out, metrics):
    return ["--input_dir", str(folder), "--input_type", "pc_normal", "--out_dir", str(out),
            "--random_weights", "--device", "cpu", "--dtype", "float32", "--bucket", "16",
            "--seed", "3", "--metrics_out", str(metrics)]


def _objs(out):
    return {os.path.basename(p): open(p, "rb").read()
            for p in glob.glob(os.path.join(str(out), "*", "*.obj"))}


def test_multihost_cli_matches_single_process(tmp_path, monkeypatch):
    """Four inputs over two ranks: each rank writes its strided share into
    one <out_dir>/<time> folder, the union is all four, byte-equal to the
    single-process CLI's OBJs; rank 1's records go to ``metrics.1``."""
    folder = _inputs(tmp_path, 4)
    run_ranks([sys.executable, "-c", WORKER, "--multihost",
               *_args(folder, tmp_path / "multi", tmp_path / "multi.jsonl")], 2,
              env={"OMP_NUM_THREADS": "1"}, timeout=300)
    monkeypatch.setattr(cli, "build_config", lambda args: small_test_config(n_max_triangles=N_MAX))
    with torch.no_grad():
        single = cli.main(_args(folder, tmp_path / "single", tmp_path / "single.jsonl"))
    assert len(single) == 4
    multi = _objs(tmp_path / "multi")
    assert len(os.listdir(tmp_path / "multi")) == 1          # one folder for both ranks
    assert multi == _objs(tmp_path / "single") and len(multi) == 4
    ranks = [[json.loads(line)["uid"] for line in open(path)]
             for path in (tmp_path / "multi.jsonl", tmp_path / "multi.jsonl.1")]
    assert ranks == [["s0", "s2"], ["s1", "s3"]]


def test_cli_multihost_flag_single_process_noop(tmp_path, monkeypatch):
    """--multihost on one process (JAX's test_cli_multihost_flag_parses_and_noops):
    a graceful no-op, every input processed, no suffix on the metrics."""
    for key in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    folder = _inputs(tmp_path, 2)
    monkeypatch.setattr(cli, "build_config", lambda args: small_test_config(n_max_triangles=N_MAX))
    metrics = tmp_path / "m.jsonl"
    with torch.no_grad():
        results = cli.main([*_args(folder, tmp_path / "out", metrics), "--multihost"])
    assert len(results) == 2 and metrics.exists()
    assert not os.path.exists(f"{metrics}.0")
