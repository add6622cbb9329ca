"""``dryrun_multichip(n)``: the port's counterpart of
``__graft_entry__.py::dryrun_multichip``. It starts n gloo processes on
the CPU (``parallel/launch.py``) with the small config in f32, and in them:

  * one sharded train step over a (data, model) mesh (model 2 where n is
    even), its loss within 1e-5 of one process's step on the same batch;
  * a (data x model) sharded ``generate`` of the trained weights and
    ``PhaseRunner`` on the rank's rows, in every tier of ``TIERS`` (the
    exact one, the int8 and int4 caches, ``--fast`` at window 4, the
    megakernel) and the runner's adaptive lookahead over the int4 cache,
    and lookahead (window 4) under data parallelism over all n ranks;
  * the segmented decode (``init_decode_state`` + bounded
    ``decode_segment``) and the segmented lookahead (``lookahead_segment``
    with iteration bounds) over the int8 and the int4 caches under data
    parallelism.

Every stream must be token-identical to the one-process run of the same
weights and batch, which each rank also makes. Run it as
``python -m meshanything_tpu_torch.parallel.dryrun [n]``.
"""
from __future__ import annotations

import sys

import numpy as np

BUCKET = 16
# tier -> generate's and PhaseRunner's keywords
TIERS = {"exact": {}, "int8": {"attn": "pallas_int8"}, "int4": {"attn": "pallas_int4"},
         "fast": {"attn": "pallas_int8", "lookahead": 4, "wq": True},
         "megakernel": {"attn": "megakernel"}}


def _worker() -> None:
    import torch

    from meshanything_tpu_torch.config import small_test_config
    from meshanything_tpu_torch.models import decoding
    from meshanything_tpu_torch.models import lookahead as la_mod
    from meshanything_tpu_torch.models import meshanything as ma
    from meshanything_tpu_torch.parallel.collectives import gather_rows
    from meshanything_tpu_torch.parallel.mesh import create_mesh, gather_params, join
    from meshanything_tpu_torch.parallel.multihost import process_info
    from meshanything_tpu_torch.runtime.checkpoint import init_random_params
    from meshanything_tpu_torch.runtime.phases import PhaseRunner
    from meshanything_tpu_torch.training.train import (
        make_batch,
        make_sharded_train_step,
        make_train_step,
    )

    torch.set_num_threads(1)
    join("cpu")
    rank, n = process_info()
    model_axis = 2 if n % 2 == 0 else 1
    data_axis = n // model_axis
    mesh = create_mesh(data_axis, model_axis, "cpu")
    dp = create_mesh(n, 1, "cpu")
    cfg = small_test_config(n_max_triangles=4)
    gl = cfg.generate_length

    def fresh():
        return init_random_params(cfg, torch.Generator().manual_seed(0), torch.float32)

    pc, ids, labels = make_batch(cfg, np.random.default_rng(0), batch=data_axis * 2, seq=gl)
    state, step_fn = make_sharded_train_step(mesh, cfg, fresh())
    state, metrics = step_fn(state, pc, ids, labels)
    loss = float(metrics["loss"])
    one, one_step = make_train_step(cfg, fresh())
    _, one_metrics = one_step(one, pc, ids, labels)
    assert np.isfinite(loss) and state.step == 1, (loss, state.step)
    np.testing.assert_allclose(loss, float(one_metrics["loss"]), rtol=1e-5)

    trained = gather_params(mesh, state.model)
    x = torch.from_numpy(pc)
    xs = torch.from_numpy(np.random.default_rng(1).normal(size=(n, cfg.perceiver.num_points, 6))
                          .astype(np.float32) * 0.5)
    checks = {}
    with torch.no_grad():
        def same(name, sharded, single):
            assert torch.equal(sharded, single), f"{name}: sharded != one process"
            checks[name] = tuple(sharded.shape)

        for tier, kw in TIERS.items():
            single = ma.generate(trained, cfg, x, bucket=BUCKET, **kw).token_ids
            same(f"generate_{tier}", ma.generate(state.model, cfg, x, bucket=BUCKET, mesh=mesh,
                                                 **kw).token_ids, single)
            runner = PhaseRunner(state.model, cfg, bucket=BUCKET, **kw)
            same(f"runner_{tier}", gather_rows(runner(ma.local_rows(mesh, x)).token_ids,
                                               mesh.data_group), single)
        adaptive = dict(bucket=BUCKET, attn="pallas_int4", lookahead="adaptive",
                        adaptive_windows=(2, 4), adaptive_check_iters=2)
        runner = PhaseRunner(state.model, cfg, **adaptive)
        same("runner_int4_adaptive", gather_rows(runner(ma.local_rows(mesh, x)).token_ids,
                                                 mesh.data_group),
             PhaseRunner(trained, cfg, **adaptive)(x).token_ids)
        same("lookahead", ma.generate(trained, cfg, xs, bucket=BUCKET, lookahead=4,
                                      mesh=dp).token_ids,
             ma.generate(trained, cfg, xs, bucket=BUCKET, lookahead=4).token_ids)

        seg = max(gl // 3, 1)
        bounds = [min((i + 1) * seg, gl) for i in range(-(-gl // seg))]

        def segmented(attn, rows):
            _, cond = ma.encode(trained, cfg, rows)
            st = decoding.family(cfg).init_decode_state(trained.opt, cfg.opt, cond,
                                                        max_new_tokens=gl, bucket=BUCKET,
                                                        attn=attn)
            for until in bounds:
                st = decoding.decode_segment(trained.opt, cfg.opt, st, max_new_tokens=gl,
                                             until=until)
            return st.tokens

        def segmented_lookahead(attn, rows):
            _, cond = ma.encode(trained, cfg, rows)
            st = la_mod.init_lookahead_state(trained.opt, cfg.opt, cond, max_new_tokens=gl,
                                             window=4, bucket=BUCKET, attn=attn)
            for until in (2, 4, gl):   # several bounded segments
                st = la_mod.lookahead_segment(trained.opt, cfg.opt, st, max_new_tokens=gl,
                                              until_iters=until)
            return st.tokens[:, :gl]

        for attn in ("pallas_int8", "pallas_int4"):
            for name, fn in (("segmented", segmented), ("segmented_lookahead",
                                                          segmented_lookahead)):
                sharded = gather_rows(fn(attn, ma.local_rows(dp, xs)), dp.data_group)
                same(f"{name}_{attn}", sharded, fn(attn, xs))
    torch.distributed.destroy_process_group()
    if rank == 0:
        print(f"dryrun_multichip OK: mesh=({data_axis}x{model_axis}), loss={loss:.4f}, "
              + ", ".join(f"{k} {v}" for k, v in checks.items())
              + " (token-identical to one process)", flush=True)


def dryrun_multichip(n_devices: int, timeout: float = 600.0) -> str:
    """Run the dry run over ``n_devices`` gloo processes; returns rank 0's
    report line and raises where a rank failed."""
    from meshanything_tpu_torch.parallel.launch import run_ranks

    results = run_ranks([sys.executable, "-m", "meshanything_tpu_torch.parallel.dryrun",
                         "--worker"], n_devices, env={"OMP_NUM_THREADS": "1"}, timeout=timeout)
    line = results[0].stdout.strip().splitlines()[-1]
    print(line)
    return line


if __name__ == "__main__":
    if sys.argv[1:] == ["--worker"]:
        _worker()
    else:
        dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
