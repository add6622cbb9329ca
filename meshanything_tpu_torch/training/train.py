"""The trainer of the AR mesh decoder on one card (the port of
``meshanything_tpu/training/train.py``): teacher-forcing CE over
[condition || tokens], the 350M optimizer recipe (``training/optim.py``),
checkpoints and the training loop.

``make_train_step`` is the one-card step; ``make_sharded_train_step`` is
JAX's step over a (data, model) mesh of ranks (``parallel/mesh.py``;
``run_training(mesh=)``, ``main --dp D --tp T`` under torchrun). Master weights are f32 (``init_random_params(cfg,
generator, dtype=torch.float32)``); the perceiver runs in the config's
activation dtype and the decoder in the promoted one, as in JAX
(``models/shape_opt.py::forward_full``). On a card the step's f32
matmuls run as TF32 (``tf32_on_card``).

Checkpoints: ``step_N/state.pt`` under the run's directory, one
``torch.save`` of a dict of tensors (the parameters, adam's two moments,
each by parameter name) and two ints, read back with
``torch.load(weights_only=True)``: torch alone, no ``safetensors`` (JAX
writes orbax). Over a mesh they hold the full tensors (rank 0 writes after
a gather; every rank reads and keeps its shards), so a run resumes on any
mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import sys
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from meshanything_tpu_torch.config import MeshAnythingConfig
from meshanything_tpu_torch.models import meshanything as ma
from meshanything_tpu_torch.models.meshanything import MeshAnything
from meshanything_tpu_torch.parallel.collectives import all_reduce_grads, all_reduce_sum
from meshanything_tpu_torch.parallel.mesh import (
    create_mesh,
    gather_tensors,
    join,
    shard_params,
    shard_tensors,
    sharded_names,
)
from meshanything_tpu_torch.runtime.checkpoint import init_random_params
from meshanything_tpu_torch.training.losses import shifted_token_ce, token_accuracy
from meshanything_tpu_torch.training.optim import OptState, Optimizer
from meshanything_tpu_torch.training.optim import make_optimizer as _make_optimizer
from meshanything_tpu_torch.training.synthetic_grammar import make_grammar_batch

STATE_FILE = "state.pt"


@dataclasses.dataclass
class TrainState:
    """The model (its parameters updated in place), adam's state and the
    count of steps taken."""

    model: MeshAnything
    opt_state: OptState
    step: int = 0


def make_optimizer(lr: float = 1e-4, weight_decay: float = 1e-2, steps=None) -> Optimizer:
    """The training optimizer: ``training/optim.py``'s clip 1.0 +
    warmup-cosine + adamw b2 0.95 recipe (the raw Michelangelo adamw,
    b2 0.99 and eps 1e-6 with neither clip nor warmup, explodes or
    plateaus at 350M by lr, as the JAX package measured)."""
    return _make_optimizer(lr, steps=steps, weight_decay=weight_decay)


def loss_fn(model: MeshAnything, cfg: MeshAnythingConfig, pc_normal: torch.Tensor,
            token_ids: torch.Tensor, labels: torch.Tensor, *, remat: bool = True,
            block_q: int = 0, group=None) -> Tuple[torch.Tensor, dict]:
    """(loss, {"loss", "accuracy"}) of one teacher-forcing batch. Only
    the token region carries labels (-100 over the condition). With
    ``group`` (the data axis, the batch this rank's rows) the loss is the
    rank's share of the global batch's (``shifted_token_ce(group=)``) and
    the metrics are the global batch's."""
    logits = ma.forward_logits(model, cfg, pc_normal, token_ids, remat=remat, block_q=block_q)
    loss = shifted_token_ce(logits, labels, group=group)
    return loss, {"loss": all_reduce_sum(loss.detach(), group),
                  "accuracy": token_accuracy(logits.detach(), labels, group=group)}


def train_step(state: TrainState, cfg: MeshAnythingConfig, optimizer: Optimizer,
               pc_normal: torch.Tensor, token_ids: torch.Tensor, labels: torch.Tensor, *,
               remat: bool = True, block_q: int = 0, mesh=None,
               sharded=frozenset()) -> Tuple[TrainState, dict]:
    """Loss, backward and one optimizer update of ``state`` in place; the
    metrics (loss, accuracy, the grad norm before the clip) stay on the
    device. With ``mesh`` the batch is the rank's rows: the grads are
    summed over the data axis, and the clip's norm is the whole model's
    (``sharded``: the names of the split parameters)."""
    data = None if mesh is None else mesh.data_group
    loss, metrics = loss_fn(state.model, cfg, pc_normal, token_ids, labels, remat=remat,
                            block_q=block_q, group=data)
    loss.backward()
    all_reduce_grads(state.model.parameters(), data)
    metrics["grad_norm"] = optimizer.step_(state.model, state.opt_state, sharded=sharded,
                                           group=None if mesh is None else mesh.model_group)
    state.step += 1
    return state, metrics


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


@contextlib.contextmanager
def tf32_on_card(device: torch.device):
    """On a card, f32 matmuls as TF32 for the duration (the JAX package's
    f32 matmuls run at XLA's default precision, bf16 passes on the TPU);
    elsewhere nothing changes."""
    if device.type != "cuda":
        yield
        return
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def make_train_step(cfg: MeshAnythingConfig, model: MeshAnything,
                    optimizer: Optional[Optimizer] = None, *, remat: bool = True,
                    block_q: int = 0) -> Tuple[TrainState, Callable]:
    """(state, step_fn) on ``model``'s device, the one-card case of
    ``make_sharded_train_step``: ``step_fn(state, pc_normal, token_ids,
    labels)`` takes numpy arrays or tensors and returns (state, metrics),
    with autograd on whatever the caller's mode. The update is in place
    and leaves no grad behind, so parameters, grads and both moments never
    exist twice.

    remat (default on): each decoder layer recomputed in backward, so
    full-length sequences fit. block_q > 0: the causal attention is
    ``scaled_dot_product_attention`` (use it at the 7,459-position
    length)."""
    return make_sharded_train_step(None, cfg, model, optimizer, remat=remat, block_q=block_q)


def make_sharded_train_step(mesh, cfg: MeshAnythingConfig, model: MeshAnything,
                            optimizer: Optional[Optimizer] = None, *, remat: bool = True,
                            block_q: int = 0) -> Tuple[TrainState, Callable]:
    """(state, step_fn) over the (data, model) ``mesh`` (JAX's
    ``make_sharded_train_step``; None: one card, ``make_train_step``).
    ``model`` is the full model, the same on every rank (one seed, or one
    checkpoint); the state holds the rank's local module
    (``shard_params``) and adam's moments of its shards.
    ``step_fn(state, pc_normal, token_ids, labels)`` takes the global
    batch (every rank the same arrays) and runs the rank's rows
    (``models/meshanything.py::local_rows``): the loss is the global
    batch's (``shifted_token_ce(group=)``: the valid count summed over
    the data axis), the grads are summed over the data axis, the clip's
    norm is the whole model's, and the metrics are the global batch's."""
    optimizer = make_optimizer() if optimizer is None else optimizer
    local = model if mesh is None else shard_params(mesh, model)
    device = _device_of(local)
    state = TrainState(model=local, opt_state=optimizer.init(local))
    sharded = sharded_names(local) if mesh is not None and mesh.model > 1 else frozenset()

    def step_fn(state: TrainState, pc_normal, token_ids, labels):
        pc, ids, lab = (ma.local_rows(mesh, torch.as_tensor(a)).to(device)
                        for a in (pc_normal, token_ids, labels))
        # autograd on whatever the caller's mode (the inference entry points
        # turn it off for the process)
        with torch.enable_grad(), tf32_on_card(device):
            return train_step(state, cfg, optimizer, pc, ids.long(), lab.long(), remat=remat,
                              block_q=block_q, mesh=mesh, sharded=sharded)

    return state, step_fn


def save_train_state(state: TrainState, path: str, mesh=None) -> None:
    """Write ``state`` to ``path/state.pt``: the parameters and adam's
    moments by name, the update count and the step. With ``mesh`` (every
    rank calls) the full tensors are gathered and rank 0 writes them."""
    tree = {"params": {n: p.detach() for n, p in state.model.named_parameters()},
            "mu": state.opt_state.mu, "nu": state.opt_state.nu,
            "count": state.opt_state.count, "step": state.step}
    if mesh is not None:
        tree.update({part: gather_tensors(mesh, tree[part]) for part in ("params", "mu", "nu")})
    if mesh is None or mesh.rank == 0:
        os.makedirs(path, exist_ok=True)
        torch.save(tree, os.path.join(path, STATE_FILE))
    if mesh is not None and dist.is_initialized():
        dist.barrier()          # the file is whole before any rank reads it


@torch.no_grad()
def restore_train_state(path: str, template: TrainState, mesh=None) -> TrainState:
    """Resume: copy a checkpoint of ``save_train_state`` into
    ``template`` (a freshly built state, e.g. from ``make_train_step``)
    and return it. Every tensor is matched by its parameter name, adam's
    moments too, never by order (pairing by order swaps same-shaped
    leaves); a name missing on either side, or a shape that differs,
    raises. With ``mesh`` the template is a rank's sharded state and it
    keeps its shard of each full tensor, whatever mesh wrote the file."""
    tree = torch.load(os.path.join(path, STATE_FILE), map_location=_device_of(template.model),
                      weights_only=True)
    named = dict(template.model.named_parameters())
    targets = {"params": named, "mu": template.opt_state.mu, "nu": template.opt_state.nu}
    for part, dst in targets.items():
        src = tree[part] if mesh is None else shard_tensors(mesh, tree[part])
        if set(src) != set(dst):
            raise KeyError(f"checkpoint {part} names differ from the model's: "
                           f"{sorted(set(src) ^ set(dst))[:8]}")
        for name, value in src.items():
            if value.shape != dst[name].shape:
                raise ValueError(f"{part}/{name}: shape {tuple(value.shape)} != "
                                 f"{tuple(dst[name].shape)}")
            dst[name].copy_(value)
    template.opt_state.count = int(tree["count"])
    template.step = int(tree["step"])
    return template


def _step_dirs(ckpt_dir: Optional[str]) -> list:
    """Sorted [(step, path)] of the step_N checkpoint dirs under ckpt_dir."""
    out = []
    if ckpt_dir and os.path.isdir(ckpt_dir):
        for name in os.listdir(ckpt_dir):
            if name.startswith("step_") and name[5:].isdigit():
                out.append((int(name[5:]), os.path.join(ckpt_dir, name)))
    return sorted(out)


def run_training(cfg: MeshAnythingConfig, batches, *, steps: int,
                 device="cuda", model: Optional[MeshAnything] = None,
                 optimizer: Optional[Optimizer] = None, ckpt_dir: Optional[str] = None,
                 save_every: int = 0, resume: bool = False, log_every: int = 10,
                 seed: int = 0, remat: bool = True, block_q: int = 0,
                 on_metrics: Optional[Callable] = None, mesh=None) -> TrainState:
    """Checkpointed training loop over a batch iterator.

    ``batches`` yields ``(pc_normal, token_ids, labels)`` numpy tuples
    (``make_batch``'s contract). Without ``model`` the weights are
    ``init_random_params`` from ``seed`` in f32 on ``device``.
    Checkpoints land in ``ckpt_dir/step_N`` every ``save_every`` steps and
    at the end; ``resume=True`` restarts from the newest one, and the run
    then equals an uninterrupted one provided the iterator is
    deterministic and the caller skipped the batches of the restored
    steps (the loop takes one batch a step; ``grammar_batches(skip=)``).
    ``on_metrics(step, metrics)`` sees each step's device metrics; the
    loop itself reads them only to log.

    ``mesh`` (``parallel/mesh.py``; every rank runs the loop on the same
    global batches): the step is ``make_sharded_train_step``'s on the
    mesh's device, ``model`` (or the seed's weights) is the full model,
    checkpoints hold full tensors and rank 0 logs."""
    if mesh is not None:
        device = mesh.device
    if model is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        model = init_random_params(cfg, generator, dtype=torch.float32)
    state, step_fn = make_sharded_train_step(mesh, cfg, model, optimizer, remat=remat,
                                             block_q=block_q)
    lead = mesh is None or mesh.rank == 0

    if resume and ckpt_dir:
        found = _step_dirs(ckpt_dir)
        if found:
            step0, path = found[-1]
            state = restore_train_state(path, state, mesh)
            if lead:
                print(f"[train] resumed step {step0} from {path}", file=sys.stderr)

    def _save(st: TrainState) -> None:
        path = os.path.join(ckpt_dir, f"step_{st.step}")
        if lead and os.path.exists(path):   # re-save of the same step (crash between save
            shutil.rmtree(path)             # and advance)
        save_train_state(st, path, mesh)

    trained = False
    while state.step < steps:
        try:
            pc, ids, labels = next(batches)
        except StopIteration:
            break
        state, metrics = step_fn(state, pc, ids, labels)
        trained = True
        n = state.step
        if lead and log_every and (n % log_every == 0 or n == steps):
            print(f"[train] step {n}/{steps} loss {float(metrics['loss']):.4f} "
                  f"acc {float(metrics['accuracy']):.4f}", file=sys.stderr)
        if on_metrics is not None:
            on_metrics(n, metrics)
        if ckpt_dir and save_every and n % save_every == 0 and n < steps:
            _save(state)
    if ckpt_dir and trained:
        _save(state)
    return state


def make_batch(cfg: MeshAnythingConfig, rng: np.random.Generator, batch: int, seq: int):
    """Synthetic teacher-forcing batch: tokens = [bos, codes..., eos];
    labels over [cond || tokens] with -100 on the condition region (the
    shift in shifted_token_ce consumes the cond->bos boundary)."""
    pc = rng.normal(size=(batch, cfg.perceiver.num_points, 6)).astype(np.float32) * 0.5
    ids = rng.integers(3, cfg.opt.vocab_size, size=(batch, seq)).astype(np.int32)
    ids[:, 0] = cfg.opt.bos_token_id
    ids[:, -1] = cfg.opt.eos_token_id
    labels = np.full((batch, cfg.cond_length + seq), -100, np.int32)
    labels[:, cfg.cond_length:] = ids
    return pc, ids, labels


def grammar_batches(cfg: MeshAnythingConfig, batch: int, *, seed: int = 0, k: int = 5,
                    skip: int = 0, mask_padding: bool = True):
    """Deterministic infinite iterator of face-grammar batches. On resume
    pass skip=<restored step>: the skipped batches are drawn and dropped,
    so the rng stream, and the resumed run, equal the uninterrupted one."""
    rng = np.random.default_rng(seed)
    i = 0
    while True:
        b = make_grammar_batch(cfg, rng, batch, k=k, mask_padding=mask_padding)
        if i >= skip:
            yield b
        i += 1


def build_parser():
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--dp", type=int, default=1, help="data-parallel axis size")
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel axis size")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt_dir", type=str, default=None)
    ap.add_argument("--save_every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--full", action="store_true",
                    help="full 350M config (default: small smoke config)")
    ap.add_argument("--n_max_triangles", type=int, default=100,
                    help="face budget for the full config")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; cpu only when asked for)")
    ap.add_argument("--backend", type=str, default=None, choices=["nccl", "gloo"],
                    help="process group of --dp/--tp (default: gloo on the CPU, nccl on "
                         "cards; several ranks on one card need gloo)")
    return ap


def main(argv=None) -> TrainState:
    """`python -m meshanything_tpu_torch.training.train`: the checkpointed
    trainer on the procedural face grammar (real token streams plug in
    through run_training(batches=...)). ``--dp D --tp T`` run under
    ``torchrun --nproc_per_node D*T`` over a (data, model) mesh."""
    from meshanything_tpu_torch.cli import resolve_device
    from meshanything_tpu_torch.config import small_test_config

    args = build_parser().parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.dp * args.tp != world:
        raise ValueError(f"--dp {args.dp} x --tp {args.tp} needs {args.dp * args.tp} ranks, the "
                         f"world has {world}: run under torchrun --nproc_per_node "
                         f"{args.dp * args.tp}")
    mesh = None
    if world > 1:
        device = join(args.device, args.backend)
        mesh = create_mesh(args.dp, args.tp, device)
    else:
        device = resolve_device(args.device)
    cfg = (MeshAnythingConfig(n_max_triangles=args.n_max_triangles)
           if args.full else small_test_config())
    skip = 0
    if args.resume and args.ckpt_dir:
        found = _step_dirs(args.ckpt_dir)
        skip = found[-1][0] if found else 0
    batches = grammar_batches(cfg, args.batch, seed=args.seed, skip=skip)
    try:
        return run_training(cfg, batches, steps=args.steps, device=device, seed=args.seed,
                            optimizer=make_optimizer(args.lr, steps=args.steps),
                            ckpt_dir=args.ckpt_dir, save_every=args.save_every,
                            resume=args.resume, log_every=args.log_every, mesh=mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
