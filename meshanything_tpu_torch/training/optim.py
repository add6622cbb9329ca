"""The optimizer of full-scale training (the port of
``meshanything_tpu/training/optim.py``): the recipe the JAX package
measured to work at 350M on the face grammar.

  * global-norm clipping at 1.0: without it, any lr that learns (>= 2e-4
    at 350M) reaches loss ~1.2 within 50 steps and then explodes;
  * a linear warmup into a cosine decay: cold-started adamw at full lr
    throws the first steps' large normalized updates at random features;
  * adamw with b2 0.95 and eps 1e-8.

The update is optax's chain ``clip_by_global_norm`` -> ``scale_by_adam``
-> ``add_decayed_weights`` -> ``scale_by_learning_rate``, written out in
optax's order of operations (``torch.nn.utils.clip_grad_norm_`` divides
by norm + 1e-6 and clips below the limit too; ``torch.optim.AdamW``
decays the weights before the step and folds the bias corrections in
another order), so that f32 training follows the JAX package step for
step. Weight decay applies to every parameter, as optax's ``adamw``
without a mask does. The update runs in place over the model's
parameters with ``torch._foreach`` ops, a group of parameters at a time,
with the grads' buffers as the denominator's scratch, and sets every
grad to None: parameters, grads and both moments never exist twice (the
reason the JAX step donates its state); the temporaries that optax's
order needs are at most two of a group's size (``GROUP_NUMEL``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
from torch import nn

from meshanything_tpu_torch.parallel.collectives import all_reduce_sum

# the update's temporaries (at most two of a group's size) cover this many
# elements at a time: 128 MiB of f32, against ~1.9 GB for the 350M model whole
GROUP_NUMEL = 1 << 25


@dataclasses.dataclass
class OptState:
    """adam's moments by parameter name, and the count of updates taken
    (optax's ``count``: the schedule is read at it before the update)."""

    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int = 0


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """clip + warmup-cosine + adamw; ``make_optimizer`` builds it."""

    lr: float
    steps: Optional[int]
    warmup_steps: int
    clip_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 1e-2
    end_lr_fraction: float = 0.1

    def schedule(self, count: int) -> float:
        """The lr of the update taken at ``count`` (optax's
        ``warmup_cosine_decay_schedule(0, lr, warmup, max(steps, 2),
        end_lr_fraction * lr)``, whose decay span includes the warmup; with
        ``steps`` None, ``linear_schedule(0, lr, warmup)``)."""
        warmup = self.warmup_steps
        if count < warmup or self.steps is None:
            return self.lr * min(count, warmup) / warmup
        decay_steps = max(self.steps, 2) - warmup
        t = min(count - warmup, decay_steps)
        alpha = self.end_lr_fraction
        return self.lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay_steps)) + alpha)

    def init(self, model: nn.Module) -> OptState:
        """Zero moments for every parameter of ``model``, by name."""
        named = dict(model.named_parameters())
        return OptState(mu={n: torch.zeros_like(p) for n, p in named.items()},
                        nu={n: torch.zeros_like(p) for n, p in named.items()})

    @torch.no_grad()
    def step_(self, model: nn.Module, state: OptState, *, group=None,
              sharded=frozenset()) -> torch.Tensor:
        """One update of ``model``'s parameters in place from their
        ``.grad`` (a missing grad counts as zeros, as JAX's grad of an
        unused leaf is), then every grad set to None. Returns the global
        grad norm before the clip, on the device (no host read).

        ``group``: ``model`` is a tensor-parallel shard (the model axis);
        the parameters named in ``sharded`` hold a slice of their leaf, so
        the norm sums their squares over the group and counts each
        replicated leaf once. The update itself is elementwise: a shard's
        update is the slice of the whole leaf's."""
        names, params, grads = [], [], []
        for name, p in model.named_parameters():
            names.append(name)
            params.append(p)
            grads.append(torch.zeros_like(p) if p.grad is None else p.grad)
            p.grad = None
        norms = torch._foreach_norm(grads)
        if group is None:
            norm = torch.linalg.vector_norm(torch.stack(norms))
        else:
            squares = torch.stack(norms) ** 2
            split = torch.tensor([n in sharded for n in names], device=squares.device)
            norm = torch.sqrt(squares[~split].sum()
                              + all_reduce_sum(squares[split].sum(), group))
        # optax: below the limit the grads pass as they are, else (g / norm) * limit
        under = norm < self.clip_norm
        torch._foreach_div_(grads, torch.where(under, 1.0, norm))
        torch._foreach_mul_(grads, torch.where(under, 1.0, torch.full_like(norm, self.clip_norm)))

        t = state.count + 1
        bc1 = (1 - torch.tensor(self.b1, dtype=torch.float32) ** t).item()
        bc2 = (1 - torch.tensor(self.b2, dtype=torch.float32) ** t).item()
        lr = self.schedule(state.count)
        for group in _groups(params, GROUP_NUMEL):
            p = [params[i] for i in group]
            g = [grads[i] for i in group]
            mu = [state.mu[names[i]] for i in group]
            nu = [state.nu[names[i]] for i in group]
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1 - self.b1))
            torch._foreach_mul_(g, g)
            torch._foreach_mul_(g, 1 - self.b2)
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_add_(nu, g)
            # the grads' buffers become the denominator sqrt(nu / bc2) + eps
            torch._foreach_copy_(g, nu)
            torch._foreach_div_(g, bc2)
            torch._foreach_sqrt_(g)
            torch._foreach_add_(g, self.eps)
            update = torch._foreach_div(mu, bc1)
            torch._foreach_div_(update, g)
            torch._foreach_add_(update, torch._foreach_mul(p, self.weight_decay))
            torch._foreach_mul_(update, -lr)
            torch._foreach_add_(p, update)
            del update
        state.count = t
        return norm


def _groups(tensors, numel: int):
    """Index lists over ``tensors`` in order, each holding at most ``numel``
    elements (a larger tensor alone)."""
    group, size = [], 0
    for i, x in enumerate(tensors):
        if group and size + x.numel() > numel:
            yield group
            group, size = [], 0
        group.append(i)
        size += x.numel()
    if group:
        yield group


def make_optimizer(lr: float = 5e-4, *, steps: Optional[int] = None,
                   warmup_steps: Optional[int] = None, clip_norm: float = 1.0,
                   b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                   weight_decay: float = 1e-2, end_lr_fraction: float = 0.1) -> Optimizer:
    """clip + warmup-cosine + adamw, the 350M recipe. ``steps``: the
    schedule's length (None: constant lr after the warmup, for open-ended
    training); the warmup defaults to min(50, max((steps or 500) // 10, 1))."""
    if warmup_steps is None:
        warmup_steps = min(50, max((steps or 500) // 10, 1))
    if warmup_steps < 1 or (steps is not None and max(steps, 2) <= warmup_steps):
        raise ValueError(f"warmup_steps={warmup_steps} must be >= 1 and, with steps, "
                         f"below max(steps, 2) (the cosine decay's span)")
    return Optimizer(lr=lr, steps=steps, warmup_steps=warmup_steps, clip_norm=clip_norm, b1=b1,
                     b2=b2, eps=eps, weight_decay=weight_decay, end_lr_fraction=end_lr_fraction)
