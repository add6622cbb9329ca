"""Seeded weights, made on the device in a few large draws.

The benchmark makes the weights itself from ``--seed``, so that the program
and the plain reference get the same values and neither takes them from
the other: ``fill`` walks ``reference/model.py::param_spec`` (the shared
parts' entries around the decoder family's) in its order,
draws one standard normal block for up to ``CHUNK`` elements of
consecutive parameters from a ``torch.Generator`` on the device, and
writes each parameter's slice, scaled, into the tensor that ``sink`` gives
for its name. The same seed on the same device gives the same values
whatever the sink's dtype, because every value is drawn in float32 and
rounded once to the served dtype (``dtype``) before it is written.

The values follow the program's own seeded initialisation
(``runtime/checkpoint.py::init_random_params``): linear weights N(0, 0.02),
the perceiver's N(0, init_scale / sqrt(width)), tables and queries
N(0, 0.02), biases 0, layer norms 1 and 0. (With small random biases and
norms the greedy streams of random weights stop repeating, and the window
tier's acceptance swings more with seed and input than with them alone.)
The output head's row of the end-of-sequence token (the family's
``interface``: ``eos_row``, ``eos``) is zero: its logit is then 0, under
the best of the other 8,194 of every position, so no seed stops a
request early and every request is the 800-face stress that the
reference's max-length run is (a seed whose weights emitted eos would cut
the window tier's work short, which the single-token tier's
``early_exit=False`` does not).
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Tuple

import torch

CHUNK = 1 << 26            # elements a draw: 256 MB of float32 at most
TABLE_STD = 0.02


def _mean_std(kind: str, std: float) -> Tuple[float, float]:
    """(mean, std) of a parameter's values; std 0 is a constant, drawn
    nothing for."""
    if kind == "linear":
        return 0.0, std
    if kind == "table":
        return 0.0, TABLE_STD
    return (1.0 if kind == "ln_weight" else 0.0), 0.0


def _chunks(spec: list) -> Iterator[List[tuple]]:
    """Consecutive drawn parameters, up to ``CHUNK`` elements a group (a
    constant one is drawn nothing for, and closes no group)."""
    group, total = [], 0
    for entry in spec:
        n = 1
        for s in entry[1]:
            n *= s
        drawn = n if _mean_std(entry[2], entry[3])[1] else 0
        if group and total + drawn > CHUNK:
            yield group
            group, total = [], 0
        group.append(entry + (n,))
        total += drawn
    if group:
        yield group


@torch.no_grad()
def fill(spec: list, sink: Callable[[str], torch.Tensor], seed: int, device: torch.device,
         dtype: torch.dtype, zero_row: Tuple[str, int]) -> None:
    """Write every parameter of ``spec`` into ``sink(name)`` (a tensor of
    the parameter's shape on ``device``): the seeded draw, scaled and
    shifted, rounded to ``dtype``, then cast to the sink's dtype; of
    ``zero_row`` (name, row), that row zero."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    for group in _chunks(spec):
        total = sum(e[-1] for e in group if _mean_std(e[2], e[3])[1])
        block = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
        start = 0
        for name, shape, kind, std, n in group:
            mean, sd = _mean_std(kind, std)
            if sd:
                values = (block[start:start + n] * sd + mean).to(dtype).reshape(shape)
                start += n
            else:
                values = torch.full(shape, mean, dtype=dtype, device=device)
            target = sink(name)
            if tuple(target.shape) != tuple(shape):
                raise ValueError(f"{name}: the program holds {tuple(target.shape)}, "
                                 f"the specification says {tuple(shape)}")
            if name == zero_row[0]:
                values[zero_row[1]] = 0
            target.copy_(values)


def reference_params(spec: list, seed: int, device: torch.device, dtype: torch.dtype,
                     zero_row: Tuple[str, int]) -> dict:
    """The same weights as float32 tensors by name, for the reference."""
    params = {name: torch.empty(shape, dtype=torch.float32, device=device)
              for name, shape, _, _ in spec}
    fill(spec, params.__getitem__, seed, device, dtype, zero_row)
    return params
