"""Auxiliary positional/coordinate embedders: the port of
``meshanything_tpu/models/embedders.py`` (the reference's extra embedder
tier, michelangelo/models/modules/embedder.py:108-230):

  * ``LearnedFourier`` (:108-132) — learned per-channel frequencies,
    output = [x ‖ sin ‖ cos];
  * ``TriplaneFourier`` (:135-153) — the sum of three plane embedders;
  * ``sequential_pos_embed`` (:156-172) — a fixed sin/cos table;
  * ``get_embedder`` (:195-230) — identity / fourier / learned selection
    (the hashgrid branch needs tiny-cuda-nn and is refused, as in JAX).

The live fixed-frequency embedder is ``models/perceiver.py::fourier_embed``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn


def learned_fourier(weights: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[..., c] -> [..., c + 2*c*per_channel]: x ‖ sin(2π x w) ‖ cos(2π x w)."""
    freqs = (x[..., None] * weights * (2 * math.pi)).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(freqs), torch.cos(freqs)], dim=-1)


def learned_fourier_out_dim(in_channels: int, dim: int) -> int:
    per_channel = (dim // 2) // in_channels
    return in_channels + 2 * in_channels * per_channel


class LearnedFourier(nn.Module):
    """LearnedFourierEmbedder: ``weights`` (per_channel,), N(0, 1) at init."""

    def __init__(self, in_channels: int, dim: int, *, generator: Optional[torch.Generator] = None,
                 device=None, dtype=None):
        super().__init__()
        if dim % 2:
            raise ValueError("dim must be even")
        per_channel = (dim // 2) // in_channels
        self.weights = nn.Parameter(torch.randn(per_channel, generator=generator,
                                                device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return learned_fourier(self.weights, x)


class TriplaneFourier(nn.Module):
    """TriplaneLearnedFourierEmbedder: the sum of the yz, xz and xy planes'
    embeddings (embedder.py:145-153)."""

    def __init__(self, in_channels: int, dim: int, *, generator: Optional[torch.Generator] = None,
                 device=None, dtype=None):
        super().__init__()
        f = {"generator": generator, "device": device, "dtype": dtype}
        self.yz = LearnedFourier(in_channels, dim, **f)
        self.xz = LearnedFourier(in_channels, dim, **f)
        self.xy = LearnedFourier(in_channels, dim, **f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.yz(x) + self.xz(x) + self.xy(x)


def sequential_pos_embed(num_len: int, embed_dim: int, device=None) -> torch.Tensor:
    """Fixed sin/cos table [sin ‖ cos] with 10000^(-2i/D) frequencies
    (embedder.py:156-172)."""
    if embed_dim % 2:
        raise ValueError("embed_dim must be even")
    pos = torch.arange(num_len, dtype=torch.float32, device=device)
    omega = 1.0 / 10000 ** (torch.arange(embed_dim // 2, dtype=torch.float32, device=device)
                            / (embed_dim / 2))
    out = pos[:, None] * omega[None]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def get_embedder(embed_type: str = "fourier", num_freqs: int = -1, input_dim: int = 3, *,
                 generator: Optional[torch.Generator] = None, learned_dim: int = 64,
                 include_pi: bool = True) -> Tuple[Callable, int]:
    """Embedder factory (embedder.py:195-230): returns (fn, out_dim).

    "identity" (or fourier with num_freqs=-1) -> passthrough; "fourier" ->
    the live fixed-frequency embedder; "learned_fourier" -> a
    ``LearnedFourier`` module drawn from ``generator`` (train it as a
    module)."""
    if embed_type == "identity" or (embed_type == "fourier" and num_freqs == -1):
        return (lambda x: x), input_dim
    if embed_type == "fourier":
        from meshanything_tpu_torch.models.perceiver import fourier_embed

        out_dim = input_dim * (2 * num_freqs + 1)
        return (lambda x: fourier_embed(x, num_freqs, include_pi=include_pi)), out_dim
    if embed_type == "learned_fourier":
        module = LearnedFourier(input_dim, learned_dim, generator=generator)
        return module, learned_fourier_out_dim(input_dim, learned_dim)
    raise ValueError(
        f"unsupported embed_type {embed_type!r} (the reference's hashgrid "
        "branch requires tiny-cuda-nn, which the port does not use)"
    )
