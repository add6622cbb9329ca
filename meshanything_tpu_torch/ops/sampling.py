"""Token sampling: greedy and HF-compatible top-k then top-p.

The filters mask exactly what ``meshanything_tpu/ops/sampling.py`` masks.
The drawn token differs from the JAX package's for the same seed (torch
generators are not threefry keys), so sampled streams are compared by
distribution, greedy streams token for token.

Every function here may run inside a CUDA-graph capture of a decode step:
no host read of a device value, no shape that depends on the data. The
draw is ``torch.multinomial``'s own one-sample path written out (an
exponential variate per token, the argmax of p / e), because
``multinomial`` checks its input on the host.
"""
from __future__ import annotations

from typing import Optional

import torch


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask everything below the k-th largest logit to -inf."""
    if k <= 0:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def top_p_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering with HF semantics: keep the tokens whose
    exclusive cumulative probability (descending order) is <= p, and
    always the top token."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) <= p
    keep[..., 0] = True
    cutoff = torch.where(keep, sorted_logits, float("inf")).amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < cutoff, float("-inf"))


def sample_token(logits: torch.Tensor, *, sampling: bool, top_k: int = 50,
                 top_p: float = 0.95, temperature: float = 1.0,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B, vocab) f32 logits -> (B,) int64 next token. Greedy takes the
    first maximal index, as ``jnp.argmax`` does."""
    if not sampling:
        return torch.argmax(logits, dim=-1)
    if temperature != 1.0:
        logits = logits / temperature
    logits = top_p_filter(top_k_filter(logits, top_k), top_p)
    probs = torch.softmax(logits, dim=-1)
    # P(argmax of p_i / e_i = i) = p_i for e_i ~ Exp(1) i.i.d.
    expo = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / expo, dim=-1)
