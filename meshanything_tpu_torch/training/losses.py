"""Training losses (the port of ``meshanything_tpu/training/losses.py``).

  * the AR token loss: the shifted cross-entropy of ShapeOPT.forward
    (shape_opt.py:157-166 of the reference);
  * the Michelangelo VAE recipe (ContrastKLNearFar, loss.py:193): BCE
    occupancy plus KL, and the CLIP-contrastive term.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from meshanything_tpu_torch.parallel.collectives import all_reduce_sum, gather_rows_grad, rank_in


def shifted_token_ce(logits: torch.Tensor, labels: torch.Tensor,
                     ignore_index: int = -100, group=None) -> torch.Tensor:
    """CrossEntropy(logits[..., :-1, :], labels[..., 1:]) in f32, the mean
    over the labels that are not ``ignore_index``, divided by
    max(count, 1): an all-ignored batch gives 0, where
    ``F.cross_entropy(reduction="mean")`` gives NaN.

    ``group`` (the data axis, each rank with its rows of the batch): the
    count is the whole batch's (summed over the group), so the value is
    this rank's share of the global batch's loss: the shares, and their
    grads, sum over the group to the loss of one device over the global
    batch (what JAX's global jit computes; the ranks' means averaged would
    not be, where their counts differ)."""
    shift_logits = logits[..., :-1, :].float()
    shift_labels = labels[..., 1:].long()
    ce = F.cross_entropy(shift_logits.reshape(-1, shift_logits.shape[-1]),
                         shift_labels.reshape(-1), ignore_index=ignore_index, reduction="sum")
    count = all_reduce_sum((shift_labels != ignore_index).sum(), group)
    return ce / count.clamp_min(1)


def token_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_index: int = -100, group=None) -> torch.Tensor:
    """Share of the labels that are not ``ignore_index`` that the
    previous position's argmax predicts; with ``group`` over the global
    batch (both counts summed over the group)."""
    pred = torch.argmax(logits[..., :-1, :], dim=-1)
    shift_labels = labels[..., 1:]
    valid = shift_labels != ignore_index
    correct = (pred == shift_labels) & valid
    return all_reduce_sum(correct.sum(), group) / all_reduce_sum(valid.sum(), group).clamp_min(1)


def vae_occupancy_loss(logits: torch.Tensor, occupancy_labels: torch.Tensor,
                       posterior_mean: torch.Tensor, posterior_logvar: torch.Tensor, *,
                       kl_weight: float = 0.001, near_logits: Optional[torch.Tensor] = None,
                       near_labels: Optional[torch.Tensor] = None,
                       near_weight: float = 0.1) -> dict:
    """Michelangelo KLNearFar (loss.py:13-92): BCE over volume occupancy
    (+ the near-surface term when given) + the posterior's KL to N(0, I)."""
    bce = F.binary_cross_entropy_with_logits(logits.float(), occupancy_labels.float())
    loss = bce
    out = {"vol_bce": bce}
    if near_logits is not None:
        nb = F.binary_cross_entropy_with_logits(near_logits.float(), near_labels.float())
        loss = loss + near_weight * nb
        out["near_bce"] = nb
    kl = 0.5 * torch.mean(posterior_mean ** 2 + torch.exp(posterior_logvar) - 1.0
                          - posterior_logvar)
    out["kl"] = kl
    out["loss"] = loss + kl_weight * kl
    return out


def contrastive_loss(shape_embed: torch.Tensor, other_embed: torch.Tensor,
                     logit_scale: torch.Tensor, group=None) -> torch.Tensor:
    """CLIP-style InfoNCE (loss.py:193-301), shape -> other, the mean over
    the local batch. ``group`` (JAX's ``axis_name``, the data axis): the
    negatives are every rank's ``other_embed``, gathered with autograd
    (the reference's all_gather_batch, misc.py:60-83), and a local row's
    positive sits at rank * local batch + its row."""
    a = shape_embed / torch.linalg.vector_norm(shape_embed, dim=-1, keepdim=True)
    b = other_embed / torch.linalg.vector_norm(other_embed, dim=-1, keepdim=True)
    b_all = gather_rows_grad(b, group)
    logits = logit_scale * (a @ b_all.T)
    labels = torch.arange(a.shape[0], device=a.device) + rank_in(group) * a.shape[0]
    return F.cross_entropy(logits, labels)


def compute_psnr(x: torch.Tensor, y: torch.Tensor, data_range: float = 2.0,
                 eps: float = 1e-7) -> torch.Tensor:
    """PSNR over a value range (reference utils/eval.py:6-11)."""
    mse = torch.mean((x - y) ** 2)
    return 10.0 * torch.log10(data_range / (mse + eps))
