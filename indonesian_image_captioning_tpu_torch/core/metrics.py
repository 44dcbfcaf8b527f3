"""Metrics: a running meter, the top-k accuracy of the train step and the
tagger's binary accuracy.

Counterpart of the JAX package's ``core/metrics.py``.  :func:`topk_hit`
keeps its exact tie rule: the target is in the top k when fewer than k
entries precede it, counting strictly greater values and equal values at
lower indices (``lax.top_k``'s first-occurrence order), so no sort runs.
"""

from __future__ import annotations

from typing import Optional

import torch


class AverageMeter:
    """Keeps the most recent value, the running average, sum and count."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def topk_hit(scores: torch.Tensor, targets: torch.Tensor,
             k: int) -> torch.Tensor:
    """Whether each row's target id is among its top-k scores.

    scores (..., V); targets (...,) int ids.  Returns bool (...,)."""
    t = targets.long().unsqueeze(-1)
    st = torch.gather(scores, -1, t)                          # (..., 1)
    idx = torch.arange(scores.shape[-1], device=scores.device)
    greater = (scores > st).sum(dim=-1)
    ties_before = ((scores == st) & (idx < t)).sum(dim=-1)
    return (greater + ties_before) < k


def topk_accuracy(scores: torch.Tensor, targets: torch.Tensor, k: int,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Top-k accuracy in percent over (N, V) scores, optionally masked to
    the valid tokens."""
    correct = topk_hit(scores, targets, k).to(torch.float32)
    if mask is None:
        return correct.mean() * 100.0
    mask = mask.to(torch.float32)
    return (correct * mask).sum() / mask.sum().clamp(min=1.0) * 100.0


def binary_accuracy(scores: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Mean agreement, in percent, of scores and targets, both thresholded
    at 0.5 (the reference's utils/metric.py:42-47)."""
    pred = scores >= 0.5
    true = targets >= 0.5
    return (pred == true).to(torch.float32).mean() * 100.0
