"""Masked losses for fixed-shape caption training.

Counterpart of the JAX package's ``ops/losses.py``, with the same
semantics: the cross-entropy is the mean over valid tokens (the reference's
packed sequence), and the doubly-stochastic attention penalty averages over
the rows that hold at least one valid token, so padding rows of a final
partial batch add nothing.
"""

from __future__ import annotations

import torch

from .vocab_head import dense_nll_topk


def _nll_hit(logits, targets, k: int = 5):
    """(nll, hit), each (B, T), of logits (B, T, V): the train steps'
    one-rank head (``vocab_head.dense_nll_topk``)."""
    B, T, V = logits.shape
    nll, hit = dense_nll_topk(logits.reshape(B * T, V),
                              targets.reshape(-1).long(), k=k)
    return nll.reshape(B, T), hit.reshape(B, T)


def masked_nll_sum(logits, targets, mask):
    """Summed CE over valid tokens: logits (B, T, V), targets (B, T) int,
    mask (B, T) in {0, 1}."""
    return (_nll_hit(logits, targets)[0] * mask).sum()


def masked_cross_entropy(logits, targets, mask):
    """Mean CE over valid tokens (:func:`masked_nll_sum` over their
    count)."""
    return masked_nll_sum(logits, targets, mask) / mask.sum().clamp(min=1.0)


def penalty_sum(alphas, mask, alpha_c: float):
    """(alpha_c * sum over valid rows of mean_p (1 - sum_t alpha)^2, the
    number of valid rows); alphas (B, T, P), mask (B, T).  The
    data-parallel step divides the first by the global row count."""
    total = (alphas * mask[..., None]).sum(dim=1)             # (B, P)
    row_valid = (mask.sum(dim=1) > 0).to(total.dtype)         # (B,)
    per_row = ((1.0 - total) ** 2).mean(dim=1)                # (B,)
    return alpha_c * (per_row * row_valid).sum(), row_valid.sum()


def doubly_stochastic_penalty(alphas, mask, alpha_c: float):
    """alpha_c * mean over valid rows of mean_p (1 - sum_t alpha)^2."""
    if alphas is None or alpha_c == 0.0:
        return torch.zeros((), dtype=torch.float32, device=mask.device)
    pen, rows = penalty_sum(alphas, mask, alpha_c)
    return pen / rows.clamp(min=1.0)


def caption_loss(outputs, caps, alpha_c: float = 0.0):
    """Loss from a ``teacher_forcing`` output; targets are the captions
    shifted by one.  Returns (loss, {ce, alpha_penalty, n_tokens})."""
    logits = outputs["predictions"]
    mask = outputs["mask"]
    targets = caps[:, 1:1 + logits.shape[1]]
    ce = masked_cross_entropy(logits, targets, mask)
    pen = doubly_stochastic_penalty(outputs["alphas"], mask, alpha_c)
    return ce + pen, {"ce": ce, "alpha_penalty": pen,
                      "n_tokens": mask.sum()}


def bce_elements(probs, targets, eps: float = 1e-7):
    """Elementwise binary cross-entropy on probabilities clipped to
    [eps, 1 - eps]."""
    p = probs.clamp(eps, 1.0 - eps)
    return -(targets * torch.log(p) + (1.0 - targets) * torch.log1p(-p))


def bce_loss(probs, targets, eps: float = 1e-7, row_valid=None):
    """Binary cross-entropy on probabilities (the tagger's loss); row_valid
    (B,) leaves out the padding rows of a final partial batch."""
    elem = bce_elements(probs, targets, eps)
    if row_valid is None:
        return elem.mean()
    w = row_valid.to(elem.dtype)
    denom = (w.sum() * elem.shape[1]).clamp(min=1.0)
    return (elem * w[:, None]).sum() / denom


def masked_topk_accuracy(logits, targets, mask, k: int = 5):
    """Top-k accuracy (%) over valid tokens, by rank (no sort)."""
    correct = _nll_hit(logits.detach(), targets, k)[1]
    return (correct * mask).sum() / mask.sum().clamp(min=1.0) * 100.0
