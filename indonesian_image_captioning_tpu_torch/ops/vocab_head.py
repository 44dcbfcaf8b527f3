"""Chunked vocab cross-entropy head: CE and top-k without the (B, T, V)
logits.

Counterpart of the JAX package's ``ops/vocab_head.py`` (plain tensor code
there too, not a Pallas kernel).  ``fc`` streams in vocab tiles through an
online logsumexp:

  forward   per tile: logits = h2 @ w[:, tile] + b[tile], rounded to the
            compute type and lifted to float32 (as the dense ``linear``);
            running max and scaled exp-sum, and the target's logit; a
            second sweep counts the entries ranked above the target
            (strictly greater, or equal at a lower index -- the tie rule of
            ``core/metrics.topk_hit``)
  backward  per tile: recompute the logits, p = exp(logits - lse),
            dl = (p - onehot) * coeff, d_h += dl @ w[:, tile]^T,
            d_w[:, tile] = h2^T @ dl, d_b[tile] = sum dl

Only one (N, tile) tile is live at a time.  The tile products are
``torch.matmul`` in float32 (TF32 off, ``core/runtime.py``).  The last tile
is narrower instead of padded, so no padded column exists.  The JAX
version's ``shard_axis`` (a vocab-parallel head across devices) is not
ported: it waits for the multi-device work.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _tile_logits(h2f, w, b, c0: int, c1: int, cdt):
    """(N, c1 - c0) float32 logits of columns c0..c1, rounded through the
    compute type cdt."""
    f32 = torch.float32
    logits = h2f @ w[:, c0:c1].to(f32) + b[c0:c1].to(f32)
    return logits.to(cdt).to(f32)


def _target_mask(tgt, c0: int, c1: int):
    cols = torch.arange(c0, c1, device=tgt.device)
    return cols, cols[None, :] == tgt[:, None]


def nll_topk_fwd(w, b, h2, tgt, *, k: int, tile: int):
    """(nll (N,), hit (N,) float32, lse (N,)) for rows h2 (N, D) against
    fc (w (D, V), b (V,)) and target ids tgt (N,)."""
    f32 = torch.float32
    cdt, N, V = h2.dtype, h2.shape[0], w.shape[1]
    h2f = h2.to(f32)
    m = torch.full((N,), NEG_INF, dtype=f32, device=h2.device)
    s = torch.zeros((N,), dtype=f32, device=h2.device)
    tl = torch.zeros((N,), dtype=f32, device=h2.device)
    for c0 in range(0, V, tile):
        c1 = min(V, c0 + tile)
        logits = _tile_logits(h2f, w, b, c0, c1, cdt)
        new_m = torch.maximum(m, logits.max(dim=-1).values)
        s = s * torch.exp(m - new_m) + torch.exp(
            logits - new_m[:, None]).sum(dim=-1)
        m = new_m
        _, is_t = _target_mask(tgt, c0, c1)
        tl = tl + torch.where(is_t, logits, 0.0).sum(dim=-1)
    gt = torch.zeros((N,), dtype=torch.int64, device=h2.device)
    tie = torch.zeros_like(gt)
    for c0 in range(0, V, tile):
        c1 = min(V, c0 + tile)
        logits = _tile_logits(h2f, w, b, c0, c1, cdt)
        cols, _ = _target_mask(tgt, c0, c1)
        gt = gt + (logits > tl[:, None]).sum(dim=-1)
        tie = tie + ((logits == tl[:, None])
                     & (cols[None, :] < tgt[:, None])).sum(dim=-1)
    lse = m + torch.log(s)
    return lse - tl, ((gt + tie) < k).to(f32), lse


def nll_bwd(w, b, h2, tgt, lse, coeff, *, tile: int):
    """(d_w, d_b, d_h) of sum(nll * coeff)."""
    f32 = torch.float32
    cdt, V = h2.dtype, w.shape[1]
    h2f = h2.to(f32)
    coeff = coeff.to(f32)
    d_h = torch.zeros(h2.shape, dtype=f32, device=h2.device)
    d_w = torch.empty(w.shape, dtype=f32, device=w.device)
    d_b = torch.empty(b.shape, dtype=f32, device=b.device)
    for c0 in range(0, V, tile):
        c1 = min(V, c0 + tile)
        logits = _tile_logits(h2f, w, b, c0, c1, cdt)
        p = torch.exp(logits - lse[:, None])
        _, is_t = _target_mask(tgt, c0, c1)
        dl = (p - is_t.to(f32)) * coeff[:, None]
        dlc = dl.to(cdt).to(f32)                   # the dense backward's type
        d_h += dlc @ w[:, c0:c1].to(f32).T
        d_w[:, c0:c1] = h2f.T @ dlc
        d_b[c0:c1] = dl.sum(dim=0)
    return d_w.to(w.dtype), d_b.to(b.dtype), d_h.to(h2.dtype)


class _NllHead(torch.autograd.Function):
    """(nll, hit) per row; differentiable in w, b and h2 through nll."""

    @staticmethod
    def forward(ctx, w, b, h2, tgt, k, tile):
        nll, hit, lse = nll_topk_fwd(w, b, h2, tgt, k=k, tile=tile)
        ctx.save_for_backward(w, b, h2, tgt, lse)
        ctx.tile = tile
        ctx.mark_non_differentiable(hit)
        return nll, hit

    @staticmethod
    def backward(ctx, d_nll, _d_hit):
        w, b, h2, tgt, lse = ctx.saved_tensors
        d_w, d_b, d_h = nll_bwd(w, b, h2, tgt, lse, d_nll, tile=ctx.tile)
        return d_w, d_b, d_h, None, None, None


def chunked_nll_topk(fc, hidden, targets, *, k: int = 5, tile: int = 2048):
    """Per-token (nll, hit), each (B, T) float32, without the logits."""
    B, T, D = hidden.shape
    nll, hit = _NllHead.apply(fc["w"], fc["b"], hidden.reshape(B * T, D),
                              targets.reshape(-1).long(), k, tile)
    return nll.reshape(B, T), hit.reshape(B, T)


def chunked_ce_topk(fc, hidden, targets, mask, *, k: int = 5,
                    tile: int = 2048):
    """Masked mean CE, top-k accuracy (%) and token count from hidden
    (B, T, D), targets (B, T) and mask (B, T); differentiable in fc and
    hidden."""
    nll, hit = chunked_nll_topk(fc, hidden, targets, k=k, tile=tile)
    maskf = mask.to(torch.float32)
    denom = maskf.sum().clamp(min=1.0)
    ce = (nll * maskf).sum() / denom
    topk = (hit * maskf).sum() / denom * 100.0
    return ce, topk, maskf.sum()


@torch.no_grad()
def chunked_eval_head(fc, hidden, targets, mask, *, k: int = 5,
                      tile: int = 2048):
    """(ce, topk_pct, n_tokens, argmax preds (B, T)) without the logits;
    argmax ties go to the lowest column, as the dense argmax."""
    B, T, D = hidden.shape
    f32 = torch.float32
    h2 = hidden.reshape(B * T, D)
    tgt = targets.reshape(-1).long()
    w, b = fc["w"], fc["b"]
    nll, hit, _ = nll_topk_fwd(w, b, h2, tgt, k=k, tile=tile)
    h2f = h2.to(f32)
    best_v = torch.full((B * T,), NEG_INF, dtype=f32, device=h2.device)
    best_i = torch.zeros((B * T,), dtype=torch.int64, device=h2.device)
    for c0 in range(0, w.shape[1], tile):
        c1 = min(w.shape[1], c0 + tile)
        logits = _tile_logits(h2f, w, b, c0, c1, hidden.dtype)
        tmax, targ = logits.max(dim=-1).values, logits.argmax(dim=-1)
        upd = tmax > best_v                   # strict: first occurrence wins
        best_v = torch.where(upd, tmax, best_v)
        best_i = torch.where(upd, targ + c0, best_i)
    maskf = mask.reshape(-1).to(f32)
    denom = maskf.sum().clamp(min=1.0)
    ce = (nll * maskf).sum() / denom
    topk = (hit * maskf).sum() / denom * 100.0
    return ce, topk, maskf.sum(), best_i.reshape(B, T)
