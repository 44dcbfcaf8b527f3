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
is narrower instead of padded, so no padded column exists.

Vocab-parallel (the JAX version's ``shard_axis``): on a mesh with a model
axis each rank holds the fc columns [col0, col0 + V/M) and passes
``col0`` and the mesh; the row max merges by an all_reduce MAX, the
rescaled exp-sum, the target logit and the rank and tie counts by SUM over
the model group, so every rank gets the global (nll, hit, lse).  The
backward gives this block's d_w and d_b and its part of d_h; the sum of
d_h over the blocks is the caller's (``core/meshes.enter_vocab_region``
on the hidden states).  :func:`dense_nll_topk` and :func:`dense_argmax`
do the same over a rank's (N, V/M) logits: no rank ever holds the whole
(B, T, V) logits.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core import meshes
from ..core.metrics import topk_hit
from ..core.profiling import annotate

NEG_INF = -1e30


def _tile_logits(h2f, w, b, c0: int, c1: int, cdt):
    """(N, c1 - c0) float32 logits of columns c0..c1, rounded through the
    compute type cdt."""
    f32 = torch.float32
    logits = h2f @ w[:, c0:c1].to(f32) + b[c0:c1].to(f32)
    return logits.to(cdt).to(f32)


def _target_mask(tgt, c0: int, c1: int, col0: int = 0):
    """(global columns of local columns c0..c1, whether each is the row's
    target)."""
    cols = torch.arange(col0 + c0, col0 + c1, device=tgt.device)
    return cols, cols[None, :] == tgt[:, None]


def _merge(mesh, m, s, tl):
    """The global (max, exp-sum at that max, target logit) of each row
    from the blocks' own."""
    if meshes.model_size(mesh) == 1:
        return m, s, tl
    m_g = meshes.model_all_reduce(m.clone(), mesh, dist.ReduceOp.MAX)
    s = meshes.model_all_reduce(s * torch.exp(m - m_g), mesh)
    return m_g, s, meshes.model_all_reduce(tl, mesh)


def _hit(gt, tie, k: int, mesh):
    """Whether the target ranks in the top k (float32), from the blocks'
    counts of columns above it and of ties at a lower column."""
    rank = meshes.model_all_reduce(gt + tie, mesh)
    return (rank < k).to(torch.float32)


def nll_topk_fwd(w, b, h2, tgt, *, k: int, tile: int, col0: int = 0,
                 mesh=None):
    """(nll (N,), hit (N,) float32, lse (N,)) for rows h2 (N, D) against
    fc (w (D, V), b (V,)) and target ids tgt (N,).  On a model axis w and
    b are this rank's block of columns, from global column col0, and the
    results are global (the same on every rank of the model group)."""
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
        _, is_t = _target_mask(tgt, c0, c1, col0)
        tl = tl + torch.where(is_t, logits, 0.0).sum(dim=-1)
    m, s, tl = _merge(mesh, m, s, tl)
    gt = torch.zeros((N,), dtype=torch.int64, device=h2.device)
    tie = torch.zeros_like(gt)
    for c0 in range(0, V, tile):
        c1 = min(V, c0 + tile)
        logits = _tile_logits(h2f, w, b, c0, c1, cdt)
        cols, _ = _target_mask(tgt, c0, c1, col0)
        gt = gt + (logits > tl[:, None]).sum(dim=-1)
        tie = tie + ((logits == tl[:, None])
                     & (cols[None, :] < tgt[:, None])).sum(dim=-1)
    lse = m + torch.log(s)
    return lse - tl, _hit(gt, tie, k, mesh), lse


def nll_bwd(w, b, h2, tgt, lse, coeff, *, tile: int, col0: int = 0):
    """(d_w, d_b, d_h) of sum(nll * coeff); on a model axis, this block's
    d_w and d_b and its part of d_h."""
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
        _, is_t = _target_mask(tgt, c0, c1, col0)
        dl = (p - is_t.to(f32)) * coeff[:, None]
        dlc = dl.to(cdt).to(f32)                   # the dense backward's type
        d_h += dlc @ w[:, c0:c1].to(f32).T
        d_w[:, c0:c1] = h2f.T @ dlc
        d_b[c0:c1] = dl.sum(dim=0)
    return d_w.to(w.dtype), d_b.to(b.dtype), d_h.to(h2.dtype)


class _NllHead(torch.autograd.Function):
    """(nll, hit) per row; differentiable in w, b and h2 through nll."""

    @staticmethod
    def forward(ctx, w, b, h2, tgt, k, tile, col0, mesh):
        nll, hit, lse = nll_topk_fwd(w, b, h2, tgt, k=k, tile=tile,
                                     col0=col0, mesh=mesh)
        ctx.save_for_backward(w, b, h2, tgt, lse)
        ctx.tile, ctx.col0 = tile, col0
        ctx.mark_non_differentiable(hit)
        return nll, hit

    @staticmethod
    def backward(ctx, d_nll, _d_hit):
        w, b, h2, tgt, lse = ctx.saved_tensors
        with annotate("iic.train.head"):
            d_w, d_b, d_h = nll_bwd(w, b, h2, tgt, lse, d_nll,
                                    tile=ctx.tile, col0=ctx.col0)
        return d_w, d_b, d_h, None, None, None, None, None


def chunked_nll_topk(fc, hidden, targets, *, k: int = 5, tile: int = 2048,
                     col0: int = 0, mesh=None):
    """Per-token (nll, hit), each (B, T) float32, without the logits.  On
    a model axis fc is this rank's block from column col0, and hidden must
    come through ``core/meshes.enter_vocab_region``."""
    B, T, D = hidden.shape
    nll, hit = _NllHead.apply(fc["w"], fc["b"], hidden.reshape(B * T, D),
                              targets.reshape(-1).long(), k, tile, col0,
                              mesh)
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


def _first_max(best_v, best_i, mesh):
    """The lowest global column among each row's maximal values, from
    each block's (max, its first column)."""
    if meshes.model_size(mesh) == 1:
        return best_i
    top = meshes.model_all_reduce(best_v.clone(), mesh, dist.ReduceOp.MAX)
    cand = torch.where(best_v == top, best_i,
                       torch.full_like(best_i, torch.iinfo(torch.int64).max))
    return meshes.model_all_reduce(cand, mesh, dist.ReduceOp.MIN)


@torch.no_grad()
def chunked_eval_head(fc, hidden, targets, mask, *, k: int = 5,
                      tile: int = 2048, col0: int = 0, mesh=None):
    """(ce, topk_pct, n_tokens, argmax preds (B, T)) without the logits;
    argmax ties go to the lowest column, as the dense argmax (across the
    blocks of a model axis too)."""
    B, T, D = hidden.shape
    f32 = torch.float32
    h2 = hidden.reshape(B * T, D)
    tgt = targets.reshape(-1).long()
    w, b = fc["w"], fc["b"]
    nll, hit, _ = nll_topk_fwd(w, b, h2, tgt, k=k, tile=tile, col0=col0,
                               mesh=mesh)
    h2f = h2.to(f32)
    best_v = torch.full((B * T,), NEG_INF, dtype=f32, device=h2.device)
    best_i = torch.zeros((B * T,), dtype=torch.int64, device=h2.device)
    for c0 in range(0, w.shape[1], tile):
        c1 = min(w.shape[1], c0 + tile)
        logits = _tile_logits(h2f, w, b, c0, c1, hidden.dtype)
        tmax, targ = logits.max(dim=-1).values, logits.argmax(dim=-1)
        upd = tmax > best_v                   # strict: first occurrence wins
        best_v = torch.where(upd, tmax, best_v)
        best_i = torch.where(upd, targ + c0 + col0, best_i)
    best_i = _first_max(best_v, best_i, mesh)
    maskf = mask.reshape(-1).to(f32)
    denom = maskf.sum().clamp(min=1.0)
    ce = (nll * maskf).sum() / denom
    topk = (hit * maskf).sum() / denom * 100.0
    return ce, topk, maskf.sum(), best_i.reshape(B, T)


def dense_nll_topk(logits, tgt, *, k: int = 5, col0: int = 0, mesh=None):
    """(nll, hit) per row of float32 logits (N, V): the log-softmax's
    target term and whether the target ranks in the top k (ties to the
    lower column, ``core/metrics.topk_hit``), differentiable in the
    logits through nll.  On a model axis the logits are this rank's block
    of columns from col0 and the results are global: the row max merges
    by MAX, the exp-sum and the target logit by ``sum_over_model``, whose
    backward leaves each block its own softmax terms."""
    if meshes.model_size(mesh) == 1:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, tgt[:, None])[:, 0]
        return nll, topk_hit(logits.detach(), tgt, k).to(torch.float32)
    V = logits.shape[-1]
    m = meshes.model_all_reduce(logits.detach().max(dim=-1).values, mesh,
                                dist.ReduceOp.MAX)
    s = meshes.sum_over_model(torch.exp(logits - m[:, None]).sum(dim=-1),
                              mesh)
    local = tgt - col0
    mine = (local >= 0) & (local < V)
    tl = torch.where(mine, torch.gather(
        logits, -1, local.clamp(0, V - 1)[:, None])[:, 0], 0.0)
    tl = meshes.sum_over_model(tl, mesh)
    nll = torch.log(s) + m - tl
    scores, st = logits.detach(), tl.detach()[:, None]
    cols = torch.arange(col0, col0 + V, device=scores.device)
    gt = (scores > st).sum(dim=-1)
    tie = ((scores == st) & (cols < tgt[:, None])).sum(dim=-1)
    return nll, _hit(gt, tie, k, mesh)


@torch.no_grad()
def dense_argmax(logits, *, col0: int = 0, mesh=None):
    """Each row's argmax over (N, V) logits, the lowest column among the
    maximal values; on a model axis over the global columns of every
    rank's block."""
    best_v, best_i = logits.max(dim=-1).values, logits.argmax(dim=-1)
    return _first_max(best_v, best_i + col0, mesh)
