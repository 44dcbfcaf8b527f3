"""Exact per-row top-k with a fixed tie order.

Counterpart of the JAX package's ``ops/topk_pallas.py`` dispatch.  The beam
search is exact, ties included, only when every top-k orders equal values by
index, first occurrence first (``decode/beam.py`` of the JAX package proves
this).  ``torch.topk`` does not promise any order among equal values, so it
is not used:

* ``"iterative"`` (:func:`row_topk_iterative`): k rounds of max, argmax
  (which returns the first maximal index) and masking the winner with
  ``NEG`` -- the JAX ``row_topk_iterative``, value for value;
* ``"lax"`` (:func:`lax_top_k`): ``jax.lax.top_k``'s order, from a stable
  descending sort.  The beam's flat merge over K*k candidates uses it, as
  the JAX engine does.

``"pallas"`` names the JAX package's top-k kernel, which is not ported yet.
"""

from __future__ import annotations

import torch

NEG = -1e30


def row_topk_iterative(x: torch.Tensor, k: int):
    """(R, V) -> (values (R, k) in x's type, indices (R, k) int64)."""
    work = x.to(torch.float32).clone()
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(work, dim=1, keepdim=True)
        vals.append(torch.gather(work, 1, i))
        idxs.append(i)
        work.scatter_(1, i, NEG)
    return torch.cat(vals, 1).to(x.dtype), torch.cat(idxs, 1)


def lax_top_k(x: torch.Tensor, k: int):
    """Top-k along the last axis, equal values in index order."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def row_topk(x: torch.Tensor, k: int, backend: str = "iterative"):
    """Dispatch per-row top-k by backend name (ModelConfig.topk_backend)."""
    if backend == "iterative":
        return row_topk_iterative(x, k)
    if backend == "lax":
        return lax_top_k(x, k)
    if backend == "pallas":
        raise NotImplementedError(
            'topk_backend="pallas": the top-k kernel (row_topk_pallas) is '
            "not ported yet (ROADMAP.md, kernels still to port)")
    raise ValueError(f"unknown topk backend: {backend!r}")
