"""Exact per-row top-k with a fixed tie order, and kernel 10.

Counterpart of the JAX package's ``ops/topk_pallas.py``.  The beam search
is exact, ties included, only when every top-k orders equal values by
index, first occurrence first (``decode/beam.py`` of the JAX package proves
this).  ``torch.topk`` does not promise any order among equal values, so it
is not used:

* ``"iterative"`` (:func:`row_topk_iterative`): k rounds of max, argmax
  (which returns the first maximal index) and masking the winner with
  ``NEG`` -- the JAX ``row_topk_iterative``, value for value;
* ``"lax"`` (:func:`lax_top_k`): ``jax.lax.top_k``'s order, from a stable
  descending sort.  The beam's flat merge over K*k candidates uses it, as
  the JAX engine does;
* ``"pallas"`` (:func:`row_topk_pallas`): kernel 10 (``csrc/topk.cu``),
  which replaces the JAX ``row_topk_pallas``: one pass over the table on
  the card.  On CPU tensors it is :func:`row_topk_iterative` on the table
  clamped at ``NEG``, its plain version: the same as on the table itself
  wherever the values are >= ``NEG``, as the beam's candidate tables are
  (the JAX dispatch takes ``lax.top_k`` on the CPU; the two agree wherever
  at least k values of a row exceed ``NEG``).
"""

from __future__ import annotations

import torch

from . import _build

NEG = -1e30
MAX_K = 8                      # csrc/common.cuh kMaxK
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def row_topk_pallas(x: torch.Tensor, k: int):
    """Exact per-row top-k of x (R, V): (values (R, k) in x's type,
    indices (R, k) int32), ``csrc/topk.cu``'s contract.

    Kernel 10 on a CUDA tensor; :func:`row_topk_iterative` on a CPU one."""
    if x.dim() != 2 or x.dtype not in _DTYPES:
        raise TypeError(f"row_topk_pallas takes a 2-D float32 or bfloat16 "
                        f"table, got {x.dim()}-D {x.dtype}")
    R, V = x.shape
    if not 1 <= k <= min(MAX_K, V):
        raise ValueError(f"top-{k} of {V} columns; the kernel takes "
                         f"1..{MAX_K}")
    if x.device.type == "cpu":
        # values at or below NEG never win a slot: clamped to NEG, they
        # leave the slots past a row's last larger value at (NEG, 0)
        vals, idx = row_topk_iterative(
            torch.clamp_min(x.to(torch.float32), NEG), k)
        return vals.to(x.dtype), idx.to(torch.int32)
    if x.device.type != "cuda":
        raise RuntimeError(f"row_topk_pallas: no kernel for {x.device}")
    if not x.is_contiguous():
        raise ValueError("row_topk_pallas takes a contiguous table")
    vals = torch.empty((R, k), dtype=x.dtype, device=x.device)
    idx = torch.empty((R, k), dtype=torch.int32, device=x.device)
    rc = _build.load("topk").iic_row_topk(
        _DTYPES[x.dtype], x.data_ptr(), R, V, k, vals.data_ptr(),
        idx.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "row_topk")
    row_topk_pallas.launches += 1
    return vals, idx


row_topk_pallas.launches = 0


def row_topk(x: torch.Tensor, k: int, backend: str = "iterative"):
    """Dispatch per-row top-k by backend name (ModelConfig.topk_backend)."""
    if backend == "iterative":
        return row_topk_iterative(x, k)
    if backend == "lax":
        return lax_top_k(x, k)
    if backend == "pallas":
        return row_topk_pallas(x, k)
    raise ValueError(f"unknown topk backend: {backend!r}")
