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
  the card, a row a thread-block cluster on the plan of :func:`topk_plan`.  On CPU tensors it is :func:`row_topk_iterative` on the table
  clamped at ``NEG``, its plain version: the same as on the table itself
  wherever the values are >= ``NEG``, as the beam's candidate tables are
  (the JAX dispatch takes ``lax.top_k`` on the CPU; the two agree wherever
  at least k values of a row exceed ``NEG``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CLUSTER = 16       # csrc/topk.cu kTopkMaxCluster (non-portable past 8)
MAX_THREADS = 256      # csrc/topk.cu kTopkMaxThreads
THREADS = 128          # a CTA's (measured faster than 256 at every shape)
TARGET_CTAS = 2 * 132  # about two CTAs an SM of the H100 in all
PASS_SLOTS = 32        # a pass's slots past k = 16


class TopkPlan(ctypes.Structure):
    """csrc/topk.cu TopkPlan, field for field: the CTAs of a row's cluster
    (cs), the threads a CTA, a thread's list slots (kk: k up to 8, then 16,
    then 32 with passes of 32 slots)."""

    _fields_ = [(n, ctypes.c_longlong) for n in ("cs", "threads", "kk")]

    def __repr__(self):
        return (f"TopkPlan(cs={self.cs}, threads={self.threads}, "
                f"kk={self.kk})")


@functools.lru_cache(maxsize=256)
def topk_plan(R: int, V: int, k: int, itemsize: int) -> TopkPlan:
    """Kernel 10's launch plan for an (R, V) table of itemsize 4 or 2 and
    top-k: a row is a cluster of cs CTAs, each streaming a slice of the
    row (:func:`topk_slices`).  cs doubles, up to MAX_CLUSTER, while the
    launch stays within TARGET_CTAS CTAs and every CTA keeps at least two
    16-byte vectors a thread, so (32, 33,815) takes 8 CTAs a row and
    (160, 6,763) one (on the card: cs 8 was the fastest for the first, 16
    and 4 within 3 %, 2 and 1 slower; the second within 6 % from cs 1 to
    4); THREADS threads a CTA."""
    if R < 1 or not 1 <= k <= V or itemsize not in (2, 4):
        raise ValueError(f"no top-k plan for R={R}, V={V}, k={k}, "
                         f"itemsize={itemsize}")
    kk = k if k <= 8 else 16 if k <= 16 else PASS_SLOTS
    threads = THREADS
    per_thread = 2 * 16 // itemsize          # two vectors' values
    cs = 1
    while (cs < MAX_CLUSTER and 2 * cs * R <= TARGET_CTAS
           and V // (2 * cs) >= threads * per_thread):
        cs *= 2
    return TopkPlan(cs=cs, threads=threads, kk=kk)


def topk_passes(k: int, kk: int):
    """The kernel's launches for top-k with lists of kk slots: (first slot,
    slots) of each pass."""
    if kk < PASS_SLOTS:
        return [(0, k)]
    return [(q0, min(PASS_SLOTS, k - q0)) for q0 in range(0, k, PASS_SLOTS)]


def topk_slices(plan: TopkPlan, V: int, head: int, itemsize: int):
    """The columns each CTA of a row's cluster reads, as csrc/topk.cu
    computes them for a row whose first 16-byte boundary lies head values
    in (0 <= head < 16 / itemsize): rank c's list of (start, stop, step)
    ranges -- the head values (rank 0), its share of the whole 16-byte
    vectors (expanded to their values) and the ragged tail (the last
    rank)."""
    E = 16 // itemsize
    h = min(head, V)
    nv = (V - h) // E
    out = []
    for c in range(plan.cs):
        v0, v1 = nv * c // plan.cs, nv * (c + 1) // plan.cs
        cols = [(0, h, 1)] if c == 0 else []
        cols.append((h + v0 * E, h + v1 * E, 1))
        if c == plan.cs - 1:
            cols.append((h + nv * E, V, 1))
        out.append(cols)
    return out


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


def _raw_stream(dev: torch.device) -> int:
    """The current CUDA stream of dev as an address (PyTorch's raw-stream
    query: a few microseconds less than current_stream(dev).cuda_stream,
    and kernel 10 runs every decode step of the "steps" rung)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def row_topk_pallas(x: torch.Tensor, k: int):
    """Exact per-row top-k of x (R, V): (values (R, k) in x's type,
    indices (R, k) int32), ``csrc/topk.cu``'s contract.

    Kernel 10 on a CUDA tensor; :func:`row_topk_iterative` on a CPU one."""
    if x.dim() != 2 or x.dtype not in _DTYPES:
        raise TypeError(f"row_topk_pallas takes a 2-D float32 or bfloat16 "
                        f"table, got {x.dim()}-D {x.dtype}")
    R, V = x.shape
    if not 1 <= k <= V:
        raise ValueError(f"top-{k} of {V} columns")
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
    plan = topk_plan(R, V, k, x.element_size())
    rc = _build.load("topk").iic_row_topk(
        _DTYPES[x.dtype], x.data_ptr(), R, V, k, vals.data_ptr(),
        idx.data_ptr(), ctypes.byref(plan), _raw_stream(x.device))
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
