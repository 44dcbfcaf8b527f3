"""Kernel 11: the vocab head with its log-sum and top-k
(``csrc/fc_topk.cu``), and its plain version.

Replaces ``ops/fc_topk_pallas.py::fc_topk`` of the JAX package (body
``_make_kernel``): for decoder rows h (R, D), the projection h @ w + b
onto the vocabulary, each row's k largest raw logits with their ids (ties
to the lowest id, ``lax.top_k``'s order) and the row's log-sum-exp, so
that ``topv - lse`` are the k best log-probabilities -- the sparse beam
candidates, without the (R, V) log-softmax.  Float32 only: h, w and b are
cast to float32, as in JAX.  No module of the JAX package calls it; its
caller there is the isolated vocab-head measurement of
``tools/profile_decode.py``.  On the card it is two launches on the tiling
of :func:`fc_plan`: the product on the tensor cores with the head folded
into its epilogue (partials per 64 words), then their merge; w is packed
K-major once per tensor (:func:`fc_pack`).  What bounds the kernel on the
H100 and what its design does about it is noted at the top of
``csrc/fc_topk.cu``.

For CUDA tensors the wrapper launches the kernel or raises; only tensors
on the CPU take the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from . import _build
from .topk import _raw_stream, row_topk_iterative
from .train_cuda import pack_kmajor

TILE_V = 64        # csrc/fc_topk.cu kFcM: vocab rows of a CTA
TILE_B = 80        # kFcNB: batch rows of a CTA (wgmma's n)
MAX_KT = 64        # kFcMaxKt: a tile's list holds min(k, 64)
TILE_SMEM = 4 * (4 + 2) * TILE_V * 32 + 4 * (4 + 2) * TILE_B * 32 + 1024
MERGE_WARPS = 4    # kFcMergeWarps: rows a merge block
MERGE_STAGE = 96 * 1024   # the merge stages a row's lists up to this
SMEM_MAX = 232448  # shared memory a CTA may take on the H100 (227 KB)


class FcPlan(ctypes.Structure):
    """csrc/fc_topk.cu FcPlan, field for field: the vocab tiles (nt) and
    batch tiles (bt) of the tile kernel's grid, its batch rows a CTA (nb),
    a tile's list length (kt), its dynamic shared memory; whether the
    merge copies each row's nt kt pairs into shared memory (stage), and
    its shared memory (a head index a tile, and the staged pairs, for each
    of its rows)."""

    _fields_ = [(n, ctypes.c_longlong) for n in
                ("nt", "bt", "nb", "kt", "smem", "stage", "merge_smem")]

    def __repr__(self):
        return "FcPlan(" + ", ".join(
            f"{n}={getattr(self, n)}" for n, _ in self._fields_) + ")"


@functools.lru_cache(maxsize=256)
def fc_plan(R: int, V: int, k: int) -> FcPlan:
    """Kernel 11's tiling for R rows, V words and top-k: CTA (t, u) of the
    tile kernel multiplies vocab rows [64 t, 64 t + 64) by batch rows [80
    u, 80 u + 80) and leaves, per batch row, the tile's max, exp-sum and
    kt = min(k, 64) best logits; the merge kernel takes a row's nt lists,
    from shared memory where four rows' fit in MERGE_STAGE bytes
    (:func:`fc_tiles` lists what each CTA covers)."""
    if R < 1 or not 1 <= k <= V:
        raise ValueError(f"no fc_topk plan for R={R}, V={V}, k={k}")
    nt = -(-V // TILE_V)
    kt = min(k, MAX_KT)
    staged = MERGE_WARPS * 4 * (nt + 2 * nt * kt)
    stage = int(staged <= MERGE_STAGE)
    return FcPlan(nt=nt, bt=-(-R // TILE_B), nb=TILE_B, kt=kt,
                  smem=TILE_SMEM, stage=stage,
                  merge_smem=staged if stage else MERGE_WARPS * 4 * nt)


def fc_tiles(plan: FcPlan, R: int, V: int):
    """Each tile CTA's (vocab range, batch range), clipped to (V, R): the
    columns and rows csrc/fc_topk.cu's fc_tile_kernel reads and folds."""
    return [((t * TILE_V, min(V, (t + 1) * TILE_V)),
             (u * plan.nb, min(R, (u + 1) * plan.nb)))
            for t in range(plan.nt) for u in range(plan.bt)]


def fc_topk_plain(h, w, b, k: int):
    """(topv (R, k) float32 raw logits, topi (R, k) int32, lse (R,)
    float32) in plain PyTorch."""
    f32 = torch.float32
    logits = h.to(f32) @ w.to(f32) + b.to(f32)
    topv, topi = row_topk_iterative(logits, k)
    m = logits.amax(dim=1, keepdim=True)
    lse = (torch.log(torch.exp(logits - m).sum(dim=1, keepdim=True)) + m)
    return topv, topi.to(torch.int32), lse[:, 0]


_packs: Dict[int, tuple] = {}   # id(w) -> (w, version, w^T pack)
_PACKS = 4


def fc_pack(w: torch.Tensor) -> torch.Tensor:
    """w (D, V) float32 as the kernel reads it: w^T (V, D) K-major, rows
    padded to 16 bytes (``train_cuda.pack_kmajor``).  Made once per tensor:
    while w is the same tensor, unchanged in place (its version counter;
    an inference tensor by identity), a later call returns the same pack.
    The last four are kept."""
    sig = -1 if w.is_inference() else w._version
    hit = _packs.get(id(w))
    if hit is not None and hit[0] is w and hit[1] == sig:
        return hit[2]
    pack = pack_kmajor(w, torch.float32)
    _packs.pop(id(w), None)
    _packs[id(w)] = (w, sig, pack)
    while len(_packs) > _PACKS:
        _packs.pop(next(iter(_packs)))
    return pack


_scratch: Dict[tuple, torch.Tensor] = {}
_SCRATCH_SETS = 8


def _partials(dev, stream, R: int, plan: FcPlan) -> torch.Tensor:
    """The partials' scratch, R nt (2 + 2 kt) words, kept per shape and
    stream (the stream orders a call's merge before the next call's
    tiles)."""
    n = R * plan.nt * (2 + 2 * plan.kt)
    key = (dev, stream, n)
    t = _scratch.get(key)
    if t is None:
        t = torch.empty(n, dtype=torch.float32, device=dev)
        _scratch[key] = t
        while len(_scratch) > _SCRATCH_SETS:
            _scratch.pop(next(iter(_scratch)))
    return t


def fc_topk(h, w, b, k: int):
    """h (R, D) @ w (D, V) + b (V,) -> (topv (R, k) raw logits, topi (R, k)
    int32, lse (R,)), all float32 -- kernel 11 on CUDA tensors.  Takes
    1 <= k <= V."""
    f32 = torch.float32
    h, w, b = (t.to(f32).contiguous() for t in (h, w, b))
    R, D = h.shape
    V = w.shape[1]
    if w.shape[0] != D or b.shape != (V,):
        raise ValueError(f"shape mismatch: h {tuple(h.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}")
    if not 1 <= k <= V:
        raise ValueError(f"top-{k} of {V} columns")
    if not h.device == w.device == b.device:
        raise ValueError(f"tensors on {h.device}, {w.device}, {b.device}")
    if h.device.type == "cpu":
        return fc_topk_plain(h, w, b, k)
    if h.device.type != "cuda":
        raise RuntimeError(f"fc_topk: no kernel for {h.device}")
    dev = h.device
    plan = fc_plan(R, V, k)
    wt = fc_pack(w)
    stream = _raw_stream(dev)
    part = _partials(dev, stream, R, plan)
    topv = torch.empty((R, k), dtype=f32, device=dev)
    topi = torch.empty((R, k), dtype=torch.int32, device=dev)
    lse = torch.empty((R,), dtype=f32, device=dev)
    rc = _build.load("fc_topk").iic_fc_topk(
        h.data_ptr(), D, wt.data_ptr(), wt.shape[1], b.data_ptr(),
        part.data_ptr(), topv.data_ptr(), topi.data_ptr(), lse.data_ptr(),
        R, D, V, k, ctypes.byref(plan), stream)
    _build.check(rc, "fc_topk")
    fc_topk.launches += 1
    return topv, topi, lse


fc_topk.launches = 0
