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
``tools/profile_decode.py``.  What bounds the kernel on the H100 and what
its design does about it is noted at the top of ``csrc/fc_topk.cu``.

For CUDA tensors the wrapper launches the kernel or raises; only tensors
on the CPU take the plain version.
"""

from __future__ import annotations

import torch

from . import _build
from .topk import row_topk_iterative


def fc_topk_plain(h, w, b, k: int):
    """(topv (R, k) float32 raw logits, topi (R, k) int32, lse (R,)
    float32) in plain PyTorch."""
    f32 = torch.float32
    logits = h.to(f32) @ w.to(f32) + b.to(f32)
    topv, topi = row_topk_iterative(logits, k)
    m = logits.amax(dim=1, keepdim=True)
    lse = (torch.log(torch.exp(logits - m).sum(dim=1, keepdim=True)) + m)
    return topv, topi.to(torch.int32), lse[:, 0]


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
    logits = torch.empty((R, V), dtype=f32, device=h.device)
    topv = torch.empty((R, k), dtype=f32, device=h.device)
    topi = torch.empty((R, k), dtype=torch.int32, device=h.device)
    lse = torch.empty((R,), dtype=f32, device=h.device)
    rc = _build.load("fc_topk").iic_fc_topk(
        h.data_ptr(), w.data_ptr(), b.data_ptr(), logits.data_ptr(),
        topv.data_ptr(), topi.data_ptr(), lse.data_ptr(), R, D, V, k,
        torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(rc, "fc_topk")
    fc_topk.launches += 1
    return topv, topi, lse


fc_topk.launches = 0
