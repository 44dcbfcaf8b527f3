"""Kernel 14: the embedding table's gradient (``csrc/embed_grad.cu``).

Replaces ``ops/embed_grad_pallas.py embed_grad_scatter`` of the JAX
package: ``d_table[ids[n]] += g[n]`` over the N = B*T caption tokens, a
(V, E) float32 table, with g float32 or bfloat16 accumulated in float32.
``models/decoders.py`` runs it as the backward of the embedding lookup
when ``embed_grad_impl="pallas"``.

The Pallas kernel's ``feasible`` (its VMEM budget for a table-sized
accumulator) has no counterpart: the CUDA kernel sorts the tokens by id
and sums the sorted list in short segments, with scratch that grows with
N and V (counts, ranks, the sorted list, the segments' partial rows) and
that this wrapper allocates.  What bounds it and what its design does
about it is noted at the top of the source.

:func:`embed_grad_scatter` launches the kernel for CUDA tensors and raises
where it cannot; only tensors on the CPU take :func:`embed_grad_plain`.
"""

from __future__ import annotations

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CHUNK, _MAX_CHUNKS = 1024, 16            # csrc/embed_grad.cu


def _segment(N: int) -> int:
    """Sorted places per segment block: 32 up to 8,192 tokens, then 32
    more per 8,192 (at most 256), so a heavy id's partials stay few."""
    return min(256, 32 * max(1, -(-N // 8192)))


def embed_grad_plain(ids: torch.Tensor, g: torch.Tensor,
                     vocab: int) -> torch.Tensor:
    """The same function in plain PyTorch: a (vocab, E) float32 table.
    Ids outside [0, vocab) add nothing, as in the kernel and in the JAX
    package's one-hot (a block of a sharded vocabulary gets the ids of
    the other blocks, shifted out of its range)."""
    out = torch.zeros((vocab, g.shape[1]), dtype=torch.float32,
                      device=g.device)
    ids = ids.long()
    mine = (ids >= 0) & (ids < vocab)
    return out.index_add_(0, ids[mine], g[mine].to(torch.float32))


def _check(ids: torch.Tensor, g: torch.Tensor, vocab: int) -> None:
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise TypeError(f"ids must be (N,) int32, got {ids.dim()}-D "
                        f"{ids.dtype}")
    if g.dim() != 2 or g.dtype not in _DTYPES:
        raise TypeError(f"g must be (N, E) float32 or bfloat16, got "
                        f"{g.dim()}-D {g.dtype}")
    if ids.shape[0] != g.shape[0]:
        raise ValueError(f"{ids.shape[0]} ids for {g.shape[0]} rows of g")
    if g.shape[0] >= 1 << 31:
        raise ValueError(f"{g.shape[0]} rows: the kernel counts rows in int32")
    if vocab < 1 or g.shape[1] < 1:
        raise ValueError(f"vocab {vocab} and E {g.shape[1]} must be >= 1")
    if ids.device != g.device:
        raise ValueError(f"ids on {ids.device} beside g on {g.device}")
    if not (ids.is_contiguous() and g.is_contiguous()):
        raise ValueError("embed_grad_scatter takes contiguous tensors")


def embed_grad_scatter(ids: torch.Tensor, g: torch.Tensor,
                       vocab: int) -> torch.Tensor:
    """Segment-sum ``d_table[ids[n]] += g[n]`` -> (vocab, E) float32.

    ids (N,) int32 (ids outside [0, vocab) add nothing); g (N, E)
    float32 or bfloat16.  Kernel 14 on CUDA tensors (each table element
    summed in a fixed order, bitwise the same from run to run);
    :func:`embed_grad_plain` on CPU tensors."""
    _check(ids, g, vocab)
    if g.device.type == "cpu":
        return embed_grad_plain(ids, g, vocab)
    if g.device.type != "cuda":
        raise RuntimeError(f"embed_grad_scatter: no kernel for {g.device}")
    N, E = g.shape
    nch = min(_MAX_CHUNKS, max(1, -(-N // _CHUNK)))
    out = torch.empty((vocab, E), dtype=torch.float32, device=g.device)
    # one buffer: the segments' partial rows, then the counts, ranks and
    # the sorted list (4-byte words both)
    seg = _segment(N)
    scratch = torch.empty(-(-N // seg) * 2 * E + nch * vocab + 3 * vocab
                          + 2 * N + 1, dtype=torch.int32, device=g.device)
    rc = _build.load("embed_grad").iic_embed_grad(
        _DTYPES[g.dtype], ids.data_ptr(), g.data_ptr(), N, vocab, E, nch,
        seg, scratch.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(rc, "embed_grad_scatter")
    embed_grad_scatter.launches += 1
    return out


embed_grad_scatter.launches = 0
