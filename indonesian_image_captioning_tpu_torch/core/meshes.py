"""Rank meshes over ``torch.distributed``.

Counterpart of the JAX package's ``core/meshes.py``.  JAX runs one process
that sees D x M devices, lays them out as a 2-D ``Mesh`` with axes
("data", "model") and lets XLA insert the collectives.  The port runs one
process per rank (started by ``torchrun`` or a test's spawner), each
holding one device: a card, or the CPU.  A :class:`Mesh` is the layout of
the D x M ranks with a process group per axis, and the collectives are
explicit (the train steps of ``train/steps.py`` given a mesh):

* the data axis: a batch's rows are split over its D ranks, the
  parameters are replicated, the gradients summed over ``data_group``;
* the model axis: the M ranks of a data row see the same rows and each
  holds 1/M of the vocabulary, the columns ``[m V/M, (m+1) V/M)`` of fc
  and the same rows of the embedding (``parallel/sharding.py``), in the
  style of a Megatron vocab-parallel layer.  Two autograd functions carry
  the activations across ``model_group``: :func:`sum_over_model` (the
  embedding lookup: each rank's rows of its shard, zeros elsewhere,
  summed; the backward is the identity, since the cotangent that comes
  back is already the same on every rank) and :func:`enter_vocab_region`
  (the hidden states entering the vocabulary head: the identity, whose
  backward sums ``d_h`` over the shards).  ``torch.distributed.nn``'s
  ``all_reduce`` is not used for the first: its backward sums the
  replicated cotangent again, which scales every embedding gradient by M.
  The M ranks of a data row compute the replicated leaves' gradients
  each on its own; :func:`replicate_over_model` then gives every rank the
  first model rank's copy, so the replicas stay bitwise equal whether or
  not the backward is deterministic (cuDNN's is not promised to be).

Every collective on tensors is an ``all_reduce`` or a ``broadcast``, which
NCCL and gloo both run on CUDA tensors; gloo also on CPU tensors (the
tests) and for several ranks on one card, which NCCL refuses.  The
shards are gathered by broadcasts (:func:`gather_model`), bitwise.  The
host gathers of validation rows (:func:`host_gather`) run on a gloo group
of their own, whatever the backend of the tensors.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .runtime import get_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
ORDERS = ("rowmajor", "colmajor")


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None,
                           device="cuda",
                           timeout_s: float = 600.0) -> bool:
    """Join the process group of a multi-process run.

    The settings default to torchrun's environment: ``WORLD_SIZE``,
    ``RANK`` and ``MASTER_ADDR``/``MASTER_PORT`` (``init_method`` "env://"),
    or come from the arguments, e.g. ``init_method="tcp://localhost:29500"``.
    With a world of one process it does nothing and returns False, as
    JAX's does; it returns True once the group exists.  The backend is
    NCCL for "cuda" and gloo for "cpu".  On CUDA a rank takes the card
    ``LOCAL_RANK``; NCCL needs a card for each rank of the node
    (``LOCAL_WORLD_SIZE``), so more ranks than cards raise unless the
    caller names ``backend="gloo"``, which shares the cards (rank modulo
    cards) and sums the gradients on the host: a test or a one-card check,
    several times slower than NCCL."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return False
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks exists; asked for {world_size}")
        return True
    if rank is None:
        rank = int(os.environ["RANK"])
    dev = torch.device(device)
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    if dev.type == "cuda":
        backend = backend or "nccl"
        cards = torch.cuda.device_count()
        local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        if local_ranks > cards and backend != "gloo":
            raise RuntimeError(
                f"{local_ranks} ranks on a node of {cards} card(s): "
                f"{backend} needs a card for each rank; start at most "
                f"{cards} ranks a node, or name backend='gloo' to share "
                "the cards (the gradients then sum on the host)")
        get_device(device)                  # raises without a card
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % cards)
    elif backend is None:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def world() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) layout of ranks.

    ``ranks[d, m]`` is the global rank at data row d, model column m;
    ``data_index`` and ``model_index`` are this rank's.  ``data_group``
    holds the ranks of this rank's model column (they split the batch;
    None for a mesh of one rank); ``model_group`` those of its data row;
    ``host_group`` every rank of the mesh, on gloo.  None stands for the
    default (world) group in the last two."""

    ranks: np.ndarray
    rank: int
    data_index: int
    model_index: int
    data_group: Optional[object]
    model_group: Optional[object]
    host_group: Optional[object]

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.ranks.shape[0], MODEL_AXIS: self.ranks.shape[1]}

    @property
    def size(self) -> int:
        return int(self.ranks.size)


def model_size(mesh: Optional[Mesh]) -> int:
    """M, the model axis' size (1 without a mesh)."""
    return 1 if mesh is None else mesh.shape[MODEL_AXIS]


def check_vocab(vocab: int, model: int) -> None:
    """Raise ValueError when the model axis does not divide the
    vocabulary (the JAX package's ``jax.device_put`` refuses an uneven
    split too)."""
    if vocab % model:
        raise ValueError(
            f"vocab_size {vocab} is not divisible by the model axis "
            f"{model}: the vocabulary is sharded in equal blocks of "
            f"vocab_size / {model} columns")


def vocab_block(vocab: int, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(col0, width): this rank's block of the vocabulary, the columns
    [col0, col0 + width) of fc and the same rows of the embedding."""
    m = model_size(mesh)
    check_vocab(vocab, m)
    width = vocab // m
    return (0 if mesh is None else mesh.model_index) * width, width


def model_all_reduce(t: torch.Tensor, mesh: Mesh,
                     op=dist.ReduceOp.SUM) -> torch.Tensor:
    """all_reduce ``t`` in place over the model group; returns it."""
    if model_size(mesh) > 1:
        dist.all_reduce(t, op=op, group=mesh.model_group)
    return t


@torch.no_grad()
def replicate_over_model(t: torch.Tensor, mesh: Optional[Mesh]
                         ) -> torch.Tensor:
    """Overwrite ``t`` in place with the copy of this data row's first
    model rank (a broadcast over the model group); returns it.  ``t``
    must be contiguous; without a model axis it is left as it is."""
    if model_size(mesh) > 1:
        dist.broadcast(t, int(mesh.ranks[mesh.data_index, 0]),
                       group=mesh.model_group)
    return t


class _SumOverModel(torch.autograd.Function):
    """Forward: the sum over the model group.  Backward: the identity
    (the cotangent is the same on every rank of the group)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return model_all_reduce(x.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _EnterVocabRegion(torch.autograd.Function):
    """Forward: the identity.  Backward: the sum over the model group
    (each shard's columns give a part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return model_all_reduce(g.clone(), ctx.mesh), None


def sum_over_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """x summed over the model group, differentiable, the backward the
    identity; x itself without a model axis."""
    return _SumOverModel.apply(x, mesh) if model_size(mesh) > 1 else x


def enter_vocab_region(x: torch.Tensor,
                       mesh: Optional[Mesh]) -> torch.Tensor:
    """x, whose gradient is summed over the model group; x itself without
    a model axis."""
    return _EnterVocabRegion.apply(x, mesh) if model_size(mesh) > 1 else x


@torch.no_grad()
def gather_model(t: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The whole tensor from each model rank's block of it along ``dim``
    (every rank of the data row gets it), by one broadcast a block, so
    the result is bitwise the blocks."""
    m = model_size(mesh)
    if m == 1:
        return t
    parts = []
    for j in range(m):
        part = t.contiguous() if j == mesh.model_index \
            else torch.empty_like(t, memory_format=torch.contiguous_format)
        dist.broadcast(part, int(mesh.ranks[mesh.data_index, j]),
                       group=mesh.model_group)
        parts.append(part)
    return torch.cat(parts, dim=dim)


def _layout(d: int, m: int, order: str) -> np.ndarray:
    if order == "colmajor":
        # the model axis strides: rank (d, m) = m * D + d
        return np.arange(d * m).reshape(m, d).T
    if order == "rowmajor":
        # the model axis is contiguous: rank (d, m) = d * M + m
        return np.arange(d * m).reshape(d, m)
    raise ValueError(f"unknown mesh order {order!r}: one of {ORDERS}")


def check_mesh_shape(mesh_shape: Optional[Tuple[int, int]]
                     ) -> Tuple[int, int]:
    """(D, M) of mesh_shape (None: every rank on the data axis); raises
    ValueError unless D x M is the process group's size."""
    size = world()[1]
    d, m = mesh_shape if mesh_shape is not None else (size, 1)
    if d < 1 or m < 1 or d * m != size:
        raise ValueError(f"mesh_shape {(d, m)} needs {d * m} ranks; the "
                         f"process group has {size}")
    return int(d), int(m)


def make_mesh(mesh_shape: Optional[Tuple[int, int]] = None,
              order: str = "rowmajor") -> Mesh:
    """The (data, model) mesh over every rank of the process group.

    mesh_shape=None puts all ranks on the data axis.  ``order`` is JAX's:
    "rowmajor" keeps a model row's ranks contiguous (rank d * M + m),
    "colmajor" strides them (rank m * D + d).  Raises when D x M is not
    the world size.  Every rank must call it, in the same order as its
    other group creations (``torch.distributed.new_group`` is
    collective)."""
    rank, size = world()
    d, m = check_mesh_shape(mesh_shape)
    ranks = _layout(d, m, order)
    where = np.argwhere(ranks == rank)[0]
    di, mi = int(where[0]), int(where[1])
    if size == 1:
        return Mesh(ranks, rank, di, mi, None, None, None)
    data_group, model_group = dist.group.WORLD, None
    if m > 1:
        # new_group is collective: every rank creates every group
        for col in range(m):
            g = dist.new_group([int(r) for r in ranks[:, col]])
            if col == mi:
                data_group = g
        for row in range(d):
            g = dist.new_group([int(r) for r in ranks[row, :]])
            if row == di:
                model_group = g
    host_group = None if dist.get_backend() == "gloo" else \
        dist.new_group(backend="gloo")
    return Mesh(ranks, rank, di, mi, data_group, model_group, host_group)


def process_data_slice(mesh: Mesh) -> Tuple[int, int]:
    """(block_index, n_blocks) of the global batch's rows this rank takes:
    its data row and the data axis' size (``data/loader.iterate``'s
    process_index and process_count).  Each rank holds one mesh cell, so
    the rows of a rank are one contiguous block under either order."""
    return mesh.data_index, mesh.shape[DATA_AXIS]


def host_gather(tree: Dict[str, object],
                mesh: Optional[Mesh]) -> Dict[str, np.ndarray]:
    """Concatenate each rank's rows of ``tree`` (tensors or arrays with a
    leading batch axis, the same shapes on every rank) along the data
    axis, in data-row order, on the host of every rank: the counterpart
    of JAX's ``replicate_for_host_fetch`` for the validation hypotheses.
    It runs on the gloo host group, whatever device the tensors are on.
    A single rank (or no mesh) gets its own rows back as numpy arrays."""
    local = {k: (v.detach().cpu() if torch.is_tensor(v)
                 else torch.from_numpy(np.ascontiguousarray(v)))
             for k, v in tree.items()}
    if mesh is None or mesh.size == 1:
        return {k: v.numpy() for k, v in local.items()}
    out = {}
    order = [int(r) for r in mesh.ranks[:, mesh.model_index]]
    for k in sorted(local):
        parts = [torch.empty_like(local[k]) for _ in range(mesh.size)]
        dist.all_gather(parts, local[k], group=mesh.host_group)
        out[k] = torch.cat([parts[r] for r in order]).numpy()
    return out


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the mesh (on the host group)."""
    if mesh.size > 1:
        dist.barrier(group=mesh.host_group)


def host_sum(values: Sequence[float], mesh: Mesh) -> list:
    """The sums over the data axis of host scalars (float64, on the host
    group): the validation metrics' weighted sums."""
    t = torch.tensor([float(v) for v in values], dtype=torch.float64)
    if mesh.size > 1:
        dist.all_reduce(t, group=mesh.host_group)
        t /= mesh.shape[MODEL_AXIS]
    return t.tolist()
