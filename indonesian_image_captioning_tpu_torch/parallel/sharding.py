"""Placement of train states and batches on a rank mesh: the data axis.

Counterpart of the JAX package's ``parallel/sharding.py`` for meshes
(D, 1).  JAX describes placements as ``NamedSharding`` trees and lets
``jax.device_put`` move the data; here each rank holds its own copy of
every leaf, so placing means making those copies equal and cutting the
batch:

* parameters, optimizer state and the frozen encoders are replicated:
  :func:`place_state` broadcasts every tensor of a state from the mesh's
  first rank, once at the start and again after a resume;
* batches are split by rows: :func:`place_batch` keeps this rank's
  contiguous block of a global batch (``data/loader.iterate`` gathers only
  that block in the trainers).

:func:`trainer_mesh` makes the trainers' mesh from ``TrainConfig``.  The
model axis is ROADMAP.md queue 1 item 7's: ``shard_vocab=True`` or a
model axis past 1 raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from ..core import meshes
from ..core.meshes import DATA_AXIS, MODEL_AXIS, Mesh
from ..train.steps import map_tree, state_payload

REPLICATED = "replicated"
MODEL_AXIS_TODO = ("the model axis (vocab-sharded fc, embedding and Adam "
                   "moments) is not ported yet: ROADMAP.md queue 1 item 7's "
                   "model axis")


def check_data_axis_only(mesh_shape, shard_vocab: bool = False) -> None:
    """Raise NotImplementedError, naming ROADMAP.md queue 1 item 7's model
    axis, for a mesh with a model axis past 1 or for shard_vocab."""
    if shard_vocab or int(mesh_shape[1]) > 1:
        raise NotImplementedError(
            f"mesh {tuple(mesh_shape)}, shard_vocab={shard_vocab}: "
            + MODEL_AXIS_TODO)


def check_mesh(mesh: Mesh, shard_vocab: bool = False) -> None:
    """check_data_axis_only for a mesh's shape."""
    check_data_axis_only((mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]),
                         shard_vocab)


def state_sharding(mesh: Mesh, state, shard_vocab: bool = False):
    """The placement of every leaf of a state: REPLICATED (the only one of
    the data axis)."""
    check_mesh(mesh, shard_vocab)
    return map_tree(state_payload(state), lambda _: REPLICATED)


def _tensors(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, torch.optim.Optimizer):
        # Adam's moments and step counts, in its parameters' order
        return [t for p in tree.param_groups[0]["params"]
                for t in _tensors(tree.state.get(p, {}))]
    if isinstance(tree, dict):
        return [t for k in tree for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


@torch.no_grad()
def place_state(mesh: Mesh, state: Dict[str, Any],
                shard_vocab: bool = False) -> Dict[str, Any]:
    """Replicate ``state`` (trees of tensors and ``torch.optim``
    optimizers) over the mesh in place: every tensor is broadcast from the
    mesh's first rank, so all ranks step from bitwise-equal copies.  The
    trees must have the same structure on every rank (an optimizer's
    moments exist on all ranks or on none).  Returns ``state``."""
    check_mesh(mesh, shard_vocab)
    if mesh.size == 1:
        return state
    src = int(mesh.ranks[0, 0])
    for t in _tensors(state):
        if t.is_cuda or dist.get_backend() == "gloo":
            dist.broadcast(t, src)
        else:  # a CPU leaf (a step count) under NCCL goes through gloo
            dist.broadcast(t, src, group=mesh.host_group)
    return state


def place_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's contiguous block of rows of a global batch (arrays or
    tensors with a leading batch axis that the data axis divides)."""
    d, i = mesh.shape[DATA_AXIS], mesh.data_index

    def rows(x):
        n = x.shape[0]
        if n % d:
            raise ValueError(f"batch of {n} rows on a data axis of {d}")
        return x[i * (n // d):(i + 1) * (n // d)]

    return {k: rows(v) if isinstance(v, (np.ndarray, torch.Tensor)) else v
            for k, v in batch.items()}


def trainer_mesh(tcfg):
    """(mesh, the loader's slice arguments) of ``tcfg.mesh_shape``: (None,
    {}) for one device; a data-parallel mesh (D, 1) over the process group
    otherwise, its batch size divisible by D (a model axis raises
    NotImplementedError)."""
    if tuple(tcfg.mesh_shape) == (1, 1):
        return None, {}
    check_data_axis_only(tcfg.mesh_shape)
    if tcfg.batch_size % tcfg.mesh_shape[0]:
        raise ValueError(
            f"batch_size {tcfg.batch_size} must be divisible by the data "
            f"axis {tcfg.mesh_shape[0]} of mesh {tuple(tcfg.mesh_shape)}")
    mesh = meshes.make_mesh(tuple(tcfg.mesh_shape), order=tcfg.mesh_order)
    blk, nblk = meshes.process_data_slice(mesh)
    return mesh, {"process_index": blk, "process_count": nblk}
