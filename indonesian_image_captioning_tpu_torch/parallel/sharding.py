"""Placement of train states and batches on a rank mesh (D, M).

Counterpart of the JAX package's ``parallel/sharding.py``.  JAX describes
placements as ``NamedSharding`` trees and lets ``jax.device_put`` move the
data; here each rank holds its own tensors, so placing means making them
equal and cutting out each rank's part:

* the batch is split by rows over the data axis: :func:`place_batch`
  keeps this rank's contiguous block of a global batch
  (``data/loader.iterate`` gathers only that block in the trainers); the
  M ranks of a data row take the same rows, as JAX's ``P("data")`` gives;
* with a model axis past 1, the rank at (d, m) holds
  the columns ``[m V/M, (m+1) V/M)`` of ``fc.w`` and ``fc.b``, the same
  rows of ``embedding``, and Adam's moments of those leaves sharded the
  same way (JAX's ``decoder_param_sharding`` and ``state_sharding``);
  M must divide V, as ``jax.device_put`` requires (a ``ValueError``
  names both);
* everything else is replicated.

:func:`place_state` broadcasts the mesh's first rank's whole state, then
each rank keeps its block of the vocabulary leaves; :func:`gather_payload`
puts a checkpoint's blocks back together (``core/checkpoint``'s saver
calls it before rank 0 writes), so a checkpoint written on a mesh is the
one-rank format.  :func:`trainer_mesh` makes the trainers' mesh from
``TrainConfig``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core import meshes
from ..core.meshes import DATA_AXIS, MODEL_AXIS, Mesh
from ..train.steps import map_tree, state_payload, tree_leaves

REPLICATED = ()
# the vocabulary leaves of a decoder tree: (path, the sharded dimension)
VOCAB_LEAVES = ((("fc", "w"), 1), (("fc", "b"), 0), (("embedding",), 0))
OPT_MOMENTS = ("exp_avg", "exp_avg_sq")


def spec(ndim: int, dim: int):
    """The JAX ``PartitionSpec`` of a leaf sharded over the model axis
    along ``dim``, as a tuple: ``(None, "model")`` for fc.w."""
    return tuple(MODEL_AXIS if i == dim else None for i in range(ndim))


def _get(tree, path):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree


def vocab_leaf_dims(params) -> Dict[int, int]:
    """{index in ``tree_leaves(params)`` order: sharded dimension} of the
    vocabulary leaves a parameter tree holds (the optimizer's order)."""
    ids = {id(t): i for i, t in enumerate(tree_leaves(params))}
    return {ids[id(leaf)]: dim for path, dim in VOCAB_LEAVES
            if (leaf := _get(params, path)) is not None}


def state_sharding(mesh: Mesh, state):
    """The placement of every leaf of a caption state (``state_payload``'s
    form), as JAX's PartitionSpecs written as tuples: ``REPLICATED`` (JAX's
    ``P()``), or the model axis on the vocabulary dimension of fc,
    embedding and the decoder Adam's moments of those leaves."""
    payload = state_payload(state)
    tree = map_tree(payload, lambda _: REPLICATED)
    if meshes.model_size(mesh) == 1 or "params" not in state:
        return tree
    for path, dim in VOCAB_LEAVES:
        leaf = _get(payload["params"], path)
        if leaf is not None:
            *head, last = path
            _get(tree["params"], head)[last] = spec(leaf.dim(), dim)
    if "opt_state" in payload:
        moments = tree["opt_state"]["state"]
        for i, dim in vocab_leaf_dims(state["params"]).items():
            for k in OPT_MOMENTS:
                if k in moments.get(i, {}):
                    moments[i][k] = spec(
                        payload["opt_state"]["state"][i][k].dim(), dim)
    return tree


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


def _block(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    col0, width = meshes.vocab_block(t.shape[dim], mesh)
    return t.narrow(dim, col0, width).clone()


@torch.no_grad()
def place_state(mesh: Mesh, state: Dict[str, Any]) -> Dict[str, Any]:
    """Place ``state`` (trees of tensors and ``torch.optim`` optimizers)
    on the mesh in place: every tensor is broadcast from the mesh's first
    rank, so all ranks start from bitwise-equal copies; then, on a model
    axis, each rank keeps its block of
    ``params``' vocabulary leaves and of their moments in ``opt_state``
    (the tensors the optimizer holds change their data, not their
    identity).  The trees must have the same structure on every rank.
    Raises ValueError when the model axis does not divide the
    vocabulary.  Returns ``state``."""
    sharded = meshes.model_size(mesh) > 1 and "params" in state
    dims = vocab_leaf_dims(state["params"]) if sharded else {}
    if dims:
        leaves = tree_leaves(state["params"])
        for i, dim in dims.items():
            meshes.check_vocab(leaves[i].shape[dim], meshes.model_size(mesh))
    if mesh.size > 1:
        src = int(mesh.ranks[0, 0])
        for t in _tensors(state):
            if t.is_cuda or dist.get_backend() == "gloo":
                dist.broadcast(t, src)
            else:  # a CPU leaf (a step count) under NCCL goes through gloo
                dist.broadcast(t, src, group=mesh.host_group)
    if dims:
        leaves = tree_leaves(state["params"])
        opt = state.get("opt_state")
        for i, dim in dims.items():
            p = leaves[i]
            moments = opt.state.get(p, {}) if opt is not None else {}
            for k in OPT_MOMENTS:
                if k in moments:
                    moments[k] = _block(moments[k], dim, mesh)
            p.data = _block(p.data, dim, mesh)
    return state


@torch.no_grad()
def gather_payload(mesh: Optional[Mesh],
                   payload: Dict[str, Any]) -> Dict[str, Any]:
    """A checkpoint payload (``state_payload``'s form of a state placed
    by :func:`place_state`) with its vocabulary blocks put back together
    over the model group: ``params``' vocabulary leaves and their moments
    in ``opt_state``'s state_dict (indexed in ``params``' leaf order).
    Every rank of the data row calls it; the result is bitwise the
    blocks, the one-rank format.  Without a model axis, ``payload``."""
    if meshes.model_size(mesh) == 1 or "params" not in payload:
        return payload
    out = dict(payload)
    out["params"] = map_tree(payload["params"], lambda t: t)
    for path, dim in VOCAB_LEAVES:
        leaf = _get(payload["params"], path)
        if leaf is not None:
            *head, last = path
            _get(out["params"], head)[last] = meshes.gather_model(
                leaf, mesh, dim)
    if "opt_state" in payload:
        sd = payload["opt_state"]
        state = {i: dict(v) for i, v in sd["state"].items()}
        for i, dim in vocab_leaf_dims(payload["params"]).items():
            for k in OPT_MOMENTS:
                if k in state.get(i, {}):
                    state[i][k] = meshes.gather_model(state[i][k], mesh, dim)
        out["opt_state"] = {**sd, "state": state}
    return out


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


def trainer_mesh(tcfg, vocab_size: Optional[int] = None):
    """(mesh, the loader's slice arguments) of ``tcfg.mesh_shape``: (None,
    {}) for one device; the (D, M) mesh over the process group otherwise,
    its batch size divisible by D and, for a caption model, its
    vocabulary by M (``vocab_size``; a ValueError names both)."""
    if tuple(tcfg.mesh_shape) == (1, 1):
        return None, {}
    if vocab_size is not None:
        meshes.check_vocab(vocab_size, int(tcfg.mesh_shape[1]))
    if tcfg.batch_size % tcfg.mesh_shape[0]:
        raise ValueError(
            f"batch_size {tcfg.batch_size} must be divisible by the data "
            f"axis {tcfg.mesh_shape[0]} of mesh {tuple(tcfg.mesh_shape)}")
    mesh = meshes.make_mesh(tuple(tcfg.mesh_shape), order=tcfg.mesh_order)
    blk, nblk = meshes.process_data_slice(mesh)
    return mesh, {"process_index": blk, "process_count": nblk}
