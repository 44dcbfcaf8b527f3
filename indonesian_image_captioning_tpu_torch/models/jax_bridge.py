"""Move parameter trees between the JAX package and the port, through numpy.

Decoder trees map leaf for leaf: the same nested names and the same
shapes, because the port keeps the JAX layouts at its public functions
((in, out) linear weights, the fused SCN gate layout).

ResNet trees (``models/resnet.py`` of both packages) differ in two ways:

* convolution kernels are HWIO in JAX and OIHW in the port;
* JAX stacks the blocks after the first of each stage on a leading axis
  (its stages run as one ``lax.scan``); the port keeps them as a list.

So every 4-D leaf is transposed, and every subtree under a ``"rest"`` key
is unstacked into a list (and stacked back by :func:`params_to_jax`).  No
decoder tree has a 4-D leaf or a ``"rest"`` key.

Nothing here imports ``jax``: :func:`params_from_jax` reads any leaf that
``numpy.asarray`` accepts, and :func:`params_to_jax` returns numpy arrays,
which every JAX function accepts.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

_HWIO_TO_OIHW = (3, 2, 0, 1)
_OIHW_TO_HWIO = (2, 3, 1, 0)


def _leaf_from_jax(x, device) -> torch.Tensor:
    a = np.asarray(x)
    bf16 = a.dtype.name == "bfloat16"
    if bf16:                       # ml_dtypes bfloat16: torch cannot share it
        a = a.astype(np.float32)
    if a.ndim == 4:
        a = a.transpose(_HWIO_TO_OIHW)
    t = torch.from_numpy(np.array(a, order="C"))   # a writable copy
    if bf16:
        t = t.to(torch.bfloat16)
    return t.to(device)


def _unstack(tree) -> list:
    """Stacked subtree (leading axis n) -> list of n subtrees."""
    first = tree
    while isinstance(first, dict):
        first = next(iter(first.values()))
    n = np.asarray(first).shape[0]

    def take(t, i):
        if isinstance(t, dict):
            return {k: take(v, i) for k, v in t.items()}
        return np.asarray(t)[i]

    return [take(tree, i) for i in range(n)]


def params_from_jax(tree: Any, device="cpu"):
    """JAX parameter (or batch-stats) tree -> the port's tree of tensors."""
    def conv(t, key=None):
        if t is None:
            return None
        if key == "rest":
            return [conv(b) for b in _unstack(t)]
        if isinstance(t, dict):
            return {k: conv(v, k) for k, v in t.items()}
        return _leaf_from_jax(t, device)

    return conv(tree)


def params_to_jax(tree: Any):
    """The port's tree of tensors -> a JAX-layout tree of numpy arrays."""
    def conv(t, key=None):
        if t is None:
            return None
        if key == "rest":
            blocks = [conv(b) for b in t]

            def stack(*xs):
                if isinstance(xs[0], dict):
                    return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
                return np.stack(xs)

            return stack(*blocks)
        if isinstance(t, dict):
            return {k: conv(v, k) for k, v in t.items()}
        a = t.detach().to("cpu", torch.float32 if t.dtype == torch.bfloat16
                          else t.dtype).numpy()
        return a.transpose(_OIHW_TO_HWIO) if a.ndim == 4 else a

    return conv(tree)
