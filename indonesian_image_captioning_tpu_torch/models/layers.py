"""Shared parameter initialisers and tiny layer primitives.

Counterpart of the JAX package's ``models/layers.py``.  Parameters are plain
nested dicts of tensors with the JAX tree's names and shapes; a linear
weight is stored (in, out) for ``x @ w``.  Random initialisation draws from
an explicit CPU ``torch.Generator`` (so a seed gives the same weights on
every device) and moves the result to ``device``.  Dropout draws from an
explicit generator too.
"""

from __future__ import annotations

import torch


def uniform(gen: torch.Generator, shape, bound: float,
            dtype=torch.float32, device="cpu") -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * bound).to(device=device, dtype=dtype)


def init_linear(gen: torch.Generator, in_dim: int, out_dim: int,
                dtype=torch.float32, device="cpu"):
    """torch nn.Linear default init; weight stored (in, out) for x @ w."""
    bound = 1.0 / (in_dim ** 0.5)
    return {
        "w": uniform(gen, (in_dim, out_dim), bound, dtype, device),
        "b": uniform(gen, (out_dim,), bound, dtype, device),
    }


def linear(p, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def dropout(gen, x: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout (scale the kept values by 1 / (1 - rate)); the
    identity at rate 0.  The keep mask draws from gen (a torch.Generator,
    on the CPU or on x's device; a fresh one seeded 0 when None)."""
    if rate == 0.0:
        return x
    if gen is None:
        gen = torch.Generator().manual_seed(0)
    u = torch.rand(x.shape, generator=gen, device=gen.device)
    keep = 1.0 - rate
    return torch.where(u.to(x.device) < keep, x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))
