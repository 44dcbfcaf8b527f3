"""PRNG discipline: named, seeded random streams as torch Generators.

Counterpart of the JAX package's ``core/prng.py``.  All randomness flows
from one root seed; named streams are derived from it by hashing, with the
same ``_tag`` as JAX's ``fold_in`` names, so adding a consumer never
perturbs the other streams.  A "key" here is a ``torch.Generator`` on an
explicit device; its seed (``initial_seed()``) is what the derivations
hash.  The numbers differ from JAX's for the same seed (different
generators), so the tests compare the two packages with dropout off.
"""

from __future__ import annotations

import hashlib

import torch


def _tag(name: str) -> int:
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")


def _derive(seed: int, data: int) -> int:
    """A 63-bit seed from a parent seed and a 32-bit datum."""
    h = hashlib.sha256(seed.to_bytes(8, "little") + data.to_bytes(8, "little"))
    return int.from_bytes(h.digest()[:8], "little") >> 1


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def root_key(seed: int, device="cpu") -> torch.Generator:
    return _generator(int(seed), device)


def stream(key: torch.Generator, name: str) -> torch.Generator:
    """A named substream, stable across program changes, on key's device."""
    return _generator(_derive(key.initial_seed(), _tag(name)), key.device)


def per_step(key: torch.Generator, step: int) -> torch.Generator:
    """The generator of one train step, on key's device."""
    return _generator(_derive(key.initial_seed(), int(step)), key.device)
