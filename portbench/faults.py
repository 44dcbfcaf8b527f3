"""Faults planted under the timed path, for the tests that show each
check failing and for reading a fault's numbers on the card
(``readings.py``).  A fault is a function (driver, fn) -> fn broken; the
benchmark's own runs plant none."""

from __future__ import annotations

import torch

from . import weights


def altered_token(driver, fn):
    """A decode whose first word of every caption is changed to another
    word where it is produced: in the sequences of a beam decode, or in
    the strings of a caption service."""
    V = driver.model.vocab_size

    def other(i):
        return (i + V // 2) % (V - 4) + 1

    def call():
        out = fn()
        if isinstance(out, list):
            return [" ".join([f"w{other(int(c.split()[0][1:]))}"]
                             + c.split()[1:]) if c.startswith("w") else c
                    for c in out]
        seqs = out["sequences"].clone()
        seqs[:, 1] = other(seqs[:, 1])
        return {**out, "sequences": seqs}
    return call


def half_batch(driver, fn):
    """A train step that leaves out the second half of its rows and takes
    the mean over the rest."""
    def step(batch):
        n = batch[0].shape[0] // 2
        return fn(tuple(x[:n] for x in batch))
    return step


def frozen(driver, fn):
    """A train step that returns its state unchanged."""
    def step(batch):
        params = driver.state["params"]
        keep = weights.clone(params)
        metrics = fn(batch)
        with torch.no_grad():
            _copy(params, keep)
        return metrics
    return step


def _copy(dst, src):
    for k, v in dst.items():
        if isinstance(v, dict):
            _copy(v, src[k])
        else:
            v.copy_(src[k])


FAULTS = {"altered_token": altered_token, "half_batch": half_batch,
          "frozen": frozen}
