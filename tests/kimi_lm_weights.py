"""Seeded weights of the latent-attention / mixture-of-experts decoder
(``models/kimi_lm.py``) for its tests, in the port's tree
(``kimi_lm.param_layout``).

The benchmark's initialisation (``portbench/weights_kimi.py``, which keeps
a copy of its own): every weight N(0, 1) / sqrt(fan in), so that each
block adds about as much as it reads; the head at HEAD_SCALE times that,
so that the logits of a unit-RMS state spread with a standard deviation
of about HEAD_SCALE; the embedding N(0, 1); the router N(0, 1) / sqrt(H)
and its correction bias N(0, BIAS_STD^2), both float32; the norms' scales
one and every bias zero.
"""

from __future__ import annotations

import math

import torch

from indonesian_image_captioning_tpu_torch.models import kimi_lm

HEAD_SCALE = 3.0
BIAS_STD = 0.05


def leaf_std(kind: str, shape) -> float:
    if kind in ("w", "router"):
        return 1.0 / math.sqrt(shape[-1])
    if kind == "head":
        return HEAD_SCALE / math.sqrt(shape[-1])
    if kind == "embed":
        return 1.0
    return BIAS_STD


def init_params(gen: torch.Generator, cfg, dtype=torch.float32,
                device="cpu"):
    """A seeded tree of ``param_layout(cfg)``, every leaf drawn from gen
    (on gen's device) in float32 and cast to dtype (router and bias stay
    float32)."""
    tree: dict = {}
    for path, shape, kind in kimi_lm.param_layout(cfg):
        if kind == "ones":
            leaf = torch.ones(shape, device=device)
        elif kind == "zeros":
            leaf = torch.zeros(shape, device=device)
        else:
            leaf = torch.randn(shape, generator=gen, device=device) \
                * leaf_std(kind, shape)
        if kind not in ("router", "bias"):
            leaf = leaf.to(dtype)
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf.contiguous()
    return tree
