"""Pretrained (GloVe-format) embeddings aligned to a word map.

Counterpart of the JAX package's ``utils/embedding.py`` (the reference's
utils/embedding.py:5-50): the out-of-vocabulary rows are drawn
uniform(+-sqrt(3/dim)) from numpy's ``default_rng(seed)``, bitwise the JAX
function's for the same seed, and the in-vocabulary rows are overwritten
from the text file.  The result feeds
``models.decoders.load_pretrained_embeddings``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def init_embedding(rng: np.random.Generator, shape) -> np.ndarray:
    bound = np.sqrt(3.0 / shape[1])
    return rng.uniform(-bound, bound, size=shape).astype(np.float32)


def load_embeddings(emb_file: str, word_map: Dict[str, int],
                    seed: int = 0) -> Tuple[np.ndarray, int]:
    """-> (embeddings (V, dim) float32 aligned to word_map ids, dim)."""
    with open(emb_file) as f:
        emb_dim = len(f.readline().split(" ")) - 1
    vocab = set(word_map.keys())
    emb = init_embedding(np.random.default_rng(seed),
                         (len(vocab), emb_dim))
    with open(emb_file) as f:
        for line in f:
            parts = line.split(" ")
            word = parts[0]
            if word not in vocab:
                continue
            vec = [float(x) for x in parts[1:] if x and not x.isspace()]
            emb[word_map[word]] = np.asarray(vec, np.float32)
    return emb, emb_dim
