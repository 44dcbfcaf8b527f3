"""Word/tag vocabularies and caption encoding.

The port's copy of the JAX package's ``data/vocab.py`` (pure Python).

Artifact parity with the reference wordmap builder (utils/dataset.py:300-323):
  * words with corpus frequency > min_word_freq, ids 1..N in corpus order;
  * <unk>, <start>, <end> appended after; <pad> = 0;
  * tagmap maps tag string -> index 0..tag_size-1;
  * caption encoding: <start> w1..wn <end> <pad>* with total length
    max_len + 2 and caplen = n + 2 (utils/dataset.py:386-395).
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, List, Sequence, Tuple

from ..core.tokens import END_TOKEN, PAD_ID, PADDING_TOKEN, START_TOKEN, UNKNOWN_TOKEN


def build_word_map(word_freq: Counter, min_word_freq: int) -> Dict[str, int]:
    words = [w for w in word_freq.keys() if word_freq[w] > min_word_freq]
    word_map = {w: i + 1 for i, w in enumerate(words)}
    word_map[UNKNOWN_TOKEN] = len(word_map) + 1
    word_map[START_TOKEN] = len(word_map) + 1
    word_map[END_TOKEN] = len(word_map) + 1
    word_map[PADDING_TOKEN] = PAD_ID
    return word_map


def encode_caption(tokens: Sequence[str], word_map: Dict[str, int],
                   max_len: int) -> Tuple[List[int], int]:
    """-> (ids of length max_len + 2, caplen = len(tokens) + 2)."""
    unk = word_map[UNKNOWN_TOKEN]
    ids = ([word_map[START_TOKEN]]
           + [word_map.get(w, unk) for w in tokens]
           + [word_map[END_TOKEN]]
           + [word_map[PADDING_TOKEN]] * (max_len - len(tokens)))
    return ids, len(tokens) + 2


def invert(mapping: Dict[str, int]) -> Dict[int, str]:
    return {v: k for k, v in mapping.items()}


def special_ids(word_map: Dict[str, int]) -> Dict[str, int]:
    return {name: word_map[name] for name in
            (START_TOKEN, END_TOKEN, UNKNOWN_TOKEN, PADDING_TOKEN)}


def save_json(obj, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def base_filename(dataset: str, captions_per_image: int,
                  min_word_freq: int) -> str:
    """Shared artifact base name (utils/dataset.py:309-311)."""
    cpi = captions_per_image if captions_per_image > -1 else "all"
    return f"{dataset}_{cpi}_cap_per_img_{min_word_freq}_min_word_freq"


def wordmap_path(folder: str, base: str) -> str:
    return os.path.join(folder, f"WORDMAP_{base}.json")


def tagmap_path(folder: str, base: str) -> str:
    return os.path.join(folder, f"TAGMAP_{base}.json")
