"""Synthetic tiny corpora built through the real preprocessing pipeline.

Counterpart of the JAX package's ``data/synthetic.py``.  It writes a
flickr10k-layout folder (the reference's folder format, its
utils/dataset.py:65-176: filenames/captions/tags JSON, train/val/test txt
and all_tags.txt) of random images and captions, then runs
``data.preprocess.create_input_files`` on it, so that tests and smoke runs
exercise the artifact path rather than hand-built arrays.  For the same
``seed`` the artifacts equal the JAX function's (numpy's ``default_rng``
draws the images and words in the same order).  CPU only: it needs Pillow
and h5py.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

from ..core.config import DataConfig

# 12 distinct words + <pad>/<unk>/<start>/<end> = vocab 16
DEFAULT_WORDS: Sequence[str] = (
    "anjing", "kucing", "burung", "bermain", "duduk", "berlari",
    "di", "atas", "taman", "rumput", "bola", "anak",
)


def make_synthetic_corpus(root: str, output_folder: str, *,
                          n_images: int = 16,
                          n_train: Optional[int] = None,
                          image_size: int = 32,
                          captions_per_image: int = 2,
                          caption_words: int = 4,
                          max_len: int = 10,
                          words: Sequence[str] = DEFAULT_WORDS,
                          tag_vocab: Sequence[str] = ("anjing", "kucing"),
                          seed: int = 0, workers: int = 0) -> DataConfig:
    """Write a tiny flickr10k-format corpus and its preprocessed artifacts.

    Returns the DataConfig pointing at the artifacts.  Every word in
    ``words`` is planted at least once, so the wordmap size is exactly
    ``len(words) + 4`` whatever the sampler draws.  ``workers`` is
    ``create_input_files``'s (the artifacts do not depend on it)."""
    from PIL import Image

    from . import preprocess

    img_dir = os.path.join(root, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(output_folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    n_train = n_train if n_train is not None else max(n_images - 4, 2)
    n_val = max((n_images - n_train) // 2, 1)

    filenames, captions, tags = [], [], []
    words = list(words)
    for i in range(n_images):
        name = f"{i:04d}.jpg"
        Image.fromarray(rng.integers(0, 256, (image_size + 8, image_size + 8,
                                              3), dtype=np.uint8)
                        ).save(os.path.join(img_dir, name))
        filenames.append(name)
        caps = []
        for c in range(captions_per_image):
            picked = rng.choice(words, caption_words).tolist()
            # plant each vocab word deterministically at least once
            picked[0] = words[(i * captions_per_image + c) % len(words)]
            caps.append(" ".join(picked))
        captions.append(caps)
        tags.append([tag_vocab[i % len(tag_vocab)]])

    def dump(name, obj):
        with open(os.path.join(root, name), "w") as f:
            json.dump(obj, f)

    dump("filenames.json", filenames)
    dump("captions.json", captions)
    dump("tags.json", tags)
    stems = [f"{i:04d}" for i in range(n_images)]
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(stems[:n_train]))
    with open(os.path.join(root, "val.txt"), "w") as f:
        f.write("\n".join(stems[n_train:n_train + n_val]))
    with open(os.path.join(root, "test.txt"), "w") as f:
        f.write("\n".join(stems[n_train + n_val:]))
    with open(os.path.join(root, "all_tags.txt"), "w") as f:
        f.write("\n".join(tag_vocab))

    preprocess.create_input_files(
        "flickr10k", root, img_dir,
        captions_per_image=captions_per_image, min_word_freq=0,
        output_folder=output_folder, tag_size=len(tag_vocab),
        max_len=max_len, image_size=image_size, workers=workers)
    data_name = f"flickr10k_{captions_per_image}_cap_per_img_0_min_word_freq"
    return DataConfig(data_folder=output_folder, data_name=data_name,
                      captions_per_image=captions_per_image,
                      image_size=image_size, tag_size=len(tag_vocab))
