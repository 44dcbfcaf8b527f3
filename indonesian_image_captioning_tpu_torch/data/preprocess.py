"""Image preprocessing.

Counterpart of the JAX package's ``data/preprocess.py``, of which it holds
only :func:`read_image` for now (the inference CLI's reader).  The corpus
builder (``create_input_files``: the flickr10k layout into HDF5 and JSON)
is ROADMAP.md queue 1 item 6.
"""

from __future__ import annotations

import numpy as np


def read_image(path: str, size: int = 256) -> np.ndarray:
    """Image file -> (3, size, size) uint8 CHW (the reference's HDF5 layout,
    utils/dataset.py:367-374), Pillow bilinear resize."""
    from PIL import Image
    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    img = img.resize((size, size), Image.BILINEAR)
    return np.ascontiguousarray(np.asarray(img, np.uint8).transpose(2, 0, 1))
