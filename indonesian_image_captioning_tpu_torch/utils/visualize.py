"""Attention visualisation: per-word 14x14 alpha overlays on the image.

The port's copy of the JAX package's ``utils/visualize.py``.  Parity:
reference utils/vizualize.py:11-51 (grid of words with upsampled
alpha maps).  skimage is not a dependency, so upsampling/smoothing uses
scipy.ndimage (zoom + gaussian blur ~ pyramid_expand(upscale=24, sigma=8)).
Headless-friendly: pass ``save_path`` to write a PNG instead of plt.show().
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np


def _upsample(alpha: np.ndarray, upscale: int, smooth: bool) -> np.ndarray:
    from scipy.ndimage import gaussian_filter, zoom
    big = zoom(alpha, upscale, order=1)
    if smooth:
        big = gaussian_filter(big, sigma=8)
    return big


def visualize_att(image_path: str, seq: Sequence[int], alphas,
                  rev_word_map: Dict[int, str], smooth: bool = True,
                  enc_image_size: int = 14, upscale: int = 24,
                  save_path: Optional[str] = None):
    import matplotlib
    if save_path:
        matplotlib.use("Agg")
    import matplotlib.cm as cm
    import matplotlib.pyplot as plt
    from PIL import Image

    alphas = np.asarray(alphas)
    image = Image.open(image_path)
    image = image.resize([enc_image_size * upscale] * 2, Image.LANCZOS)
    words = [rev_word_map[int(i)] for i in seq]

    plt.figure(1, figsize=(24, 9))
    for t, word in enumerate(words):
        if t > 50:
            break
        plt.subplot(int(math.ceil(len(words) / 5.0)), 5, t + 1)
        plt.text(0, 1, word, color="black", backgroundcolor="white",
                 fontsize=12)
        plt.imshow(image)
        alpha = _upsample(
            alphas[t].reshape(enc_image_size, enc_image_size), upscale,
            smooth)
        plt.imshow(alpha, alpha=0.0 if t == 0 else 0.8)
        plt.set_cmap(cm.Greys_r)
        plt.axis("off")
    if save_path:
        plt.savefig(save_path, bbox_inches="tight")
        plt.close()
        return save_path
    plt.show()
    return None
