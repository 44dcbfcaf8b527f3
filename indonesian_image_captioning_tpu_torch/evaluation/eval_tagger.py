"""TEST-split tagger evaluation: mean binary accuracy.

Counterpart of the JAX package's ``evaluation/eval_tagger.py`` (reference
eval_tagger.py:34-62): batch the TEST ``TagDataset``, score the sigmoid
outputs against the multi-hot ground truth with 0.5 thresholds on both
sides, and report the mean over valid rows, x100.  The tagger is a
ResNet with no hand-written kernel: on the card its convolutions run
through cuDNN.

:func:`evaluate` reads the split from the artifact files;
:func:`evaluate_dataset` takes any dataset with ``gather`` (e.g.
``TagDataset.from_arrays``), so a caller holding the split in memory needs
no ``h5py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import DataConfig
from ..core.runtime import get_device
from ..data import loader as loader_lib
from ..data.datasets import TagDataset
from ..models import encoders


def evaluate(params, stats, data_cfg: DataConfig, batch_size: int = 32,
             arch: str = "resnet152", log=print, device="cuda") -> float:
    ds = TagDataset(data_cfg.data_folder, data_cfg.data_name, "TEST")
    return evaluate_dataset(params, stats, ds, batch_size=batch_size,
                            arch=arch, log=log, device=device)


def evaluate_dataset(params, stats, ds, batch_size: int = 32,
                     arch: str = "resnet152", log=print,
                     device="cuda") -> float:
    """Mean binary accuracy (x100) of the tagger (params, stats) on
    ``device`` over the images of ``ds``."""
    dev = device if isinstance(device, torch.device) else get_device(device)
    accs = []
    with torch.inference_mode():
        for batch in loader_lib.iterate(ds, batch_size):
            images, tags = (torch.from_numpy(batch[k]).to(dev)
                            for k in ("images", "tags"))
            probs, _ = encoders.apply_encoder_tagger(
                params, stats, encoders.prep_images(images), train=False,
                arch=arch)
            agree = (probs >= 0.5) == (tags >= 0.5)
            per_row = agree.to(torch.float32).mean(dim=-1).cpu().numpy()
            valid = batch["valid"] > 0
            accs.extend((per_row[valid] * 100.0).tolist())
    acc = float(np.mean(accs)) if accs else 0.0
    log(f"Mean accuracy of tagger is {acc:.4f}")
    return acc
