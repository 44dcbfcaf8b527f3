"""Device-resident uint8 image store: device memory replaces the per-step
host-to-device copy of pixels.

Counterpart of the JAX package's ``data/device_store.py``, without the
mesh.  The flagship flickr10k TRAIN split is about 2 GB of uint8 (10k
images x 3x256x256); it fits in an H100's 80 GB beside the model.  The
split is uploaded once, and each batch's rows are gathered on the device
by index: per-step input traffic drops to a (B,) index array.  The same
pattern the feature cache uses for encoder outputs
(``train/feature_cache.py``), one level earlier, so it also serves
uncached training.

Exactness: the store returns the uint8 rows the host gather would have
produced.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class DeviceImageStore:
    """All unique images of one split, resident on the device as uint8."""

    def __init__(self, images: np.ndarray, device):
        self.images = torch.from_numpy(np.ascontiguousarray(images)).to(
            torch.device(device))
        self.nbytes = self.images.numel() * self.images.element_size()

    def lookup(self, idx: torch.Tensor, cpi: int = 1) -> torch.Tensor:
        """(B,) dataset indices -> (B, 3, S, S) uint8 rows.

        ``cpi``: captions-per-image divisor for CAPTION indices (the store
        holds unique images; caption row i uses image i // cpi, reference
        datasets/caption.py:46)."""
        img = torch.div(idx.to(self.images.device).long(), int(cpi),
                        rounding_mode="floor")
        return self.images.index_select(0, img)


def estimate_bytes(dataset) -> int:
    n = getattr(dataset, "num_images", len(dataset))
    per_img = int(np.prod(dataset._images.shape[1:]))  # uint8
    return n * per_img


def build(dataset, *, budget_bytes: int, device, log=print,
          split: str = "") -> Optional[DeviceImageStore]:
    """Upload ``dataset``'s unique images to the device if they fit the
    budget.

    Returns None (the caller keeps the host loader path) when the split
    exceeds ``budget_bytes`` or the images are not host-resident (windowed
    HDF5 reads, above ``datasets.IN_MEMORY_LIMIT``)."""
    images = dataset._images
    if not isinstance(images, np.ndarray):
        log(f"device image store [{split or 'split'}]: images are windowed "
            f"HDF5 (> host RAM limit) -- staying on the host loader path")
        return None
    if images.nbytes > budget_bytes:
        log(f"device image store [{split or 'split'}]: "
            f"{images.nbytes / (1 << 30):.2f} GiB exceeds the "
            f"{budget_bytes / (1 << 30):.2f} GiB device budget -- staying "
            f"on the host loader path")
        return None
    store = DeviceImageStore(images, device)
    log(f"device image store [{split or 'split'}]: "
        f"{images.shape[0]} images, {store.nbytes / (1 << 20):.0f} MiB "
        f"uint8 resident on {store.images.device} -- per-step input traffic "
        f"is now a (B,) index array")
    return store


def build_pair(tcfg, train_ds, val_ds, device, log=print):
    """TRAIN + VAL stores per ``TrainConfig.device_images``
    ("auto" | "on" | "off"), sharing ``device_images_budget_gb``.

    Marks each stored dataset ``load_images = False`` so the loader stops
    gathering pixels; callers must then iterate ``with_index=True`` and
    substitute ``store.lookup(batch["index"], cpi)``."""
    mode = tcfg.device_images
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"unknown device_images {mode!r}")
    if mode == "off":
        return None, None
    budget = int(tcfg.device_images_budget_gb * (1 << 30))
    train_store = build(train_ds, budget_bytes=budget, device=device,
                        log=log, split="TRAIN")
    if mode == "on" and train_store is None:
        raise ValueError(
            "device_images='on' but the TRAIN split does not fit "
            "device_images_budget_gb (or is windowed HDF5)")
    val_store = None
    if train_store is not None:
        train_ds.load_images = False
        val_store = build(val_ds, budget_bytes=budget - train_store.nbytes,
                          device=device, log=log, split="VAL")
        if val_store is not None:
            val_ds.load_images = False
    return train_store, val_store
