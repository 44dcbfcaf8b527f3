"""The caption and tag dataset readers over the HDF5/JSON artifacts, or
over arrays.

Counterpart of the JAX package's ``data/datasets.py``, with the same
semantics.  ``CaptionDataset``: one item per caption; image index = i //
captions_per_image; VAL/TEST items also carry all captions of their image
for the corpus metrics (reference datasets/caption.py:9-68).
``TagDataset``: one item per image, its pixels and its multi-hot tags.
Batches are numpy gathers; ``data/loader.py`` moves them to the device.

``h5py`` is imported only by the HDF5 constructors, so a caller fed
in-memory splits (the ``from_arrays`` constructors) runs without it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from . import vocab as vocab_lib

SPLITS = ("TRAIN", "VAL", "TEST")
# Above this many bytes the image array stays on disk (windowed reads).
IN_MEMORY_LIMIT = 8 << 30


def _artifact(folder: str, split: str, kind: str, base: str, ext: str) -> str:
    return os.path.join(folder, f"{split}_{kind}_{base}.{ext}")


def _fancy_index(images, idx: np.ndarray) -> np.ndarray:
    """Gather rows by (possibly repeated, unsorted) indices from either an
    in-RAM array or an h5py dataset (which requires sorted unique fancy
    indices)."""
    if isinstance(images, np.ndarray):
        return images[idx]
    order = np.argsort(idx, kind="stable")
    uniq, inv = np.unique(idx[order], return_inverse=True)
    return np.asarray(images[uniq.tolist()])[inv][
        np.argsort(order, kind="stable")]


class CaptionDataset:
    """One item per caption: (image u8 CHW, caption ids, caplen[, allcaps])."""

    def __init__(self, data_folder: str, data_name: str, split: str,
                 in_memory: Optional[bool] = None):
        import h5py

        if split not in SPLITS:
            raise ValueError(f"split {split!r} is not one of {SPLITS}")
        self.split = split
        img_path = _artifact(data_folder, split, "IMAGES", data_name, "hdf5")
        tag_path = _artifact(data_folder, split, "TAGS", data_name, "hdf5")
        self._h = h5py.File(img_path, "r")
        self._images = self._h["images"]
        self.cpi = int(self._h.attrs["captions_per_image"])
        if in_memory is None:
            in_memory = self._images.nbytes <= IN_MEMORY_LIMIT
        if in_memory:
            self._images = self._images[...]
            self._h.close()
            self._h = None
        if os.path.exists(tag_path):
            with h5py.File(tag_path, "r") as t:
                self.tags = t["tags"][...]
        else:
            self.tags = None
        self.captions = np.asarray(vocab_lib.load_json(
            _artifact(data_folder, split, "CAPTIONS", data_name, "json")),
            np.int32)
        self.caplens = np.asarray(vocab_lib.load_json(
            _artifact(data_folder, split, "CAPLENS", data_name, "json")),
            np.int32)
        if len(self.captions) != len(self.caplens):
            raise ValueError(f"{split}: {len(self.captions)} captions but "
                             f"{len(self.caplens)} caption lengths")
        # Set False when batches don't need pixels (the feature cache or
        # the device image store serves them by index instead).
        self.load_images = True

    @classmethod
    def from_arrays(cls, images: np.ndarray, captions: np.ndarray,
                    caplens: np.ndarray, *, cpi: int,
                    tags: Optional[np.ndarray] = None,
                    split: str = "TRAIN") -> "CaptionDataset":
        """The in-memory reader without the file: images (n, 3, S, S)
        uint8, captions (n * cpi, L) and caplens (n * cpi,) integers, tags
        (n, tag_size) or None."""
        if split not in SPLITS:
            raise ValueError(f"split {split!r} is not one of {SPLITS}")
        images = np.asarray(images)
        if images.dtype != np.uint8 or images.ndim != 4:
            raise ValueError(f"images must be (n, 3, S, S) uint8, got "
                             f"{images.shape} {images.dtype}")
        ds = cls.__new__(cls)
        ds.split = split
        ds._h = None
        ds._images = images
        ds.cpi = int(cpi)
        ds.tags = None if tags is None else np.asarray(tags)
        ds.captions = np.asarray(captions, np.int32)
        ds.caplens = np.asarray(caplens, np.int32)
        if len(ds.captions) != len(ds.caplens) or \
                len(ds.captions) != images.shape[0] * ds.cpi:
            raise ValueError(f"{len(ds.captions)} captions and "
                             f"{len(ds.caplens)} lengths for "
                             f"{images.shape[0]} images x {ds.cpi}")
        ds.load_images = True
        return ds

    def __len__(self) -> int:
        return len(self.captions)

    @property
    def num_images(self) -> int:
        return self._images.shape[0]

    def image(self, img_idx: int) -> np.ndarray:
        return np.asarray(self._images[img_idx])

    def gather_images(self, img_idx: np.ndarray) -> np.ndarray:
        """Batch fetch of unique-image rows (u8 CHW) by IMAGE index."""
        return _fancy_index(self._images, img_idx)

    def gather(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        """Vectorised batch fetch for caption indices ``idx``."""
        img_idx = idx // self.cpi
        batch = {
            "captions": self.captions[idx],            # (B, L)
            "caplens": self.caplens[idx],              # (B,)
        }
        if self.load_images:
            batch["images"] = _fancy_index(self._images, img_idx)  # u8 CHW
        if self.tags is not None:
            batch["tags"] = self.tags[img_idx]         # (B, tag_size)
        if self.split != "TRAIN":
            # all cpi captions of each image (datasets/caption.py:57-63)
            first = img_idx * self.cpi
            all_idx = first[:, None] + np.arange(self.cpi)[None, :]
            batch["allcaps"] = self.captions[all_idx]  # (B, cpi, L)
        return batch


class TagDataset:
    """One item per image: (image u8 CHW, tag multi-hot)."""

    def __init__(self, data_folder: str, data_name: str, split: str,
                 in_memory: Optional[bool] = None):
        import h5py

        if split not in SPLITS:
            raise ValueError(f"split {split!r} is not one of {SPLITS}")
        self.split = split
        img_path = _artifact(data_folder, split, "IMAGES", data_name, "hdf5")
        self._h = h5py.File(img_path, "r")
        self._images = self._h["images"]
        if in_memory is None:
            in_memory = self._images.nbytes <= IN_MEMORY_LIMIT
        if in_memory:
            self._images = self._images[...]
            self._h.close()
            self._h = None
        with h5py.File(_artifact(data_folder, split, "TAGS", data_name,
                                 "hdf5"), "r") as t:
            self.tags = t["tags"][...]
            self.tag_size = int(t.attrs["tag_size"])
        # Set False when batches don't need pixels (e.g. a device-resident
        # image store serves them by index, data/device_store.py).
        self.load_images = True

    @classmethod
    def from_arrays(cls, images: np.ndarray, tags: np.ndarray, *,
                    split: str = "TEST") -> "TagDataset":
        """The in-memory reader without the files: images (n, 3, S, S)
        uint8, tags (n, tag_size) multi-hot."""
        if split not in SPLITS:
            raise ValueError(f"split {split!r} is not one of {SPLITS}")
        images = np.asarray(images)
        tags = np.asarray(tags)
        if images.dtype != np.uint8 or images.ndim != 4:
            raise ValueError(f"images must be (n, 3, S, S) uint8, got "
                             f"{images.shape} {images.dtype}")
        if tags.ndim != 2 or tags.shape[0] != images.shape[0]:
            raise ValueError(f"tags {tags.shape} for {images.shape[0]} "
                             "images")
        ds = cls.__new__(cls)
        ds.split = split
        ds._h = None
        ds._images = images
        ds.tags = tags
        ds.tag_size = int(tags.shape[1])
        ds.load_images = True
        return ds

    def __len__(self) -> int:
        return self.tags.shape[0]

    @property
    def num_images(self) -> int:
        return self._images.shape[0]

    def image(self, img_idx: int) -> np.ndarray:
        return np.asarray(self._images[img_idx])

    def gather_images(self, img_idx: np.ndarray) -> np.ndarray:
        """Batch fetch of image rows (u8 CHW) by image index."""
        return _fancy_index(self._images, img_idx)

    def gather(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        batch = {"tags": self.tags[idx]}
        if self.load_images:
            batch["images"] = _fancy_index(self._images, idx)
        return batch
