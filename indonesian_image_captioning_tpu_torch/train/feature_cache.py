"""Frozen-encoder feature cache: run the two ResNet-152s once per image.

Counterpart of the JAX package's ``train/feature_cache.py``.  The caption
recipe freezes both the caption encoder and the tagger, and the frozen
encoders run in eval mode (deterministic BatchNorm), so their outputs are a
pure function of the image.  The reference still recomputes both forwards
for every caption row of every epoch (5 x epochs forwards per image at 5
captions per image); this cache computes them once, after which an epoch
is decoder work only.

Placement:
  * on the device when the cache fits ``TrainConfig.cache_device_budget_gb``:
    one preallocated tensor per output, written slice by slice with
    ``copy_``; a batch's rows are an ``index_select`` by caption index //
    captions_per_image;
  * host RAM otherwise: a dataset view adds the feature rows to every
    batch, and the loader's prefetch thread copies them to the device.

Exactness: with the default ``cache_dtype="float32"`` the cached rows are
``steps.make_encoders_fn``'s outputs, so cached training is what uncached
training computes (up to the convolution algorithm the library picks for
another batch composition); "bfloat16" halves the memory at one rounding.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.config import ModelConfig, TrainConfig
from . import steps

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class FeatureCache:
    """Per-unique-image encoder features + tagger semantics.

    ``lookup(index)`` maps device CAPTION indices to float32 (features,
    tags) rows; ``host_view(ds)`` wraps a dataset for the host-RAM path
    instead.
    """

    def __init__(self, feats, tags, cpi: int, on_device: bool):
        self.feats = feats
        self.tags = tags
        self.cpi = int(cpi)
        self.on_device = on_device

    @property
    def nbytes(self) -> int:
        if self.on_device:
            return sum(t.numel() * t.element_size()
                       for t in (self.feats, self.tags))
        return self.feats.nbytes + self.tags.nbytes

    def lookup(self, cap_index: torch.Tensor):
        """(B,) caption indices on the cache's device -> (features (B, S,
        S, E), tags (B, semantic)) float32."""
        if not self.on_device:
            raise RuntimeError("a host cache serves batches via host_view()")
        img = torch.div(cap_index.to(self.feats.device).long(), self.cpi,
                        rounding_mode="floor")
        return (self.feats.index_select(0, img).to(torch.float32),
                self.tags.index_select(0, img).to(torch.float32))

    def host_view(self, dataset) -> "HostFeatureView":
        if self.on_device:
            raise RuntimeError("a device cache serves batches via lookup()")
        return HostFeatureView(dataset, self.feats, self.tags)


class HostFeatureView:
    """Dataset view adding host-cached feature/tag rows to every batch
    (and dropping image pixels: the decoder never sees them)."""

    def __init__(self, ds, feats: np.ndarray, tags: np.ndarray):
        self._ds = ds
        self._feats = feats
        self._tags = tags
        ds.load_images = False

    def __len__(self) -> int:
        return len(self._ds)

    @property
    def cpi(self) -> int:
        return self._ds.cpi

    def gather(self, idx: np.ndarray):
        batch = self._ds.gather(idx)
        img = idx // self._ds.cpi
        batch["features"] = self._feats[img]
        batch["ftags"] = self._tags[img]
        return batch


def estimate_bytes(n_images: int, cfg: ModelConfig, dtype: str) -> int:
    itemsize = torch.empty((), dtype=_DTYPES[dtype]).element_size()
    per_img = (cfg.enc_image_size * cfg.enc_image_size * cfg.encoder_dim
               + cfg.semantic_dim) * itemsize
    return n_images * per_img


def build(state, cfg: ModelConfig, tcfg: TrainConfig, dataset, *,
          device, log=print, split: str = "", force_host: bool = False,
          batch_size: Optional[int] = None) -> FeatureCache:
    """Run the frozen encoders over every unique image of ``dataset``.

    Uses the encoders of uncached training (``steps.make_encoders_fn``
    with ``tcfg.encoder_dtype``) at ``batch_size`` (default: the training
    batch size) images per call.  The batches have one shape: when the
    split is not a multiple of it, the tail batch overlaps the one before
    (re-encoding a few rows beats a ragged last call)."""
    device = torch.device(device)
    if tcfg.cache_dtype not in _DTYPES:
        raise ValueError(f"unknown cache_dtype {tcfg.cache_dtype!r}")
    dtype = _DTYPES[tcfg.cache_dtype]
    n = dataset.num_images
    budget = int(tcfg.cache_device_budget_gb * (1 << 30))
    on_device = (not force_host
                 and estimate_bytes(n, cfg, tcfg.cache_dtype) <= budget)
    bs = batch_size or tcfg.batch_size
    encode = steps.make_encoders_fn(cfg, tcfg.encoder_dtype, device)
    P, E, S = cfg.enc_image_size, cfg.encoder_dim, cfg.semantic_dim

    if on_device:
        feats = torch.empty((n, P, P, E), dtype=dtype, device=device)
        tags = torch.empty((n, S), dtype=dtype, device=device)
    else:
        # numpy has no bfloat16: the host cache keeps the rounded values
        # in float32
        feats = np.zeros((n, P, P, E), np.float32)
        tags = np.zeros((n, S), np.float32)

    if n <= bs:
        starts = [0]
    else:
        starts = list(range(0, n - bs + 1, bs))
        if starts[-1] + bs < n:
            starts.append(n - bs)
    for s in starts:
        idx = np.arange(s, min(s + bs, n))
        imgs = dataset.gather_images(idx)
        if len(idx) < bs:  # only possible when n < bs
            pad = np.zeros((bs - len(idx),) + imgs.shape[1:], imgs.dtype)
            imgs = np.concatenate([imgs, pad])
        f_rows, t_rows = encode(state, {"images": imgs})
        f_rows, t_rows = f_rows[:len(idx)], t_rows[:len(idx)]
        if on_device:
            feats[s:s + len(idx)].copy_(f_rows)
            tags[s:s + len(idx)].copy_(t_rows)
        else:
            feats[idx] = f_rows.to(dtype).float().cpu().numpy()
            tags[idx] = t_rows.to(dtype).float().cpu().numpy()

    cache = FeatureCache(feats, tags, dataset.cpi, on_device)
    log(f"feature cache [{split or 'split'}]: {n} images, "
        f"{cache.nbytes / (1 << 20):.0f} MiB {tcfg.cache_dtype} "
        f"({'device' if on_device else 'host RAM'})")
    return cache
