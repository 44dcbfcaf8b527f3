"""Micro-batching caption server over the port's decode path.

Counterpart of the JAX package's ``serve/engine.py``:

* an incoming batch is padded to the smallest bucket that holds it, so the
  device sees a fixed set of batch shapes (``warmup`` runs each once);
* the pipeline (uint8 -> normalize -> tagger -> encoder -> beam) runs as
  eager calls on the engine's device, on the current CUDA stream; the beam
  picks its rung per shape (``decode/api.resolve_decode_impl``);
* the async front is a queue and a worker thread: requests are coalesced
  up to the largest bucket or until ``max_wait_ms`` has passed since the
  oldest queued one; a batch that fails fails only its own requests.

In the JAX package ``max_inflight`` overlaps the host's coalescing with the
device's work, because JAX dispatch is asynchronous.  The port's beam loop
reads ``alive_count`` on the host every step, so a dispatched batch has
mostly finished when its call returns; the option is kept with the same
meaning (batches dispatched before the oldest one's results are fetched).
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.config import BeamConfig, ModelConfig
from ..core.runtime import get_device
from ..decode.api import caption_beam_search
from ..models import encoders

PAD_ID = 0          # the padding token's id in every wordmap


@dataclass(frozen=True)
class ServeConfig:
    """Engine knobs.  Buckets must be ascending; requests above the
    largest bucket are split across calls."""

    batch_buckets: tuple = (1, 8, 32, 128)
    max_wait_ms: float = 2.0
    beam_size: int = 5
    # None -> BeamConfig's default (51), the reference cap.
    max_steps: Optional[int] = None
    # Batches dispatched before the oldest one's results are fetched.
    max_inflight: int = 2


@dataclass
class ServeStats:
    """Batch sizes, and the decode rung and step count of each call."""

    batches: List[int] = field(default_factory=list)
    decode_impls: List[str] = field(default_factory=list)
    decode_steps: List[int] = field(default_factory=list)

    def record(self, n: int) -> None:
        self.batches.append(n)

    def clear(self) -> None:
        self.batches.clear()
        self.decode_impls.clear()
        self.decode_steps.clear()


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return None if tree is None else tree.to(device)


class CaptionEngine:
    """Batched image -> caption serving engine.

    state: the inference-state dict (keys params / encoder / encoder_stats
        and, for tag-using models, tagger / tagger_stats), trees of tensors.
    word_map: token -> id dict (WORDMAP artifact).
    device: a device name for ``core.runtime.get_device`` or a
        ``torch.device``; "cuda" without a CUDA device raises.
    """

    def __init__(self, state: Dict, cfg: ModelConfig,
                 word_map: Dict[str, int],
                 serve_cfg: ServeConfig = ServeConfig(), device="auto"):
        if list(serve_cfg.batch_buckets) != sorted(
                set(serve_cfg.batch_buckets)):
            raise ValueError("batch_buckets must be ascending and unique")
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        self.word_map = word_map
        self.rev_word_map = {i: w for w, i in word_map.items()}
        self.start_id = word_map["<start>"]
        self.end_id = word_map["<end>"]
        self.device = (device if isinstance(device, torch.device)
                       else get_device(device))
        self.state = _to_device(state, self.device)
        self.stats = ServeStats()
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        if serve_cfg.max_steps is None:
            self.beam_cfg = BeamConfig(beam_size=serve_cfg.beam_size)
        else:
            self.beam_cfg = BeamConfig(beam_size=serve_cfg.beam_size,
                                       max_steps=serve_cfg.max_steps)

    def _pipeline(self, images_u8: np.ndarray):
        """(B, 3, H, W) uint8 -> (sequences, lengths) on the device."""
        cfg, st = self.cfg, self.state
        with torch.inference_mode():
            x = encoders.prep_images(
                torch.from_numpy(images_u8).to(self.device))
            if cfg.dtype == "bfloat16":
                x = x.to(torch.bfloat16)
            if cfg.uses_tags:
                tags = encoders.apply_encoder_tagger(
                    st["tagger"], st["tagger_stats"], x, train=False,
                    arch=cfg.encoder_arch)[0]
            else:
                tags = torch.zeros((x.shape[0], cfg.semantic_dim),
                                   dtype=x.dtype, device=x.device)
            enc = encoders.apply_encoder_caption(
                st["encoder"], st["encoder_stats"], x, train=False,
                enc_image_size=cfg.enc_image_size, arch=cfg.encoder_arch)[0]
            out = caption_beam_search(
                st["params"], cfg, enc.to(x.dtype), tags.to(x.dtype),
                start_id=self.start_id, end_id=self.end_id,
                beam_cfg=self.beam_cfg)
        self.stats.decode_impls.append(out["decode_impl"])
        self.stats.decode_steps.append(out["steps"])
        return out["sequences"], out["lengths"]

    # ------------------------------------------------------------------
    # synchronous path
    # ------------------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.serve_cfg.batch_buckets:
            if n <= b:
                return b
        return self.serve_cfg.batch_buckets[-1]

    def _pad(self, images: np.ndarray) -> np.ndarray:
        bucket = self._bucket_for(images.shape[0])
        if images.shape[0] == bucket:
            return images
        pad = np.zeros((bucket - images.shape[0],) + images.shape[1:],
                       images.dtype)
        return np.concatenate([images, pad], 0)

    def _detokenize(self, seq: Sequence[int]) -> str:
        skip = (self.start_id, self.end_id, PAD_ID)
        return " ".join(self.rev_word_map[int(w)] for w in seq
                        if int(w) not in skip)

    def caption_batch(self, images_u8: np.ndarray) -> List[str]:
        """(B, 3, H, W) uint8 -> B caption strings (any B >= 1)."""
        images_u8 = np.asarray(images_u8)
        if images_u8.ndim != 4:
            raise ValueError("expected (B, 3, H, W) uint8 batch")
        captions: List[str] = []
        max_b = self.serve_cfg.batch_buckets[-1]
        for lo in range(0, images_u8.shape[0], max_b):
            chunk = images_u8[lo:lo + max_b]
            seqs, lens = self._pipeline(self._pad(chunk))
            seqs, lens = seqs.cpu().numpy(), lens.cpu().numpy()
            self.stats.record(int(chunk.shape[0]))
            for i in range(chunk.shape[0]):
                captions.append(self._detokenize(seqs[i][:lens[i]]))
        return captions

    def warmup(self, image_size: int = 256) -> None:
        """Run every bucket once at the deployment's image size."""
        for b in self.serve_cfg.batch_buckets:
            self.caption_batch(
                np.zeros((b, 3, image_size, image_size), np.uint8))
        self.stats.clear()

    # ------------------------------------------------------------------
    # async micro-batching front
    # ------------------------------------------------------------------

    def start(self) -> None:
        if self._worker is not None:
            return
        self._stop.clear()
        self._worker = threading.Thread(target=self._serve_loop, daemon=True)
        self._worker.start()

    def stop(self) -> None:
        if self._worker is None:
            return
        self._stop.set()
        self._worker.join()
        self._worker = None
        # Fail anything still queued so no caller blocks forever.
        while True:
            try:
                _, fut = self._queue.get_nowait()
            except queue.Empty:
                break
            if fut.set_running_or_notify_cancel():
                fut.set_exception(RuntimeError("engine stopped"))

    def submit(self, image_u8: np.ndarray) -> "Future[str]":
        """Enqueue one (3, H, W) uint8 image; resolves to its caption."""
        if self._worker is None:
            raise RuntimeError("engine not started (call start())")
        image_u8 = np.asarray(image_u8)
        if image_u8.ndim != 3 or image_u8.shape[0] != 3:
            raise ValueError(
                f"expected a (3, H, W) image, got shape {image_u8.shape}")
        fut: "Future[str]" = Future()
        self._queue.put((image_u8, fut))
        return fut

    def _serve_loop(self) -> None:
        max_b = self.serve_cfg.batch_buckets[-1]
        wait_s = self.serve_cfg.max_wait_ms / 1e3
        depth = max(int(self.serve_cfg.max_inflight), 1)
        inflight: "collections.deque" = collections.deque()

        def resolve_oldest():
            live, seqs, lens = inflight.popleft()
            try:
                seqs, lens = seqs.cpu().numpy(), lens.cpu().numpy()
            except Exception as e:       # a device fault fails its batch
                for _, fut in live:
                    fut.set_exception(e)
                return
            for i, (_, fut) in enumerate(live):
                fut.set_result(self._detokenize(seqs[i][:lens[i]]))

        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.002 if inflight else 0.05)
            except queue.Empty:
                if inflight:
                    resolve_oldest()
                continue
            batch = [first]
            deadline = time.monotonic() + wait_s
            while len(batch) < max_b:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    try:            # drain anything already queued
                        batch.append(self._queue.get_nowait())
                        continue
                    except queue.Empty:
                        break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            # Skip requests cancelled while queued.
            live = [(img, fut) for img, fut in batch
                    if fut.set_running_or_notify_cancel()]
            if not live:
                continue
            try:
                images = np.stack([img for img, _ in live])
                seqs, lens = self._pipeline(self._pad(images))
            except Exception as e:   # fail every request in the batch
                for _, fut in live:
                    fut.set_exception(e)
                continue
            self.stats.record(len(live))
            inflight.append((live, seqs, lens))
            while len(inflight) >= depth:
                resolve_oldest()
        while inflight:              # stop(): land everything in flight
            resolve_oldest()
