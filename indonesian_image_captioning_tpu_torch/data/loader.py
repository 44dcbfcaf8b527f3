"""Batch iteration and a device prefetch pipeline.

Counterpart of the JAX package's ``data/loader.py``.  :func:`batch_indices`,
:func:`iterate` and :func:`num_batches` are its numpy code as it is, so
the shuffle order, the padding and the ``valid`` masks equal JAX's for the
same seed and epoch:

  * deterministic per-epoch shuffling from a seeded numpy Generator;
  * fixed batch shapes: the final partial batch is padded and a per-row
    ``valid`` mask is attached (losses and metrics ignore padded rows).

:func:`prefetch_to_device` replaces ``jax.device_put`` in a thread: a
background thread gathers the next batches, copies them into pinned host
memory and sends them to the card with ``non_blocking=True`` on a copy
stream of its own; the consumer's stream waits on an event recorded after
each batch's copies.  Images travel as uint8 (4x less host-to-device
traffic than float32); normalisation runs on the device.

Under a data-parallel mesh each rank iterates its own block of every
global batch (``process_index`` / ``process_count``), as JAX's processes
do.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch


def batch_indices(n: int, batch_size: int, *, shuffle: bool, seed: int,
                  epoch: int, drop_last: bool = False):
    """Yield (idx array, valid count) per batch with fixed batch_size."""
    idx = np.arange(n)
    if shuffle:
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        rng.shuffle(idx)
    for start in range(0, n, batch_size):
        chunk = idx[start:start + batch_size]
        valid = len(chunk)
        if valid < batch_size:
            if drop_last:
                return
            pad = np.zeros(batch_size - valid, np.int64)
            chunk = np.concatenate([chunk, pad])
        yield chunk, valid


def iterate(dataset, batch_size: int, *, shuffle: bool = False, seed: int = 0,
            epoch: int = 0, drop_last: bool = False,
            process_index: int = 0, process_count: int = 1,
            with_index: bool = False
            ) -> Iterator[Dict[str, np.ndarray]]:
    """Host-side batch iterator over a dataset with .gather(idx).

    with_index adds each row's dataset index ("index", int32; padding rows
    repeat index 0 and are masked by valid and caplens downstream), so a
    device-resident cache or store can gather its rows by lookup.

    Data-parallel runs: with process_count > 1 each rank gathers only its
    contiguous 1/process_count block of every GLOBAL batch (rank
    process_index of the mesh's data axis, ``core/meshes.process_data_slice``).
    The shuffle order, the padding and the ``valid`` masks are computed
    globally, the same on every rank, so the ranks' blocks put together
    are the one-process batch."""
    if batch_size % process_count:
        raise ValueError(f"batch_size {batch_size} must be divisible by "
                         f"process_count {process_count}")
    local = batch_size // process_count
    lo, hi = process_index * local, (process_index + 1) * local
    for chunk, valid in batch_indices(len(dataset), batch_size,
                                      shuffle=shuffle, seed=seed, epoch=epoch,
                                      drop_last=drop_last):
        batch = dataset.gather(chunk[lo:hi])
        if with_index:
            batch["index"] = chunk[lo:hi].astype(np.int32)
        mask = np.zeros(batch_size, np.float32)
        mask[:valid] = 1.0
        batch["valid"] = mask[lo:hi]
        if valid < hi and "caplens" in batch:
            # zero caplens on padding rows -> zero token mask downstream
            batch["caplens"] = batch["caplens"].copy()
            batch["caplens"][max(valid - lo, 0):] = 0
        yield batch


def _to_tensors(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def prefetch_to_device(iterator, device, size: int = 2):
    """Wrap a host batch iterator with a background copy to ``device``.

    Yields dicts of tensors on ``device``.  On the CPU the tensors share
    the numpy batches' memory.  On CUDA a worker thread pins each batch
    and copies it on a stream of its own with ``non_blocking=True``; the
    consumer's current stream waits on the batch's event before the
    batch is handed over, and each tensor is marked as used by that
    stream, so the allocator does not reuse its memory early."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()
    err: list = []
    stop = threading.Event()
    on_card = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if on_card else None

    def put(batch):
        tensors = _to_tensors(batch)
        if not on_card:
            return tensors, None
        with torch.cuda.device(device), torch.cuda.stream(copy_stream):
            out = {k: v.pin_memory().to(device, non_blocking=True)
                   for k, v in tensors.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    def worker():
        try:
            for batch in iterator:
                item = put(batch)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except Exception as e:  # propagate into the consumer thread
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            out, done = item
            if done is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(done)
                for v in out.values():
                    v.record_stream(consumer)
            yield out
    finally:
        # a consumer that stops early (break, exception) releases the worker
        stop.set()
        while t.is_alive():
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
        t.join()


def num_batches(n: int, batch_size: int, drop_last: bool = False) -> int:
    return n // batch_size if drop_last else -(-n // batch_size)
