"""Checkpoints: one ``torch.save`` file per checkpoint, with best-copy
semantics.

Counterpart of the JAX package's ``core/checkpoint.py`` (an orbax
directory per checkpoint there).  The reference's naming holds
(utils/checkpoint.py:28-31): ``checkpoint_{model}_{data}``, and a
``BEST_checkpoint_{model}_{data}`` copy when the validation metric
improves.  A payload is a nested dict of tensors, numbers, strings and
lists; the caption trainer's is

    {"state": {"params", "opt_state" (Adam's state_dict), "encoder",
               "encoder_stats", "tagger", "tagger_stats"},
     "epoch": int, "epochs_since_improvement": int, "metric": float}

Tensors are written from the CPU and loaded onto the CPU; the caller
moves them where they belong.  Loading uses ``weights_only=True``: only
tensors and plain containers are unpickled.
"""

from __future__ import annotations

import os
import queue
import shutil
import threading
import time
from typing import Any, Dict

import torch


def _ckpt_name(model_name: str, data_name: str) -> str:
    return f"checkpoint_{model_name}_{data_name}"


def _map_tensors(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return fn(tree) if torch.is_tensor(tree) else tree


def save_pytree(path: str, tree) -> None:
    """Write ``tree`` to ``path`` (a file), whole or not at all: written to
    a temporary name, then renamed over the old one."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(_map_tensors(tree, lambda t: t.detach().cpu()), tmp)
    os.replace(tmp, path)


def load_pytree(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def save_checkpoint(directory: str, model_name: str, data_name: str,
                    state: Dict[str, Any], is_best: bool) -> str:
    """Save ``state`` under the reference naming scheme; copy it to BEST_*
    on improvement (utils/checkpoint.py:4-31 semantics)."""
    name = _ckpt_name(model_name, data_name)
    path = os.path.abspath(os.path.join(directory, name))
    save_pytree(path, state)
    if is_best:
        best = os.path.abspath(os.path.join(directory, "BEST_" + name))
        tmp = f"{best}.tmp"
        shutil.copyfile(path, tmp)
        os.replace(tmp, best)
        return best
    return path


def load_checkpoint(directory: str, model_name: str, data_name: str,
                    best: bool = False):
    name = _ckpt_name(model_name, data_name)
    if best:
        name = "BEST_" + name
    return load_pytree(os.path.abspath(os.path.join(directory, name)))


def _snapshot(tree):
    """A copy of every tensor of ``tree`` on its own device."""
    return _map_tensors(tree, lambda t: t.detach().clone())


def _to_host(tree, stream):
    """(tree with every CUDA tensor copied to pinned host memory on
    ``stream``, bytes copied); returns once the copies are done."""
    nbytes = 0

    def copy(t):
        nonlocal nbytes
        if not t.is_cuda:
            return t
        nbytes += t.numel() * t.element_size()
        with torch.cuda.stream(stream):
            return t.to("cpu", non_blocking=True)

    host = _map_tensors(tree, copy)
    if nbytes:
        stream.synchronize()
    return host, nbytes


def _cuda_device(tree):
    """The CUDA device of ``tree``'s tensors (a checkpoint lies on one),
    or None."""
    found = []
    _map_tensors(tree, lambda t: found.append(t.device) if t.is_cuda
                 else None)
    return found[0] if found else None


class AsyncSaver:
    """Epoch checkpoints written off-thread: the trainer keeps stepping
    while the device-to-host copy and the file write run in the background.

    ``submit`` snapshots every tensor with ``.detach().clone()`` on its own
    device and returns at once; the train step updates the parameters and
    Adam's moments in place, so the next step cannot reach the snapshot.
    An event recorded after the clones orders them before the worker's
    copies to the host.  The worker copies on one CUDA stream of the
    saver's own, made at the first save on a card, into pinned host
    memory: a copy on the default stream would wait for the training
    kernels queued there, and hold up those queued after it.  One worker
    thread writes, in submission order, so the last submitted state is
    what ends up on disk.  A checkpoint's tensors lie on one device.

    The worker drops each snapshot and its host copy once the file is
    written.  The pinned memory comes from PyTorch's caching host
    allocator, which keeps it after the save and reuses it for the next:
    the process holds one checkpoint's tensor bytes pinned (each save's
    "bytes" below, rounded up block by block) until it ends.

    Call ``wait()`` before reading checkpoints back or returning from the
    trainer; a worker's exception re-raises there (and on the next
    submit).  ``close()`` ends the worker.

    ``timings`` lists each written save's host seconds in three parts:
    "wait" for the snapshot's clones, "copy" the device-to-host copy and
    "write" the file (``torch.save`` and the BEST copy), with its "bytes".
    """

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._err = None
        self._stream = None
        self.timings = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                self._write(*item)
            except Exception as e:  # surfaced on wait() / the next submit
                self._err = e
            finally:
                item = None     # the snapshot goes before the next wait
                self._q.task_done()

    def _write(self, job, event):
        directory, model, data, snap, is_best = job
        t0 = time.perf_counter()
        if event is not None:
            event.synchronize()
        t1 = time.perf_counter()
        host, nbytes = _to_host(snap, self._stream)
        t2 = time.perf_counter()
        save_checkpoint(directory, model, data, host, is_best)
        self.timings.append({"wait": t1 - t0, "copy": t2 - t1,
                             "write": time.perf_counter() - t2,
                             "bytes": nbytes})

    def submit(self, directory: str, model_name: str, data_name: str,
               state: Dict[str, Any], is_best: bool) -> None:
        self._raise_pending()
        snap = _snapshot(state)
        dev, event = _cuda_device(snap), None
        if dev is not None:
            if self._stream is None:
                self._stream = torch.cuda.Stream(dev)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        self._q.put(((directory, model_name, data_name, snap, is_best),
                     event))

    def wait(self) -> None:
        """Block until every submitted save has been written."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()

    def _raise_pending(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err


def trainer_saver(tcfg, mesh, model_name: str, data_name: str, state_fn):
    """(the async saver or None, save(epoch, stale, metric, is_best)) of a
    trainer: the checkpoint holds ``state_fn()``, the epoch counters and
    the metric.  Saves are asynchronous under ``tcfg.async_checkpoint`` in
    a single process.  Under a multi-rank mesh (``core/meshes.py``) rank
    0 alone writes, synchronously (JAX saves asynchronously only in a
    single process), and every rank waits for the write before the next
    epoch.  On a model axis the ranks of rank 0's data row first gather
    the vocabulary blocks over their model group
    (``parallel/sharding.gather_payload``), so the file is the one-rank
    format."""
    from . import meshes
    multi = mesh is not None and mesh.size > 1
    saver = AsyncSaver() if tcfg.async_checkpoint and not multi else None
    writer = not multi or meshes.world()[0] == 0
    gathers = multi and meshes.model_size(mesh) > 1 and mesh.data_index == 0

    def save(epoch: int, stale_now: int, metric: float, is_best: bool):
        state = None
        if gathers:
            from ..parallel.sharding import gather_payload
            state = gather_payload(mesh, state_fn())
        if writer:
            payload = {"state": state_fn() if state is None else state,
                       "epoch": epoch,
                       "epochs_since_improvement": stale_now,
                       "metric": metric}
            if saver is not None:
                saver.submit(tcfg.checkpoint_dir, model_name, data_name,
                             payload, is_best)
            else:
                save_checkpoint(tcfg.checkpoint_dir, model_name, data_name,
                                payload, is_best)
        if multi:
            meshes.barrier(mesh)

    return saver, save
