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


def _devices(tree) -> set:
    found = set()

    def visit(t):
        if t.device.type == "cuda":
            found.add(t.device)
        return t

    _map_tensors(tree, visit)
    return found


class AsyncSaver:
    """Epoch checkpoints written off-thread: the trainer keeps stepping
    while the device-to-host copy and the file write run in the background.

    ``submit`` snapshots every tensor with ``.detach().clone()`` on its own
    device and returns at once; the train step updates the parameters and
    Adam's moments in place, so the next step cannot reach the snapshot.
    An event recorded after the clones orders them before the worker's
    copies to the host.  One worker thread writes, in submission order,
    so the last submitted state is what ends up on disk.

    Call ``wait()`` before reading checkpoints back or returning from the
    trainer; a worker's exception re-raises there (and on the next
    submit).  ``close()`` ends the worker.
    """

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._err = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                args, events = item
                for ev in events:
                    ev.synchronize()
                save_checkpoint(*args)
            except Exception as e:  # surfaced on wait() / the next submit
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, directory: str, model_name: str, data_name: str,
               state: Dict[str, Any], is_best: bool) -> None:
        self._raise_pending()
        snap = _snapshot(state)
        events = []
        for dev in _devices(snap):
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            events.append(ev)
        self._q.put(((directory, model_name, data_name, snap, is_best),
                     events))

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
