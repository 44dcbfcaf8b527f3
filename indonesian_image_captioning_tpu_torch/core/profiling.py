"""Profiling and step timing.

Counterpart of the JAX package's ``core/profiling.py``, with the same names:

* :func:`trace` runs a block under ``torch.profiler`` (CPU activity, and
  CUDA activity when a card is present) and exports a Chrome trace
  (chrome://tracing, Perfetto) into ``log_dir``;
* :func:`annotate` names a region of that trace
  (``torch.profiler.record_function``), and costs one check of whether a
  profiler runs when none does;
* :class:`StepTimer` times steps on the host clock and, like JAX's, waits
  for the device before it reads the clock: ``stop(result)`` synchronises
  each CUDA device that holds a tensor of ``result``.

The reference's own instrumentation, wall-clock AverageMeters printed
every print_freq batches, is ``train/loop.EpochPrinter``.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict, List, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile a block and write ``log_dir/trace.json`` (default: the
    ``iic_torch_trace`` folder under the temporary directory)::

        with profiling.trace("trace_dir"):
            step(state, batch)

    Yields ``log_dir``, as JAX's does."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "iic_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A named region that shows up in the trace's timeline: a context
    manager, ``torch.profiler.record_function(name)`` while a
    ``torch.profiler`` profile runs in the process, and else a shared
    no-op that enters nothing.  A profile records the regions of the
    threads it profiles: the one that started it and its autograd
    backward's, or every thread under ``profile_all_threads``.  The
    port's own regions are named ``iic.<layer>.<part>``.

    Whether a profile runs is torch's flag
    ``torch.autograd.profiler._is_profiler_enabled``, which only the
    Python-side profilers set (``torch.profiler.profile``,
    ``torch.autograd.profiler.profile``, ``emit_nvtx``, ``emit_itt``).
    A trace that starts elsewhere -- Kineto's on-demand trace from its
    daemon, or ``torch._C._enable_profiler`` called directly -- records
    no region of the port's, and nothing warns of it."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def _cuda_devices(result) -> set:
    if torch.is_tensor(result):
        return {result.device} if result.is_cuda else set()
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        return set().union(*(_cuda_devices(x) for x in result))
    return set()


class StepTimer:
    """Host-clock step timer that waits for the device results."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.time()

    def stop(self, result=None) -> float:
        """Seconds since :meth:`start`, after the CUDA devices holding a
        tensor of ``result`` (a tensor, or dicts, lists and tuples of them)
        have finished their queued work."""
        for dev in _cuda_devices(result):
            torch.cuda.synchronize(dev)
        dt = time.time() - self._t0
        self.times.append(dt)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        n = len(ts)
        return {
            "mean_s": sum(ts) / n,
            "p50_s": ts[n // 2],
            "p90_s": ts[min(int(n * 0.9), n - 1)],
            "min_s": ts[0],
            "max_s": ts[-1],
            "count": n,
        }
