"""The port's profiler (``core/profiling.py``) against the JAX package's
names, on the CPU: ``trace`` writes a Chrome trace holding an ``annotate``
region and the ops run inside it; ``StepTimer`` keeps JAX's summary keys
and waits only on CUDA results."""

import json
import os

import pytest
import torch

from indonesian_image_captioning_tpu.core import profiling as jax_profiling
from indonesian_image_captioning_tpu_torch.core import profiling

torch.set_num_threads(1)


def test_trace_writes_the_annotated_region(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir) as where:
        assert where == log_dir
        with profiling.annotate("train_step"):
            torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    path = os.path.join(log_dir, profiling.TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "train_step" in names
    assert any("mm" in str(n) for n in names)


def test_trace_defaults_under_the_temporary_directory(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    with profiling.trace() as where:
        torch.ones(2).sum()
    assert where == str(tmp_path / "iic_torch_trace")
    assert os.path.isfile(os.path.join(where, profiling.TRACE_FILE))


def test_step_timer_summary_matches_jax():
    ours, theirs = profiling.StepTimer(), jax_profiling.StepTimer()
    assert ours.summary() == theirs.summary() == {}
    for timer in (ours, theirs):
        for _ in range(5):
            timer.start()
            timer.stop({"loss": torch.ones(()), "parts": [torch.zeros(2)]})
    assert ours.summary().keys() == theirs.summary().keys()
    s = ours.summary()
    assert s["count"] == 5 and s["min_s"] <= s["p50_s"] <= s["max_s"]
    # identical times give JAX's order statistics
    ours.times = theirs.times = [0.3, 0.1, 0.2, 0.5, 0.4]
    assert ours.summary() == pytest.approx(theirs.summary())
    # CPU results need no device wait; CUDA devices are found in trees
    assert profiling._cuda_devices({"a": [torch.ones(1), (1, "x")]}) == set()
