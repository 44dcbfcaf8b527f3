"""The port's own trace regions (``core/profiling.annotate``), on the CPU.

Under ``profiling.trace`` the span decode, the serving engine and the
caption train step name their parts as ``iic.*`` regions of the Chrome
trace: one ``iic.decode.span`` a kernel call, the engine's parts nested
under ``iic.serve.batch``, the train scan and head in both the forward and
the backward.  With no profiler running, ``annotate`` enters nothing.
``chip_smoke.kernel_times`` leaves the regions' own device events out of
the kernels' time."""

import dataclasses
import json
import os
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from indonesian_image_captioning_tpu_torch.core import profiling
from indonesian_image_captioning_tpu_torch.core.config import (
    BeamConfig, ModelConfig, TaggerConfig, TrainConfig)
from indonesian_image_captioning_tpu_torch.decode.api import \
    caption_beam_search
from indonesian_image_captioning_tpu_torch.models import decoders, encoders
from indonesian_image_captioning_tpu_torch.serve import (CaptionEngine,
                                                         ServeConfig)
from indonesian_image_captioning_tpu_torch.train import steps
from _torch_tmp import tmp_path  # noqa: F401 (fixtures)

torch.set_num_threads(1)

V = 24
CFG = ModelConfig(model_type="attention_scn", vocab_size=V, embed_dim=16,
                  attention_dim=16, decoder_dim=16, factored_dim=8,
                  semantic_dim=8, enc_image_size=1, max_caption_len=10,
                  encoder_arch="resnet50", dropout=0.0)


def _regions(log_dir):
    """[(name, start us, end us)] of the trace's iic.* host regions."""
    with open(os.path.join(log_dir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith("iic.")]


def _named(regions, name):
    return [r for r in regions if r[0] == name]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.fixture
def spy(monkeypatch):
    """[(name, thread id)] of every record_function entered."""
    real, seen = torch.profiler.record_function, []

    def record(name, args=None):
        seen.append((name, threading.get_ident()))
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", record)
    return seen


def test_span_decode_names_prepare_each_span_sync_and_replay(tmp_path):
    gen = torch.Generator().manual_seed(0)
    params = decoders.init_decoder(gen, CFG)
    enc = torch.randn((3, 4, CFG.encoder_dim), generator=gen) * 0.1
    tags = torch.rand((3, CFG.semantic_dim), generator=gen)
    cfg = dataclasses.replace(CFG, decode_impl="fused_span", decode_span=3)
    with profiling.trace(str(tmp_path)) as log_dir:
        out = caption_beam_search(params, cfg, enc, tags, start_id=V - 2,
                                  end_id=V - 1,
                                  beam_cfg=BeamConfig(beam_size=3,
                                                      max_steps=9))
    assert out["decode_impl"] == "fused_span"
    regions = _regions(log_dir)
    (decode,) = _named(regions, "iic.decode")
    spans = _named(regions, "iic.decode.span")
    syncs = _named(regions, "iic.decode.sync")
    assert len(spans) == out["decode_calls"] >= 1
    # a read of the live lanes before every call but the first, and one
    # more where the decode stops early
    assert len(syncs) in (len(spans) - 1, len(spans))
    if len(spans) > 1:
        assert syncs
    assert len(_named(regions, "iic.decode.prepare")) == 1
    assert len(_named(regions, "iic.decode.replay")) == 1
    for r in regions:
        assert _inside(r, decode), r
    # the regions follow one another: prepare, span, (sync, span)*, replay
    order = [r[0] for r in sorted(regions, key=lambda r: r[1])
             if r[0] != "iic.decode"]
    assert order[0] == "iic.decode.prepare"
    assert order[-1] == "iic.decode.replay"
    assert order[1] == "iic.decode.span"


def _engine(buckets=(1, 4)):
    gen = torch.Generator().manual_seed(1)
    params = decoders.init_decoder(gen, CFG)
    enc_p, enc_s = encoders.init_encoder_caption(gen, arch="resnet50")
    tag_p, tag_s = encoders.init_encoder_tagger(
        gen, TaggerConfig(semantic_size=CFG.semantic_dim), arch="resnet50")
    images = np.random.default_rng(3).integers(
        0, 256, size=(3, 3, 32, 32), dtype=np.uint8)
    x = encoders.prep_images(torch.from_numpy(images))
    with torch.no_grad():
        _, enc_s = encoders.apply_encoder_caption(
            enc_p, enc_s, x, train="calibrate", enc_image_size=1,
            arch="resnet50")
        _, tag_s = encoders.apply_encoder_tagger(
            tag_p, tag_s, x, train="calibrate", arch="resnet50")
    word_map = {"<pad>": 0, **{f"w{i}": i for i in range(1, V - 3)},
                "<unk>": V - 3, "<start>": V - 2, "<end>": V - 1}
    state = {"params": params, "encoder": enc_p, "encoder_stats": enc_s,
             "tagger": tag_p, "tagger_stats": tag_s}
    eng = CaptionEngine(state, CFG, word_map,
                        ServeConfig(batch_buckets=buckets, beam_size=2,
                                    max_steps=5), device="cpu")
    return eng, images


def test_engine_nests_its_parts_under_the_batch(tmp_path):
    eng, images = _engine()
    with profiling.trace(str(tmp_path)) as log_dir:
        caps = eng.caption_batch(images)
    assert len(caps) == 3
    regions = _regions(log_dir)
    (batch,) = _named(regions, "iic.serve.batch")
    for name in ("iic.serve.prep", "iic.serve.tagger", "iic.serve.encoder",
                 "iic.decode"):
        (r,) = _named(regions, name)
        assert _inside(r, batch), name
    # the copy home and the strings come after the batch's pipeline
    for name in ("iic.serve.fetch", "iic.serve.detokenize"):
        (r,) = _named(regions, name)
        assert r[1] >= batch[2], name


def test_async_front_ties_coalesce_and_batch_by_number(spy):
    """The worker thread's regions, under a profile of every thread: the
    n-th batch's pipeline follows the n-th coalesce, on the thread that
    formed it."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    eng, images = _engine(buckets=(1, 2))
    eng.start()
    worker = eng._worker.ident
    try:
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)):
            futs = [eng.submit(img) for img in images[:2]]
            texts = [f.result(timeout=120) for f in futs]
    finally:
        eng.stop()
    assert all(isinstance(t, str) for t in texts)
    front = [(n, t) for n, t in spy
             if n in ("iic.serve.coalesce", "iic.serve.batch")]
    assert front and len(front) % 2 == 0
    for i in range(0, len(front), 2):
        assert [n for n, _ in front[i:i + 2]] == ["iic.serve.coalesce",
                                                  "iic.serve.batch"]
        assert front[i][1] == front[i + 1][1] == worker


def test_train_step_names_scan_head_backward_and_optimizer(tmp_path):
    gen = torch.Generator().manual_seed(2)
    cfg = dataclasses.replace(CFG, train_scan_impl="fused")
    params = decoders.init_decoder(gen, cfg)
    opt = steps.make_optimizer(1e-3, 5.0)
    tcfg = TrainConfig(batch_size=2, head_impl="chunked", head_tile=8,
                       decoder_dtype="bfloat16")
    _, step = steps.make_caption_train_step(cfg, tcfg, opt, device="cpu")
    sub = {"params": params, "opt_state": opt.init(params)}
    enc = torch.randn((2, 4, cfg.encoder_dim), generator=gen) * 0.1
    tags = torch.rand((2, cfg.semantic_dim), generator=gen)
    caps = torch.randint(1, V - 3, (2, cfg.max_caption_len), generator=gen)
    lens = torch.tensor([5, 8])
    with profiling.trace(str(tmp_path)) as log_dir:
        _, metrics = step(sub, enc, tags, caps, lens)
    assert bool(torch.isfinite(metrics["loss"]))
    regions = _regions(log_dir)
    (whole,) = _named(regions, "iic.train.step")
    (backward,) = _named(regions, "iic.train.backward")
    for r in regions:
        assert _inside(r, whole), r
    assert len(_named(regions, "iic.train.cast")) == 1
    # the scan and the head: once in the forward, once in the backward
    for name in ("iic.train.scan", "iic.train.head"):
        forward, back = sorted(_named(regions, name), key=lambda r: r[1])
        assert forward[2] <= backward[1], name
        assert _inside(back, backward), name
    # the gradients' reset before the forward, the clamp and Adam after
    # the backward
    reset, update = sorted(_named(regions, "iic.train.optimizer"),
                           key=lambda r: r[1])
    assert reset[2] <= backward[1] and update[1] >= backward[2]


def test_annotate_enters_nothing_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    with profiling.annotate("iic.decode"):
        with profiling.annotate("iic.serve.batch"):
            x = torch.ones(2) + 1
    assert float(x.sum()) == 4.0
    # one shared no-op, whatever the name
    assert profiling.annotate("iic.a") is profiling.annotate("iic.b")


def test_annotate_reads_torchs_profiler_flag(tmp_path):
    """annotate's one check is torch's private flag: this fails, instead
    of the regions going silent, if a torch release renames or drops it
    or stops setting it for torch.profiler.profile."""
    import torch.autograd.profiler as autograd_profiler

    assert autograd_profiler._is_profiler_enabled is False
    with profiling.trace(str(tmp_path)):
        assert autograd_profiler._is_profiler_enabled is True
        region = profiling.annotate("iic.decode")
        assert isinstance(region, torch.profiler.record_function)
    assert autograd_profiler._is_profiler_enabled is False
    assert profiling.annotate("iic.decode") is profiling.annotate("iic.b")


def _chip_smoke():
    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    import chip_smoke
    return chip_smoke


def test_kernel_times_leaves_out_the_regions_device_spans():
    """A CUDA profile gives each region a device event under its host
    name, spanning its kernels: chip_smoke's breakdowns sum the kernels
    and copies only."""
    from torch.autograd import DeviceType

    def ev(key, device_type, us):
        return SimpleNamespace(key=key, device_type=device_type,
                               self_device_time_total=us)

    avgs = [ev("iic.decode", DeviceType.CPU, 0.0),
            ev("iic.decode.span", DeviceType.CPU, 0.0),
            ev("aten::mm", DeviceType.CPU, 0.0),
            ev("iic.decode", DeviceType.CUDA, 900.0),
            ev("iic.decode.span", DeviceType.CUDA, 800.0),
            ev("void iic::span_kernel<float>(...)", DeviceType.CUDA, 500.0),
            ev("Memcpy DtoH (Device -> Pinned)", DeviceType.CUDA, 20.0)]
    prof = SimpleNamespace(key_averages=lambda: avgs)
    assert sorted(_chip_smoke().kernel_times(prof)) == [
        (20.0, "Memcpy DtoH (Device -> Pinned)"),
        (500.0, "void iic::span_kernel<float>(...)")]
