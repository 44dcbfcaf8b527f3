"""The port's caption server against the JAX package, on the CPU.

ResNet-50 encoders on 64-pixel images and a tiny attention_scn decoder,
initialised in JAX and moved with ``params_from_jax``; the port's encoders
calibrate their BatchNorm statistics on the test images (random-init
eval-mode features are about 1e10), and the JAX engine gets the same
statistics back through ``params_to_jax``.  Captions compare exactly.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from indonesian_image_captioning_tpu.core.config import (ModelConfig,
                                                         TaggerConfig)
from indonesian_image_captioning_tpu.models import decoders as jax_decoders
from indonesian_image_captioning_tpu.models import encoders as jax_encoders
from indonesian_image_captioning_tpu.serve import CaptionEngine as JaxEngine
from indonesian_image_captioning_tpu.serve import ServeConfig as JaxServeConfig
from indonesian_image_captioning_tpu_torch.core.runtime import get_device
from indonesian_image_captioning_tpu_torch.models import encoders
from indonesian_image_captioning_tpu_torch.models.jax_bridge import (
    params_from_jax, params_to_jax)
from indonesian_image_captioning_tpu_torch.ops.attention_cuda import \
    attend_fused
from indonesian_image_captioning_tpu_torch.serve import (CaptionEngine,
                                                         ServeConfig)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def _tiny_word_map(vocab=40):
    wm = {"<pad>": 0}
    for i in range(1, vocab - 3):
        wm[f"w{i}"] = i
    wm["<unk>"], wm["<start>"], wm["<end>"] = vocab - 3, vocab - 2, vocab - 1
    return wm


@pytest.fixture(scope="module")
def engine_parts():
    cfg = ModelConfig(model_type="attention_scn", vocab_size=40,
                      embed_dim=16, attention_dim=16, decoder_dim=16,
                      factored_dim=8, semantic_dim=8, enc_image_size=2,
                      max_caption_len=10, encoder_arch="resnet50")
    images = np.random.default_rng(3).integers(
        0, 256, size=(5, 3, 64, 64), dtype=np.uint8)
    params = jax_decoders.init_decoder(jax.random.key(0), cfg)
    enc_p, enc_s = jax_encoders.init_encoder_caption(jax.random.key(1),
                                                     arch="resnet50")
    tag_p, tag_s = jax_encoders.init_encoder_tagger(
        jax.random.key(2), TaggerConfig(semantic_size=cfg.semantic_dim),
        arch="resnet50")
    state = {k: params_from_jax(v) for k, v in (
        ("params", params), ("encoder", enc_p), ("encoder_stats", enc_s),
        ("tagger", tag_p), ("tagger_stats", tag_s))}
    x = encoders.prep_images(torch.from_numpy(images))
    for name, apply in (("encoder", encoders.apply_encoder_caption),
                        ("tagger", encoders.apply_encoder_tagger)):
        _, state[name + "_stats"] = apply(
            state[name], state[name + "_stats"], x, train="calibrate",
            arch="resnet50")
    return cfg, state, _tiny_word_map(), images


def test_batched_matches_single_image_and_jax_engine(engine_parts):
    cfg, state, wm, images = engine_parts
    eng = CaptionEngine(state, cfg, wm,
                        ServeConfig(batch_buckets=(1, 2, 8), beam_size=3),
                        device="cpu")
    singles = [eng.caption_batch(images[i:i + 1])[0] for i in range(5)]
    assert all(isinstance(c, str) and c for c in singles)
    eng.stats.clear()
    batched = eng.caption_batch(images)      # 5 -> one padded bucket-8 call
    assert batched == singles
    assert eng.stats.batches == [5]
    assert eng.stats.decode_impls == ["steps"]

    jax_eng = JaxEngine(params_to_jax(state), cfg, wm,
                        JaxServeConfig(batch_buckets=(1, 2, 8), beam_size=3))
    assert jax_eng.caption_batch(images) == batched


def test_async_front_coalesces_requests(engine_parts):
    cfg, state, wm, images = engine_parts
    eng = CaptionEngine(state, cfg, wm,
                        ServeConfig(batch_buckets=(1, 2, 8), beam_size=3,
                                    max_wait_ms=500.0), device="cpu")
    expected = eng.caption_batch(images)
    eng.warmup(image_size=64)
    eng.start()
    try:
        futs = [eng.submit(images[i]) for i in range(5)]
        got = [f.result(timeout=120) for f in futs]
    finally:
        eng.stop()
    assert got == expected
    assert any(b > 1 for b in eng.stats.batches), eng.stats.batches
    assert sum(eng.stats.batches) == 5


def test_failed_batch_fails_only_its_requests(engine_parts):
    """Two images of different sizes cannot share a batch: both fail, and
    the engine serves the next request."""
    cfg, state, wm, images = engine_parts
    eng = CaptionEngine(state, cfg, wm,
                        ServeConfig(batch_buckets=(1, 2), beam_size=2,
                                    max_wait_ms=300.0), device="cpu")
    expected = eng.caption_batch(images[:1])[0]
    eng.start()
    try:
        with pytest.raises(ValueError):
            eng.submit(np.zeros((64, 64, 3), np.uint8))
        bad = [eng.submit(images[0]), eng.submit(images[1, :, :32, :32])]
        for f in bad:
            with pytest.raises(ValueError):
                f.result(timeout=120)
        assert eng.submit(images[0]).result(timeout=120) == expected
    finally:
        eng.stop()
    with pytest.raises(RuntimeError):
        eng.submit(images[0])


def test_cuda_request_without_a_device_raises(engine_parts):
    """A CUDA request never runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg, state, wm, _ = engine_parts
    with pytest.raises(RuntimeError, match="CUDA"):
        get_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        CaptionEngine(state, cfg, wm, device="cuda")
    meta = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        attend_fused(meta, torch.empty((1, 4, 8), device="meta"),
                     torch.empty((1, 2, 8), device="meta"),
                     torch.empty((8,), device="meta"))
    assert get_device("auto").type == "cpu"


def test_port_imports_no_jax():
    """After the port is imported and its CPU path has run, neither jax
    nor the JAX package is in sys.modules (a subprocess: this test process
    has imported both)."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        from indonesian_image_captioning_tpu_torch.core.config import (
            ModelConfig, TaggerConfig)
        from indonesian_image_captioning_tpu_torch.models import (
            decoders, encoders)
        from indonesian_image_captioning_tpu_torch.serve import (
            CaptionEngine, ServeConfig)
        torch.set_num_threads(1)
        cfg = ModelConfig(vocab_size=20, embed_dim=8, attention_dim=8,
                          decoder_dim=8, factored_dim=4, semantic_dim=6,
                          enc_image_size=1, encoder_arch="resnet50")
        g = torch.Generator().manual_seed(0)
        enc_p, enc_s = encoders.init_encoder_caption(g, "resnet50")
        tag_p, tag_s = encoders.init_encoder_tagger(
            g, TaggerConfig(semantic_size=6), "resnet50")
        state = dict(params=decoders.init_decoder(g, cfg), encoder=enc_p,
                     encoder_stats=enc_s, tagger=tag_p, tagger_stats=tag_s)
        wm = {"<pad>": 0, **{f"w{i}": i for i in range(1, 17)},
              "<unk>": 17, "<start>": 18, "<end>": 19}
        eng = CaptionEngine(state, cfg, wm, ServeConfig(
            batch_buckets=(2,), beam_size=2, max_steps=3), device="cpu")
        caps = eng.caption_batch(np.zeros((2, 3, 32, 32), np.uint8))
        assert all(isinstance(c, str) for c in caps)
        pkg = "indonesian_image_captioning_tpu"
        loaded = sorted(m for m in sys.modules
                        if m in ("jax", "jaxlib", pkg)
                        or m.startswith(("jax.", "jaxlib.", pkg + ".")))
        print("JAX_MODULES", loaded)
        sys.exit(1 if loaded else 0)
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "JAX_MODULES []" in r.stdout
