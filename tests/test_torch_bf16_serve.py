"""The port's caption server at bfloat16 against the JAX package's, on the
CPU.

The JAX benchmark's end-to-end mode serves with every floating leaf of the
state in bf16, BatchNorm statistics included, and
``ModelConfig(dtype="bfloat16")``.  Here: ResNet-50 encoders on 64-pixel
images and a tiny attention_scn decoder, initialised in JAX and moved with
``params_from_jax``, the statistics calibrated by the port on the test
images in float32 (random-init eval-mode features are about 1e10), then
the whole state cast to bf16 and handed to both engines.

Every bottleneck's residual branch is damped (bn3 scale x 0.2, as
``tests/test_torch_tagger.py`` does): a random ResNet amplifies any
change of rounding, and undamped the two frameworks' bf16 convolutions
(XLA keeps float32 inside its fusions, torch rounds each op) move the tags
by 16 bf16 ulps and three of five captions.  Damped, the tags lie within
TAG_TOL (one bf16 ulp at 0.5; measured 0.0039) and the captions are
equal.  The test also records what the engine hands the decode: bf16
parameters, encodings and tags.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indonesian_image_captioning_tpu.core.config import (ModelConfig,
                                                         TaggerConfig)
from indonesian_image_captioning_tpu.models import decoders as jax_decoders
from indonesian_image_captioning_tpu.models import encoders as jax_encoders
from indonesian_image_captioning_tpu.serve import CaptionEngine as JaxEngine
from indonesian_image_captioning_tpu.serve import ServeConfig as JaxServeConfig
from indonesian_image_captioning_tpu.train.steps import \
    prep_images as jax_prep_images
from indonesian_image_captioning_tpu_torch.models import encoders
from indonesian_image_captioning_tpu_torch.models.jax_bridge import (
    params_from_jax, params_to_jax)
from indonesian_image_captioning_tpu_torch.serve import (CaptionEngine,
                                                         ServeConfig)
from indonesian_image_captioning_tpu_torch.train.steps import cast_tree

torch.set_num_threads(1)
TAG_TOL = 2 ** -8
DAMP = 0.2
BUCKETS = (1, 8)


def word_map(vocab=40):
    wm = {"<pad>": 0}
    for i in range(1, vocab - 3):
        wm[f"w{i}"] = i
    wm["<unk>"], wm["<start>"], wm["<end>"] = vocab - 3, vocab - 2, vocab - 1
    return wm


def damped(resnet_tree):
    tree = jax.tree.map(np.asarray, resnet_tree)
    for stage in ("layer1", "layer2", "layer3", "layer4"):
        for part in tree["resnet"][stage].values():
            part["bn3"]["scale"] = part["bn3"]["scale"] * DAMP
    return tree


@pytest.fixture(scope="module")
def bf16_state():
    cfg = ModelConfig(model_type="attention_scn", vocab_size=40,
                      embed_dim=16, attention_dim=16, decoder_dim=16,
                      factored_dim=8, semantic_dim=8, enc_image_size=2,
                      max_caption_len=10, encoder_arch="resnet50",
                      dtype="bfloat16")
    images = np.random.default_rng(3).integers(
        0, 256, size=(5, 3, 64, 64), dtype=np.uint8)
    params = jax_decoders.init_decoder(jax.random.key(0), cfg)
    enc_p, enc_s = jax_encoders.init_encoder_caption(jax.random.key(1),
                                                     arch="resnet50")
    tag_p, tag_s = jax_encoders.init_encoder_tagger(
        jax.random.key(2), TaggerConfig(semantic_size=cfg.semantic_dim),
        arch="resnet50")
    state = {k: params_from_jax(v) for k, v in (
        ("params", params), ("encoder", damped(enc_p)),
        ("encoder_stats", enc_s), ("tagger", damped(tag_p)),
        ("tagger_stats", tag_s))}
    x = encoders.prep_images(torch.from_numpy(images))
    for name, apply in (("encoder", encoders.apply_encoder_caption),
                        ("tagger", encoders.apply_encoder_tagger)):
        _, state[name + "_stats"] = apply(
            state[name], state[name + "_stats"], x, train="calibrate",
            arch="resnet50")
    state = cast_tree(state, torch.bfloat16)
    jstate = jax.tree.map(
        lambda a: jnp.asarray(a, jnp.bfloat16)
        if np.issubdtype(a.dtype, np.floating) else a, params_to_jax(state))
    return cfg, state, jstate, images


def test_bf16_engine_matches_jax_engine(bf16_state, monkeypatch):
    """caption_batch of five images (one padded bucket-8 call) on the bf16
    state: every floating leaf bf16, the decode on "steps" (the CPU's
    rung) given bf16 parameters, encodings and tags (serve/engine.py's
    casts), the captions equal to JAX's CaptionEngine's on the same state,
    and equal image by image through bucket 1; the tags the engine hands
    the decode within TAG_TOL of JAX's tagger's."""
    from indonesian_image_captioning_tpu_torch.serve import engine as serve
    cfg, state, jstate, images = bf16_state
    assert all(t.dtype == torch.bfloat16 for t in
               jax.tree.leaves(state, is_leaf=torch.is_tensor)
               if t.is_floating_point())
    seen = []
    decode = serve.caption_beam_search

    def spy(params, cfg_, enc, tags, **kw):
        seen.append((params["fc"]["w"].dtype, enc.dtype, tags.clone()))
        return decode(params, cfg_, enc, tags, **kw)

    monkeypatch.setattr(serve, "caption_beam_search", spy)
    eng = CaptionEngine(state, cfg, word_map(),
                        ServeConfig(batch_buckets=BUCKETS, beam_size=3),
                        device="cpu")
    got = eng.caption_batch(images)
    assert eng.stats.batches == [5] and eng.stats.decode_impls == ["steps"]
    (w_dtype, enc_dtype, tags), = seen
    assert w_dtype == enc_dtype == tags.dtype == torch.bfloat16
    ref = JaxEngine(jstate, cfg, word_map(),
                    JaxServeConfig(batch_buckets=BUCKETS, beam_size=3)
                    ).caption_batch(images)
    assert got == ref
    assert [eng.caption_batch(images[i:i + 1])[0] for i in range(5)] == got

    jtags = jax.jit(lambda st, im: jax_encoders.apply_encoder_tagger(
        st["tagger"], st["tagger_stats"],
        jax_prep_images(im).astype(jnp.bfloat16), train=False,
        arch="resnet50")[0])(jstate, images)
    assert jtags.dtype == jnp.bfloat16
    err = float(np.abs(tags[:5].float().numpy()
                       - np.asarray(jtags.astype(jnp.float32))).max())
    assert err <= TAG_TOL, f"tags {err} > {TAG_TOL}"
