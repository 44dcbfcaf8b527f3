"""Kernel 7's plain version and its driver against the JAX span kernel, on
the CPU.

``ops/span_cuda.py`` (``fused_decode_span_plain`` and
``beam_decode_span_records``) against ``ops/span_pallas.py`` run in
interpret mode, on seeded numpy inputs and JAX-initialised weights moved
with ``params_from_jax``.  Tolerances: ids, parents, alive counts and
previous words exactly; float32 values to 1e-5 (summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indonesian_image_captioning_tpu.core.config import ModelConfig
from indonesian_image_captioning_tpu.models import attention as jax_attention
from indonesian_image_captioning_tpu.models import decoders as jax_decoders
from indonesian_image_captioning_tpu.ops import span_pallas, step_pallas
from indonesian_image_captioning_tpu.ops.attention_pallas import pad_pixels
from indonesian_image_captioning_tpu_torch.core import config as tconfig
from indonesian_image_captioning_tpu_torch.models.jax_bridge import \
    params_from_jax
from indonesian_image_captioning_tpu_torch.ops import span_cuda, step_cuda

torch.set_num_threads(1)
TOL = 1e-5
NEG = -1e30


def tiny(vocab=50, model_type="attention_scn"):
    kw = dict(model_type=model_type, vocab_size=vocab, embed_dim=10,
              attention_dim=8, decoder_dim=12, factored_dim=8,
              semantic_dim=11, encoder_dim=16, enc_image_size=3)
    return ModelConfig(**kw), tconfig.ModelConfig(**kw)


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=0)


def same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def mid_decode_state(rng, B, K, D, V):
    """A state some steps into a decode: per image a live-lane count in
    0..K, that many live lanes at arbitrary ranks with negative scores,
    the others retired (NEG); images with no live lane are dead.  Previous
    words anywhere in [0, V), ids >= 256 included."""
    alive = np.array([K, 2, 0, 1, K, 2, 0, K][:B], np.int32) % (K + 1)
    sc = np.full((B, K), NEG, np.float32)
    for b in range(B):
        lanes = rng.permutation(K)[:alive[b]]
        sc[b, lanes] = -rng.uniform(1.0, 6.0, size=len(lanes))
    pw = rng.integers(0, V, size=(B * K, 1)).astype(np.int32)
    pw[::4] = rng.integers(256, V, size=pw[::4].shape)
    h = (rng.normal(size=(B * K, D)) * 0.5).astype(np.float32)
    c = (rng.normal(size=(B * K, D)) * 0.5).astype(np.float32)
    return h, c, sc.reshape(B * K, 1), pw, alive.reshape(B, 1)


@pytest.mark.parametrize("model_type", ["attention_scn", "pure_attention"])
def test_plain_span_matches_the_pallas_span(model_type):
    """One S=3 call from a mid-decode state with retired lanes and dead
    images, V=300 so that ids >= 256 are carried: every record and every
    carried state equal."""
    jcfg, tcfg = tiny(vocab=300, model_type=model_type)
    B, K, S, V = 8, 3, 3, 300
    rng = np.random.default_rng(21)
    params = jax_decoders.init_decoder(jax.random.key(21), jcfg)
    bias = np.zeros(V, np.float32)
    bias[[257, 283]] = 2.5             # ids that bf16 cannot hold
    bias[V - 1] = 2.0                  # <end>: retirements inside the call
    params["fc"]["b"] = jnp.asarray(bias)
    cell = "scn" if model_type == "attention_scn" else "lstm"
    P, F4 = jcfg.num_pixels, 4 * jcfg.factored_dim
    enc = (rng.normal(size=(B, P, jcfg.encoder_dim)) * 0.5).astype(
        np.float32)
    ea = np.asarray(jax_attention.precompute(params["attention"], enc))
    semx = semh = None
    if cell == "scn":
        semx = rng.uniform(size=(B * K, F4)).astype(np.float32)
        semh = rng.uniform(size=(B * K, F4)).astype(np.float32)
    h, c, sc, pw, alive = mid_decode_state(rng, B, K, jcfg.decoder_dim, V)

    Vp = -(-V // 128) * 128
    ref = span_pallas.fused_decode_span(
        step_pallas.pack_step_weights(params, jcfg, jnp.float32),
        jnp.pad(params["embedding"], ((0, Vp - V), (0, 0))),
        pad_pixels(enc), pad_pixels(ea), semx, semh, h, c, sc, pw, alive,
        span=S, num_pixels=P, end_id=V - 1, interpret=True, vocab_size=V,
        cell=cell)
    tp = params_from_jax(params)
    out = span_cuda.fused_decode_span(
        step_cuda.pack_step_weights(tp, tcfg, torch.float32),
        tp["embedding"], t(enc), t(ea), t(semx), t(semh), t(h), t(c),
        t(sc), t(pw), t(alive), span=S, end_id=V - 1, cell=cell)

    words, parents, vals, h2, c2, sc2, pw2, alive2 = out
    assert words.shape == (B, S, K) and words.dtype == torch.int32
    for got, want in ((words, ref[0]), (parents, ref[1]), (pw2, ref[6]),
                      (alive2, ref[7])):
        same(got, want)
    for got, want in ((vals, ref[2]), (h2, ref[3]), (c2, ref[4]),
                      (sc2, ref[5])):
        close(got, want)
    assert int(alive2.sum()) < int(alive.sum())         # lanes retired
    assert set(words.flatten().tolist()) & {257, 283}  # ids >= 256 carried


def _records_both(jcfg, tcfg, params, enc, tags, K, T, S):
    V = jcfg.vocab_size
    kw = dict(beam_size=K, start_id=V - 2, end_id=V - 1, max_steps=T,
              span=S)
    ref = span_pallas.beam_decode_span_records(params, jcfg, enc, tags,
                                               interpret=True, **kw)
    out = span_cuda.beam_decode_span_records(params_from_jax(params), tcfg,
                                             t(enc), t(tags), **kw)
    return ref, out


@pytest.mark.parametrize("model_type, end_bias, calls", [
    ("attention_scn", 0.0, 3),     # every call, the last one overshooting T
    ("attention_scn", 1.5, 1),     # every image done in the first call
    ("pure_attention", 0.0, 3)])
def test_span_driver_matches_jax(model_type, end_bias, calls):
    """T=7 in spans of 3 (T % S != 0): the records sliced back to T, and
    with an <end> bias the early exit once no image is alive (records
    past it inert)."""
    jcfg, tcfg = tiny(model_type=model_type)
    rng = np.random.default_rng(31)
    params = jax_decoders.init_decoder(jax.random.key(31), jcfg)
    V = jcfg.vocab_size
    params["fc"]["b"] = params["fc"]["b"].at[V - 1].set(end_bias)
    enc = (rng.normal(size=(8, 9, 16)) * 0.5).astype(np.float32)
    tags = rng.uniform(size=(8, 11)).astype(np.float32)
    ref, out = _records_both(jcfg, tcfg, params, enc, tags, K=3, T=7, S=3)
    for k in ("words", "parents"):
        assert out[k].shape == (8, 7, 3)
        same(out[k], ref[k])
    close(out["vals"], ref["vals"])
    assert out["calls"] == calls
    if calls < 3:
        assert (out["vals"][:, calls * 3:] == NEG).all()


def test_span_driver_rejects_pure_scn():
    _, tcfg = tiny(model_type="pure_scn")
    enc = torch.zeros((8, 9, 16))
    with pytest.raises(NotImplementedError):
        span_cuda.beam_decode_span_records(
            {}, tcfg, enc, torch.zeros((8, 11)),
            beam_size=3, start_id=1, end_id=2, max_steps=4)
