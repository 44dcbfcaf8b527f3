"""The record decode of the port against the JAX package, on the CPU:
``decode/replay.py``, kernel 13's plain version, kernel 10's plain
version, the decode rungs that replay records and ``caption_greedy``.

Seeded numpy inputs and JAX-initialised weights (moved with
``params_from_jax``) go through the JAX function and the port's
counterpart; the JAX Pallas kernels run in interpret mode.  Tolerances:
ids, sequences, lengths and counts exactly; float32 values to 1e-5
(summation order); the replays, which only move values, exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indonesian_image_captioning_tpu.core.config import BeamConfig, ModelConfig
from indonesian_image_captioning_tpu.decode import replay as jax_replay
from indonesian_image_captioning_tpu.decode.api import \
    caption_beam_search as jax_caption_beam_search
from indonesian_image_captioning_tpu.decode.greedy import \
    caption_greedy as jax_caption_greedy
from indonesian_image_captioning_tpu.models import decoders as jax_decoders
from indonesian_image_captioning_tpu.ops import decode_pallas, topk_pallas
from indonesian_image_captioning_tpu_torch.core import config as tconfig
from indonesian_image_captioning_tpu_torch.decode import replay
from indonesian_image_captioning_tpu_torch.decode.api import \
    caption_beam_search
from indonesian_image_captioning_tpu_torch.decode.greedy import \
    caption_greedy
from indonesian_image_captioning_tpu_torch.models.jax_bridge import \
    params_from_jax
from indonesian_image_captioning_tpu_torch.ops import decode_cuda
from indonesian_image_captioning_tpu_torch.ops.topk import row_topk_pallas

torch.set_num_threads(1)
TOL = 1e-5
NEG = -1e30
RESULT_KEYS = ("sequences", "lengths", "completed_count",
               "completed_lengths", "completed_sequences")


def tiny(model_type="attention_scn", **kw):
    kw = dict(model_type=model_type, vocab_size=50, embed_dim=10,
              attention_dim=8, decoder_dim=12, factored_dim=8,
              semantic_dim=11, encoder_dim=16, enc_image_size=3, **kw)
    return ModelConfig(**kw), tconfig.ModelConfig(**kw)


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=0)


def t(x):
    return torch.from_numpy(np.array(x))


def assert_same_result(ref, out, tol=TOL):
    for k in RESULT_KEYS:
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(ref[k]),
                                      err_msg=k)
    close(out["scores"], ref["scores"], tol)
    close(out["completed_scores"], ref["completed_scores"], tol)


def random_records(rng, B, T, K, V, end_id, end_rate):
    """Adversarial records (the pattern of tests/test_replay_fast.py):
    random words and parents, falling scores with NEG lanes sprinkled,
    <end> at the given rate; row 0 never ends, row 1 ends everywhere
    (freezes and overflows its pool)."""
    words = rng.integers(0, V, (B, T, K)).astype(np.int32)
    words = np.where(rng.random((B, T, K)) < end_rate, end_id, words)
    words[0] = np.where(words[0] == end_id, 0, words[0])
    words[1] = end_id
    parents = rng.integers(0, K, (B, T, K)).astype(np.int32)
    vals = (-rng.random((B, T, K)).astype(np.float32)
            * np.arange(1, T + 1)[None, :, None])
    vals = np.where(rng.random((B, T, K)) < 0.15, NEG, vals)
    return {"words": words, "parents": parents,
            "vals": vals.astype(np.float32)}


@pytest.mark.parametrize("end_rate", [0.0, 0.05, 0.35])
def test_replays_match_jax_replay(end_rate):
    rng = np.random.default_rng(int(end_rate * 100) + 3)
    B, T, K, V = 8, 12, 5, 40
    recs = random_records(rng, B, T, K, V, end_id=V - 1, end_rate=end_rate)
    kw = dict(start_id=V - 2, end_id=V - 1, seq_len=T + 1)
    ref = jax_replay.replay_beam_records(
        {k: jnp.asarray(v) for k, v in recs.items()}, **kw)
    trecs = {k: t(v) for k, v in recs.items()}
    for fn in (replay.replay_beam_records, replay.replay_beam_records_scan):
        out = fn(trecs, **kw)
        assert_same_result(ref, out, tol=0.0)
        assert out["steps"] == T


def alive_before(records, K, end_id):
    """(B, T): whether the image had a live lane when step t began (the
    replay's alive recurrence over the records)."""
    vals, words = np.asarray(records["vals"]), np.asarray(records["words"])
    B, T, _ = words.shape
    alive = np.full(B, K)
    out = np.zeros((B, T), bool)
    for s in range(T):
        out[:, s] = alive > 0
        valid = ((np.arange(K)[None] < alive[:, None]) & (vals[:, s] > NEG)
                 & (alive > 0)[:, None])
        alive = alive - (valid & (words[:, s] == end_id)).sum(1)
    return out


@pytest.mark.parametrize("end_bias", [0.0, 0.1])
def test_plain_megakernel_matches_the_pallas_megakernel(end_bias):
    """Kernel 13's plain version against ``beam_decode_records`` (two
    image chunks in interpret mode): the records of every step at which
    the image was alive (the TPU kernel leaves the steps of a dead chunk
    unwritten), and the replayed beams in full."""
    jcfg, tcfg = tiny()
    rng = np.random.default_rng(41)
    params = jax_decoders.init_decoder(jax.random.key(41), jcfg)
    V, B, K, T = jcfg.vocab_size, 16, 3, 7
    params["fc"]["b"] = params["fc"]["b"].at[V - 1].set(end_bias)
    enc = (rng.normal(size=(B, 9, 16)) * 0.5).astype(np.float32)
    tags = rng.uniform(size=(B, 11)).astype(np.float32)
    kw = dict(beam_size=K, start_id=V - 2, end_id=V - 1, max_steps=T)
    ref = decode_pallas.beam_decode_records(params, jcfg, enc, tags,
                                            interpret=True, **kw)
    out = decode_cuda.beam_decode_records_plain(
        params_from_jax(params), tcfg, t(enc), t(tags), **kw)
    on = alive_before(ref, K, V - 1)
    np.testing.assert_array_equal(on, alive_before(out, K, V - 1))
    assert on.any() and (end_bias == 0.0) == on.all()
    for k in ("words", "parents"):
        np.testing.assert_array_equal(out[k].numpy()[on],
                                      np.asarray(ref[k])[on])
    close(out["vals"].numpy()[on], np.asarray(ref["vals"])[on])
    assert (out["vals"].numpy()[~on] == NEG).all() or end_bias == 0.0
    rkw = dict(start_id=V - 2, end_id=V - 1, seq_len=T + 1)
    assert_same_result(jax_replay.replay_beam_records(ref, **rkw),
                       replay.replay_beam_records(out, **rkw))


def _run_both(jcfg, tcfg, params, enc, tags, K, T, **port_cfg):
    V = jcfg.vocab_size
    ref = jax_caption_beam_search(
        params, dataclasses.replace(jcfg, decode_impl="steps"), enc, tags,
        start_id=V - 2, end_id=V - 1,
        beam_cfg=BeamConfig(beam_size=K, max_steps=T))
    out = caption_beam_search(
        params_from_jax(params), dataclasses.replace(tcfg, **port_cfg),
        t(enc), t(tags), start_id=V - 2, end_id=V - 1,
        beam_cfg=tconfig.BeamConfig(beam_size=K, max_steps=T))
    return ref, out


@pytest.mark.parametrize("model_type, impl, ran", [
    ("attention_scn", "fused_span", "fused_span"),
    ("attention_scn", "fused", "fused"),
    ("pure_attention", "fused_span", "fused_span"),
    ("pure_attention", "fused", "steps"),     # kernel 13 is attention_scn's
    ("pure_scn", "fused_span", "steps")])     # no attention to amortise
def test_record_rungs_match_the_jax_engine(model_type, impl, ran):
    """decode_impl="fused_span" / "fused" on CPU tensors (the kernels'
    plain versions and the replay) give the JAX step engine's beams; the
    rungs that do not apply fall down the ladder as in JAX."""
    jcfg, tcfg = tiny(model_type=model_type)
    rng = np.random.default_rng(11)
    params = jax_decoders.init_decoder(jax.random.key(5), jcfg)
    enc = (rng.normal(size=(8, 9, 16)) * 0.5).astype(np.float32)
    tags = rng.uniform(size=(8, 11)).astype(np.float32)
    ref, out = _run_both(jcfg, tcfg, params, enc, tags, K=5, T=10,
                         decode_impl=impl, decode_span=3)
    assert out["decode_impl"] == ran
    assert_same_result(ref, out)


def test_pallas_topk_backend_matches_jax():
    """topk_backend="pallas" with the dense head: kernel 10's plain
    version over the (B, K*V) candidate table gives JAX's beams."""
    jcfg, tcfg = tiny(sparse_head=False, topk_backend="pallas")
    rng = np.random.default_rng(13)
    params = jax_decoders.init_decoder(jax.random.key(7), jcfg)
    enc = (rng.normal(size=(4, 9, 16)) * 0.5).astype(np.float32)
    tags = rng.uniform(size=(4, 11)).astype(np.float32)
    V = jcfg.vocab_size
    kw = dict(start_id=V - 2, end_id=V - 1,
              beam_cfg=BeamConfig(beam_size=4, max_steps=8))
    ref = jax_caption_beam_search(params, jcfg, enc, tags, **kw)
    out = caption_beam_search(
        params_from_jax(params), tcfg, t(enc), t(tags), start_id=V - 2,
        end_id=V - 1, beam_cfg=tconfig.BeamConfig(beam_size=4, max_steps=8))
    assert out["decode_impl"] == "steps"
    assert_same_result(ref, out)


def test_row_topk_plain_matches_the_pallas_topk():
    """Kernel 10's plain version against ``row_topk_pallas`` in interpret
    mode on a ragged table (V not a tile multiple) with exact ties, NEG
    entries and rows with fewer than k values above NEG."""
    rng = np.random.default_rng(17)
    R, V, k = 6, 2100, 5
    x = rng.normal(size=(R, V)).astype(np.float32)
    x[0, [3, 700, 2099]] = 9.0                    # ties across tiles
    x[1] = NEG
    x[1, [5, 2050]] = 1.0                         # two values above NEG
    x[2, ::3] = NEG
    ref_v, ref_i = topk_pallas.row_topk_pallas(jnp.asarray(x), k,
                                               interpret=True)
    vals, idx = row_topk_pallas(t(x), k)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_v))
    assert idx[0, :3].tolist() == [3, 700, 2099]


@pytest.mark.parametrize("model_type", ["attention_scn", "pure_scn"])
def test_caption_greedy_matches_jax(model_type):
    jcfg, tcfg = tiny(model_type=model_type)
    rng = np.random.default_rng(19)
    params = jax_decoders.init_decoder(jax.random.key(9), jcfg)
    enc = (rng.normal(size=(3, 9, 16)) * 0.5).astype(np.float32)
    tags = rng.uniform(size=(3, 11)).astype(np.float32)
    V = jcfg.vocab_size
    ref = jax_caption_greedy(params, jcfg, enc, tags, start_id=V - 2,
                             end_id=V - 1, max_steps=9)
    out = caption_greedy(params_from_jax(params), tcfg, t(enc), t(tags),
                         start_id=V - 2, end_id=V - 1, max_steps=9)
    assert_same_result(ref, out)
