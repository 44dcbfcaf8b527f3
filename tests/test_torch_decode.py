"""The port's decode path against the JAX package, on the CPU.

Seeded numpy inputs and JAX-initialised weights (moved with
``params_from_jax``) go through the JAX function and the port's
counterpart.  The kernels' wrappers take their plain versions here, because
the tensors lie on the CPU; the JAX Pallas kernels run in interpret mode.
Tolerances: 1e-5 on float32 values (summation order differs); ids,
sequences, lengths and counts exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indonesian_image_captioning_tpu.core.config import BeamConfig, ModelConfig
from indonesian_image_captioning_tpu.decode.api import \
    caption_beam_search as jax_caption_beam_search
from indonesian_image_captioning_tpu.models import attention as jax_attention
from indonesian_image_captioning_tpu.models import decoders as jax_decoders
from indonesian_image_captioning_tpu.ops import attention_pallas, step_pallas
from indonesian_image_captioning_tpu_torch.decode.api import (
    caption_beam_search, resolve_decode_impl)
from indonesian_image_captioning_tpu_torch.models import attention, decoders
from indonesian_image_captioning_tpu_torch.models.jax_bridge import \
    params_from_jax
from indonesian_image_captioning_tpu_torch.ops import step_cuda
from indonesian_image_captioning_tpu_torch.ops.attention_cuda import \
    attend_fused_mxu

torch.set_num_threads(1)
TOL = 1e-5


def tiny_cfg(vocab=50, model_type="attention_scn", **kw):
    return ModelConfig(model_type=model_type, vocab_size=vocab,
                       embed_dim=10, attention_dim=8, decoder_dim=12,
                       factored_dim=8, semantic_dim=11, encoder_dim=16,
                       enc_image_size=3, **kw)


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=0)


def t(x):
    return torch.from_numpy(np.array(x))


def test_attend_matches_jax_attend_and_mxu_kernel():
    rng = np.random.default_rng(0)
    B, K, P, E, A, D = 3, 4, 9, 16, 8, 12
    params = jax_attention.init_attention(jax.random.key(0), E, D, A)
    enc = rng.normal(size=(B, P, E)).astype(np.float32)
    h = rng.normal(size=(B, K, D)).astype(np.float32)
    ea = np.asarray(jax_attention.precompute(params, enc))
    ref_awe, ref_alpha = jax_attention.attend(params, enc[:, None],
                                              ea[:, None], h)
    mxu_awe, mxu_alpha = attention_pallas.attend_fused_mxu(
        params, enc[:, None], ea[:, None], h, interpret=True)

    tp = params_from_jax(params)
    awe, alpha = attention.attend(tp, t(enc)[:, None], t(ea)[:, None], t(h))
    close(awe, ref_awe)
    close(alpha, ref_alpha)
    k_awe, k_alpha = attend_fused_mxu(tp, t(enc), t(ea), t(h))
    close(k_awe, mxu_awe)
    close(k_alpha, mxu_alpha)
    assert torch.allclose(attention.precompute(tp, t(enc)), t(ea), atol=TOL)


def _step_inputs(cfg, B, K, seed):
    rng = np.random.default_rng(seed)
    R = B * K
    params = jax_decoders.init_decoder(jax.random.key(seed), cfg)
    params["fc"]["b"] = jnp.asarray(
        rng.normal(size=(cfg.vocab_size,)).astype(np.float32))
    P = cfg.num_pixels
    enc = rng.normal(size=(B, P, cfg.encoder_dim)).astype(np.float32) * 0.5
    emb = rng.normal(size=(R, cfg.embed_dim)).astype(np.float32) * 0.1
    h = rng.normal(size=(R, cfg.decoder_dim)).astype(np.float32) * 0.5
    c = rng.normal(size=(R, cfg.decoder_dim)).astype(np.float32) * 0.5
    F4 = 4 * cfg.factored_dim
    semx = rng.uniform(size=(R, F4)).astype(np.float32)
    semh = rng.uniform(size=(R, F4)).astype(np.float32)
    return params, enc, emb, h, c, semx, semh


@pytest.mark.parametrize("model_type", ["attention_scn", "pure_attention",
                                        "pure_scn"])
def test_plain_fused_step_matches_pallas_step(model_type):
    cfg = tiny_cfg(model_type=model_type)
    B, K = 8, 3
    params, enc, emb, h, c, semx, semh = _step_inputs(cfg, B, K, seed=1)
    cell = "lstm" if model_type == "pure_attention" else "scn"
    if model_type == "pure_attention":
        semx = semh = None
    jw = step_pallas.pack_step_weights(params, cfg, jnp.float32)
    tw = step_cuda.pack_step_weights(params_from_jax(params), cfg,
                                     torch.float32)
    tsx = None if semx is None else t(semx)
    tsh = None if semh is None else t(semh)
    if cfg.uses_attention:
        ea = np.asarray(jax_attention.precompute(params["attention"], enc))
        ref = step_pallas.fused_decode_step(
            jw, attention_pallas.pad_pixels(enc),
            attention_pallas.pad_pixels(ea), emb, h, c, semx, semh,
            num_pixels=enc.shape[1], cell=cell, vocab_size=cfg.vocab_size,
            interpret=True)
        out = step_cuda.fused_decode_step(tw, t(enc), t(ea), t(emb), t(h),
                                          t(c), tsx, tsh, cell=cell)
    else:
        ref = step_pallas.fused_decode_step_noattn(
            jw, emb, h, c, semx, semh, beam_k=K, vocab_size=cfg.vocab_size,
            interpret=True)
        out = step_cuda.fused_decode_step_noattn(tw, t(emb), t(h), t(c),
                                                 tsx, tsh, beam_k=K)
    topv, topi, lse, h_new, c_new = out
    assert (topi.numpy() == np.asarray(ref[1])).all()
    for a, b in zip((topv, lse, h_new, c_new),
                    (ref[0], ref[2], ref[3], ref[4])):
        close(a, b)


def _run_both(cfg, params, enc, tags, K, T, **port_cfg):
    V = cfg.vocab_size
    kw = dict(start_id=V - 2, end_id=V - 1,
              beam_cfg=BeamConfig(beam_size=K, max_steps=T))
    ref = jax_caption_beam_search(
        params, dataclasses.replace(cfg, decode_impl="steps"), enc, tags, **kw)
    out = caption_beam_search(
        params_from_jax(params), dataclasses.replace(cfg, **port_cfg),
        t(enc), t(tags), **kw)
    return ref, out


def _assert_same_beam(ref, out):
    for k in ("sequences", "lengths", "completed_count", "completed_lengths"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    close(out["scores"], ref["scores"])


@pytest.mark.parametrize("model_type", ["attention_scn", "pure_attention",
                                        "pure_scn"])
@pytest.mark.parametrize("K", [1, 5])
@pytest.mark.parametrize("end_bias", [0.0, 1.5])
def test_caption_beam_search_matches_jax(model_type, K, end_bias):
    """The step engine, beam 1 and 5, with and without a head biased
    toward <end> (beams retire at differing steps: pools, alive
    shrinkage and row freezing)."""
    cfg = tiny_cfg(model_type=model_type)
    rng = np.random.default_rng(7)
    params = jax_decoders.init_decoder(jax.random.key(3), cfg)
    V = cfg.vocab_size
    params["fc"]["b"] = params["fc"]["b"].at[V - 1].set(end_bias)
    enc = rng.normal(size=(4, 3, 3, 16)).astype(np.float32) * 0.5
    tags = rng.uniform(size=(4, 11)).astype(np.float32)
    ref, out = _run_both(cfg, params, enc, tags, K=K, T=10)
    assert out["decode_impl"] == "steps"
    _assert_same_beam(ref, out)
    if end_bias:
        assert int(np.asarray(ref["completed_count"]).sum()) > 0


@pytest.mark.parametrize("model_type", ["attention_scn", "pure_attention",
                                        "pure_scn"])
def test_fused_step_rung_matches_jax_engine(model_type):
    """decode_impl="fused_step" (kernel 2's plain version on the CPU) gives
    the JAX step engine's beams."""
    cfg = tiny_cfg(model_type=model_type)
    rng = np.random.default_rng(11)
    params = jax_decoders.init_decoder(jax.random.key(5), cfg)
    V = cfg.vocab_size
    params["fc"]["b"] = params["fc"]["b"].at[V - 1].set(1.2)
    enc = rng.normal(size=(8, 9, 16)).astype(np.float32) * 0.5
    tags = rng.uniform(size=(8, 11)).astype(np.float32)
    ref, out = _run_both(cfg, params, enc, tags, K=5, T=10,
                         decode_impl="fused_step")
    assert out["decode_impl"] == "fused_step"
    _assert_same_beam(ref, out)


def test_recorded_alphas_match_jax():
    cfg = tiny_cfg()
    rng = np.random.default_rng(13)
    params = jax_decoders.init_decoder(jax.random.key(6), cfg)
    enc = rng.normal(size=(2, 9, 16)).astype(np.float32) * 0.5
    tags = rng.uniform(size=(2, 11)).astype(np.float32)
    V = cfg.vocab_size
    kw = dict(start_id=V - 2, end_id=V - 1,
              beam_cfg=BeamConfig(beam_size=3, max_steps=6))
    ref = jax_caption_beam_search(params, cfg, enc, tags,
                                  record_alphas=True, **kw)
    out = caption_beam_search(params_from_jax(params), cfg, t(enc), t(tags),
                              record_alphas=True, **kw)
    np.testing.assert_array_equal(out["sequences"].numpy(),
                                  np.asarray(ref["sequences"]))
    close(out["alpha"], ref["alpha"])


def test_decode_ladder_and_unported_names():
    cfg = tiny_cfg()
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert resolve_decode_impl(cfg, record_alphas=False,
                               device=cuda) == "fused_step"
    assert resolve_decode_impl(cfg, record_alphas=True,
                               device=cuda) == "steps"
    assert resolve_decode_impl(cfg, record_alphas=False,
                               device=cpu) == "steps"
    for kw in (dict(decode_impl="fused_span"), dict(decode_impl="fused"),
               dict(enc_quant="int8"), dict(fused_cell=True),
               dict(topk_backend="pallas")):
        with pytest.raises(NotImplementedError):
            resolve_decode_impl(dataclasses.replace(cfg, **kw),
                                record_alphas=False, device=cuda)
    assert decoders.resolve_attention_impl(cfg, cuda) == "kernel"
    assert decoders.resolve_attention_impl(cfg, cpu) == "plain"
    for name, want in (("pallas", "kernel"), ("pallas_mxu", "kernel"),
                       ("xla", "plain"), ("xla_pk", "plain")):
        c = dataclasses.replace(cfg, attention_impl=name)
        assert decoders.resolve_attention_impl(c, cuda) == want


def test_sequences_to_tokens_matches_jax():
    from indonesian_image_captioning_tpu.decode.api import \
        sequences_to_tokens as jax_sequences_to_tokens
    from indonesian_image_captioning_tpu_torch.decode.api import \
        sequences_to_tokens
    seqs = np.array([[8, 3, 1, 9, 0], [8, 2, 9, 0, 0]], np.int32)
    lens = np.array([4, 3], np.int32)
    rev = {i: f"w{i}" for i in range(10)}
    assert (sequences_to_tokens(t(seqs), t(lens), rev, skip_ids=(8, 9))
            == jax_sequences_to_tokens(seqs, lens, rev, skip_ids=(8, 9))
            == [["w3", "w1"], ["w2"]])
