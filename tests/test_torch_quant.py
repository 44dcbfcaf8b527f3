"""The port's int8 encoder-state mode against the JAX package, on the CPU.

``ModelConfig.enc_quant="int8"``: ``quantize_pixels``, the plain version
of kernel 5 (``attend_fused_q``) and of kernel 6c
(``fused_decode_step_q``), the beam decode through both and the ladder.
Seeded numpy inputs and JAX-initialised weights (moved with
``params_from_jax``) go through the JAX function and the port's
counterpart; the JAX Pallas kernels run in interpret mode, the port's
wrappers take their plain versions (the tensors lie on the CPU).

JAX pads the pixels to a multiple of 32 (a TPU tile) and the port does
not, so the JAX arrays are compared on their first P pixel rows; the port
is also fed JAX's padded arrays with p_actual = P.  Tolerances: the
quantizer bit for bit; 1e-5 on float32 values (JAX's own tolerance for
the kernel against its oracle, tests/test_attention_quant.py; summation
order differs); at bfloat16 4e-3 on awe and alpha (four bf16 ulps at
|awe| < 0.25: a float32 sum that lands on the other side of a rounding
boundary moves a score by an ulp; the case below agrees bit for bit);
ids, sequences and lengths exactly.
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
from indonesian_image_captioning_tpu_torch.models.jax_bridge import \
    params_from_jax
from indonesian_image_captioning_tpu_torch.ops import (attention_q_cuda,
                                                       step_cuda)

torch.set_num_threads(1)
TOL = 1e-5
BF16_TOL = 4e-3


def tiny_cfg(vocab=50, model_type="attention_scn", **kw):
    return ModelConfig(model_type=model_type, vocab_size=vocab,
                       embed_dim=10, attention_dim=8, decoder_dim=12,
                       factored_dim=8, semantic_dim=11, encoder_dim=16,
                       enc_image_size=3, enc_quant="int8", **kw)


def t(x):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def close(a, b, tol=TOL):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=0)


@pytest.mark.parametrize("P", [30, 196])
def test_quantize_pixels_bit_equal(P):
    rng = np.random.default_rng(P)
    x = (rng.normal(size=(3, P, 64)) * 2.0).astype(np.float32)
    x[1, 4] = 0.0                          # an all-zero pixel: scale 1e-30
    jq, js = attention_pallas.quantize_pixels(x)
    q, s = attention_q_cuda.quantize_pixels(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == (3, P, 64) and s.shape == (3, P, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq)[:, :P])
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(js)[:, :P].view(np.int32))


def _attention_case(seed, dtype=jnp.float32):
    """JAX attention parameters, int8 state from JAX's quantizer (padded)
    and the port's (not), and beam hidden states."""
    B, K, P, E, A, D = 4, 5, 30, 64, 32, 48
    rng = np.random.default_rng(seed)
    params = jax_attention.init_attention(jax.random.key(seed), E, D, A)
    enc = (rng.normal(size=(B, P, E)) * 0.3).astype(np.float32)
    ea = np.asarray(jax_attention.precompute(params, enc))
    h = (rng.normal(size=(B, K, D)) * 0.3).astype(np.float32)
    params = jax.tree.map(lambda x: x.astype(dtype), params)
    jq = attention_pallas.quantize_pixels(enc) + \
        attention_pallas.quantize_pixels(ea)
    tq = attention_q_cuda.quantize_pixels(t(enc)) + \
        attention_q_cuda.quantize_pixels(t(ea))
    return params, jq, tq, jnp.asarray(h, dtype), P


def test_plain_attend_q_matches_jax_ref_and_kernel():
    params, jq, tq, h, P = _attention_case(0)
    ref_awe, ref_alpha = attention_pallas.attend_quant_ref(params, *jq, h,
                                                           p_actual=P)
    k_awe, k_alpha = attention_pallas.attend_fused_q(params, *jq, h,
                                                     p_actual=P)
    tp = params_from_jax(params)
    awe, alpha = attention_q_cuda.attend_quant(tp, *tq, t(h))
    for want_awe, want_alpha in ((ref_awe, ref_alpha), (k_awe, k_alpha)):
        close(awe, want_awe)
        close(alpha, want_alpha)
    # JAX's own 32-row padded state, masked past p_actual
    pawe, palpha = attention_q_cuda.attend_quant(
        tp, *(t(x) for x in jq), t(h), p_actual=P, kernel=False)
    assert palpha.shape == (4, 5, P)
    close(pawe, ref_awe)
    close(palpha, ref_alpha)
    # the kernel-level wrapper without alpha
    dec = (t(h) @ tp["decoder_att"]["w"] + tp["decoder_att"]["b"])
    awe2, none = attention_q_cuda.attend_fused_q(
        *tq, dec.contiguous(), tp["full_att"]["w"].reshape(-1),
        with_alpha=False)
    assert none is None
    close(awe2, ref_awe)


def test_plain_attend_q_bf16_matches_jax_ref():
    params, jq, tq, h, P = _attention_case(1, jnp.bfloat16)
    ref_awe, ref_alpha = attention_pallas.attend_quant_ref(params, *jq, h,
                                                           p_actual=P)
    awe, alpha = attention_q_cuda.attend_quant(params_from_jax(params), *tq,
                                               t(h))
    assert awe.dtype == alpha.dtype == torch.bfloat16
    close(awe, ref_awe.astype(jnp.float32), BF16_TOL)
    close(alpha, ref_alpha.astype(jnp.float32), BF16_TOL)


def _step_inputs(cfg, B, K, seed):
    rng = np.random.default_rng(seed)
    R = B * K
    params = jax_decoders.init_decoder(jax.random.key(seed), cfg)
    params["fc"]["b"] = jnp.asarray(
        rng.normal(size=(cfg.vocab_size,)).astype(np.float32))
    enc = rng.normal(size=(B, cfg.num_pixels,
                           cfg.encoder_dim)).astype(np.float32) * 0.5
    emb = rng.normal(size=(R, cfg.embed_dim)).astype(np.float32) * 0.1
    h = rng.normal(size=(R, cfg.decoder_dim)).astype(np.float32) * 0.5
    c = rng.normal(size=(R, cfg.decoder_dim)).astype(np.float32) * 0.5
    F4 = 4 * cfg.factored_dim
    semx = rng.uniform(size=(R, F4)).astype(np.float32)
    semh = rng.uniform(size=(R, F4)).astype(np.float32)
    return params, enc, emb, h, c, semx, semh


@pytest.mark.parametrize("model_type", ["attention_scn", "pure_attention"])
def test_plain_fused_step_q_matches_pallas(model_type):
    cfg = tiny_cfg(model_type=model_type)
    B, K = 8, 3
    params, enc, emb, h, c, semx, semh = _step_inputs(cfg, B, K, seed=2)
    cell = "lstm" if model_type == "pure_attention" else "scn"
    if cell == "lstm":
        semx = semh = None
    P = enc.shape[1]
    ea = np.asarray(jax_attention.precompute(params["attention"], enc))
    jq = attention_pallas.quantize_pixels(enc) + \
        attention_pallas.quantize_pixels(ea)
    jw = step_pallas.pack_step_weights(params, cfg, jnp.float32)
    ref = step_pallas.fused_decode_step_q(
        jw, *jq, emb, h, c, semx, semh, num_pixels=P, cell=cell,
        vocab_size=cfg.vocab_size, interpret=True)
    tw = step_cuda.pack_step_weights(params_from_jax(params), cfg,
                                     torch.float32)
    rows = (t(emb), t(h), t(c), None if semx is None else t(semx),
            None if semh is None else t(semh))
    tq = attention_q_cuda.quantize_pixels(t(enc)) + \
        attention_q_cuda.quantize_pixels(t(ea))
    for state, pa in ((tq, None), (tuple(t(x) for x in jq), P)):
        out = step_cuda.fused_decode_step_q(tw, *state, *rows, cell=cell,
                                            p_actual=pa)
        assert (out[1].numpy() == np.asarray(ref[1])).all()
        for a, b in zip((out[0], out[2], out[3], out[4]),
                        (ref[0], ref[2], ref[3], ref[4])):
            close(a, b)


def _run_both(cfg, params, enc, tags, K, T, **port_cfg):
    V = cfg.vocab_size
    kw = dict(start_id=V - 2, end_id=V - 1,
              beam_cfg=BeamConfig(beam_size=K, max_steps=T))
    ref = jax_caption_beam_search(
        params, dataclasses.replace(cfg, decode_impl="steps"), enc, tags, **kw)
    # a strided view of the encodings, as the encoders' NHWC output is
    enc_view = t(np.ascontiguousarray(enc.swapaxes(1, 2))).transpose(1, 2)
    assert not enc_view.is_contiguous()
    out = caption_beam_search(
        params_from_jax(params), dataclasses.replace(cfg, **port_cfg),
        enc_view, t(tags), **kw)
    return ref, out


@pytest.mark.parametrize("model_type", ["attention_scn", "pure_attention"])
@pytest.mark.parametrize("impl", ["steps", "fused_step"])
def test_int8_beam_search_matches_jax(model_type, impl):
    """The int8 step engine (kernel 5's plain version) and the int8
    "fused_step" rung (kernel 6c's) give the JAX int8 step engine's
    beams, with beams retiring at differing steps (head biased toward
    <end>), as tests/test_step_fused.py holds JAX's two rungs."""
    cfg = tiny_cfg(model_type=model_type)
    rng = np.random.default_rng(21)
    params = jax_decoders.init_decoder(jax.random.key(20), cfg)
    V = cfg.vocab_size
    params["fc"]["b"] = params["fc"]["b"].at[V - 1].set(1.0)
    enc = (rng.normal(size=(8, 9, 16)) * 0.5).astype(np.float32)
    tags = rng.uniform(size=(8, 11)).astype(np.float32)
    ref, out = _run_both(cfg, params, enc, tags, K=3, T=10, decode_impl=impl)
    assert out["decode_impl"] == impl
    assert int(np.asarray(ref["completed_count"]).sum()) > 0
    for k in ("sequences", "lengths", "completed_count", "completed_lengths"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    close(out["scores"], ref["scores"])


def test_int8_alphas_match_jax():
    cfg = tiny_cfg()
    rng = np.random.default_rng(23)
    params = jax_decoders.init_decoder(jax.random.key(22), cfg)
    enc = (rng.normal(size=(2, 9, 16)) * 0.5).astype(np.float32)
    tags = rng.uniform(size=(2, 11)).astype(np.float32)
    V = cfg.vocab_size
    kw = dict(start_id=V - 2, end_id=V - 1,
              beam_cfg=BeamConfig(beam_size=3, max_steps=6),
              record_alphas=True)
    ref = jax_caption_beam_search(params, cfg, enc, tags, **kw)
    out = caption_beam_search(params_from_jax(params), cfg, t(enc), t(tags),
                              **kw)
    assert out["decode_impl"] == "steps"
    np.testing.assert_array_equal(out["sequences"].numpy(),
                                  np.asarray(ref["sequences"]))
    close(out["alpha"], ref["alpha"])


def test_int8_ladder():
    cfg = tiny_cfg()
    cuda, cpu = torch.device("cuda"), torch.device("cpu")

    def rung(device, record_alphas=False, **kw):
        return resolve_decode_impl(dataclasses.replace(cfg, **kw),
                                   record_alphas=record_alphas,
                                   device=device)

    # the span rung excludes the int8 state: "auto" takes kernel 6c
    assert rung(cuda) == "fused_step"
    assert rung(cuda, model_type="pure_attention") == "fused_step"
    assert rung(cuda, decode_impl="fused_span") == "fused_step"
    assert rung(cuda, model_type="pure_scn") == "fused_step"
    assert rung(cuda, record_alphas=True) == "steps"
    assert rung(cpu) == "steps"
    assert rung(cpu, decode_impl="fused_span") == "steps"
    assert rung(cpu, decode_impl="fused_step") == "fused_step"
    # "fused" ignores enc_quant, as JAX's eligibility test does
    assert rung(cuda, decode_impl="fused") == "fused"
    assert rung(cuda, enc_quant="none") == "fused_span"
    with pytest.raises(ValueError, match="enc_quant"):
        rung(cuda, enc_quant="int4")


def test_fused_rung_under_int8_is_the_unquantized_megakernel():
    """JAX's "fused" rung reads no quantized state; neither does the
    port's: its int8 beams are the full-precision "fused" beams."""
    cfg = tiny_cfg(decode_impl="fused")
    rng = np.random.default_rng(25)
    params = params_from_jax(jax_decoders.init_decoder(jax.random.key(24),
                                                       cfg))
    enc = torch.from_numpy((rng.normal(size=(4, 9, 16)) * 0.5)
                           .astype(np.float32))
    tags = torch.from_numpy(rng.uniform(size=(4, 11)).astype(np.float32))
    V = cfg.vocab_size
    kw = dict(start_id=V - 2, end_id=V - 1,
              beam_cfg=BeamConfig(beam_size=3, max_steps=6))
    q = caption_beam_search(params, cfg, enc, tags, **kw)
    full = caption_beam_search(
        params, dataclasses.replace(cfg, enc_quant="none"), enc, tags, **kw)
    assert q["decode_impl"] == full["decode_impl"] == "fused"
    assert torch.equal(q["sequences"], full["sequences"])
    assert torch.equal(q["scores"], full["scores"])
