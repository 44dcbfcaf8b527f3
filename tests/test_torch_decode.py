"""The port's decode path against the JAX package, on the CPU.

Seeded numpy inputs and JAX-initialised weights (moved with
``params_from_jax``) go through the JAX function and the port's
counterpart.  The kernels' wrappers take their plain versions here, because
the tensors lie on the CPU; the JAX Pallas kernels run in interpret mode.
Tolerances: 1e-5 on float32 values (summation order differs); ids,
sequences, lengths and counts exactly.
"""

import dataclasses
import inspect

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
from indonesian_image_captioning_tpu_torch.ops import step_cuda, topk
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

    def rung(device, record_alphas=False, **kw):
        return resolve_decode_impl(dataclasses.replace(cfg, **kw),
                                   record_alphas=record_alphas,
                                   device=device)

    assert rung(cuda) == "fused_span"
    assert rung(cuda, model_type="pure_attention") == "fused_span"
    assert rung(cuda, model_type="pure_scn") == "fused_step"
    assert rung(cuda, record_alphas=True) == "steps"
    assert rung(cpu) == "steps"
    # explicit rungs: on CPU tensors they run the kernels' plain versions;
    # where one does not apply it falls down the ladder
    assert rung(cpu, decode_impl="fused_span") == "fused_span"
    assert rung(cuda, decode_impl="fused_span",
                model_type="pure_scn") == "fused_step"
    assert rung(cpu, decode_impl="fused_span", model_type="pure_scn") \
        == "steps"
    assert rung(cuda, decode_impl="fused_span", record_alphas=True) == "steps"
    assert rung(cpu, decode_impl="fused") == "fused"
    assert rung(cuda, decode_impl="fused",
                model_type="pure_attention") == "steps"
    assert rung(cuda, decode_impl="fused_step") == "fused_step"
    assert rung(cuda, topk_backend="pallas") == "fused_span"
    # the opt-in modes are ported: int8 state leaves the span rung
    # (tests/test_torch_quant.py has its ladder), the fused cell changes
    # only the step engine
    assert rung(cuda, enc_quant="int8") == "fused_step"
    assert rung(cuda, fused_cell=True) == "fused_span"
    assert rung(cuda, fused_cell=True, record_alphas=True) == "steps"
    assert decoders.resolve_attention_impl(cfg, cuda) == "kernel"
    assert decoders.resolve_attention_impl(cfg, cpu) == "plain"
    for name, want in (("pallas", "kernel"), ("pallas_mxu", "kernel"),
                       ("xla", "plain"), ("xla_pk", "plain")):
        c = dataclasses.replace(cfg, attention_impl=name)
        assert decoders.resolve_attention_impl(c, cuda) == want


PROBE = dict(model_type="attention_scn", vocab_size=40, embed_dim=12,
             attention_dim=8, decoder_dim=16, factored_dim=8,
             semantic_dim=11, encoder_dim=32, enc_image_size=3,
             attention_impl="pallas_mxu")


@pytest.mark.parametrize("decode_impl",
                         ["steps", "fused_step", "fused_span", "fused"])
def test_beam_9_matches_jax_under_every_kernel_name(decode_impl):
    """Beam 9, past the eight lanes the port's kernels once took, under
    each rung and the kernel attention: the port equals JAX's
    caption_beam_search with the same names (V=40, E=32, D=16, B=2, T=5,
    float32)."""
    cfg = ModelConfig(**PROBE, decode_impl=decode_impl)
    rng = np.random.default_rng(19)
    params = jax_decoders.init_decoder(jax.random.key(9), cfg)
    params["fc"]["b"] = params["fc"]["b"].at[cfg.vocab_size - 1].set(1.0)
    enc = rng.normal(size=(2, 9, 32)).astype(np.float32) * 0.5
    tags = rng.uniform(size=(2, 11)).astype(np.float32)
    V = cfg.vocab_size
    kw = dict(start_id=V - 2, end_id=V - 1,
              beam_cfg=BeamConfig(beam_size=9, max_steps=5))
    ref = jax_caption_beam_search(params, cfg, enc, tags, **kw)
    out = caption_beam_search(params_from_jax(params), cfg, t(enc), t(tags),
                              **kw)
    assert out["decode_impl"] == decode_impl
    assert out["sequences"].shape == (2, 6)
    for k in ("sequences", "lengths"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    close(out["scores"], ref["scores"])


@pytest.mark.parametrize("K", [9, 33, 200])
def test_no_beam_width_moves_the_ladder(K):
    """Every kernel takes any K (decode/api.py, "Beam width"), so the
    ladder never falls for K: wide beams keep "auto"'s rung and every
    explicit one, on the card and the CPU, and the plain top-k, kernel
    10's CPU side, takes any k."""
    cfg = tiny_cfg()
    cuda, cpu = torch.device("cuda"), torch.device("cpu")

    def rung(device, **kw):
        return resolve_decode_impl(dataclasses.replace(cfg, **kw),
                                   record_alphas=False, device=device)

    assert "beam_size" not in inspect.signature(resolve_decode_impl).parameters
    assert rung(cuda) == "fused_span"
    assert rung(cuda, model_type="pure_scn") == "fused_step"
    assert rung(cuda, enc_quant="int8") == "fused_step"
    for impl in ("fused_span", "fused_step", "fused", "steps"):
        assert rung(cuda, decode_impl=impl) == impl
        assert rung(cpu, decode_impl=impl) == impl
    assert decoders.resolve_attention_impl(cfg, cuda) == "kernel"
    gen = torch.Generator().manual_seed(K)
    x = torch.randn((3, K + 50), generator=gen)
    x[0, :K] = 10.0                         # K-way tie, taken in id order
    vals, idx = topk.row_topk_pallas(x, K)
    ref_v, ref_i = topk.row_topk_iterative(x, K)
    assert idx.dtype == torch.int32 and torch.equal(idx.long(), ref_i)
    assert torch.equal(vals, ref_v)
    assert idx[0].tolist() == list(range(K))


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


def test_packed_weights_are_kept_per_tree():
    """step_cuda.pack_step_weights packs a tree once per type: the same
    tensors, unchanged, give the same dict back; an in-place update, a
    new tree or another type packs anew, and a tree of inference tensors
    is never kept."""
    cfg = ModelConfig(**PROBE)
    params = decoders.init_decoder(torch.Generator().manual_seed(0), cfg)
    first = step_cuda.pack_step_weights(params, cfg, torch.float32)
    assert step_cuda.pack_step_weights(params, cfg, torch.float32) is first
    with torch.no_grad():
        params["fc"]["w"].add_(1.0)
    again = step_cuda.pack_step_weights(params, cfg, torch.float32)
    assert again is not first and torch.equal(again["fcw"], params["fc"]["w"])
    hi, lo = step_cuda.pack_tc(params["fc"]["w"], torch.float32)
    assert torch.equal(again["fcw_t"], hi) and torch.equal(again["fcw_tlo"], lo)
    bf = step_cuda.pack_step_weights(params, cfg, torch.bfloat16)
    assert bf["fcw_t"].dtype == torch.bfloat16 and "fcw_tlo" not in bf
    other = decoders.init_decoder(torch.Generator().manual_seed(0), cfg)
    assert step_cuda.pack_step_weights(other, cfg, torch.float32) \
        is not again
    with torch.inference_mode():
        frozen = decoders.cast_params(params, torch.bfloat16)
        a = step_cuda.pack_step_weights(frozen, cfg, torch.bfloat16)
        assert step_cuda.pack_step_weights(frozen, cfg, torch.bfloat16) \
            is not a
