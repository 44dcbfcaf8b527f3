"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one (the ``dev``
fixture decides when the test runs).  On a machine with one, from the
repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest`` leaves out ``tests/conftest.py``, which sets up JAX for
the CPU tests; these tests import only torch and the port.)

``chip_smoke.py`` holds the kernels at the flagship widths.  These hold
them at small, ragged shapes -- pixel counts, widths and row counts that
are not multiples of the kernels' tiles, beam widths 1 to 8 -- and on exact
ties in the head, where the lowest vocabulary id must win.  Tolerances:
1e-5 at float32 (summation order); at bfloat16 a few ulps of the values'
magnitudes (the kernels round once where the plain versions round twice);
ids exactly, except where the two logits are within 1e-5 at float32.
"""

import pytest
import torch

from indonesian_image_captioning_tpu_torch.core.config import (BeamConfig,
                                                               ModelConfig)
from indonesian_image_captioning_tpu_torch.core.runtime import get_device
from indonesian_image_captioning_tpu_torch.decode.api import \
    caption_beam_search
from indonesian_image_captioning_tpu_torch.models import (attention,
                                                          decoders, scn_cell)
from indonesian_image_captioning_tpu_torch.ops import (attention_cuda,
                                                       step_cuda)

pytestmark = pytest.mark.cuda

F32, BF16 = torch.float32, torch.bfloat16
TOL = {F32: {"attend": 1e-5, "vals": 1e-5, "state": 1e-5},
       BF16: {"attend": 3e-2, "vals": 1e-1, "state": 5e-2}}
NEAR_TIE = 1e-5
FAMILIES = ("attention_scn", "pure_attention", "pure_scn")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return get_device("cuda")


def small_cfg(model_type="attention_scn", **kw):
    return ModelConfig(model_type=model_type, vocab_size=203, embed_dim=24,
                       attention_dim=40, decoder_dim=36, factored_dim=20,
                       semantic_dim=30, encoder_dim=72, enc_image_size=3,
                       **kw)


def randn(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen) * scale


def err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("K", [1, 5, 8])
@pytest.mark.parametrize("P, E", [(9, 72), (37, 600)])
def test_attend_kernel_matches_plain(dev, dtype, K, P, E):
    gen = torch.Generator().manual_seed(K * 100 + P)
    B, A = 3, 40
    enc = torch.relu(randn(gen, B, P, E)).to(dev, dtype)
    ea = randn(gen, B, P, A, scale=0.5).to(dev, dtype)
    dec = randn(gen, B, K, A, scale=0.5).to(dev, dtype)
    wf = randn(gen, A).to(dev)
    n0 = attention_cuda.attend_fused.launches
    awe, alpha = attention_cuda.attend_fused(enc, ea, dec, wf)
    ref_awe, ref_alpha = attention_cuda.attend_plain(enc, ea, dec, wf)
    torch.cuda.synchronize()
    assert attention_cuda.attend_fused.launches == n0 + 1
    assert awe.dtype == alpha.dtype == dtype
    assert err(awe, ref_awe) <= TOL[dtype]["attend"]
    assert err(alpha, ref_alpha) <= TOL[dtype]["attend"]
    sums = alpha.float().sum(-1)
    assert err(sums, torch.ones_like(sums)) <= (1e-5 if dtype == F32
                                                else 1e-2)


def _step_case(dev, dtype, cfg, B, K, gen, params=None):
    """Kernel 2 and its plain version on one seeded input of cfg's
    family; returns (kernel outputs, plain outputs, weights)."""
    if params is None:
        params = decoders.init_decoder(gen, cfg, device=dev)
        params["fc"]["b"] = randn(gen, cfg.vocab_size).to(dev)
    R = B * K
    weights = step_cuda.pack_step_weights(params, cfg, dtype)
    emb = randn(gen, R, cfg.embed_dim, scale=0.1).to(dev, dtype)
    h = torch.tanh(randn(gen, R, cfg.decoder_dim)).to(dev, dtype)
    c = randn(gen, R, cfg.decoder_dim, scale=0.5).to(dev, dtype)
    semx = semh = None
    cell = "scn" if cfg.uses_tags else "lstm"
    if cell == "scn":
        tags = torch.rand((B, cfg.semantic_dim), generator=gen).to(dev)
        sx, sh = scn_cell.semantic_projections(params["decode_step"], tags)
        semx, semh = (s.reshape(B, -1).repeat_interleave(K, 0).to(dtype)
                      .contiguous() for s in (sx, sh))
    enc = ea = None
    if cfg.uses_attention:
        enc = torch.relu(randn(gen, B, cfg.num_pixels, cfg.encoder_dim))
        enc = enc.to(dev, dtype)
        ea = attention.precompute(params["attention"], enc.float())
        ea = ea.to(dtype).contiguous()
        out = step_cuda.fused_decode_step(weights, enc, ea, emb, h, c, semx,
                                          semh, cell=cell)
    else:
        out = step_cuda.fused_decode_step_noattn(weights, emb, h, c, semx,
                                                 semh, beam_k=K)
    ref = step_cuda.fused_decode_step_plain(weights, enc, ea, emb, h, c,
                                            semx, semh, cell=cell, topk=K)
    torch.cuda.synchronize()
    return out, ref, weights


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("B, K", [(3, 1), (14, 5), (3, 8)])
def test_fused_step_kernel_matches_plain(dev, family, dtype, B, K):
    cfg = small_cfg(family)
    gen = torch.Generator().manual_seed(B * 10 + K)
    n_step = step_cuda.fused_decode_step.launches
    n_att = attention_cuda.attend_fused.launches
    out, ref, weights = _step_case(dev, dtype, cfg, B, K, gen)
    assert step_cuda.fused_decode_step.launches == n_step + 1
    assert attention_cuda.attend_fused.launches == \
        n_att + int(cfg.uses_attention)
    topv, topi, lse, h_new, c_new = out
    R = B * K
    assert topv.shape == topi.shape == (R, K) and lse.shape == (R, 1)
    assert topv.dtype == lse.dtype == F32 and topi.dtype == torch.int32
    assert err(topv, ref[0]) <= TOL[dtype]["vals"]
    assert err(lse, ref[2]) <= TOL[dtype]["vals"]
    assert err(h_new, ref[3]) <= TOL[dtype]["state"]
    assert err(c_new, ref[4]) <= TOL[dtype]["state"]
    if dtype == F32:
        logits = ref[3] @ weights["fcw"] + weights["fcb"]
        for r, q in (topi != ref[1]).nonzero().tolist():
            a, b = int(topi[r, q]), int(ref[1][r, q])
            assert abs(float(logits[r, a] - logits[r, b])) <= NEAR_TIE


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_head_ties_go_to_the_lowest_id(dev, dtype):
    """Seven vocab columns with equal weights and a bias that lifts them
    above every other logit: each row's top 5 are the five lowest of the
    seven ids, in ascending order, with equal values."""
    cfg = small_cfg()
    gen = torch.Generator().manual_seed(5)
    params = decoders.init_decoder(gen, cfg, device=dev)
    tied = [3, 50, 51, 120, 121, 180, 199]
    params["fc"]["w"][:, tied] = params["fc"]["w"][:, 7:8]
    params["fc"]["b"][tied] = 10.0
    out, _, _ = _step_case(dev, dtype, cfg, 4, 5, gen, params)
    want = torch.tensor(tied[:5], dtype=torch.int32, device=dev)
    assert bool((out[1] == want).all())
    assert bool((out[0] == out[0][:, :1]).all())


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("end_bias", [0.0, 1.2])
def test_decode_on_card_matches_cpu(dev, family, end_bias):
    """The serving rung on the card (fused_step: kernel 2) and the step
    engine with recorded alphas (kernel 1) give the CPU's beams: all 12
    steps without an <end> bias, early completions with one."""
    cfg = small_cfg(family)
    gen = torch.Generator().manual_seed(11)
    params = decoders.init_decoder(gen, cfg)
    V = cfg.vocab_size
    params["fc"]["b"][V - 1] = end_bias
    enc = torch.relu(randn(gen, 6, 3, 3, cfg.encoder_dim, scale=0.5))
    tags = torch.rand((6, cfg.semantic_dim), generator=gen)
    kw = dict(start_id=V - 2, end_id=V - 1,
              beam_cfg=BeamConfig(beam_size=5, max_steps=12))
    for record in (False, True):
        ref = caption_beam_search(params, cfg, enc, tags,
                                  record_alphas=record, **kw)
        out = caption_beam_search(_to(params, dev), cfg, enc.to(dev),
                                  tags.to(dev), record_alphas=record, **kw)
        want = "steps" if record else "fused_step"
        assert ref["decode_impl"] == "steps" and out["decode_impl"] == want
        assert out["steps"] == ref["steps"]
        for k in ("sequences", "lengths", "completed_count",
                  "completed_lengths"):
            assert torch.equal(out[k].cpu(), ref[k]), k
        assert err(out["scores"].cpu(), ref["scores"]) <= 1e-4
        if record and cfg.uses_attention:
            assert err(out["alpha"].cpu(), ref["alpha"]) <= 1e-5
    assert (int(ref["completed_count"].sum()) > 0) == (end_bias > 0)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    gen = torch.Generator().manual_seed(0)
    enc = randn(gen, 2, 9, 16).to(dev)
    ea = randn(gen, 2, 9, 8).to(dev)
    wf = randn(gen, 8).to(dev)
    n0 = attention_cuda.attend_fused.launches
    with pytest.raises(ValueError, match="lanes"):
        attention_cuda.attend_fused(enc, ea, randn(gen, 2, 9, 8).to(dev), wf)
    with pytest.raises(ValueError, match="contiguous"):
        attention_cuda.attend_fused(enc.transpose(1, 2).contiguous()
                                    .transpose(1, 2), ea,
                                    randn(gen, 2, 3, 8).to(dev), wf)
    with pytest.raises(TypeError):
        attention_cuda.attend_fused(enc.half(), ea.half(),
                                    randn(gen, 2, 3, 8).to(dev).half(), wf)
    assert attention_cuda.attend_fused.launches == n0
