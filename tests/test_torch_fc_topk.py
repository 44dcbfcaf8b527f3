"""The port's fused vocab head (kernel 11's plain version,
``ops/fc_topk.py``) against the JAX ``ops/fc_topk_pallas.py fc_topk`` in
interpret mode, on the CPU, at the shapes of tests/test_fc_topk.py: odd
row counts, a vocabulary that is not a multiple of the Pallas tile, one
that crosses a tile boundary, several row tiles, and equal logits (the
lowest id first, lax.top_k's order).  Seeded numpy inputs.  Tolerances:
1e-5 on the raw logits and the log-sum (JAX's own; summation order); ids
exactly.
"""

import jax
import numpy as np
import pytest
import torch

from indonesian_image_captioning_tpu.ops.fc_topk_pallas import \
    fc_topk as jax_fc_topk
from indonesian_image_captioning_tpu_torch.core.config import ModelConfig
from indonesian_image_captioning_tpu_torch.models import decoders, scn_cell
from indonesian_image_captioning_tpu_torch.ops import step_cuda
from indonesian_image_captioning_tpu_torch.ops.fc_topk import fc_topk

torch.set_num_threads(1)
TOL = 1e-5


def close(a, b):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=1e-5)


def _case(seed, R, D, V, wscale=0.3, bias=True):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(R, D)).astype(np.float32)
    w = (rng.normal(size=(D, V)) * wscale).astype(np.float32)
    b = (rng.normal(size=(V,)) if bias else np.zeros(V)).astype(np.float32)
    return h, w, b


@pytest.mark.parametrize("R,D,V,k,r_tile", [
    (7, 16, 40, 5, 256),      # odd rows, V not a tile multiple
    (16, 32, 100, 3, 256),
    (8, 8, 513, 5, 256),      # crosses a vocab tile boundary (v_tile=512)
    (24, 16, 60, 5, 8),       # three row tiles
])
def test_plain_fc_topk_matches_jax(R, D, V, k, r_tile):
    h, w, b = _case(R * 1000 + V, R, D, V, bias=r_tile != 8)
    ref_v, ref_i, ref_lse = jax_fc_topk(h, w, b, k, interpret=True,
                                        r_tile=r_tile)
    tv, ti, lse = fc_topk(*(torch.from_numpy(x) for x in (h, w, b)), k)
    assert tv.dtype == lse.dtype == torch.float32 and ti.dtype == torch.int32
    assert tv.shape == ti.shape == (R, k) and lse.shape == (R,)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ref_i))
    close(tv, ref_v)
    close(lse, ref_lse)
    lse_ref = jax.scipy.special.logsumexp(h @ w + b, axis=1)
    close(lse, lse_ref)


def test_plain_fc_topk_tie_order():
    """Equal logits: the lowest ids, in order, as lax.top_k gives them."""
    R, D, V = 8, 4, 20
    ref_v, ref_i, ref_lse = jax_fc_topk(np.zeros((R, D), np.float32),
                                        np.zeros((D, V), np.float32),
                                        np.zeros((V,), np.float32), 4,
                                        interpret=True)
    tv, ti, lse = fc_topk(torch.zeros((R, D)), torch.zeros((D, V)),
                          torch.zeros(V), 4)
    np.testing.assert_array_equal(ti.numpy(), np.tile(np.arange(4), (R, 1)))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ref_i))
    close(tv, ref_v)
    close(lse, ref_lse)


def test_casts_to_float32_and_checks_k():
    h, w, b = _case(1, 6, 8, 30)
    args = [torch.from_numpy(x) for x in (h, w, b)]
    f32 = fc_topk(*args, 5)
    bf = fc_topk(*(a.to(torch.bfloat16) for a in args), 5)
    want = fc_topk(*(a.to(torch.bfloat16).float() for a in args), 5)
    assert bf[0].dtype == torch.float32
    for a, b_ in zip(bf, want):
        assert torch.equal(a, b_)
    assert not torch.equal(f32[0], bf[0])
    for k in (0, 31):                  # 1 <= k <= V = 30 on CPU tensors
        with pytest.raises(ValueError, match="top-"):
            fc_topk(*args, k)
    wide = fc_topk(*args, 9)           # past 8: the cap is the card's, 32
    assert wide[1].shape == (6, 9) and torch.equal(wide[1][:, :5], f32[1])
    with pytest.raises(ValueError, match="top-"):
        fc_topk(args[0], args[1][:, :3], args[2][:3], 5)


def test_candidates_equal_the_fused_steps():
    """On the h rows of one fused step (kernel 6b's plain version, a
    pure_scn step), topv - lse and topi are the step's own candidates --
    the isolated vocab head of tools/profile_decode.py, as chip_smoke.py
    drives kernel 11."""
    cfg = ModelConfig(model_type="pure_scn", vocab_size=300, embed_dim=10,
                      decoder_dim=12, factored_dim=8, semantic_dim=11)
    gen = torch.Generator().manual_seed(7)
    params = decoders.init_decoder(gen, cfg)
    params["fc"]["b"] = torch.randn((cfg.vocab_size,), generator=gen)
    weights = step_cuda.pack_step_weights(params, cfg, torch.float32)
    B, K = 3, 4
    emb = torch.randn((B * K, cfg.embed_dim), generator=gen) * 0.1
    h, c = (torch.randn((B * K, cfg.decoder_dim), generator=gen)
            for _ in range(2))
    sx, sh = scn_cell.semantic_projections(
        params["decode_step"], torch.rand((B, 11), generator=gen))
    semx, semh = (x.reshape(B, -1).repeat_interleave(K, 0) for x in (sx, sh))
    topv, topi, lse, h_new, _ = step_cuda.fused_decode_step_noattn(
        weights, emb, h, c, semx, semh, beam_k=K)
    tv, ti, tl = fc_topk(h_new, weights["fcw"], weights["fcb"], K)
    assert torch.equal(ti, topi)
    assert float(((tv - tl[:, None]) - (topv - lse)).abs().max()) <= TOL
