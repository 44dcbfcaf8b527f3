"""The fused decode step's weight packs (``ops/step_cuda.py``) on the CPU.

Kernels 2, 6b and 6c read their weights in packed forms made once per
packed tree (``step_cuda.step_packs``): K-major rows padded to 16 bytes, as
stored (no TF32 split), the products of h side by side ([wda | wfb | wh]),
and the cell's four gates of 64 units interleaved (so the cell runs in the
epilogue of the product that makes its pre-activations).  Each pack must
unpack exactly to the weights as the JAX package lays them out
(``step_pallas.pack_step_weights``), for the three families at ragged
widths, and the plain step fed the unpacked weights must still match the
Pallas step in interpret mode, within the 1e-5 of
``tests/test_torch_decode.py`` (summation order).  Inputs come from numpy
with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indonesian_image_captioning_tpu.core.config import \
    ModelConfig as JaxModelConfig
from indonesian_image_captioning_tpu.models import attention as jax_attention
from indonesian_image_captioning_tpu.models import decoders as jax_decoders
from indonesian_image_captioning_tpu.ops import attention_pallas, step_pallas
from indonesian_image_captioning_tpu_torch.core.config import ModelConfig
from indonesian_image_captioning_tpu_torch.models.jax_bridge import \
    params_from_jax
from indonesian_image_captioning_tpu_torch.ops import step_cuda, train_cuda

torch.set_num_threads(1)
F32, BF16 = torch.float32, torch.bfloat16
FAMILIES = ("attention_scn", "pure_attention", "pure_scn")
TOL = 1e-5


def cfg_kw(model_type):
    # ragged widths: D = 36 and F = 20 are no multiple of the 64-row tile
    # or of eight values (a bf16 row of 16 bytes); so are Emb, A, E and V
    return dict(model_type=model_type, vocab_size=50, embed_dim=26,
                attention_dim=40, decoder_dim=36, factored_dim=20,
                semantic_dim=10, encoder_dim=44, enc_image_size=3)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def cell_of(model_type):
    return "lstm" if model_type == "pure_attention" else "scn"


def packs_of(model_type, dtype, seed=0):
    """JAX's pack_step_weights (float32) and the port's step packs of the
    same weights in dtype."""
    jcfg = JaxModelConfig(**cfg_kw(model_type))
    p = jax_decoders.init_decoder(jax.random.key(seed), jcfg)
    jw = step_pallas.pack_step_weights(p, jcfg, jnp.float32)
    cfg = ModelConfig(**cfg_kw(model_type))
    tw = step_cuda.pack_step_weights(params_from_jax(p), cfg, dtype)
    packs, offs = step_cuda.step_packs(tw, cell_of(model_type))
    return p, jcfg, jw, cfg, tw, packs, offs


def unpack(packs, offs, cfg):
    """The step packs back to the JAX layout's weights (fcw unpadded)."""
    A, E, D = cfg.attention_dim, cfg.encoder_dim, cfg.decoder_dim
    Emb, F = cfg.embed_dim, cfg.factored_dim
    att = cfg.model_type != "pure_scn"
    w1 = train_cuda.unpack_kmajor(packs["w1"], D)
    out = {"fcw": train_cuda.unpack_kmajor(packs["fcw"], D)}
    if att:
        out["wda"], out["wfb"] = w1[:, :A], w1[:, A:A + E]
    if cfg.model_type == "pure_attention":
        assert w1.shape[1] == A + E
        cat = train_cuda.unpack_gates(packs["wg"], packs["wg"].shape[1], D)
        out["wih"] = torch.cat([cat[offs[0]:offs[0] + Emb],
                                cat[offs[1]:offs[1] + E]])
        out["wh"] = cat[offs[2]:offs[2] + D]
    else:
        out["wh"] = w1[:, A + E:] if att else w1
        out["wxe"] = train_cuda.unpack_kmajor(packs["wxe"], Emb)
        if att:
            out["wxa"] = train_cuda.unpack_kmajor(packs["wxa"], E)
        assert offs[1] == packs["wg"].shape[1] // 2
        out["wxp"], out["whp"] = train_cuda.unpack_scn_gates(packs["wg"], F,
                                                             D)
    return out


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("model_type", FAMILIES)
def test_step_packs_unpack_to_the_jax_layout(model_type, dtype):
    """Every pack unpacks exactly to JAX's pack_step_weights (cast to
    dtype): W as stored, never split; rows on 16 bytes, each source of
    the gate pack starting on 16 bytes; bxh = bx + bh in float32."""
    _, _, jw, cfg, tw, packs, offs = packs_of(model_type, dtype)
    back = unpack(packs, offs, cfg)
    V = cfg.vocab_size
    for name, w in back.items():
        ref = np.asarray(jw[name])
        if name == "fcw":
            ref = ref[:, :V]
        assert w.dtype == dtype, name
        assert torch.equal(w, t(ref).to(dtype)), name
    for name, p in packs.items():
        if name != "bxh":
            assert p.dtype == dtype and p.is_contiguous(), name
            assert p.shape[1] * p.element_size() % 16 == 0, name
    assert all(o % train_cuda.KPAD == 0 for o in offs)
    bxh = (t(np.asarray(jw["bx"])) + t(np.asarray(jw["bh"]))).reshape(-1)
    if dtype == BF16:   # the biases as the kernels read them: cast, summed
        bxh = (t(np.asarray(jw["bx"])).to(BF16).float()
               + t(np.asarray(jw["bh"])).to(BF16).float()).reshape(-1)
    assert packs["bxh"].dtype == F32 and torch.equal(packs["bxh"], bxh)


@pytest.mark.parametrize("model_type", FAMILIES)
def test_plain_step_on_unpacked_weights_matches_the_pallas_step(model_type):
    """fused_decode_step_plain on the weights unpacked from the step packs
    against the Pallas step (interpret mode): topi exactly, the rest
    within 1e-5."""
    p, jcfg, jw, cfg, tw, packs, offs = packs_of(model_type, F32, seed=1)
    rng = np.random.default_rng(3)
    B, K = 8, 3          # rows: a multiple of the Pallas step's 8
    R, P = B * K, jcfg.num_pixels
    enc = (rng.normal(size=(B, P, jcfg.encoder_dim)) * 0.5).astype(
        np.float32)
    emb = (rng.normal(size=(R, jcfg.embed_dim)) * 0.1).astype(np.float32)
    h = (rng.normal(size=(R, jcfg.decoder_dim)) * 0.5).astype(np.float32)
    c = (rng.normal(size=(R, jcfg.decoder_dim)) * 0.5).astype(np.float32)
    F4 = 4 * jcfg.factored_dim
    semx = rng.uniform(size=(R, F4)).astype(np.float32)
    semh = rng.uniform(size=(R, F4)).astype(np.float32)
    cell = cell_of(model_type)
    if cell == "lstm":
        semx = semh = None
    weights = {**tw, **unpack(packs, offs, cfg)}
    ts = [None if x is None else t(x) for x in (emb, h, c, semx, semh)]
    if jcfg.uses_attention:
        ea = np.asarray(jax_attention.precompute(p["attention"], enc))
        ref = step_pallas.fused_decode_step(
            jw, attention_pallas.pad_pixels(enc),
            attention_pallas.pad_pixels(ea), emb, h, c, semx, semh,
            num_pixels=P, cell=cell, vocab_size=jcfg.vocab_size,
            interpret=True)
        out = step_cuda.fused_decode_step_plain(weights, t(enc), t(ea), *ts,
                                                cell=cell, topk=K)
    else:
        ref = step_pallas.fused_decode_step_noattn(
            jw, emb, h, c, semx, semh, beam_k=K,
            vocab_size=jcfg.vocab_size, interpret=True)
        out = step_cuda.fused_decode_step_plain(weights, None, None, *ts,
                                                cell=cell, topk=K)
    assert (out[1].numpy() == np.asarray(ref[1])).all()
    for a, b in zip((out[0], out[2], out[3], out[4]),
                    (ref[0], ref[2], ref[3], ref[4])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                   rtol=0)


def test_step_packs_are_made_once_per_tree():
    """The same packed dict gives the same packs; an in-place edit of one
    of its tensors, or a dict holding a tensor of another type, is seen
    when the packs are made."""
    cfg = ModelConfig(**cfg_kw("attention_scn"))
    jcfg = JaxModelConfig(**cfg_kw("attention_scn"))
    params = params_from_jax(jax_decoders.init_decoder(jax.random.key(2),
                                                       jcfg))
    tw = step_cuda.pack_step_weights(params, cfg, F32)
    first = step_cuda.step_packs(tw, "scn")
    assert step_cuda.step_packs(tw, "scn") is first
    tw["wxe"].add_(1.0)                      # in place: a new version
    again = step_cuda.step_packs(tw, "scn")
    assert again is not first
    assert torch.equal(train_cuda.unpack_kmajor(again[0]["wxe"],
                                                cfg.embed_dim), tw["wxe"])
    bad = dict(tw, wh=tw["wh"].to(BF16))
    with pytest.raises(TypeError):
        step_cuda.step_packs(bad, "scn")


def test_pack_gates_cat_starts_each_source_on_16_bytes():
    """pack_gates_cat: segments at multiples of KPAD values, zeros between
    them, and each segment back exactly."""
    rng = np.random.default_rng(5)
    H = 36
    ws = [t(rng.normal(size=(k, 4 * H))) for k in (26, 44, 36)]
    pack, offs = step_cuda.pack_gates_cat(ws, H, F32)
    assert offs == [0, 32, 80] and pack.shape[1] == 120
    cat = train_cuda.unpack_gates(pack, pack.shape[1], H)
    for o, w in zip(offs, ws):
        assert torch.equal(cat[o:o + w.shape[0]], w)
    assert not cat[26:32].any() and not cat[76:80].any()
