"""The train scan's weight packs (``ops/train_cuda.py``) on the CPU.

Kernels 8 and 9 read their weights in packed forms: K-major rows padded to
16 bytes, the four gates of 64 units interleaved (so the cell runs in the
epilogue of the product that makes its pre-activations), and the SCN gate
weights [wxp_g | whp_g] side by side.  Each pack must unpack exactly to the
weights as the JAX package lays them out (``train_pallas.pack_train_weights``),
and the plain scan fed the unpacked weights must still match the Pallas
pair in interpret mode, within the 1e-5 of ``tests/test_torch_train.py``
(summation order).  Inputs come from numpy with a seed.
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
from indonesian_image_captioning_tpu.models import scn_cell as jax_scn_cell
from indonesian_image_captioning_tpu.ops import train_pallas
from indonesian_image_captioning_tpu.ops.attention_pallas import pad_pixels
from indonesian_image_captioning_tpu_torch.core.config import ModelConfig
from indonesian_image_captioning_tpu_torch.models.jax_bridge import \
    params_from_jax
from indonesian_image_captioning_tpu_torch.ops import step_cuda, train_cuda

torch.set_num_threads(1)
B, P, T = 5, 9, 4
F32, BF16 = torch.float32, torch.bfloat16


def cfg_kw(model_type):
    # ragged widths: D = 36 and F = 20 are no multiple of the 64-row tile
    # or of eight values (a bf16 row of 16 bytes)
    return dict(model_type=model_type, vocab_size=50, embed_dim=24,
                attention_dim=40, decoder_dim=36, factored_dim=20,
                semantic_dim=10, encoder_dim=44, enc_image_size=3,
                max_caption_len=T + 1, train_span=T, dropout=0.0)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def jax_weights(model_type, seed=0):
    jcfg = JaxModelConfig(**cfg_kw(model_type))
    p = jax_decoders.init_decoder(jax.random.key(seed), jcfg)
    return p, jcfg, train_pallas.pack_train_weights(p, jcfg, jnp.float32)


def unpack_fwd(packs, cell, dims):
    """The forward's packs back to the JAX layout's wda, wfb, wh, wxa
    (and wxp, whp)."""
    A, E, D, F4 = dims
    Nh = 4 * D if cell == "lstm" else F4
    w1 = train_cuda.unpack_kmajor(packs["w1"], D)
    out = {"wda": w1[:, :A], "wfb": w1[:, A:A + E], "wh": w1[:, A + E:]}
    assert w1.shape[1] == A + E + Nh
    if cell == "lstm":
        out["wxa"] = train_cuda.unpack_gates(packs["wxa_p"], E, D)
    else:
        out["wxa"] = train_cuda.unpack_kmajor(packs["wxa_p"], E)
        out["wxp"], out["whp"] = train_cuda.unpack_scn_gates(
            packs["wg"], F4 // 4, D)
    return out


def unpack_bwd(packs, cell, dims, part="hi"):
    """Pass A's packs back to the JAX layout: their TF32 hi or lo parts at
    float32 (part), the weights themselves at bfloat16."""
    A, E, D, F4 = dims

    def get(name):
        w = packs[f"{name}_{part}"]
        return packs[f"{name}_hi"] if w is None else w

    w1 = train_cuda.unpack_kmajor(get("w1"), D)
    out = {"wda": w1[:, :A], "wfb": w1[:, A:A + E], "wh": w1[:, A + E:],
           "wxa": train_cuda.unpack_kmajor(get("wxan"), E)}
    if cell == "scn":
        F = F4 // 4
        for n in ("wxp", "whp"):   # pack_tc: per gate (H, F) = W_g^T
            out[n] = get(n).reshape(4, D, F).transpose(1, 2).reshape(
                4 * F, D)
    return out


def tf32_parts(w, part):
    """The TF32 part of w that csrc/mma.cuh's 3xTF32 reads (pack_tc)."""
    if w.dtype != F32:
        return w
    hi = step_cuda.tf32_round(w)
    return hi if part == "hi" else step_cuda.tf32_round(w - hi)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("K, N, H", [(37, 72, 18), (512, 256, 64),
                                     (24, 4 * 65, 65)])
def test_generic_packs_unpack_exactly(dtype, K, N, H):
    """pack_kmajor (rows padded to 16 bytes), pack_gates (units past H are
    zero rows; row (4 u + g) 64 + j is unit u 64 + j of gate g) and
    pack_scn_gates, each against its inverse and one element by hand."""
    rng = np.random.default_rng(K + N)
    w = t(rng.normal(size=(K, N)))
    p = train_cuda.pack_kmajor(w, dtype)
    assert p.dtype == dtype and p.shape == (N, -(-K // 8) * 8)
    assert p.shape[1] * p.element_size() % 16 == 0
    assert torch.equal(train_cuda.unpack_kmajor(p, K), w.to(dtype))
    assert not p[:, K:].any()
    wg = t(rng.normal(size=(K, 4 * H)))
    pg = train_cuda.pack_gates(wg, H, dtype)
    Hp = -(-H // 64) * 64
    assert pg.shape == (4 * Hp, -(-K // 8) * 8)
    assert torch.equal(train_cuda.unpack_gates(pg, K, H), wg.to(dtype))
    u, g, j = (H - 1) // 64, 2, (H - 1) % 64
    assert pg[(4 * u + g) * 64 + j, K - 1] == wg[K - 1, g * H + H - 1].to(
        dtype)
    if H % 64:
        assert not pg[(4 * u + 3) * 64 + j + 1:].any()
    F = max(K // 4, 1)
    wxp, whp = (t(rng.normal(size=(4 * F, H))) for _ in range(2))
    ps = train_cuda.pack_scn_gates(wxp, whp, dtype)
    Fp = -(-F // 8) * 8
    assert ps.shape == (4 * Hp, 2 * Fp)
    a, b = train_cuda.unpack_scn_gates(ps, F, H)
    assert torch.equal(a, wxp.to(dtype)) and torch.equal(b, whp.to(dtype))
    assert ps[(4 * u + g) * 64 + j, Fp + F - 1] == whp[
        g * F + F - 1, H - 1].to(dtype)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("model_type", ["attention_scn", "pure_attention"])
def test_train_packs_unpack_to_the_jax_layout(model_type, dtype):
    """pack_fwd and pack_bwd of the port's weights unpack exactly to JAX's
    pack_train_weights (cast to dtype); at float32 pass A's packs hold the
    weights' TF32 hi and lo parts, each exactly."""
    p, jcfg, jkw = jax_weights(model_type)
    cfg = ModelConfig(**cfg_kw(model_type))
    cell = train_cuda.cell_of(cfg)
    kw = train_cuda.pack_train_weights(params_from_jax(p), cfg, dtype)
    dims = (cfg.attention_dim, cfg.encoder_dim, cfg.decoder_dim,
            kw["wxa"].shape[1])
    unpacked = [(unpack_fwd(train_cuda.pack_fwd(kw, cell, dtype), cell,
                            dims), "whole")]
    bwd = train_cuda.pack_bwd(kw, cell, dtype)
    for part in ("hi", "lo"):
        unpacked.append((unpack_bwd(bwd, cell, dims, part), part))
    for back, part in unpacked:
        for name, w in back.items():
            assert w.dtype == dtype
            ref = t(np.asarray(jkw[name]).reshape(w.shape)).to(dtype)
            if part != "whole":
                ref = tf32_parts(ref, part)
            assert torch.equal(w, ref), (name, part)
            if part == "whole":
                assert torch.equal(w, kw[name]), name
    if dtype == BF16:
        assert bwd["w1_lo"] is None and bwd["wxan_lo"] is None


def scan_inputs(model_type):
    """The Pallas pair's inputs (JAX arrays, pixels padded) and the port's,
    on seeded numpy data."""
    p, jcfg, jkw = jax_weights(model_type, seed=1)
    cfg = ModelConfig(**cfg_kw(model_type))
    rng = np.random.default_rng(7)
    enc = jnp.asarray(rng.normal(size=(B, P, cfg.encoder_dim)) * 0.3,
                      jnp.float32)
    tags = jnp.asarray(rng.uniform(size=(B, cfg.semantic_dim)), jnp.float32)
    ea = jax_attention.precompute(p["attention"], enc)
    emb = jnp.asarray(rng.normal(size=(B, T, cfg.embed_dim)) * 0.5,
                      jnp.float32)
    step = p["decode_step"]
    cell = train_cuda.cell_of(cfg)
    if cell == "lstm":
        semx = semh = jnp.zeros((B, 1), jnp.float32)
        w_x_emb = step["w_ih"][:cfg.embed_dim]
    else:
        sx, sh = jax_scn_cell.semantic_projections(step, tags)
        semx, semh = sx.reshape(B, -1), sh.reshape(B, -1)
        w_x_emb = step["w_x"][:cfg.embed_dim]
    h0, c0 = jax_decoders.init_hidden_state(p, enc)
    emb_fac = emb @ w_x_emb
    j = (jkw, pad_pixels(enc), pad_pixels(ea), emb_fac, semx, semh, h0, c0)
    kw = train_cuda.pack_train_weights(params_from_jax(p), cfg, F32)
    port = (kw, t(enc), t(ea), t(emb_fac),
            t(semx) if cell == "scn" else None,
            t(semh) if cell == "scn" else None, t(h0), t(c0))
    return j, port, cell, cfg


@pytest.mark.parametrize("model_type", ["attention_scn", "pure_attention"])
def test_plain_scan_on_unpacked_weights_matches_the_pallas_pair(model_type):
    """train_fwd_plain and train_bwd_plain on the weights unpacked from
    pack_fwd and pack_bwd against _fwd_call and _bwd_call (interpret
    mode): every output, sliced to P."""
    j, port, cell, cfg = scan_inputs(model_type)
    kw = port[0]
    dims = (cfg.attention_dim, cfg.encoder_dim, cfg.decoder_dim,
            kw["wxa"].shape[1])
    static = dict(span=T, num_pixels=P, img_tile=32, interpret=True)
    jh, jc, jal, jawe = train_pallas._fwd_call(*j, **static, save_awe=True)
    kw_f = {**kw, **unpack_fwd(train_cuda.pack_fwd(kw, cell, F32), cell,
                               dims)}
    h_all, c_all, alphas, awe_raw = train_cuda.train_fwd_plain(
        kw_f, *port[1:], cell=cell)
    for name, ours, ref in (("h_all", h_all, jh), ("c_all", c_all, jc),
                            ("alphas", alphas, jal[:, :, :P]),
                            ("awe_raw", awe_raw, jawe)):
        ref = np.asarray(ref)
        err = float(np.abs(ours.numpy() - ref).max())
        assert err <= 1e-5 * max(float(np.abs(ref).max()), 1e-30), name

    rng = np.random.default_rng(11)
    d_hall = rng.normal(size=(B, T, cfg.decoder_dim)).astype(np.float32)
    d_alphas = (rng.normal(size=(B, T, P)) * 0.1).astype(np.float32)
    d_alphas_p = np.zeros(jal.shape, np.float32)
    d_alphas_p[:, :, :P] = d_alphas
    d_ea, d_emb, d_semx, d_semh, dh0, dc0, _ = train_pallas._bwd_call(
        *j, jh, jc, jal, jawe, jnp.asarray(d_hall), jnp.asarray(d_alphas_p),
        **static)
    bwd = train_cuda.pack_bwd(kw, cell, F32)
    hi, lo = (unpack_bwd(bwd, cell, dims, part) for part in ("hi", "lo"))
    kw_b = {**kw, **{n: hi[n] + lo[n] for n in hi}}   # 3xTF32's weights
    g = train_cuda.train_bwd_plain(kw_b, *port[1:], t(jh), t(jc),
                                   t(jal[:, :, :P]), t(jawe), t(d_hall),
                                   t(d_alphas), cell=cell)
    pairs = [("d_ea", g["d_ea"], d_ea[:, :P]), ("d_emb", g["d_emb"], d_emb),
             ("dh0", g["dh0"], dh0), ("dc0", g["dc0"], dc0)]
    if cell == "scn":
        pairs += [("d_semx", g["d_semx"], d_semx),
                  ("d_semh", g["d_semh"], d_semh)]
    for name, ours, ref in pairs:
        ref = np.asarray(ref)
        err = float(np.abs(ours.numpy() - ref).max())
        assert err <= 1e-5 * max(float(np.abs(ref).max()), 1e-30), name
