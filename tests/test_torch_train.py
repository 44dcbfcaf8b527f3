"""The port's teacher-forcing scan against the JAX package, on the CPU.

Kernels 8 and 9 (``ops/train_cuda.py``) take their plain versions here, as
the tensors lie on the CPU; the JAX Pallas pair runs in interpret mode.
Sizes follow ``tests/test_train_fused.py`` (B=16, P=9, T=7, narrow
widths); inputs come from numpy with a seed and weights cross over through
``params_from_jax``.  Tolerances, float32: the plain kernels against the
Pallas pair 1e-5 of each output's largest magnitude (summation order);
``teacher_forcing`` values 1e-5 of scale; ``caption_loss`` gradients
against ``jax.grad`` of the JAX eager scan 1e-4 of each leaf's largest
value for the port's eager scan and 5e-3 for the fused route (the JAX
contract of ``tests/test_train_fused.py``: the backward recomputes with
another association, and the recurrence amplifies it).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indonesian_image_captioning_tpu.core.config import \
    ModelConfig as JaxModelConfig
from indonesian_image_captioning_tpu.models import decoders as jax_decoders
from indonesian_image_captioning_tpu.models import scn_cell as jax_scn_cell
from indonesian_image_captioning_tpu.ops import losses as jax_losses
from indonesian_image_captioning_tpu.ops import train_pallas
from indonesian_image_captioning_tpu.ops.attention_pallas import pad_pixels
from indonesian_image_captioning_tpu_torch.core.config import ModelConfig
from indonesian_image_captioning_tpu_torch.models import decoders
from indonesian_image_captioning_tpu_torch.models.jax_bridge import \
    params_from_jax
from indonesian_image_captioning_tpu_torch.ops import losses, train_cuda

torch.set_num_threads(1)
B, P, T = 16, 9, 7
FAMILIES = ("attention_scn", "pure_attention", "pure_scn")


def cfg_kw(model_type):
    return dict(model_type=model_type, vocab_size=50, embed_dim=24,
                attention_dim=40, decoder_dim=32, factored_dim=16,
                semantic_dim=10, encoder_dim=48, enc_image_size=3,
                max_caption_len=T + 1, train_span=T, dropout=0.0)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def rel_err(ours, ref):
    ref = np.asarray(ref, np.float32)
    ours = ours.detach().float().numpy() if torch.is_tensor(ours) \
        else np.asarray(ours, np.float32)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    scale = float(np.abs(ref).max())
    return float(np.abs(ours - ref).max()) / max(scale, 1e-30), scale


def assert_close(ours, ref, tol, name=""):
    err, _ = rel_err(ours, ref)
    assert err < tol, f"{name}: relative error {err} >= {tol}"


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """Weights, inputs and the JAX eager scan's outputs and gradients."""
    mt = request.param
    jcfg = JaxModelConfig(**cfg_kw(mt))
    cfg = ModelConfig(**cfg_kw(mt))
    rng = np.random.default_rng(FAMILIES.index(mt))
    jparams = jax_decoders.init_decoder(jax.random.key(0), jcfg)
    enc = (rng.normal(size=(B, P, cfg.encoder_dim)) * 0.3).astype(np.float32)
    tags = rng.uniform(size=(B, cfg.semantic_dim)).astype(np.float32)
    caps = rng.integers(1, cfg.vocab_size, size=(B, T + 1)).astype(np.int32)
    caplens = rng.integers(2, T + 2, size=(B,)).astype(np.int32)

    def jloss(p):
        out = jax_decoders.teacher_forcing(
            p, dataclasses.replace(jcfg, train_scan_impl="xla"), enc, tags,
            caps, caplens, train=True)
        return jax_losses.caption_loss(out, caps, alpha_c=1.0)[0]

    ref = jax_decoders.teacher_forcing(
        jparams, dataclasses.replace(jcfg, train_scan_impl="xla"), enc, tags,
        caps, caplens)
    hid = jax_decoders.teacher_forcing(
        jparams, dataclasses.replace(jcfg, train_scan_impl="xla"), enc, tags,
        caps, caplens, return_hidden=True)
    jgrads = jax.grad(jloss)(jparams)
    return dict(cfg=cfg, jcfg=jcfg, jparams=jparams, enc=enc, tags=tags,
                caps=caps, caplens=caplens, ref=ref, hidden=hid["hidden"],
                jgrads=jgrads, jloss=float(jloss(jparams)))


def port_inputs(f):
    params = params_from_jax(f["jparams"])
    return (params, t(f["enc"]), t(f["tags"]),
            torch.from_numpy(f["caps"]).long(),
            torch.from_numpy(f["caplens"]).long())


def scan_inputs(model_type):
    """The kernels' inputs, as the JAX fused_teacher_forcing_scan builds
    them (JAX arrays, pixels padded) and as the port's wrapper does."""
    from indonesian_image_captioning_tpu.models import attention as jattn
    jcfg = JaxModelConfig(**cfg_kw(model_type))
    cfg = ModelConfig(**cfg_kw(model_type))
    p = jax_decoders.init_decoder(jax.random.key(1), jcfg)
    rng = np.random.default_rng(5)
    enc = jnp.asarray(rng.normal(size=(B, P, cfg.encoder_dim)) * 0.3,
                      jnp.float32)
    tags = jnp.asarray(rng.uniform(size=(B, cfg.semantic_dim)), jnp.float32)
    ea = jattn.precompute(p["attention"], enc)
    emb = jnp.asarray(rng.normal(size=(B, T, cfg.embed_dim)) * 0.5,
                      jnp.float32)
    cell = p["decode_step"]
    if cfg.model_type == "pure_attention":
        semx = semh = jnp.zeros((B, 1), jnp.float32)
        w_x_emb = cell["w_ih"][:cfg.embed_dim]
    else:
        sx, sh = jax_scn_cell.semantic_projections(cell, tags)
        semx, semh = sx.reshape(B, -1), sh.reshape(B, -1)
        w_x_emb = cell["w_x"][:cfg.embed_dim]
    h0, c0 = jax_decoders.init_hidden_state(p, enc)
    emb_fac = emb @ w_x_emb
    j = dict(kw=train_pallas.pack_train_weights(p, jcfg, jnp.float32),
             enc_p=pad_pixels(enc), ea_p=pad_pixels(ea), emb_fac=emb_fac,
             semx=semx, semh=semh, h0=h0, c0=c0)
    cell_kind = train_cuda.cell_of(cfg)
    port = dict(kw=train_cuda.pack_train_weights(params_from_jax(p), cfg,
                                                 torch.float32),
                enc=t(enc), ea=t(ea), emb_fac=t(emb_fac),
                semx=t(semx) if cell_kind == "scn" else None,
                semh=t(semh) if cell_kind == "scn" else None,
                h0=t(h0), c0=t(c0))
    return j, port, cell_kind


@pytest.mark.parametrize("model_type", ["attention_scn", "pure_attention"])
def test_plain_kernels_match_the_pallas_pair(model_type):
    """train_fwd_plain against _fwd_call and train_bwd_plain (with the
    stream products) against _bwd_call, both in interpret mode: every
    output, sliced to T and P; the streams through the weight gradients
    they give, against JAX's.  (pure_scn has no fused scan, as in JAX.)"""
    j, port, cell = scan_inputs(model_type)
    args = (j["kw"], j["enc_p"], j["ea_p"], j["emb_fac"], j["semx"],
            j["semh"], j["h0"], j["c0"])
    static = dict(span=T, num_pixels=P, img_tile=32, interpret=True)
    jh, jc, jal, jawe = train_pallas._fwd_call(*args, **static,
                                               save_awe=True)
    pargs = (port["kw"], port["enc"], port["ea"], port["emb_fac"],
             port["semx"], port["semh"], port["h0"], port["c0"])
    h_all, c_all, alphas, awe_raw = train_cuda.train_fwd(*pargs, cell=cell)
    for name, ours, ref in (("h_all", h_all, jh), ("c_all", c_all, jc),
                            ("alphas", alphas, jal[:, :, :P]),
                            ("awe_raw", awe_raw, jawe)):
        assert_close(ours, ref, 1e-5, name)
    assert alphas.dtype == torch.float32

    rng = np.random.default_rng(11)
    d_hall = rng.normal(size=(B, T, h_all.shape[-1])).astype(np.float32)
    d_alphas = (rng.normal(size=(B, T, P)) * 0.1).astype(np.float32)
    d_alphas_p = np.zeros(jal.shape, np.float32)
    d_alphas_p[:, :, :P] = d_alphas
    d_ea, d_emb, d_semx, d_semh, dh0, dc0, d_kw = train_pallas._bwd_call(
        *args, jh, jc, jal, jawe, jnp.asarray(d_hall), jnp.asarray(d_alphas_p),
        **static)
    g = train_cuda.train_bwd(*pargs, t(jh), t(jc), t(jal[:, :, :P]),
                             t(jawe), t(d_hall), t(d_alphas), cell=cell)
    wg = train_cuda.stream_weight_grads(
        g, train_cuda._prev(t(j["h0"]), t(jh)), cell=cell)
    wg["wf"] = g["d_wf"]
    pairs = [("d_ea", g["d_ea"], d_ea[:, :P]), ("d_emb", g["d_emb"], d_emb),
             ("dh0", g["dh0"], dh0), ("dc0", g["dc0"], dc0)]
    if cell == "scn":
        pairs += [("d_semx", g["d_semx"], d_semx),
                  ("d_semh", g["d_semh"], d_semh)]
    for name in train_cuda.WEIGHT_NAMES[cell]:
        pairs.append((name, wg[name], np.asarray(d_kw[name]).reshape(
            wg[name].shape)))
    for name, ours, ref in pairs:
        assert_close(ours, ref, 1e-5, name)


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_teacher_forcing_matches_jax(family, impl):
    """predictions, alphas, mask and the hidden states of return_hidden,
    against the JAX eager scan."""
    cfg = dataclasses.replace(family["cfg"], train_scan_impl=impl)
    params, enc, tags, caps, caplens = port_inputs(family)
    out = decoders.teacher_forcing(params, cfg, enc, tags, caps, caplens)
    ref = family["ref"]
    assert_close(out["predictions"], ref["predictions"], 1e-5, "predictions")
    np.testing.assert_array_equal(out["mask"].numpy(), np.asarray(
        ref["mask"]))
    if cfg.uses_attention:
        assert_close(out["alphas"], ref["alphas"], 1e-5, "alphas")
    else:
        assert out["alphas"] is None and ref["alphas"] is None
    hid = decoders.teacher_forcing(params, cfg, enc, tags, caps, caplens,
                                   return_hidden=True)
    assert "predictions" not in hid
    assert_close(hid["hidden"], family["hidden"], 1e-5, "hidden")
    assert hid["mask"].dtype == torch.float32


@pytest.mark.parametrize("impl, tol", [("xla", 1e-4), ("fused", 5e-3)])
def test_caption_loss_gradients_match_jax(family, impl, tol):
    cfg = dataclasses.replace(family["cfg"], train_scan_impl=impl)
    params, enc, tags, caps, caplens = port_inputs(family)
    leaves = []

    def walk(tree, path=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{path}{k}/")
            else:
                v.requires_grad_(True)
                leaves.append((path + k, v))

    walk(params)
    out = decoders.teacher_forcing(params, cfg, enc, tags, caps, caplens,
                                   train=True)
    loss, aux = losses.caption_loss(out, caps, alpha_c=1.0)
    loss.backward()
    assert abs(loss.item() - family["jloss"]) < 1e-5 * max(
        1.0, abs(family["jloss"]))
    jflat = {jax.tree_util.keystr(path, simple=True, separator="/"): g
             for path, g in jax.tree_util.tree_leaves_with_path(
                 family["jgrads"])}
    assert set(jflat) == {name for name, _ in leaves}
    for name, leaf in leaves:
        ref = np.asarray(jflat[name])
        if float(np.abs(ref).max()) < 1e-7:   # full_att bias: zero in math
            assert leaf.grad is None or float(leaf.grad.abs().max()) < 1e-6
            continue
        assert_close(leaf.grad, ref, tol, name)


def test_resolvers():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    scn = ModelConfig(model_type="attention_scn")
    lstm = ModelConfig(model_type="pure_attention")
    pscn = ModelConfig(model_type="pure_scn")
    for cfg in (scn, lstm):
        assert decoders.resolve_train_scan_impl(cfg, cpu) == "xla"
        assert decoders.resolve_train_scan_impl(cfg, cuda) == "fused"
        assert decoders.resolve_train_scan_impl(cfg, cuda,
                                                enc_grad=True) == "xla"
        fused = dataclasses.replace(cfg, train_scan_impl="fused")
        assert decoders.resolve_train_scan_impl(fused, cpu) == "fused"
    for impl in ("auto", "fused"):
        assert decoders.resolve_train_scan_impl(
            dataclasses.replace(pscn, train_scan_impl=impl), cuda) == "xla"
    with pytest.raises(ValueError):
        decoders.resolve_train_scan_impl(
            dataclasses.replace(scn, train_scan_impl="pallas"), cpu)
    assert decoders.resolve_embed_grad_impl(scn) == "onehot"
    assert decoders.resolve_embed_grad_impl(
        dataclasses.replace(scn, embed_grad_impl="pallas")) == "pallas"
    assert not train_cuda.feasible(pscn, torch.float32)
    assert train_cuda.feasible(scn, torch.bfloat16)
    assert not train_cuda.feasible(scn, torch.float16)


def test_embed_lookup_grad_is_the_onehot_product():
    """The one-hot backward equals the gather's scatter-add, tiled or not,
    and JAX's embed_lookup backward."""
    rng = np.random.default_rng(3)
    table = rng.normal(size=(37, 6)).astype(np.float32)
    ids = rng.integers(0, 37, size=(5, 9))
    g = rng.normal(size=(5, 9, 6)).astype(np.float32)
    tt = t(table).requires_grad_(True)
    decoders.embed_lookup(tt, torch.from_numpy(ids)).backward(t(g))
    plain = t(table).requires_grad_(True)
    plain[torch.from_numpy(ids)].backward(t(g))
    np.testing.assert_allclose(tt.grad.numpy(), plain.grad.numpy(),
                               atol=1e-5)
    _, vjp = jax.vjp(lambda x: jax_decoders.embed_lookup(x, ids), table)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(vjp(g)[0]),
                               atol=1e-5)
    old = decoders._ONEHOT_TILE
    try:
        decoders._ONEHOT_TILE = 8
        tiled = t(table).requires_grad_(True)
        decoders._EmbedLookup.apply(tiled, torch.from_numpy(ids)).backward(
            t(g))
    finally:
        decoders._ONEHOT_TILE = old
    # the tiled branch only runs past 2^30 one-hot elements; at this size
    # the single product runs, so both equal the plain scatter
    np.testing.assert_allclose(tiled.grad.numpy(), plain.grad.numpy(),
                               atol=1e-5)


def test_trainable_mask_and_pretrained_embeddings(family):
    params = params_from_jax(family["jparams"])
    mask = decoders.trainable_mask(params, fine_tune_embeddings=False)
    jmask = jax_decoders.trainable_mask(family["jparams"], False)
    assert mask == jax.tree.map(bool, jmask)
    new = np.arange(np.prod(params["embedding"].shape), dtype=np.float32
                    ).reshape(params["embedding"].shape)
    p2 = decoders.load_pretrained_embeddings(params, new)
    np.testing.assert_array_equal(p2["embedding"].numpy(), new)
    assert p2["fc"] is params["fc"]
    with pytest.raises(ValueError):
        decoders.load_pretrained_embeddings(params, new[:3])
