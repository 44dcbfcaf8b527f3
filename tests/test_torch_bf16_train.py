"""The port's bfloat16 training path against the JAX package's, on the CPU.

Mixed precision as ``TrainConfig(decoder_dtype="bfloat16")`` runs it: the
parameters cast to bf16 inside the loss, float32 master weights, Adam
moments and gradients.  Seeded numpy inputs, JAX-initialised weights
through ``params_from_jax``, dropout off (the two frameworks draw other
masks).

Tolerances.  XLA on the CPU keeps float32 inside its fusions (excess
precision) and rounds to bf16 only where a value leaves one, while the
port rounds every op's output, so the two bf16 paths differ by a few bf16
ulps (2^-8 relative) where they meet:

* teacher forcing: predictions and alphas within TF_TOL of the largest
  magnitude (measured up to 0.0087);
* the step: the loss within LOSS_TOL relative (measured 9.3e-5), the
  alpha penalty within PEN_TOL relative (it squares each image's
  1 - sum of its bf16 alphas: measured 2.2e-3);
  top-5 within TOP5_TOL relative (JAX's dense head takes its mask in the
  predictions' type, so its top-5 sum rounds to bf16: 6.4375 against the
  port's 6.4516); each clamped gradient within GRAD_TOL of its largest
  value (measured up to 0.024; JAX's own fused-against-eager bf16 bound is
  0.15, tests/test_train_fused.py); full_att's bias, zero in exact
  arithmetic, within GRAD_DUST of the largest gradient; the updated
  parameters within 2 lr of JAX's (Adam's first update is about lr times
  the gradient's sign, so a gradient within bf16 noise of 0 may take the
  other sign) and within UPDATE_TOL lr where JAX's gradient exceeds both
  the step's gradient error tenfold and Adam's eps a thousandfold (there
  lr g / (|g| + eps) moves by less than 1e-4 lr; a float32 parameter near
  0.1 rounds by 7e-9, 2e-5 lr; measured 1.5e-8).

At these widths a float32 decoder lands as close to JAX's bf16 values as
the port's bf16 one does, so the step test also records what the step's
teacher forcing and head are given: bf16 parameters, encodings and tags,
as JAX's step casts them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indonesian_image_captioning_tpu.core.config import \
    ModelConfig as JaxModelConfig
from indonesian_image_captioning_tpu.core.config import \
    TrainConfig as JaxTrainConfig
from indonesian_image_captioning_tpu.models import decoders as jax_decoders
from indonesian_image_captioning_tpu.ops import losses as jax_losses
from indonesian_image_captioning_tpu.train import steps as jax_steps
from indonesian_image_captioning_tpu_torch.core.config import (ModelConfig,
                                                               TrainConfig)
from indonesian_image_captioning_tpu_torch.models import decoders
from indonesian_image_captioning_tpu_torch.models.jax_bridge import \
    params_from_jax
from indonesian_image_captioning_tpu_torch.train import steps

torch.set_num_threads(1)
B, T = 8, 7
TF_TOL = 0.02
LOSS_TOL, PEN_TOL, TOP5_TOL = 1e-3, 1e-2, 2 ** -7
GRAD_TOL, GRAD_DUST, UPDATE_TOL = 0.05, 1e-3, 1e-4
ADAM_EPS = 1e-8
LR = 4e-4
bf16 = jnp.bfloat16


def cfg_kw(model_type):
    return dict(model_type=model_type, vocab_size=41, embed_dim=16,
                attention_dim=12, decoder_dim=16, factored_dim=8,
                semantic_dim=10, encoder_dim=24, enc_image_size=2,
                max_caption_len=T + 1, dropout=0.0, train_span=4)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def rel(ours, ref):
    """Largest absolute error over the reference's largest magnitude."""
    ours = ours.detach().float().numpy() if torch.is_tensor(ours) \
        else np.asarray(ours, np.float32)
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


def by_path(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k, v in tree.items():
        out.update(by_path(v, f"{prefix}{k}/"))
    return out


def jax_by_path(tree):
    return {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def case(model_type):
    kw = cfg_kw(model_type)
    rng = np.random.default_rng(6)
    jparams = jax_decoders.init_decoder(jax.random.key(3),
                                        JaxModelConfig(**kw))
    enc = (rng.normal(size=(B, 2, 2, 24)) * 0.5).astype(np.float32)
    tags = rng.uniform(size=(B, 10)).astype(np.float32)
    caps = rng.integers(1, 41, size=(B, T + 1)).astype(np.int32)
    caplens = rng.integers(2, T + 2, size=(B,)).astype(np.int32)
    return kw, jparams, enc, tags, caps, caplens


@pytest.mark.parametrize("impl", ["xla", "fused"])
@pytest.mark.parametrize("model_type", ["attention_scn", "pure_attention"])
def test_bf16_teacher_forcing_matches_jax(model_type, impl):
    """teacher_forcing on bf16 parameters, encodings and tags under the
    eager scan ("xla") and kernels 8 and 9's plain versions ("fused")
    against JAX's at bf16 under the same name (the Pallas pair in
    interpret mode): predictions and alphas in bf16, within TF_TOL."""
    kw, jparams, enc, tags, caps, caplens = case(model_type)
    jcfg = JaxModelConfig(**kw, train_scan_impl=impl)
    ref = jax.jit(lambda p: jax_decoders.teacher_forcing(
        p, jcfg, jnp.asarray(enc).astype(bf16),
        jnp.asarray(tags).astype(bf16), caps, caplens))(
            jax_decoders.cast_params(jparams, bf16))
    cfg = ModelConfig(**kw, train_scan_impl=impl)
    p16 = decoders.cast_params(params_from_jax(jparams), torch.bfloat16)
    out = decoders.teacher_forcing(
        p16, cfg, t(enc).to(torch.bfloat16), t(tags).to(torch.bfloat16),
        torch.from_numpy(caps).long(), torch.from_numpy(caplens).long())
    assert ref["predictions"].dtype == ref["alphas"].dtype == bf16
    assert out["predictions"].dtype == out["alphas"].dtype == torch.bfloat16
    for name in ("predictions", "alphas"):
        err = rel(out[name], ref[name].astype(jnp.float32))
        assert err <= TF_TOL, f"{name}: {err} > {TF_TOL}"
    np.testing.assert_array_equal(out["mask"].float().numpy(),
                                  np.asarray(ref["mask"], np.float32))


def jax_mixed_loss(jcfg, head, enc, tags, caps, caplens):
    """JAX's mixed-precision caption loss as its make_caption_train_step
    takes it (train/steps.py there), as a function of the f32 masters."""
    def loss(p):
        p = jax_decoders.cast_params(p, bf16)
        out = jax_decoders.teacher_forcing(
            p, jcfg, jnp.asarray(enc).astype(bf16),
            jnp.asarray(tags).astype(bf16), caps, caplens,
            dropout_rng=jax.random.key(0), train=True,
            return_hidden=head == "chunked")
        out = {**out, "alphas": out["alphas"].astype(jnp.float32)}
        if head == "chunked":
            return jax_losses.caption_loss_chunked(p["fc"], out, caps, 1.0,
                                                   k=5, tile=16)[0]
        out["predictions"] = out["predictions"].astype(jnp.float32)
        return jax_losses.caption_loss(out, caps, 1.0)[0]

    return loss


@pytest.mark.parametrize("head_impl", ["dense", "chunked"])
def test_bf16_train_step_matches_jax(head_impl, monkeypatch):
    """One make_caption_train_step step with decoder_dtype="bfloat16" from
    JAX's weights against JAX's step from the same state: loss, ce,
    alpha_penalty, top-5, n_tokens, every clamped gradient and the updated
    parameters (module docstring); the scan and the head run on bf16
    parameters and inputs; masters, gradients and Adam's moments stay
    float32."""
    seen = []
    forcing = decoders.teacher_forcing

    def spy(params, cfg, enc, tags, *args, **kw):
        seen.append((params["fc"]["w"].dtype, params["embedding"].dtype,
                     enc.dtype, tags.dtype))
        return forcing(params, cfg, enc, tags, *args, **kw)

    monkeypatch.setattr(steps.decoders, "teacher_forcing", spy)
    kw, jparams, enc, tags, caps, caplens = case("attention_scn")
    jcfg = JaxModelConfig(**kw)
    jt = JaxTrainConfig(head_impl=head_impl, head_tile=16,
                        decoder_dtype="bfloat16", decoder_lr=LR)
    jopt = jax_steps.make_optimizer(LR, jt.grad_clip)
    _, jstep = jax_steps.make_caption_train_step(jcfg, jt, jopt,
                                                 donate=False)
    jsub, jm = jstep({"params": jparams, "opt_state": jopt.init(jparams)},
                     enc, tags, caps, caplens, jax.random.key(0))
    jgrads = jax.jit(jax.grad(jax_mixed_loss(jcfg, head_impl, enc, tags,
                                             caps, caplens)))(jparams)
    jgrads = {k: np.clip(g, -5, 5) for k, g in jax_by_path(jgrads).items()}

    params = params_from_jax(jparams)
    opt = steps.make_optimizer(LR, 5.0)
    _, step = steps.make_caption_train_step(
        ModelConfig(**kw), TrainConfig(head_impl=head_impl, head_tile=16,
                                       decoder_dtype="bfloat16"), opt,
        device="cpu")
    sub = {"params": params, "opt_state": opt.init(params)}
    _, m = step(sub, t(enc), t(tags), torch.from_numpy(caps).long(),
                torch.from_numpy(caplens).long())
    assert seen == [(torch.bfloat16,) * 4]
    for k in ("loss", "ce"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=LOSS_TOL), k
    assert float(m["alpha_penalty"]) == pytest.approx(
        float(jm["alpha_penalty"]), rel=PEN_TOL)
    assert float(m["top5"]) == pytest.approx(float(jm["top5"]),
                                             rel=TOP5_TOL)
    assert float(m["n_tokens"]) == float(jm["n_tokens"])

    ours, before = by_path(params), jax_by_path(jparams)
    after = jax_by_path(jsub["params"])
    assert set(ours) == set(jgrads)
    scale = max(float(np.abs(g).max()) for g in jgrads.values())
    for name, leaf in ours.items():
        assert leaf.dtype == leaf.grad.dtype == torch.float32, name
        state = opt_state_of(sub["opt_state"], leaf)
        assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype \
            == torch.float32
        ref = jgrads[name]
        if "full_att/b" in name:        # zero in exact arithmetic: dust
            assert float(leaf.grad.abs().max()) <= GRAD_DUST * scale
            continue
        err = rel(leaf.grad, ref)
        assert err <= GRAD_TOL, f"{name}: gradient {err} > {GRAD_TOL}"
        moved = leaf.detach().numpy() - before[name]
        jmoved = after[name] - before[name]
        assert float(np.abs(moved - jmoved).max()) <= 2 * LR * (1 + 1e-3)
        noise = err * float(np.abs(ref).max())
        sure = np.abs(ref) > max(10 * noise, 1e3 * ADAM_EPS)
        np.testing.assert_allclose(moved[sure], jmoved[sure], rtol=0,
                                   atol=UPDATE_TOL * LR, err_msg=name)


def opt_state_of(opt_state, leaf):
    return opt_state.state[leaf]


def test_mixed_precision_learns_as_jax_says():
    """The counterpart of JAX's test_caption_loss_decreases_mixed_precision
    (tests/test_train_smoke.py), at its widths (embed and decoder 16,
    factors 12, attention 8, 2 tags, 2x2 features, 12 tokens, B = 4): 8
    steps at decoder_dtype bfloat16 and at float32 from one state on one
    batch of Zipf-drawn captions (learnable, as JAX's synthetic corpus),
    dropout 0.5, LR 1e-2: each loss falls below 0.9 of its first, the masters
    stay float32, and the two first losses lie within JAX's bound of each
    other (0.05 relative + 0.05)."""
    kw = dict(model_type="attention_scn", vocab_size=30, embed_dim=16,
              decoder_dim=16, factored_dim=12, attention_dim=8,
              semantic_dim=2, enc_image_size=2, max_caption_len=12)
    rng = np.random.default_rng(11)
    jparams = jax_decoders.init_decoder(jax.random.key(0),
                                        JaxModelConfig(**kw))
    enc = rng.uniform(size=(4, 2, 2, 2048)).astype(np.float32) * 0.1
    tags = rng.uniform(size=(4, 2)).astype(np.float32)
    zipf = 1.0 / np.arange(1, 28) ** 1.5       # words 1-27, as a corpus
    caps = torch.from_numpy(rng.choice(np.arange(1, 28), size=(4, 12),
                                       p=zipf / zipf.sum())).long()
    caps[:, 0] = 28                            # <start>
    caplens = torch.tensor([12, 9, 7, 10])
    first = {}
    for dtype in ("float32", "bfloat16"):
        params = params_from_jax(jparams)
        opt = steps.make_optimizer(1e-2, 5.0)
        _, step = steps.make_caption_train_step(
            ModelConfig(**kw), TrainConfig(batch_size=4, decoder_lr=1e-2,
                                           decoder_dtype=dtype), opt,
            device="cpu")
        sub = {"params": params, "opt_state": opt.init(params)}
        hist = []
        for i in range(8):
            sub, m = step(sub, t(enc), t(tags), caps, caplens,
                          torch.Generator().manual_seed(i))
            hist.append(float(m["loss"]))
        first[dtype] = hist[0]
        assert hist[-1] < hist[0] * 0.9, (dtype, hist)
        assert all(p.dtype == torch.float32
                   for p in steps.tree_leaves(sub["params"]))
    assert abs(first["bfloat16"] - first["float32"]) \
        < 0.05 * abs(first["float32"]) + 0.05, first
