"""The port's train step, heads, losses, metrics and optimizer against the
JAX package, on the CPU.

Seeded numpy inputs; JAX-initialised weights through ``params_from_jax``.
Tolerances: float32 values and gradients 1e-5 of scale (summation order),
the chunked head's gradients 1e-4 (tiles sum in another order), metrics
and counts exactly, and clamp + Adam 1e-6 against optax.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from indonesian_image_captioning_tpu.core import metrics as jax_metrics
from indonesian_image_captioning_tpu.core.config import \
    ModelConfig as JaxModelConfig
from indonesian_image_captioning_tpu.core.config import \
    TrainConfig as JaxTrainConfig
from indonesian_image_captioning_tpu.models import decoders as jax_decoders
from indonesian_image_captioning_tpu.ops import losses as jax_losses
from indonesian_image_captioning_tpu.ops import vocab_head as jax_vocab_head
from indonesian_image_captioning_tpu.train import steps as jax_steps
from indonesian_image_captioning_tpu_torch.core import metrics
from indonesian_image_captioning_tpu_torch.core.config import (ModelConfig,
                                                               TrainConfig)
from indonesian_image_captioning_tpu_torch.models import decoders
from indonesian_image_captioning_tpu_torch.models.jax_bridge import \
    params_from_jax
from indonesian_image_captioning_tpu_torch.ops import losses, vocab_head
from indonesian_image_captioning_tpu_torch.train import steps

torch.set_num_threads(1)
CPU = torch.device("cpu")


def t(x, dtype=np.float32):
    return torch.from_numpy(np.array(x, dtype=dtype))


def close(ours, ref, tol):
    ref = np.asarray(ref, np.float32)
    ours = ours.detach().float().numpy() if torch.is_tensor(ours) \
        else np.asarray(ours, np.float32)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1.0)
    err = float(np.abs(ours - ref).max())
    assert err <= tol * scale, f"error {err} > {tol} * {scale}"


def by_path(tree, prefix=""):
    """{path: leaf} of a nested dict of tensors (JAX trees: by keystr)."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k, v in tree.items():
        out.update(by_path(v, f"{prefix}{k}/"))
    return out


def jax_by_path(tree):
    return {jax.tree_util.keystr(p, simple=True, separator="/"): x
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def head_case(seed=0, B=4, T=7, D=32, V=301):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((D, V)) * 0.2).astype(np.float32)
    b = (rng.standard_normal((V,)) * 0.1).astype(np.float32)
    hidden = (rng.standard_normal((B, T, D)) * 0.5).astype(np.float32)
    targets = rng.integers(0, V, (B, T)).astype(np.int32)
    lens = rng.integers(2, T + 1, (B,))
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    return w, b, hidden, targets, mask


@pytest.mark.parametrize("tile", [64, 301, 512])
def test_chunked_head_matches_jax_value_and_grad(tile):
    """chunked_ce_topk: CE, top-5, n_tokens and the (w, b, hidden)
    gradients against JAX; the last tile is ragged at 64."""
    w, b, hidden, targets, mask = head_case()

    def jfn(w_, b_, h_):
        ce, top, n = jax_vocab_head.chunked_ce_topk(
            {"w": w_, "b": b_}, h_, targets, mask, tile=tile)
        return ce, (top, n)

    (jce, (jtop, jn)), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                               has_aux=True)(w, b, hidden)
    tw, tb, th = (t(x).requires_grad_(True) for x in (w, b, hidden))
    ce, top, n = vocab_head.chunked_ce_topk(
        {"w": tw, "b": tb}, th, torch.from_numpy(targets), t(mask),
        tile=tile)
    ce.backward()
    close(ce, jce, 1e-5)
    assert float(top) == pytest.approx(float(jtop), abs=1e-4)
    assert float(n) == float(jn)
    for ours, ref in zip((tw.grad, tb.grad, th.grad), jg):
        close(ours, ref, 1e-4)


def test_chunked_head_matches_the_dense_head():
    """The port's chunked head against its own dense head (log_softmax and
    topk_hit over the materialised logits), value and gradients."""
    w, b, hidden, targets, mask = head_case(seed=1, V=97)
    outs = {}
    for name in ("dense", "chunked"):
        tw, tb, th = (t(x).requires_grad_(True) for x in (w, b, hidden))
        tg = torch.from_numpy(targets)
        if name == "dense":
            logits = th @ tw + tb
            ce = losses.masked_cross_entropy(logits, tg, t(mask))
            top = losses.masked_topk_accuracy(logits, tg, t(mask), 5)
        else:
            ce, top, _ = vocab_head.chunked_ce_topk(
                {"w": tw, "b": tb}, th, tg, t(mask), tile=32)
        ce.backward()
        outs[name] = (ce, top, tw.grad, tb.grad, th.grad)
    for a, b_ in zip(outs["dense"], outs["chunked"]):
        close(a, b_.detach().numpy(), 1e-5)


def test_chunked_eval_head_matches_jax():
    w, b, hidden, targets, mask = head_case(seed=2)
    # a duplicated column makes an exact tie for the argmax
    w[:, 40] = w[:, 7]
    b[40] = b[7]
    ref = jax_vocab_head.chunked_eval_head({"w": w, "b": b}, hidden, targets,
                                           mask, tile=64)
    ours = vocab_head.chunked_eval_head(
        {"w": t(w), "b": t(b)}, t(hidden), torch.from_numpy(targets),
        t(mask), tile=64)
    close(ours[0], ref[0], 1e-5)
    assert float(ours[1]) == pytest.approx(float(ref[1]), abs=1e-4)
    assert float(ours[2]) == float(ref[2])
    np.testing.assert_array_equal(ours[3].numpy(), np.asarray(ref[3]))


def test_topk_hit_exact_ties_match_jax():
    """Equal scores rank by index, first occurrence first."""
    scores = np.array([[1.0, 3.0, 3.0, 3.0, 0.0, 3.0],
                       [2.0, 2.0, 2.0, 2.0, 2.0, 2.0],
                       [5.0, 1.0, 1.0, 1.0, 1.0, 1.0]], np.float32)
    for k in (1, 2, 3, 4):
        for tgt in range(6):
            targets = np.full((3,), tgt, np.int32)
            ref = np.asarray(jax_metrics.topk_hit(scores, targets, k))
            ours = metrics.topk_hit(t(scores), torch.from_numpy(targets), k)
            np.testing.assert_array_equal(ours.numpy(), ref)
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    targets = np.array([3, 0, 2], np.int32)
    for m in (None, mask):
        ref = jax_metrics.topk_accuracy(scores, targets, 2, m)
        ours = metrics.topk_accuracy(t(scores), torch.from_numpy(targets), 2,
                                     None if m is None else t(m))
        assert float(ours) == pytest.approx(float(ref), abs=1e-5)
    meter = metrics.AverageMeter()
    for v, n in ((1.0, 2), (4.0, 1)):
        meter.update(v, n)
    assert (meter.val, meter.sum, meter.count, meter.avg) == (4.0, 6.0, 3,
                                                              2.0)


def test_losses_match_jax():
    rng = np.random.default_rng(4)
    alphas = rng.uniform(size=(3, 5, 4)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [0, 0, 0, 0, 0], [1, 1, 1, 1, 1]],
                    np.float32)
    for c in (0.0, 1.0, 0.3):
        ref = jax_losses.doubly_stochastic_penalty(alphas, mask, c)
        ours = losses.doubly_stochastic_penalty(t(alphas), t(mask), c)
        assert float(ours) == pytest.approx(float(ref), rel=1e-6)
    assert float(losses.doubly_stochastic_penalty(None, t(mask), 1.0)) == 0
    probs = rng.uniform(size=(3, 6)).astype(np.float32)
    tg = (rng.uniform(size=(3, 6)) > 0.5).astype(np.float32)
    valid = np.array([1.0, 0.0, 1.0], np.float32)
    for rv in (None, valid):
        ref = jax_losses.bce_loss(probs, tg, row_valid=rv)
        ours = losses.bce_loss(t(probs), t(tg),
                               row_valid=None if rv is None else t(rv))
        assert float(ours) == pytest.approx(float(ref), rel=1e-6)


def test_clamp_adam_and_decay_match_optax():
    """Clamp + Adam + decay_learning_rate, fed equal gradients (some past
    the clamp), against optax over 3 updates."""
    rng = np.random.default_rng(5)
    p0 = {"a": rng.normal(size=(4, 3)).astype(np.float32),
          "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    grads = [jax.tree.map(lambda x, s=s: (rng.normal(size=x.shape) * 4 * s)
                          .astype(np.float32), p0) for s in (1, 2, 0.5)]
    jopt = jax_steps.make_optimizer(1e-2, 5.0)
    jparams, jstate = p0, jopt.init(p0)
    opt = steps.make_optimizer(1e-2, 5.0)
    params = jax.tree.map(lambda x: torch.from_numpy(x.copy()), p0)
    state = opt.init(params)
    for i, g in enumerate(grads):
        if i == 2:
            jstate = jax_steps.decay_learning_rate(jstate, 0.8)
            steps.decay_learning_rate(state, 0.8)
        upd, jstate = jopt.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for leaf, gl in zip(steps.tree_leaves(params), jax.tree.leaves(g)):
            leaf.grad = torch.from_numpy(np.array(gl))
        opt.update(state)
        for ours, ref in zip(steps.tree_leaves(params),
                             jax.tree.leaves(jparams)):
            np.testing.assert_allclose(ours.detach().numpy(),
                                       np.asarray(ref), atol=1e-6, rtol=0)
    assert steps.current_learning_rate(state) == pytest.approx(
        jax_steps.current_learning_rate(jstate))


def test_resolve_head_impl():
    cfg = ModelConfig(vocab_size=6763)
    tcfg = TrainConfig()
    cuda = torch.device("cuda")
    assert steps.resolve_head_impl(tcfg, cfg, 1024, CPU) == "dense"
    assert steps.resolve_head_impl(tcfg, cfg, 32, cuda) == "dense"
    assert steps.resolve_head_impl(tcfg, cfg, 1024, cuda) == "chunked"
    for impl in ("dense", "chunked"):
        tc = dataclasses.replace(tcfg, head_impl=impl)
        assert steps.resolve_head_impl(tc, cfg, 8, CPU) == impl
    with pytest.raises(ValueError):
        steps.resolve_head_impl(dataclasses.replace(tcfg, head_impl="x"),
                                cfg, 8, CPU)


B, T = 6, 7


@pytest.fixture(scope="module")
def step_case():
    kw = dict(model_type="attention_scn", vocab_size=41, embed_dim=16,
              attention_dim=12, decoder_dim=16, factored_dim=8,
              semantic_dim=10, encoder_dim=24, enc_image_size=2,
              max_caption_len=T + 1, dropout=0.0)
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    rng = np.random.default_rng(6)
    jparams = jax_decoders.init_decoder(jax.random.key(3), jcfg)
    enc = (rng.normal(size=(B, 2, 2, 24)) * 0.5).astype(np.float32)
    tags = rng.uniform(size=(B, 10)).astype(np.float32)
    caps = rng.integers(1, 41, size=(B, T + 1)).astype(np.int32)
    caplens = np.array([2, 8, 5, 3, 8, 6], np.int32)
    return cfg, jcfg, jparams, enc, tags, caps, caplens


@pytest.mark.parametrize("head_impl", ["dense", "chunked"])
def test_train_step_matches_jax(step_case, head_impl):
    """One step from the same weights and batch, dropout 0: loss, top5,
    n_tokens, ce and alpha_penalty against JAX's make_caption_train_step,
    and the (clamped) gradients against jax.grad of its loss."""
    cfg, jcfg, jparams, enc, tags, caps, caplens = step_case
    jt = JaxTrainConfig(head_impl=head_impl, head_tile=16)
    tcfg = TrainConfig(head_impl=head_impl, head_tile=16)
    jopt = jax_steps.make_optimizer(jt.decoder_lr, jt.grad_clip)
    _, jstep = jax_steps.make_caption_train_step(jcfg, jt, jopt,
                                                 donate=False)
    _, jm = jstep({"params": jparams, "opt_state": jopt.init(jparams)}, enc,
                  tags, caps, caplens, jax.random.key(0))

    def jloss(p):
        out = jax_decoders.teacher_forcing(p, jcfg, enc, tags, caps, caplens,
                                           train=True)
        return jax_losses.caption_loss(out, caps, jt.alpha_c)[0]

    jgrads = jax.tree.map(lambda g: np.clip(g, -5, 5),
                          jax.grad(jloss)(jparams))

    params = params_from_jax(jparams)
    opt = steps.make_optimizer(tcfg.decoder_lr, tcfg.grad_clip)
    _, step = steps.make_caption_train_step(cfg, tcfg, opt, device="cpu")
    sub = {"params": params, "opt_state": opt.init(params)}
    _, m = step(sub, t(enc), t(tags), torch.from_numpy(caps).long(),
                torch.from_numpy(caplens).long())
    for k in ("loss", "ce", "alpha_penalty"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    assert float(m["top5"]) == pytest.approx(float(jm["top5"]), abs=1e-4)
    assert float(m["n_tokens"]) == float(jm["n_tokens"])
    ours, ref = by_path(params), jax_by_path(jgrads)
    assert set(ours) == set(ref)
    for name, leaf in ours.items():
        close(leaf.grad, ref[name], 1e-4)


def test_eval_step_matches_jax(step_case):
    cfg, jcfg, jparams, enc, tags, caps, caplens = step_case
    params = params_from_jax(jparams)
    for impl in ("dense", "chunked"):
        jt = JaxTrainConfig(head_impl=impl, head_tile=16)
        _, jstep = jax_steps.make_caption_eval_step(jcfg, jt)
        ref = jstep(jparams, enc, tags, caps, caplens)
        _, step = steps.make_caption_eval_step(
            cfg, TrainConfig(head_impl=impl, head_tile=16), device="cpu")
        out = step(params, t(enc), t(tags), torch.from_numpy(caps).long(),
                   torch.from_numpy(caplens).long())
        assert float(out["loss"]) == pytest.approx(float(ref["loss"]),
                                                   rel=1e-5)
        assert float(out["top5"]) == pytest.approx(float(ref["top5"]),
                                                   abs=1e-4)
        assert float(out["n_tokens"]) == float(ref["n_tokens"])
        np.testing.assert_array_equal(out["preds"].numpy(),
                                      np.asarray(ref["preds"]))
        np.testing.assert_array_equal(out["mask"].numpy(),
                                      np.asarray(ref["mask"]))


def test_builders_run_on_the_card_unless_asked_for_the_cpu(step_case):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = step_case[0]
    opt = steps.make_optimizer(1e-3, 5.0)
    for build in (lambda: steps.make_caption_train_step(cfg, TrainConfig(),
                                                        opt),
                  lambda: steps.make_caption_eval_step(cfg, TrainConfig()),
                  lambda: steps.make_encoders_fn(cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()


def test_dropout_is_seeded_by_its_generator(step_case):
    """train=True with cfg.dropout > 0: the same generator seed gives the
    same predictions, another seed others; eval mode drops nothing."""
    cfg, _, jparams, enc, tags, caps, caplens = step_case
    cfg = dataclasses.replace(cfg, dropout=0.5)
    params = params_from_jax(jparams)
    args = (params, cfg, t(enc), t(tags), torch.from_numpy(caps).long(),
            torch.from_numpy(caplens).long())

    def run(seed, train=True):
        gen = torch.Generator().manual_seed(seed)
        return decoders.teacher_forcing(*args, dropout_gen=gen, train=train,
                                        return_hidden=True)["hidden"]

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    assert torch.equal(run(1, train=False), run(2, train=False))
    h = run(1)
    assert float((h == 0).float().mean()) == pytest.approx(0.5, abs=0.1)
