"""The port's encoder fine-tuning and caption-trainer paths against the JAX
package, on the CPU.

One ``make_caption_finetune_train_step`` step at
``tests/test_registry_finetune.py``'s widths (attention_scn, V = 30, a
ResNet-50 encoder, B = 2), dropout 0, from the JAX
state (``models/jax_bridge.py``) with every residual branch damped (each
bottleneck's last BatchNorm scale times 0.2, on both sides:
``tests/test_torch_tagger.py`` says why), on 64-pixel images (at 32,
layer4's BatchNorm normalises 2 values a channel, which alone moves the
loss by 1e-4 between the frameworks).  The JAX step runs with
optimizers that are its own clamp and Adam and also keep the clamped,
masked gradients they were given, so one JAX program gives both.  Then
the trainer's fine-tune branch (resume keeps the encoder's Adam state,
both learning rates decay, the feature cache refuses it) and the caption
trainer's gaps: the loss falls in float32 and bfloat16 (against JAX's
steps on the same weights and features), the bf16 feature cache and the
host-cache fallback.

Tolerances: the loss 1e-4 relative; gradients 2e-3 of each leaf's
largest (1e-6 absolute at least, for the leaf whose gradient is zero by
symmetry); each updated weight within 2 lr of JAX's (Adam's first step
moves a weight by about lr whatever its gradient's size); the running
statistics 1e-4 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from indonesian_image_captioning_tpu.core.config import \
    ModelConfig as JaxModelConfig
from indonesian_image_captioning_tpu.core.config import \
    TrainConfig as JaxTrainConfig
from indonesian_image_captioning_tpu.core.prng import root_key
from indonesian_image_captioning_tpu.models import decoders as jax_decoders
from indonesian_image_captioning_tpu.train import caption as jax_caption
from indonesian_image_captioning_tpu.train import steps as jax_steps
from indonesian_image_captioning_tpu_torch.core.config import (ModelConfig,
                                                               TrainConfig)
from indonesian_image_captioning_tpu_torch.data import loader, vocab
from indonesian_image_captioning_tpu_torch.data.datasets import \
    CaptionDataset
from indonesian_image_captioning_tpu_torch.models import encoders
from indonesian_image_captioning_tpu_torch.models.jax_bridge import \
    params_from_jax
from indonesian_image_captioning_tpu_torch.train import (caption,
                                                         feature_cache,
                                                         steps)
from test_torch_tagger import data_env  # noqa: F401  (the shared corpus)
from test_torch_tagger import by_path, damp_residuals, rel_err
from _torch_tmp import tmp_path, tmp_path_factory  # noqa: F401 (fixtures)

torch.set_num_threads(1)
CPU = torch.device("cpu")
ARCH = "resnet50"
B, L = 2, 8
CFG = dict(model_type="attention_scn", vocab_size=30, embed_dim=16,
           attention_dim=16, decoder_dim=16, factored_dim=8, semantic_dim=4,
           enc_image_size=2, max_caption_len=L, encoder_arch=ARCH,
           dropout=0.0)


def capturing(optimizer):
    """optimizer (clamp, then Adam) whose state also keeps the clamped
    gradients of its last update."""
    def init(params):
        return optimizer.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = optimizer.update(grads, state[0], params)
        return updates, (inner, jax.tree.map(
            lambda g: jnp.clip(g, -5.0, 5.0), grads))

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def jax_finetune_case():
    jcfg = JaxModelConfig(**CFG)
    jtcfg = JaxTrainConfig(batch_size=B, fine_tune_encoder=True)
    dec_opt = capturing(jax_steps.make_optimizer(jtcfg.decoder_lr, 5.0))
    enc_opt = capturing(jax_steps.make_optimizer(jtcfg.encoder_lr, 5.0))
    state = jax_caption.init_state(root_key(0), jcfg,
                                   jax_steps.make_optimizer(1e-3, 5.0))
    state = {"params": state["params"],
             "opt_state": dec_opt.init(state["params"]),
             "encoder": damp_residuals(state["encoder"]),
             "encoder_stats": state["encoder_stats"],
             "tagger": state["tagger"],
             "tagger_stats": state["tagger_stats"]}
    state["enc_opt_state"] = enc_opt.init(state["encoder"])
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (B, 3, 64, 64)).astype(np.uint8)
    caps = rng.integers(1, 30, (B, L)).astype(np.int32)
    caplens = np.asarray([6, 8], np.int32)
    tagger_fn, step = jax_steps.make_caption_finetune_train_step(
        jcfg, jtcfg, dec_opt, enc_opt, donate=False)
    tags = np.asarray(tagger_fn(state, {"images": images}))
    new_state, m = step(state, images, tags, caps, caplens,
                        jax.random.key(0))
    return dict(state=jax.device_get(state), images=images, caps=caps,
                caplens=caplens, tags=tags, metrics=jax.device_get(m),
                new=jax.device_get(new_state))


def port_finetune_state(jstate, dec_opt, enc_opt):
    params = params_from_jax(jstate["params"])
    encoder = params_from_jax(jstate["encoder"])
    return {"params": params, "opt_state": dec_opt.init(params),
            "encoder": encoder,
            "encoder_stats": params_from_jax(jstate["encoder_stats"]),
            "enc_opt_state": enc_opt.init(encoder),
            "tagger": params_from_jax(jstate["tagger"]),
            "tagger_stats": params_from_jax(jstate["tagger_stats"])}


def test_finetune_step_matches_jax(jax_finetune_case):
    """Counterpart of test_registry_finetune.py::
    test_finetune_step_updates_encoder_stages, held against JAX's step:
    the loss, the clamped gradients of the decoder and of the encoder's
    stages 2-4, the updated weights, conv1 and layer1 bitwise (and no
    backward into them), layer4 changed, every running statistic moved as
    JAX's (the frozen stem's bn1 too)."""
    c = jax_finetune_case
    cfg, tcfg = ModelConfig(**CFG), TrainConfig(batch_size=B,
                                                fine_tune_encoder=True)
    dec_opt = steps.make_optimizer(tcfg.decoder_lr, tcfg.grad_clip)
    enc_opt = steps.make_optimizer(tcfg.encoder_lr, tcfg.grad_clip)
    state = port_finetune_state(c["state"], dec_opt, enc_opt)
    tagger_fn, step = steps.make_caption_finetune_train_step(
        cfg, tcfg, dec_opt, enc_opt, device="cpu")
    tags = tagger_fn(state, {"images": c["images"]})
    np.testing.assert_allclose(tags.numpy(), c["tags"], atol=1e-4, rtol=0)
    before = {k: v.clone() for k, v in by_path(
        {"params": state["params"], "encoder": state["encoder"]}).items()}
    _, m = step(state, c["images"], torch.from_numpy(c["tags"]),
                torch.from_numpy(c["caps"]).long(),
                torch.from_numpy(c["caplens"]).long())
    assert np.isfinite(float(m["loss"]))
    for k in ("loss", "ce", "alpha_penalty"):
        assert float(m[k]) == pytest.approx(float(c["metrics"][k]),
                                            rel=1e-4), k
    assert float(m["n_tokens"]) == float(c["metrics"]["n_tokens"])

    lrs = {"params": tcfg.decoder_lr, "encoder": tcfg.encoder_lr}
    for tree, opt_key in (("params", "opt_state"),
                          ("encoder", "enc_opt_state")):
        ours = by_path(state[tree])
        grads = by_path(params_from_jax(c["new"][opt_key][1]))
        new_ref = by_path(params_from_jax(c["new"][tree]))
        assert ours.keys() == grads.keys() == new_ref.keys()
        for k, p in ours.items():
            frozen = tree == "encoder" and k.split("/")[1] in (
                "conv1", "bn1", "layer1")
            assert p.requires_grad != frozen, k
            if frozen:
                assert torch.equal(p, before[f"{tree}/{k}"]), k
                assert torch.equal(new_ref[k], before[f"{tree}/{k}"]), k
                continue
            # the attention score bias's gradient is 0 but for rounding
            # (the softmax ignores a shift): 1e-6 absolute there
            err = float(np.abs(p.grad.numpy() - grads[k].numpy()).max())
            assert err <= max(2e-3 * float(np.abs(grads[k].numpy()).max()),
                              1e-6), k
            np.testing.assert_allclose(
                p.detach().numpy(), new_ref[k].numpy(),
                atol=2 * lrs[tree], rtol=0, err_msg=k)
    layer4 = [k for k in before if k.startswith("encoder/resnet/layer4")]
    assert any(not torch.equal(by_path(state)[k], before[k])
               for k in layer4)
    stats = by_path(state["encoder_stats"])
    ref = by_path(params_from_jax(c["new"]["encoder_stats"]))
    old = by_path(params_from_jax(c["state"]["encoder_stats"]))
    assert not torch.equal(stats["resnet/bn1/mean"], old["resnet/bn1/mean"])
    for k, v in stats.items():
        assert v.dtype == torch.float32
        assert rel_err(v.numpy(), ref[k].numpy()) < 1e-4, k


# ---------------------------------------------------------------------------
# The trainer's fine-tune branch
# ---------------------------------------------------------------------------

def small_cfg(wm, model_type="pure_scn"):
    return ModelConfig(model_type=model_type, vocab_size=len(wm),
                       embed_dim=16, attention_dim=16, decoder_dim=16,
                       factored_dim=12, semantic_dim=2, enc_image_size=2,
                       max_caption_len=12, encoder_arch=ARCH)


def word_map(data_env):
    return vocab.load_json(vocab.wordmap_path(data_env.data_folder,
                                              data_env.data_name))


def adam_counts(opt):
    return {int(s["step"]) for s in opt.state.values()}


def test_finetune_resume_preserves_encoder_opt_state(data_env, tmp_path):
    """Counterpart of test_train_smoke.py::
    test_finetune_resume_preserves_encoder_opt_state: a resumed fine-tune
    run restores the encoder's Adam moments and step counts (and its
    weights), so the counts accumulate over the two runs."""
    cfg = small_cfg(word_map(data_env))
    tcfg = TrainConfig(epochs=1, batch_size=4, print_freq=1,
                       fine_tune_encoder=True, checkpoint_dir=str(tmp_path))
    state1, _ = caption.main("pure_scn", data_env, tcfg, model_cfg=cfg,
                             log=lambda s: None, device="cpu")
    n_steps = loader.num_batches(12, 4)
    assert adam_counts(state1["enc_opt_state"]) == {n_steps}
    saved = [s["exp_avg"].clone()
             for s in state1["enc_opt_state"].state.values()]
    again, s_again = caption.main("pure_scn", data_env, tcfg, model_cfg=cfg,
                                  resume=True, log=lambda s: None,
                                  device="cpu")
    assert s_again["step_losses"] == {}
    assert all(torch.equal(s["exp_avg"], m) for s, m in zip(
        again["enc_opt_state"].state.values(), saved, strict=True))
    layer4 = steps.tree_leaves(again["encoder"]["resnet"]["layer4"])
    assert all(torch.equal(a, b) for a, b in zip(
        layer4, steps.tree_leaves(state1["encoder"]["resnet"]["layer4"])))
    state2, _ = caption.main("pure_scn", data_env,
                             dataclasses.replace(tcfg, epochs=2),
                             model_cfg=cfg, resume=True, log=lambda s: None,
                             device="cpu")
    assert adam_counts(state2["enc_opt_state"]) == {2 * n_steps}
    assert adam_counts(state2["opt_state"]) == {2 * n_steps}


def test_finetune_trainer_decays_both_learning_rates(data_env, monkeypatch,
                                                     tmp_path):
    """Counterpart of test_registry_finetune.py::
    test_lr_decay_actually_decays for both optimizers: the trainer's
    stale-epoch decay multiplies the decoder's and the encoder's LR."""
    def decay_only(tcfg, *, decay_lr, **kw):
        decay_lr(0.8)
        return {"best_metric": 0.0, "epochs_since_improvement": 0,
                "train_loss": float("nan")}

    monkeypatch.setattr(caption, "fit", decay_only)
    tcfg = TrainConfig(batch_size=4, fine_tune_encoder=True,
                       checkpoint_dir=str(tmp_path))
    state, _ = caption.main("pure_scn", data_env, tcfg,
                            model_cfg=small_cfg(word_map(data_env)),
                            log=lambda s: None, device="cpu")
    assert steps.current_learning_rate(state["opt_state"]) == \
        pytest.approx(tcfg.decoder_lr * 0.8, rel=1e-12)
    assert steps.current_learning_rate(state["enc_opt_state"]) == \
        pytest.approx(tcfg.encoder_lr * 0.8, rel=1e-12)


def test_cache_rejects_fine_tune(data_env):
    """Counterpart of test_feature_cache.py::test_cache_rejects_fine_tune."""
    tcfg = TrainConfig(batch_size=4, epochs=1, cache_features=True,
                       fine_tune_encoder=True)
    with pytest.raises(ValueError, match="frozen encoder"):
        caption.main("attention_scn", data_env, tcfg,
                     model_cfg=small_cfg(word_map(data_env),
                                         "attention_scn"),
                     log=lambda s: None, device="cpu")


# ---------------------------------------------------------------------------
# The caption trainer's gaps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_type,dtype", [
    ("pure_scn", "float32"), ("attention_scn", "float32"),
    ("attention_scn", "bfloat16")])
def test_caption_loss_decreases_matches_jax(model_type, dtype):
    """Counterparts of test_train_smoke.py::test_caption_loss_decreases
    and ::test_caption_loss_decreases_mixed_precision: 12 steps on one
    batch of cached features (non-negative, as a ResNet's are) at LR 1e-2,
    dropout 0 and alpha_c 0 (the doubly stochastic penalty of 4 pixels
    over 11 steps is most of an untrained loss and falls slowly), from
    JAX's weights.
    The loss falls below 0.9 of its first value, the master weights stay
    float32; float32 losses within 1e-4 relative of JAX's steps, step for
    step; bfloat16's first loss within 5 % + 0.05 of float32's and of
    JAX's bfloat16 step."""
    kw = dict(CFG, model_type=model_type, vocab_size=23, max_caption_len=12)
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    rng = np.random.default_rng(7)
    enc = (np.maximum(rng.standard_normal((4, 2, 2, 2048)), 0.0)
           * 0.5).astype(np.float32)
    tags = rng.uniform(size=(4, 4)).astype(np.float32)
    caps = rng.integers(1, 23, (4, 12)).astype(np.int32)
    caplens = np.asarray([12, 7, 9, 4], np.int32)
    jparams = jax_decoders.init_decoder(jax.random.key(0), jcfg)

    def jax_losses(decoder_dtype):
        jt = JaxTrainConfig(batch_size=4, decoder_lr=1e-2, alpha_c=0.0,
                            decoder_dtype=decoder_dtype, head_impl="dense")
        jopt = jax_steps.make_optimizer(1e-2, 5.0)
        _, jstep = jax_steps.make_caption_train_step(jcfg, jt, jopt,
                                                     donate=False)
        sub = {"params": jparams, "opt_state": jopt.init(jparams)}
        out = []
        for i in range(12 if decoder_dtype == "float32" else 1):
            sub, m = jstep(sub, enc, tags, caps, caplens, jax.random.key(i))
            out.append(float(m["loss"]))
        return out

    def port_losses(decoder_dtype):
        tcfg = TrainConfig(batch_size=4, decoder_lr=1e-2, head_impl="dense",
                           alpha_c=0.0, decoder_dtype=decoder_dtype)
        params = params_from_jax(jparams)
        opt = steps.make_optimizer(1e-2, 5.0)
        _, step = steps.make_caption_train_step(cfg, tcfg, opt,
                                                device="cpu")
        sub = {"params": params, "opt_state": opt.init(params)}
        args = (torch.from_numpy(enc), torch.from_numpy(tags),
                torch.from_numpy(caps).long(),
                torch.from_numpy(caplens).long())
        out = [float(step(sub, *args)[1]["loss"]) for _ in range(12)]
        assert all(p.dtype == torch.float32
                   for p in steps.tree_leaves(params))
        return out

    ours = port_losses(dtype)
    assert ours[-1] < ours[0] * 0.9, ours
    if dtype == "float32":
        np.testing.assert_allclose(ours, jax_losses("float32"), rtol=1e-4)
    else:
        f32_first = port_losses("float32")[0]
        for ref in (f32_first, jax_losses("bfloat16")[0]):
            assert abs(ours[0] - ref) < 0.05 * abs(ref) + 0.05, (ours, ref)


def test_bf16_cache_close(data_env):
    """Counterpart of test_feature_cache.py::test_bf16_cache_close: a
    bfloat16 feature cache rounds once; its lookup returns float32 and
    the step's loss stays within 2 % + 0.02 of the float32 encoders'."""
    wm = word_map(data_env)
    cfg = small_cfg(wm, "attention_scn")
    tcfg = TrainConfig(batch_size=4, encoder_dtype="float32")
    ds = CaptionDataset(data_env.data_folder, data_env.data_name, "TRAIN")
    opt = steps.make_optimizer(tcfg.decoder_lr, tcfg.grad_clip)
    state = caption.init_state(torch.Generator().manual_seed(0), cfg, opt,
                               device="cpu")
    cache = feature_cache.build(
        state, cfg, dataclasses.replace(tcfg, cache_dtype="bfloat16"), ds,
        device=CPU, log=lambda *_: None)
    encode_fn, step = steps.make_caption_train_step(cfg, tcfg, opt,
                                                    device="cpu")
    batch = next(iter(loader.iterate(ds, 4, with_index=True)))
    enc_a, tags_a = encode_fn(state, batch)
    enc_b, tags_b = cache.lookup(torch.from_numpy(batch["index"]))
    assert enc_b.dtype == enc_a.dtype == torch.float32
    assert not torch.equal(enc_a, enc_b)
    args = (torch.from_numpy(batch["captions"]).long(),
            torch.from_numpy(batch["caplens"]).long())
    snapshot = [p.detach().clone() for p in steps.tree_leaves(
        state["params"])]

    def loss(enc, tags):
        with torch.no_grad():
            for p, s in zip(steps.tree_leaves(state["params"]), snapshot):
                p.copy_(s)
        sub = {"params": state["params"],
               "opt_state": opt.init(state["params"])}
        return float(step(sub, enc, tags, *args,
                          torch.Generator().manual_seed(0))[1]["loss"])

    la, lb = loss(enc_a, tags_a), loss(enc_b, tags_b)
    assert abs(la - lb) < 0.02 * abs(la) + 0.02, (la, lb)


def test_trainer_main_cache_host_fallback(data_env, tmp_path):
    """Counterpart of test_feature_cache.py::
    test_trainer_main_cache_host_fallback: with no device budget the
    cache stays in host RAM and the trainer trains, validates and
    checkpoints through it."""
    tcfg = TrainConfig(epochs=1, batch_size=4, print_freq=1,
                       cache_features=True, cache_device_budget_gb=0.0,
                       checkpoint_dir=str(tmp_path))
    logs = []
    _, summary = caption.main("attention_scn", data_env, tcfg,
                              model_cfg=small_cfg(word_map(data_env),
                                                  "attention_scn"),
                              log=logs.append, device="cpu")
    assert any("feature cache [TRAIN]" in x and "host RAM" in x
               for x in logs)
    assert any("BLEU-4" in x for x in logs)
    assert np.isfinite(summary["train_loss"])
    assert (tmp_path / f"checkpoint_attention_scn_{data_env.data_name}"
            ).is_file()


def test_finetune_builder_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    opt = steps.make_optimizer(1e-3, 5.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.make_caption_finetune_train_step(ModelConfig(**CFG),
                                               TrainConfig(), opt, opt)
    mask = encoders.caption_encoder_trainable_mask(
        encoders.init_encoder_caption(torch.Generator().manual_seed(0),
                                      arch=ARCH)[0])
    assert {k.split("/")[1] for k, v in by_path(mask).items() if v} == {
        "layer2", "layer3", "layer4"}
