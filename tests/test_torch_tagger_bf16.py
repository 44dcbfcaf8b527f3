"""The port's bfloat16 tagger train step against JAX's, on the CPU.

``make_tagger_train_step`` with ``tagger_dtype="bfloat16"`` casts the
float32 masters to bf16 inside the step, runs the ResNet in bf16 (its
batch statistics reduce in float32) and scores float32 probabilities.
Here it is held against JAX's bf16 step from the same ResNet-50 weights
(the damped residual branches of ``tests/test_torch_tagger.py``) on one
batch of 8 seeded noise images at 64 px, 2 tags, dropout 0.

A bf16 gradient of a train-mode ResNet carries bf16's own error, far more
than a few roundings: JAX's float32 gradients differ from its bf16 ones
by a cosine of 0.92 in the worst trainable leaf here, and by 0.49 at the
32 px, B = 4 batch of ``tests/test_torch_tagger.py`` (where layer4's
BatchNorm sees 4 values a channel).  So the port is held to JAX's bf16
step within bf16's error, at 64 px and B = 8, by four limits, each set
from the measured gap:

* the loss within 5e-3 relative (port 1.2e-4; the float32 step 1.3e-3);
* every trainable leaf's clamped gradient at a cosine of at least 0.8 to
  JAX's (port 0.90 in the worst leaf; the float32 step 0.92);
* the head's gradients within 0.1 of their largest (port 0.05);
* the running statistics within 5e-2 of each leaf's largest (port
  1.7e-2).

The controls, the same bf16 step with the ResNet's features zeroed or
with its BatchNorm normalising by the running statistics, must fail them:
their loss moves by 2e-2 and their median leaf cosine is about 0.

Adam's first step moves each weight by at most lr, so an updated weight
is within 2 lr of JAX's (plus a float32 rounding) whatever the sign of a
noisy gradient; that bound checks only that each weight moved as Adam's
first step moves it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_tagger import (ARCH, LR, by_path, damp_residuals, jax_tree,
                               port_state, rel_err)

from indonesian_image_captioning_tpu.core.config import \
    TaggerConfig as JaxTaggerConfig
from indonesian_image_captioning_tpu.core.config import \
    TrainConfig as JaxTrainConfig
from indonesian_image_captioning_tpu.core.prng import root_key
from indonesian_image_captioning_tpu.models import encoders as jax_encoders
from indonesian_image_captioning_tpu.ops import losses as jax_losses
from indonesian_image_captioning_tpu.train import steps as jax_steps
from indonesian_image_captioning_tpu.train import tagger as jax_tagger
from indonesian_image_captioning_tpu_torch.core.config import TrainConfig
from indonesian_image_captioning_tpu_torch.models import resnet
from indonesian_image_captioning_tpu_torch.train import steps

torch.set_num_threads(1)
BATCH, SIZE, TAGS = 8, 64, 2
LOSS_TOL, GRAD_COS, HEAD_TOL, STATS_TOL = 5e-3, 0.8, 0.1, 5e-2


@pytest.fixture(scope="module")
def jax_bf16_case():
    """JAX's bf16 tagger step on one seeded batch, and the gradients of
    its loss (the step's loss_fn: masters cast to bf16, probabilities
    back to float32)."""
    tagger_cfg = JaxTaggerConfig(semantic_size=TAGS, encoder_arch=ARCH)
    jopt = jax_steps.make_optimizer(LR, 5.0)
    jtcfg = JaxTrainConfig(batch_size=BATCH, decoder_lr=LR,
                           tagger_dtype="bfloat16")
    jstate = jax_tagger.init_state(root_key(0), jtcfg, tagger_cfg, jopt)
    jstate = jax.device_get({**jstate,
                             "params": damp_residuals(jstate["params"])})
    rng = np.random.default_rng(5)
    batch = {"images": rng.integers(0, 256, (BATCH, 3, SIZE, SIZE),
                                    dtype=np.uint8),
             "tags": rng.integers(0, 2, (BATCH, TAGS)).astype(np.float32),
             "valid": np.ones(BATCH, np.float32)}
    step = jax_steps.make_tagger_train_step(jtcfg, jopt, dropout_rate=0.0,
                                            arch=ARCH, donate=False)
    new_state, m = step(jstate, batch, jax.random.key(0))
    images = jax_steps.prep_images(batch["images"]).astype(jnp.bfloat16)

    def loss_fn(params):
        params = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
        probs, _ = jax_encoders.apply_encoder_tagger(
            params, jstate["stats"], images, train=True, arch=ARCH)
        return jax_losses.bce_loss(probs.astype(jnp.float32), batch["tags"],
                                   row_valid=batch["valid"])

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jstate["params"])
    assert float(loss) == pytest.approx(float(m["loss"]), rel=1e-6)
    return dict(state=jstate, batch=batch, new_state=jax.device_get(new_state),
                loss=float(m["loss"]),
                grads=jax_tree(jax.tree.map(
                    lambda g: np.clip(np.asarray(g, np.float32), -5, 5),
                    jax.device_get(grads))))


def port_bf16_step(c):
    """(state after one port bf16 step from the case's weights, its
    metrics, the parameters before it by path)."""
    opt = steps.make_optimizer(LR, 5.0)
    state = port_state(c["state"], opt)
    before = {k: v.clone() for k, v in by_path(state["params"]).items()}
    step = steps.make_tagger_train_step(
        TrainConfig(batch_size=BATCH, decoder_lr=LR,
                    tagger_dtype="bfloat16"),
        opt, dropout_rate=0.0, arch=ARCH, device="cpu")
    _, m = step(state, c["batch"])
    return state, m, before


def gaps(c, state, m):
    """The port's step against JAX's: the loss's relative gap, the least
    gradient cosine over trainable leaves, the head's gradient gap and
    the running statistics' gap, each leaf against its largest."""
    mask = by_path(steps.tagger_trainable_mask(state["params"]))
    cos, head = [], []
    for k, p in by_path(state["params"]).items():
        if not mask[k]:
            continue
        a = p.grad.numpy().ravel().astype(np.float64)
        b = c["grads"][k].numpy().ravel().astype(np.float64)
        cos.append(float(a @ b) / max(
            float(np.linalg.norm(a) * np.linalg.norm(b)), 1e-30))
        if k.startswith("linear/"):
            head.append(rel_err(a, b))
    ref = jax_tree(c["new_state"]["stats"])
    stats = max(rel_err(v.numpy(), ref[k].numpy())
                for k, v in by_path(state["stats"]).items())
    return {"loss": abs(float(m["loss"]) - c["loss"]) / c["loss"],
            "cos": min(cos), "head": max(head), "stats": stats}


def within(g):
    return (g["loss"] < LOSS_TOL and g["cos"] >= GRAD_COS
            and g["head"] < HEAD_TOL and g["stats"] < STATS_TOL)


def test_tagger_bf16_train_step_matches_jax(jax_bf16_case, monkeypatch):
    """One bf16 step within the four limits of JAX's, every convolution
    run in bf16, the masters, Adam's update and the running statistics
    float32, each updated weight within 2 lr of JAX's, conv1 and layer1
    bitwise unchanged."""
    c = jax_bf16_case
    conv, dtypes = resnet._conv, set()

    def spy(x, w, stride, padding):
        dtypes.update((x.dtype, w.dtype))
        return conv(x, w, stride, padding)

    monkeypatch.setattr(resnet, "_conv", spy)
    state, m, before = port_bf16_step(c)
    assert dtypes == {torch.bfloat16}
    g = gaps(c, state, m)
    assert within(g), g
    new_ref = jax_tree(c["new_state"]["params"])
    mask = by_path(steps.tagger_trainable_mask(state["params"]))
    for k, p in by_path(state["params"]).items():
        assert p.dtype == torch.float32 and (
            p.grad is None or p.grad.dtype == torch.float32), k
        if not mask[k]:
            assert torch.equal(p, before[k]) and torch.equal(new_ref[k],
                                                             before[k]), k
            continue
        np.testing.assert_allclose(p.detach().numpy(), new_ref[k].numpy(),
                                   atol=2 * LR + 1e-6, rtol=0, err_msg=k)
    assert all(v.dtype == torch.float32
               for v in steps.tree_leaves(state["stats"]))


@pytest.mark.parametrize("control", ["features_zeroed", "running_stats_bn"])
def test_tagger_bf16_limits_reject_wrong_features(jax_bf16_case, monkeypatch,
                                                  control):
    """The limits of test_tagger_bf16_train_step_matches_jax fail a bf16
    step whose features are wrong: the ResNet's output zeroed, or its
    BatchNorm normalising by the running statistics in train mode."""
    if control == "features_zeroed":
        apply = resnet.apply_resnet

        def zeroed(*a, **kw):
            feat, stats = apply(*a, **kw)
            return feat * 0, stats

        monkeypatch.setattr(resnet, "apply_resnet", zeroed)
    else:
        bn = resnet._bn

        def running(x, p, s, train, group=None):
            return bn(x, p, s, False)[0], bn(x, p, s, train, group)[1]

        monkeypatch.setattr(resnet, "_bn", running)
    state, m, _ = port_bf16_step(jax_bf16_case)
    g = gaps(jax_bf16_case, state, m)
    assert not within(g), g
