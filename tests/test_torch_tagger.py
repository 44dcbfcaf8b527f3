"""The port's tagger training against the JAX package, on the CPU.

BatchNorm's training mode, a ResNet-50 tagger's train-mode forward, one
tagger train step and its eval step, held against the JAX functions from
JAX-initialised weights (``models/jax_bridge.py``) on the corpus of
``tests/test_train_smoke.py`` (8 noise images at 32 px, 2 tags, built by
the JAX ``create_input_files``), dropout 0 (the two packages' dropout
streams differ).  Then the tagger trainer (``train/tagger.py``) end to
end: its checkpoint, resume, the device image store, the remat modes and
bf16.

A randomly initialised ResNet in train mode is chaotic: the port against
itself, with each convolution summed in two halves, differs by a median
of several percent in a leaf's gradient at 32 px and B = 4
(``test_train_mode_resnet_is_chaotic_until_damped``).  So the parity tests
damp every residual branch, scaling its last BatchNorm's scale by 0.2
(the zero-init-residual family of inits), on both sides; the same
self-check then differs by under 2e-3.

Tolerances: BatchNorm 1e-5 (float32 statistics; a bf16 output within one
bf16 rounding, since the two packages sum the statistics in other
orders); the train-mode forward's probabilities 1e-4 and statistics 1e-4
relative (each framework sums a convolution in its own order); the step's
loss 1e-4 relative, its gradients 2e-3 of each leaf's largest, taken as
``tests/test_train_smoke.py::test_tagger_encoder_remat_matches`` takes
them, and each updated weight within 2 lr of JAX's (Adam's first step
moves a weight by about lr whatever its gradient's size, so a near-zero
gradient of the other sign is no fault).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from indonesian_image_captioning_tpu.core import metrics as jax_metrics
from indonesian_image_captioning_tpu.core.config import \
    TaggerConfig as JaxTaggerConfig
from indonesian_image_captioning_tpu.core.config import \
    TrainConfig as JaxTrainConfig
from indonesian_image_captioning_tpu.core.config import \
    tagger_train_config as jax_tagger_train_config
from indonesian_image_captioning_tpu.core.prng import root_key
from indonesian_image_captioning_tpu.data import loader as jax_loader
from indonesian_image_captioning_tpu.data import preprocess
from indonesian_image_captioning_tpu.data.datasets import \
    TagDataset as JaxTagDataset
from indonesian_image_captioning_tpu.models import encoders as jax_encoders
from indonesian_image_captioning_tpu.models import resnet as jax_resnet
from indonesian_image_captioning_tpu.ops import losses as jax_losses
from indonesian_image_captioning_tpu.train import steps as jax_steps
from indonesian_image_captioning_tpu.train import tagger as jax_tagger
from indonesian_image_captioning_tpu_torch.cli import common
from indonesian_image_captioning_tpu_torch.core import checkpoint as ckpt
from indonesian_image_captioning_tpu_torch.core import metrics
from indonesian_image_captioning_tpu_torch.core.config import (
    DataConfig, ModelConfig, TaggerConfig, TrainConfig, tagger_train_config)
from indonesian_image_captioning_tpu_torch.data import device_store, loader
from indonesian_image_captioning_tpu_torch.data.datasets import TagDataset
from indonesian_image_captioning_tpu_torch.models import encoders, resnet
from indonesian_image_captioning_tpu_torch.models.jax_bridge import \
    params_from_jax
from indonesian_image_captioning_tpu_torch.ops import losses
from indonesian_image_captioning_tpu_torch.train import caption, steps
from indonesian_image_captioning_tpu_torch.train import tagger
from _torch_tmp import tmp_path, tmp_path_factory  # noqa: F401 (fixtures)

torch.set_num_threads(1)
CPU = torch.device("cpu")
ARCH = "resnet50"
NAME = "flickr10k_2_cap_per_img_0_min_word_freq"
LR = 1e-3


@pytest.fixture(scope="module")
def data_env(tmp_path_factory):
    """tests/test_train_smoke.py's corpus, preprocessed by the JAX
    package."""
    root = tmp_path_factory.mktemp("corpus")
    img_dir = root / "imgs"
    img_dir.mkdir()
    out = tmp_path_factory.mktemp("scn_data")
    rng = np.random.default_rng(0)
    words = ["anjing", "kucing", "bermain", "di", "taman", "bola", "anak"]
    filenames, captions, tags = [], [], []
    for i in range(8):
        name = f"{i:04d}.jpg"
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
                        ).save(img_dir / name)
        filenames.append(name)
        captions.append([" ".join(rng.choice(words, 4).tolist())
                         for _ in range(2)])
        tags.append([rng.choice(["anjing", "kucing"])])
    (root / "filenames.json").write_text(json.dumps(filenames))
    (root / "captions.json").write_text(json.dumps(captions))
    (root / "tags.json").write_text(json.dumps(tags))
    (root / "train.txt").write_text("\n".join(f"{i:04d}" for i in range(6)))
    (root / "val.txt").write_text("\n".join(f"{i:04d}" for i in range(6, 8)))
    (root / "test.txt").write_text("")
    (root / "all_tags.txt").write_text("anjing\nkucing")
    preprocess.create_input_files(
        "flickr10k", str(root), str(img_dir), captions_per_image=2,
        min_word_freq=0, output_folder=str(out), tag_size=2, max_len=10,
        image_size=32)
    return DataConfig(data_folder=str(out), data_name=NAME,
                      captions_per_image=2, image_size=32, tag_size=2)


def by_path(tree, prefix=""):
    """{path: leaf} of nested dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(by_path(v, f"{prefix}{k}/"))
    return out


def jax_tree(tree):
    """A JAX tree in the port's layout, by path."""
    return by_path(params_from_jax(jax.device_get(tree)))


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = np.abs(b).max()
    return 0.0 if scale == 0 else float(np.abs(a - b).max() / scale)


def damp_residuals(jax_params, factor=0.2):
    """The JAX ResNet tree (under "resnet") with every bottleneck's bn3
    scale multiplied by factor."""
    params = jax.tree.map(np.asarray, jax.device_get(jax_params))
    for stage in ("layer1", "layer2", "layer3", "layer4"):
        for part in params["resnet"][stage].values():
            part["bn3"]["scale"] = part["bn3"]["scale"] * factor
    return params


def f32(t):
    return t.detach().to(torch.float32).numpy()


# ---------------------------------------------------------------------------
# BatchNorm's training mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_mode_matches_jax(dtype):
    """resnet._bn(train=True): batch statistics in float32, the running
    statistics moved by momentum 0.1 with the unbiased variance, both
    within 1e-5 of JAX's; the output within 1e-5 (bf16: one rounding)."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 4, 6)) * 2 + 0.7).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
         "bias": rng.standard_normal(6).astype(np.float32)}
    s = {"mean": rng.standard_normal(6).astype(np.float32),
         "var": rng.uniform(0.5, 2.0, 6).astype(np.float32)}
    jdt = jnp.dtype(dtype)
    y_ref, s_ref = jax_resnet._bn(jnp.asarray(x, jdt), p, s, True)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)
    y, new_s = resnet._bn(xt, {k: torch.from_numpy(v) for k, v in p.items()},
                          {k: torch.from_numpy(v) for k, v in s.items()},
                          True)
    assert y.dtype == tdt
    y = f32(y.permute(0, 2, 3, 1))
    y_ref = np.asarray(y_ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(y, y_ref, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(y, y_ref, atol=1e-5,
                                   rtol=2.0 ** -8)
    for k in ("mean", "var"):
        assert new_s[k].dtype == torch.float32
        np.testing.assert_allclose(new_s[k].numpy(), np.asarray(s_ref[k]),
                                   atol=1e-5, rtol=1e-5)
    n = 3 * 5 * 4
    xf = x.astype(np.float64) if dtype == "float32" else np.asarray(
        jnp.asarray(x, jdt), np.float64)
    var = xf.var(axis=(0, 1, 2)) * n / (n - 1)
    np.testing.assert_allclose(new_s["var"].numpy(), 0.9 * s["var"]
                               + 0.1 * var, rtol=1e-5)
    with pytest.raises(ValueError, match="BatchNorm mode"):
        resnet._bn(xt, {k: torch.from_numpy(v) for k, v in p.items()},
                   s, "train")


# ---------------------------------------------------------------------------
# One tagger train step against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_step_case(data_env):
    """JAX's tagger step (the shapes of test_train_smoke.py's mixed-
    precision test, its weights with damped residual branches) and
    jax.value_and_grad of its loss, with the train-mode probabilities and
    statistics: one batch of 4, dropout 0."""
    tagger_cfg = JaxTaggerConfig(semantic_size=2, encoder_arch=ARCH)
    jopt = jax_steps.make_optimizer(LR, 5.0)
    jtcfg = JaxTrainConfig(batch_size=4, decoder_lr=LR)
    jstate = jax_tagger.init_state(root_key(0), jtcfg, tagger_cfg, jopt)
    jstate = {**jstate, "params": damp_residuals(jstate["params"])}
    ds = JaxTagDataset(data_env.data_folder, data_env.data_name, "TRAIN")
    batch = next(iter(jax_loader.iterate(ds, 4)))
    step = jax_steps.make_tagger_train_step(jtcfg, jopt, dropout_rate=0.0,
                                            arch=ARCH, donate=False)
    new_state, m = step(jstate, batch, jax.random.key(0))
    images = jax_steps.prep_images(batch["images"])

    def loss_fn(params):
        probs, stats = jax_encoders.apply_encoder_tagger(
            params, jstate["stats"], images, train=True, arch=ARCH)
        return jax_losses.bce_loss(probs, batch["tags"],
                                   row_valid=batch["valid"]), (probs, stats)

    (loss, (probs, stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(jstate["params"])
    return dict(state=jax.device_get(jstate), batch=batch,
                new_state=jax.device_get(new_state), metrics=m,
                loss=float(loss), probs=np.asarray(probs),
                stats=jax.device_get(stats), grads=jax.device_get(grads))


def port_state(jstate, opt):
    params = params_from_jax(jstate["params"])
    return {"params": params, "stats": params_from_jax(jstate["stats"]),
            "opt_state": opt.init(params)}


@pytest.mark.parametrize("factor,bound", [(1.0, None), (0.2, 2e-3)])
def test_train_mode_resnet_is_chaotic_until_damped(jax_step_case,
                                                   monkeypatch, factor,
                                                   bound):
    """Why the parity tests damp the residual branches: the tagger's
    train-mode gradients from JAX's init, the port against itself with
    each convolution summed in two halves of its input channels.
    Undamped, a leaf's gradient moves by a median above 1e-2 of its
    largest; damped (bn3 scale x0.2) every leaf moves by under 2e-3."""
    c = jax_step_case
    params = params_from_jax(c["state"]["params"])
    if factor != 0.2:          # the fixture's weights are damped by 0.2
        for bp in [b for st in ("layer1", "layer2", "layer3", "layer4")
                   for b in [params["resnet"][st]["first"],
                             *params["resnet"][st]["rest"]]]:
            bp["bn3"]["scale"] = bp["bn3"]["scale"] * (factor / 0.2)
    x = encoders.prep_images(torch.from_numpy(c["batch"]["images"]))
    tags = torch.from_numpy(c["batch"]["tags"])
    conv = resnet._conv

    def halves(x, w, stride, padding):
        h = w.shape[1] // 2
        if h == 0:
            return conv(x, w, stride, padding)
        return (conv(x[:, :h], w[:, :h], stride, padding)
                + conv(x[:, h:], w[:, h:], stride, padding))

    def grads():
        for p in steps.tree_leaves(params):
            p.requires_grad_(True)
            p.grad = None
        probs, _ = encoders.apply_encoder_tagger(
            params, params_from_jax(c["state"]["stats"]), x, train=True,
            arch=ARCH)
        losses.bce_loss(probs, tags).backward()
        return [p.grad.clone() for p in steps.tree_leaves(params)]

    a = grads()
    monkeypatch.setattr(resnet, "_conv", halves)
    b = grads()
    errs = [rel_err(u.numpy(), v.numpy()) for u, v in zip(a, b)]
    if bound is None:
        assert float(np.median(errs)) > 1e-2, np.median(errs)
    else:
        assert max(errs) < bound, max(errs)


def test_tagger_train_mode_forward_matches_jax(jax_step_case):
    """A ResNet-50 tagger with train=True at 32 px: probabilities within
    1e-4 and new statistics within 1e-4 relative of JAX's, float32."""
    c = jax_step_case
    x = encoders.prep_images(torch.from_numpy(c["batch"]["images"]))
    with torch.no_grad():
        probs, stats = encoders.apply_encoder_tagger(
            params_from_jax(c["state"]["params"]),
            params_from_jax(c["state"]["stats"]), x, train=True, arch=ARCH)
    np.testing.assert_allclose(probs.numpy(), c["probs"], atol=1e-4, rtol=0)
    ours, ref = by_path(stats), jax_tree(c["stats"])
    assert ours.keys() == ref.keys()
    for k, v in ours.items():
        assert v.dtype == torch.float32
        assert rel_err(v.numpy(), ref[k].numpy()) < 1e-4, k


def test_tagger_train_step_matches_jax(jax_step_case):
    """One make_tagger_train_step step from the same weights and batch:
    loss and accuracy, the clamped gradients of the trainable leaves, the
    updated weights, the frozen conv1 and layer1 bitwise (and no backward
    into them), every running statistic moved as JAX's."""
    c = jax_step_case
    opt = steps.make_optimizer(LR, 5.0)
    state = port_state(c["state"], opt)
    before = {k: v.clone() for k, v in by_path(state["params"]).items()}
    step = steps.make_tagger_train_step(TrainConfig(batch_size=4), opt,
                                        dropout_rate=0.0, arch=ARCH,
                                        device="cpu")
    _, m = step(state, c["batch"])
    assert float(m["loss"]) == pytest.approx(float(c["metrics"]["loss"]),
                                             rel=1e-4)
    assert float(m["loss"]) == pytest.approx(c["loss"], rel=1e-4)
    assert float(m["acc"]) == float(c["metrics"]["acc"])

    mask = by_path(steps.tagger_trainable_mask(state["params"]))
    params = by_path(state["params"])
    grads = jax_tree(jax.tree.map(lambda g: np.clip(g, -5, 5), c["grads"]))
    new_ref = jax_tree(c["new_state"]["params"])
    assert params.keys() == grads.keys() == new_ref.keys() == mask.keys()
    for k, p in params.items():
        frozen = k.split("/")[1] in ("conv1", "bn1", "layer1")
        assert mask[k] != frozen and p.requires_grad != frozen, k
        if frozen:
            assert torch.equal(p, before[k]), k
            assert torch.equal(new_ref[k], before[k]), k
            continue
        assert rel_err(p.grad.numpy(), grads[k].numpy()) < 2e-3, k
        np.testing.assert_allclose(p.detach().numpy(), new_ref[k].numpy(),
                                   atol=2 * LR, rtol=0, err_msg=k)
        assert not torch.equal(p, before[k]), k
    stats, ref = by_path(state["stats"]), jax_tree(c["new_state"]["stats"])
    for k, v in stats.items():
        assert v.dtype == torch.float32
        assert rel_err(v.numpy(), ref[k].numpy()) < 1e-4, k
    # the frozen stages' running statistics move too (train-mode BN)
    old = jax_tree(c["state"]["stats"])
    assert not torch.equal(stats["resnet/bn1/mean"], old["resnet/bn1/mean"])
    assert not torch.equal(stats["resnet/layer1/first/bn1/var"],
                           old["resnet/layer1/first/bn1/var"])


@pytest.mark.parametrize("valid", [None, [1, 1, 1, 0]])
def test_tagger_eval_step_matches_jax(jax_step_case, valid):
    c = jax_step_case
    batch = dict(c["batch"])
    if valid is None:
        del batch["valid"]
    else:
        batch["valid"] = np.asarray(valid, np.float32)
    ref = jax_steps.make_tagger_eval_step(arch=ARCH)(
        c["state"]["params"], c["state"]["stats"], batch)
    out = steps.make_tagger_eval_step(arch=ARCH, device="cpu")(
        params_from_jax(c["state"]["params"]),
        params_from_jax(c["state"]["stats"]), batch)
    assert float(out["loss"]) == pytest.approx(float(ref["loss"]), rel=1e-4)
    assert float(out["acc"]) == float(ref["acc"])


def test_binary_accuracy_matches_jax_and_ignores_padded_rows():
    """core.metrics.binary_accuracy and the step's _binary_accuracy
    against JAX's; padded rows (valid 0) do not count."""
    rng = np.random.default_rng(2)
    probs = rng.uniform(size=(3, 5)).astype(np.float32)
    targets = rng.integers(0, 2, (3, 5)).astype(np.float32)
    probs[0, 0] = 0.5                      # the threshold counts as 1
    t = torch.from_numpy
    assert float(metrics.binary_accuracy(t(probs), t(targets))) == float(
        jax_metrics.binary_accuracy(probs, targets))
    base = steps._binary_accuracy(t(probs), t(targets))
    assert float(base) == float(jax_steps._binary_accuracy(probs, targets))
    probs_p = np.concatenate([probs, np.zeros((2, 5), np.float32)])
    targets_p = np.concatenate([targets, np.ones((2, 5), np.float32)])
    valid = np.asarray([1, 1, 1, 0, 0], np.float32)
    ours = steps._binary_accuracy(t(probs_p), t(targets_p), t(valid))
    assert float(ours) == pytest.approx(float(base), rel=1e-6)
    assert float(ours) == pytest.approx(float(jax_steps._binary_accuracy(
        probs_p, targets_p, row_valid=valid)), rel=1e-6)


# ---------------------------------------------------------------------------
# The tagger trainer
# ---------------------------------------------------------------------------

def tagger_cfg():
    return TaggerConfig(semantic_size=2, encoder_arch=ARCH)


def run_trainer(data_env, tmp_path, log=None, resume=False, **kw):
    tcfg = tagger_train_config(**{**dict(
        epochs=2, batch_size=4, print_freq=1,
        checkpoint_dir=str(tmp_path)), **kw})
    logs = [] if log is None else log
    return tagger.main(data_env, tcfg, tagger_cfg(), resume=resume,
                       log=logs.append, device="cpu")


def test_tagger_trainer_end_to_end_checkpoint_and_resume(data_env,
                                                         tmp_path):
    """Counterpart of test_train_smoke.py::test_tagger_trainer_end_to_end:
    two epochs write checkpoint_tagger_{data}; its state loads through
    cli.common.load_tagger_state and caption.init_state(tagger_checkpoint)
    bitwise; a resume with nothing left runs nothing and keeps Adam's
    moments, one for a third epoch starts there."""
    logs = []
    state, summary = run_trainer(data_env, tmp_path, logs)
    name = f"checkpoint_tagger_{NAME}"
    assert (tmp_path / name).is_file()
    assert (tmp_path / f"BEST_{name}").exists() == (
        summary["best_metric"] > 0.0)
    assert 0.0 <= summary["best_metric"] <= 100.0
    assert sorted(summary["step_losses"]) == [0, 1]
    assert all(len(v) == 2 and np.isfinite(v).all()
               for v in summary["step_losses"].values())
    assert any("device image store [TRAIN]" in x for x in logs)
    assert sum("ACCURACY" in x for x in logs) == 2

    saved = ckpt.load_checkpoint(str(tmp_path), "tagger", NAME)
    assert sorted(saved["state"]) == ["opt_state", "params", "stats"]
    assert saved["epoch"] == 1
    want = by_path({"params": state["params"], "stats": state["stats"]})
    params, stats = common.load_tagger_state(str(tmp_path / name), ARCH,
                                             device="cpu")
    got = by_path({"params": params, "stats": stats})
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    cfg = ModelConfig(model_type="attention_scn", vocab_size=9,
                      embed_dim=8, attention_dim=8, decoder_dim=8,
                      factored_dim=8, semantic_dim=2, encoder_arch=ARCH)
    cstate = caption.init_state(torch.Generator().manual_seed(0), cfg,
                                steps.make_optimizer(1e-3, 5.0),
                                tagger_checkpoint=str(tmp_path / name),
                                device="cpu")
    got = by_path({"params": cstate["tagger"],
                   "stats": cstate["tagger_stats"]})
    assert all(torch.equal(got[k], want[k]) for k in want)

    moments = [s["exp_avg_sq"].clone()
               for s in state["opt_state"].state.values()]
    again, s2 = run_trainer(data_env, tmp_path, resume=True)
    assert s2["start_epoch"] == 2 and s2["step_losses"] == {}
    assert all(torch.equal(s["exp_avg_sq"], m) for s, m in
               zip(again["opt_state"].state.values(), moments))
    assert all(int(s["step"]) == 4
               for s in again["opt_state"].state.values())
    logs3 = []
    _, s3 = run_trainer(data_env, tmp_path, logs3, resume=True, epochs=3)
    assert s3["start_epoch"] == 2 and sorted(s3["step_losses"]) == [2]
    assert "Current epoch 3\n" in logs3 and "Current epoch 1\n" not in logs3


def test_tagger_training_bit_identical_with_store(data_env, tmp_path):
    """Counterpart of test_device_store.py::
    test_tagger_training_bit_identical_with_store."""
    _, s_off = run_trainer(data_env, tmp_path / "off", epochs=1,
                           device_images="off")
    logs = []
    _, s_on = run_trainer(data_env, tmp_path / "on", logs, epochs=1,
                          device_images="on")
    assert any("device image store [TRAIN]" in x for x in logs)
    assert s_on["train_loss"] == s_off["train_loss"]
    assert s_on["best_metric"] == s_off["best_metric"]
    assert s_on["step_losses"] == s_off["step_losses"]


def test_tag_dataset_load_images_flag(data_env):
    """Counterpart of test_device_store.py::test_tag_dataset_load_images_
    flag, with the loader's index rows against JAX's."""
    ds = TagDataset(data_env.data_folder, data_env.data_name, "TRAIN")
    jds = JaxTagDataset(data_env.data_folder, data_env.data_name, "TRAIN")
    assert ds.num_images == 6
    b = ds.gather(np.array([1, 0]))
    assert "images" in b
    np.testing.assert_array_equal(b["images"][1], ds.image(0))
    np.testing.assert_array_equal(ds.gather_images(np.array([2, 2])),
                                  np.stack([ds.image(2)] * 2))
    ds.load_images = jds.load_images = False
    b2 = ds.gather(np.array([1, 0]))
    assert "images" not in b2 and "tags" in b2
    kw = dict(shuffle=True, seed=3, epoch=1, with_index=True)
    for a, r in zip(loader.iterate(ds, 4, **kw),
                    jax_loader.iterate(jds, 4, **kw), strict=True):
        assert sorted(a) == sorted(r) == ["index", "tags", "valid"]
        for k in r:
            np.testing.assert_array_equal(a[k], r[k])


class _FakeDs:
    def __init__(self, images):
        self._images = images
        self.num_images = images.shape[0]
        self.load_images = True


def test_device_store_budget_fallback_and_required():
    """Counterpart of test_device_store.py::
    test_build_budget_fallback_and_required."""
    images = np.zeros((4, 3, 16, 16), np.uint8)
    logs = []
    assert device_store.build(_FakeDs(images), budget_bytes=10, device=CPU,
                              log=logs.append) is None
    assert "exceeds" in logs[-1]
    store = device_store.build(_FakeDs(images), budget_bytes=1 << 20,
                               device=CPU, log=logs.append)
    assert store is not None and store.nbytes == images.nbytes
    tcfg = TrainConfig(device_images="on", device_images_budget_gb=1e-9)
    with pytest.raises(ValueError, match="does not fit"):
        device_store.build_pair(tcfg, _FakeDs(images), _FakeDs(images), CPU)
    tcfg = TrainConfig(device_images="off")
    assert device_store.build_pair(tcfg, _FakeDs(images), _FakeDs(images),
                                   CPU) == (None, None)
    auto = TrainConfig(device_images_budget_gb=1e-9)
    train_ds, val_ds = _FakeDs(images), _FakeDs(images)
    assert device_store.build_pair(auto, train_ds, val_ds, CPU,
                                   log=logs.append) == (None, None)
    assert train_ds.load_images and val_ds.load_images


@pytest.fixture(scope="module")
def one_batch(data_env):
    ds = TagDataset(data_env.data_folder, data_env.data_name, "TRAIN")
    return next(iter(loader.iterate(ds, 4)))


def test_tagger_loss_decreases_mixed_precision(jax_step_case):
    """Counterpart of test_train_smoke.py::
    test_tagger_loss_decreases_mixed_precision, from its weights (damped
    residual branches) and batch: 8 steps at float32 and bfloat16 both learn, master weights and
    running statistics stay float32, and the first-step losses agree
    within 5 % + 0.05."""
    first = {}
    one_batch = jax_step_case["batch"]
    for dtype in ("float32", "bfloat16"):
        opt = steps.make_optimizer(LR, 5.0)
        state = port_state(jax_step_case["state"], opt)
        step = steps.make_tagger_train_step(
            TrainConfig(batch_size=4, decoder_lr=LR, tagger_dtype=dtype),
            opt, dropout_rate=0.0, arch=ARCH, device="cpu")
        hist = [float(step(state, one_batch)[1]["loss"]) for _ in range(8)]
        first[dtype] = hist[0]
        assert hist[-1] < hist[0], (dtype, hist)
        assert all(x.dtype == torch.float32
                   for x in steps.tree_leaves(state["params"]))
        assert all(x.dtype == torch.float32
                   for x in steps.tree_leaves(state["stats"]))
    assert abs(first["bfloat16"] - first["float32"]) \
        < 0.05 * abs(first["float32"]) + 0.05, first


@pytest.fixture(scope="module")
def remat_reference(one_batch):
    """The tagger loss, gradients and new statistics without remat, with
    dropout at 0.15 from a seeded generator."""
    params, stats = encoders.init_encoder_tagger(
        torch.Generator().manual_seed(0), tagger_cfg(), arch=ARCH)
    for p in steps.tree_leaves(params):
        p.requires_grad_(True)
    x = encoders.prep_images(torch.from_numpy(one_batch["images"]))
    tags = torch.from_numpy(one_batch["tags"])

    def run(remat):
        for p in steps.tree_leaves(params):
            p.grad = None
        probs, new_stats = encoders.apply_encoder_tagger(
            params, stats, x, train=True,
            dropout_gen=torch.Generator().manual_seed(3), dropout_rate=0.15,
            arch=ARCH, remat=remat)
        loss = losses.bce_loss(probs, tags)
        loss.backward()
        return (float(loss), [p.grad.clone() for p in
                              steps.tree_leaves(params)],
                steps.tree_leaves(new_stats))

    return run, run(False)


@pytest.mark.parametrize("remat", [True, "blocks", "convs"])
def test_tagger_encoder_remat_matches(remat_reference, remat):
    """Counterpart of test_train_smoke.py::test_tagger_encoder_remat_
    matches: rematerialised bottlenecks give the loss within 1e-6, every
    gradient within 1e-3 of its leaf's largest, and the forward's
    statistics bitwise."""
    run, (loss0, grads0, stats0) = remat_reference
    loss, grads, stats = run(remat)
    assert abs(loss - loss0) < 1e-6
    for i, (a, b) in enumerate(zip(grads0, grads, strict=True)):
        scale = float(a.abs().max())
        if scale == 0.0:
            assert float(b.abs().max()) == 0.0
            continue
        assert float((a - b).abs().max()) / scale < 1e-3, (remat, i)
    assert all(torch.equal(a, b) for a, b in zip(stats0, stats, strict=True))
    with pytest.raises(ValueError, match="remat"):
        resnet._block_fn("layers")


def test_tagger_builders_run_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    opt = steps.make_optimizer(LR, 5.0)
    for build in (lambda: steps.make_tagger_train_step(TrainConfig(), opt),
                  lambda: steps.make_tagger_eval_step(),
                  lambda: tagger.train(None, None)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    assert dataclasses.asdict(tagger_train_config(epochs=3)) == \
        dataclasses.asdict(jax_tagger_train_config(epochs=3))
