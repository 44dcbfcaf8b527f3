"""Training-format (family (a)) torch checkpoint import.

The reference pickles WHOLE nn.Modules (utils/checkpoint.py:20-31); users
hold such files from their reference training runs.  These tests prove they
load without the reference package or torchvision on the path (classes are
stubbed at unpickle time) and evaluate through the normal CLI loaders.
"""

import sys
import types

import numpy as np
import pytest
import torch

from indonesian_image_captioning_tpu.models import torch_import
from _torch_tmp import tmp_path  # noqa: F401 (fixtures)

FAKE_MOD = "fake_reference_models_pkg"


def _transient_class(name, build):
    """Define a module class inside a throwaway package, so unpickling in
    the test process CANNOT resolve it and must stub."""
    mod = sys.modules.get(FAKE_MOD) or types.ModuleType(FAKE_MOD)
    cls = type(name, (torch.nn.Module,), {"__module__": FAKE_MOD})
    setattr(mod, name, cls)
    sys.modules[FAKE_MOD] = mod
    obj = cls()
    torch.nn.Module.__init__(obj)
    build(obj)
    return obj


def _cleanup():
    sys.modules.pop(FAKE_MOD, None)


def test_stubbed_unpickle_and_extraction(tmp_path):
    def build(m):
        m.linear = torch.nn.Linear(4, 3)
        m.register_buffer("running", torch.arange(3.0))
        m.sub = torch.nn.Sequential(torch.nn.Linear(3, 2))

    enc = _transient_class("FakeEncoder", build)
    snapshot = {k: v.clone() for k, v in enc.state_dict().items()}
    opt = torch.optim.Adam(enc.parameters(), lr=1e-4)
    path = tmp_path / "checkpoint_tagger_foo.pth.tar"
    torch.save({"epoch": 3, "epochs_since_improvement": 1,
                "accuracy": 87.5, "encoder": enc,
                "encoder_optimizer": opt}, path)
    _cleanup()

    ckpt = torch_import.load_training_checkpoint(str(path))
    assert ckpt["epoch"] == 3 and ckpt["accuracy"] == 87.5
    assert "encoder_optimizer" not in ckpt            # optimizers dropped
    assert set(ckpt["encoder"]) == set(snapshot)
    for k in snapshot:
        np.testing.assert_array_equal(np.asarray(ckpt["encoder"][k]),
                                      snapshot[k].numpy())


def _torch_bottleneck(cin, width, cout, downsample):
    b = torch.nn.Module()
    b.conv1 = torch.nn.Conv2d(cin, width, 1, bias=False)
    b.bn1 = torch.nn.BatchNorm2d(width)
    b.conv2 = torch.nn.Conv2d(width, width, 3, padding=1, bias=False)
    b.bn2 = torch.nn.BatchNorm2d(width)
    b.conv3 = torch.nn.Conv2d(width, cout, 1, bias=False)
    b.bn3 = torch.nn.BatchNorm2d(cout)
    if downsample:
        b.downsample = torch.nn.Sequential(
            torch.nn.Conv2d(cin, cout, 1, bias=False),
            torch.nn.BatchNorm2d(cout))
    return b


def _reference_shaped_tagger(semantic=7):
    """Mirror the reference EncoderTagger structure (encoders/tagger.py:
    resnet children minus fc wrapped in nn.Sequential + dropout + linear)
    at resnet50 depth, without torchvision."""
    from indonesian_image_captioning_tpu.models.resnet import BLOCKS, WIDTHS

    layers = []
    cin = 64
    for n, width in zip(BLOCKS["resnet50"], WIDTHS):
        cout = width * 4
        blocks = [_torch_bottleneck(cin, width, cout, True)]
        blocks += [_torch_bottleneck(cout, width, cout, False)
                   for _ in range(n - 1)]
        layers.append(torch.nn.Sequential(*blocks))
        cin = cout

    def build(m):
        m.semantic_size = semantic
        m.resnet = torch.nn.Sequential(
            torch.nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False),
            torch.nn.BatchNorm2d(64),
            torch.nn.ReLU(inplace=True),
            torch.nn.MaxPool2d(3, stride=2, padding=1),
            *layers,
            torch.nn.AdaptiveAvgPool2d((1, 1)))
        m.dropout = torch.nn.Dropout(0.15)
        m.linear = torch.nn.Linear(2048, semantic)
        m.sigmoid = torch.nn.Sigmoid()

    with torch.no_grad():
        tagger = _transient_class("EncoderTagger", build)
        for p in tagger.parameters():
            p.mul_(0.05)
    return tagger


def test_tagger_training_checkpoint_evaluates(tmp_path):
    """eval_tagger-style checkpoint (module under 'encoder',
    reference eval_tagger.py:24-25) loads through the CLI loader and runs."""
    import jax.numpy as jnp

    from indonesian_image_captioning_tpu.cli import common
    from indonesian_image_captioning_tpu.models import convert, encoders

    tagger = _reference_shaped_tagger()
    snapshot = {k: v.clone() for k, v in tagger.state_dict().items()}
    path = tmp_path / "BEST_checkpoint_tagger_foo.pth.tar"
    torch.save({"epoch": 1, "epochs_since_improvement": 0,
                "accuracy": 91.0, "encoder": tagger,
                "encoder_optimizer": torch.optim.Adam(
                    tagger.parameters())}, path)
    _cleanup()

    params, stats = common.load_tagger_state(str(path), arch="resnet50")
    # identical pytrees to converting the state_dict directly
    ref_params, ref_stats = convert.encoder_tagger_from_torch(
        snapshot, arch="resnet50")
    import jax
    for got, want in zip(jax.tree.leaves(params), jax.tree.leaves(ref_params)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    # and it evaluates end-to-end
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=(2, 64, 64, 3)).astype(np.float32))
    probs, _ = encoders.apply_encoder_tagger(params, stats, x, train=False,
                                             arch="resnet50")
    assert probs.shape == (2, 7)
    assert np.isfinite(np.asarray(probs)).all()
    assert (np.asarray(probs) >= 0).all() and (np.asarray(probs) <= 1).all()


def test_is_training_format():
    assert torch_import.is_training_format({"encoder": object(),
                                            "decoder": object()})
    assert not torch_import.is_training_format(
        {"encoder_model_state_dict": {}, "decoder_model_state_dict": {}})
