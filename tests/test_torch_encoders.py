"""The port's encoders and weight bridge against the JAX package, on the CPU.

ResNet-50 on 64-pixel images, JAX-initialised weights moved with
``params_from_jax``.  Tolerance, relative to the largest magnitude: 1e-4
in eval mode (a ResNet sums convolutions in another order in each
framework; at random init the eval-mode features are large, so the bound is
relative), 1e-3 in calibrate mode (each BatchNorm divides by the standard
deviation of as few as 16 values per channel, which amplifies those
differences layer by layer).
"""

import jax
import numpy as np
import pytest
import torch

from indonesian_image_captioning_tpu.core.config import (ModelConfig,
                                                         TaggerConfig)
from indonesian_image_captioning_tpu.models import decoders as jax_decoders
from indonesian_image_captioning_tpu.models import encoders as jax_encoders
from indonesian_image_captioning_tpu.ops.adaptive_pool import _pool_matrix
from indonesian_image_captioning_tpu.train.steps import \
    prep_images as jax_prep_images
from indonesian_image_captioning_tpu_torch.models import encoders, resnet
from indonesian_image_captioning_tpu_torch.models.jax_bridge import (
    params_from_jax, params_to_jax)
from indonesian_image_captioning_tpu_torch.ops.bn_act import bn_act
from indonesian_image_captioning_tpu_torch.ops.adaptive_pool import \
    adaptive_avg_pool2d

torch.set_num_threads(1)
ARCH = "resnet50"


def rel_close(a, b, tol=1e-4):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    assert np.abs(a - b).max() / scale < tol, np.abs(a - b).max() / scale


def tree_close(a, b, tol=1e-4):
    if isinstance(b, dict):
        assert a.keys() == b.keys()
        for k in b:
            tree_close(a[k], b[k], tol)
    elif b is None:
        assert a is None
    else:
        rel_close(a, b, tol)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, size=(4, 3, 64, 64), dtype=np.uint8)
    x = np.array(jax_prep_images(u8))
    xt = encoders.prep_images(torch.from_numpy(u8))
    np.testing.assert_allclose(xt.numpy(), x, atol=1e-6)
    return u8, x


TOL = {False: 1e-4, "calibrate": 1e-3}


@pytest.mark.parametrize("train", [False, "calibrate"])
def test_caption_encoder_matches_jax(images, train):
    _, x = images
    p, s = jax_encoders.init_encoder_caption(jax.random.key(1), arch=ARCH)
    ref, ref_s = jax_encoders.apply_encoder_caption(
        p, s, x, train=train, enc_image_size=2, arch=ARCH)
    out, out_s = encoders.apply_encoder_caption(
        params_from_jax(p), params_from_jax(s), torch.from_numpy(x),
        train=train, enc_image_size=2, arch=ARCH)
    assert out.shape == ref.shape == (4, 2, 2, 2048)
    rel_close(out, ref, TOL[train])
    tree_close(params_to_jax(out_s), jax.device_get(ref_s), TOL[train])


@pytest.mark.parametrize("train", [False, "calibrate"])
def test_tagger_matches_jax(images, train):
    _, x = images
    tcfg = TaggerConfig(semantic_size=8)
    p, s = jax_encoders.init_encoder_tagger(jax.random.key(2), tcfg,
                                            arch=ARCH)
    ref, _ = jax_encoders.apply_encoder_tagger(p, s, x, train=train,
                                               arch=ARCH)
    out, _ = encoders.apply_encoder_tagger(
        params_from_jax(p), params_from_jax(s), torch.from_numpy(x),
        train=train, arch=ARCH)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL[train])


def _count_passes(monkeypatch):
    """Counts the inference path's bn_act passes (resnet.bn_act calls)."""
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return bn_act(*args, **kwargs)

    monkeypatch.setattr(resnet, "bn_act", counted)
    return calls


@pytest.mark.parametrize("encoder", ["caption", "tagger"])
def test_inference_path_matches_jax_eval(images, encoder, monkeypatch):
    """Under inference_mode the eval pass takes the inference path
    (channels_last, one bn_act pass a convolution but the downsample one:
    1 + 3 x 16 for a ResNet-50) and still gives JAX's eval outputs."""
    _, x = images
    calls = _count_passes(monkeypatch)
    if encoder == "caption":
        p, s = jax_encoders.init_encoder_caption(jax.random.key(1),
                                                 arch=ARCH)
        ref, _ = jax_encoders.apply_encoder_caption(
            p, s, x, train=False, enc_image_size=2, arch=ARCH)
        with torch.inference_mode():
            out, out_s = encoders.apply_encoder_caption(
                params_from_jax(p), params_from_jax(s), torch.from_numpy(x),
                train=False, enc_image_size=2, arch=ARCH)
        rel_close(out, ref, TOL[False])
        tree_close(params_to_jax(out_s), jax.device_get(s))
    else:
        tcfg = TaggerConfig(semantic_size=8)
        p, s = jax_encoders.init_encoder_tagger(jax.random.key(2), tcfg,
                                                arch=ARCH)
        ref, _ = jax_encoders.apply_encoder_tagger(p, s, x, train=False,
                                                   arch=ARCH)
        with torch.inference_mode():
            out, _ = encoders.apply_encoder_tagger(
                params_from_jax(p), params_from_jax(s), torch.from_numpy(x),
                train=False, arch=ARCH)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=TOL[False])
    assert len(calls) == 1 + 3 * sum(resnet.BLOCKS[ARCH])


def _served_block(gen, first: bool):
    """layer2's first (downsampling) or second block of a ResNet-50, with
    BatchNorm parameters and statistics away from (1, 0) and (0, 1)."""
    p, s = resnet.init_resnet(gen, ARCH)
    bp, bs = ((p["layer2"]["first"], s["layer2"]["first"]) if first else
              (p["layer2"]["rest"][0], s["layer2"]["rest"][0]))
    for name in bs:
        C = bs[name]["mean"].shape[0]
        bp[name] = {"scale": 0.5 + torch.rand(C, generator=gen),
                    "bias": 0.1 * torch.randn(C, generator=gen)}
        bs[name] = {"mean": 0.1 * torch.randn(C, generator=gen),
                    "var": 0.5 + torch.rand(C, generator=gen)}
    return bp, bs


@pytest.mark.parametrize("first", [True, False],
                         ids=["downsample", "plain"])
def test_inference_block_equals_the_composition(first):
    """_infer_block (bn_act after each convolution, the shortcut in conv3's
    pass) against _bottleneck's _bn + relu + add with autograd on, float32:
    the same block within 1e-5 of the largest output."""
    gen = torch.Generator().manual_seed(7)
    bp, bs = _served_block(gen, first)
    cin = 256 if first else 512
    x = torch.randn((2, cin, 8, 8), generator=gen).contiguous(
        memory_format=torch.channels_last)
    stride = 2 if first else 1
    ref, _ = resnet._bottleneck(x, bp, bs, stride, False, None)
    with torch.no_grad():
        out = resnet._infer_block(x, bp, bs, stride)
    assert out.is_contiguous(memory_format=torch.channels_last)
    rel_close(out, ref, 1e-5)


def test_eval_with_autograd_keeps_the_composition(images, monkeypatch):
    """An eval pass with autograd on does not take the inference path: the
    BatchNorm scales and biases get gradients, and bn_act never runs."""
    _, x = images
    calls = _count_passes(monkeypatch)
    gen = torch.Generator().manual_seed(8)
    p, s = resnet.init_resnet(gen, ARCH)
    leaves = [p["bn1"]["scale"], p["bn1"]["bias"],
              p["layer4"]["rest"][-1]["bn3"]["scale"],
              p["layer4"]["rest"][-1]["bn3"]["bias"],
              p["layer3"]["first"]["downsample_bn"]["bias"]]
    for t in leaves:
        t.requires_grad_(True)
    feat, _ = resnet.apply_resnet(p, s, torch.from_numpy(x[:2]),
                                  train=False, arch=ARCH)
    feat.square().mean().backward()
    assert not calls
    for t in leaves:
        assert t.grad is not None and float(t.grad.abs().sum()) > 0


def test_calibrated_stats_make_eval_reproduce_calibrate_pass(images):
    """The port's own contract: eval with calibrated statistics gives the
    calibrate pass's features."""
    _, x = images
    gen = torch.Generator().manual_seed(3)
    p, s = resnet.init_resnet(gen, ARCH)
    xt = torch.from_numpy(x)
    cal, cal_s = resnet.apply_resnet(p, s, xt, train="calibrate", arch=ARCH)
    ev, _ = resnet.apply_resnet(p, cal_s, xt, train=False, arch=ARCH)
    rel_close(ev, cal, 1e-5)
    assert float(cal.abs().max()) < 1e3


def test_adaptive_pool_up_to_14_matches_pool_matrix():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8, 8, 5)).astype(np.float32)
    P = _pool_matrix(8, 14)
    ref = np.einsum("bhwc,oh,pw->bopc", x, P, P)
    out = adaptive_avg_pool2d(torch.from_numpy(x), (14, 14))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("tree", ["resnet", "decoder"])
def test_bridge_round_trip(tree):
    if tree == "resnet":
        p, _ = jax_encoders.init_encoder_caption(jax.random.key(5),
                                                 arch=ARCH)
    else:
        p = jax_decoders.init_decoder(
            jax.random.key(6), ModelConfig(vocab_size=30, embed_dim=8,
                                           attention_dim=8, decoder_dim=8,
                                           factored_dim=4, semantic_dim=6,
                                           encoder_dim=12))
    tp = params_from_jax(p)
    if tree == "resnet":
        conv = tp["resnet"]["layer2"]["rest"][1]["conv2"]
        ref = np.asarray(p["resnet"]["layer2"]["rest"]["conv2"][1])
        np.testing.assert_array_equal(conv.numpy(),
                                      ref.transpose(3, 2, 0, 1))
        assert len(tp["resnet"]["layer2"]["rest"]) == 3
    back = params_to_jax(tp)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b),
                 back, jax.device_get(p))
