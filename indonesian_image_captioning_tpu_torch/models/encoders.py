"""Image encoders: the caption feature encoder and the 1000-concept tagger.

Counterpart of the JAX package's ``models/encoders.py`` and of
``prep_images`` in its ``train/steps.py``:

* the caption encoder is a ResNet minus fc and avgpool, then an adaptive
  average pool to (14, 14): (B, 14, 14, 2048), NHWC;
* the tagger is a ResNet, a global average pool, dropout (only when
  training, and only with a generator), Linear(2048, tags) and a sigmoid.

Which parameters train is the trainers' choice (JAX has no
``requires_grad``): :func:`caption_encoder_trainable_mask` marks the
caption encoder's stages 2-4, as the reference's ``fine_tune`` does.
"""

from __future__ import annotations

import torch

from ..core.config import TaggerConfig
from ..ops.adaptive_pool import adaptive_avg_pool2d
from . import resnet
from .layers import dropout, init_linear, linear

# ImageNet normalisation used by every reference dataloader.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def init_encoder_caption(gen: torch.Generator, arch: str = "resnet152",
                         dtype=torch.float32, device="cpu"):
    params, stats = resnet.init_resnet(gen, arch, dtype, device)
    return {"resnet": params}, {"resnet": stats}


def apply_encoder_caption(params, stats, images, *, train=False,
                          enc_image_size: int = 14,
                          arch: str = "resnet152", remat=False,
                          bn_group=None):
    """images (B, H, W, 3) normalized -> (B, S, S, 2048), new_stats.
    remat, bn_group: see ``resnet.apply_resnet``."""
    feat, new_stats = resnet.apply_resnet(params["resnet"], stats["resnet"],
                                          images, train=train, arch=arch,
                                          remat=remat, bn_group=bn_group)
    out = adaptive_avg_pool2d(feat, (enc_image_size, enc_image_size))
    return out, {"resnet": new_stats}


def init_encoder_tagger(gen: torch.Generator,
                        cfg: TaggerConfig = TaggerConfig(),
                        arch: str = "resnet152", dtype=torch.float32,
                        device="cpu"):
    rparams, rstats = resnet.init_resnet(gen, arch, dtype, device)
    params = {
        "resnet": rparams,
        "linear": init_linear(gen, cfg.feature_dim, cfg.semantic_size, dtype,
                              device),
    }
    return params, {"resnet": rstats}


def apply_encoder_tagger(params, stats, images, *, train=False,
                         dropout_gen=None, dropout_rate: float = 0.15,
                         arch: str = "resnet152", remat=False,
                         bn_group=None):
    """images (B, H, W, 3) -> tag probabilities (B, semantic_size), stats.

    When training with a dropout generator (a torch.Generator), dropout
    acts on the pooled features; its numbers differ from JAX's.  remat,
    bn_group: see ``resnet.apply_resnet``."""
    feat, new_stats = resnet.apply_resnet(params["resnet"], stats["resnet"],
                                          images, train=train, arch=arch,
                                          remat=remat, bn_group=bn_group)
    pooled = feat.mean(dim=(1, 2))                      # global avg pool
    if train and dropout_gen is not None:
        pooled = dropout(dropout_gen, pooled, dropout_rate)
    probs = torch.sigmoid(linear(params["linear"], pooled.to(
        params["linear"]["w"].dtype)))
    return probs, {"resnet": new_stats}


def normalize_images(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> normalized float32 (/255, then ImageNet
    mean and std)."""
    x = images_u8.to(torch.float32) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def caption_encoder_trainable_mask(params):
    """A tree of booleans over the caption encoder's parameters: True for
    the fine-tuned ResNet stages layer2-layer4 (the reference's
    ``EncoderCaption.fine_tune``)."""
    return {"resnet": resnet_trainable_mask(params["resnet"])}


def resnet_trainable_mask(tree):
    """True under layer2-layer4 of a ResNet tree, False elsewhere."""
    def fill(t, value):
        if isinstance(t, dict):
            return {k: fill(v, value) for k, v in t.items()}
        if isinstance(t, list):
            return [fill(v, value) for v in t]
        return value

    return {k: fill(v, k in ("layer2", "layer3", "layer4"))
            for k, v in tree.items()}


def prep_images(images_u8_chw: torch.Tensor) -> torch.Tensor:
    """uint8 (B, 3, S, S) artifact layout -> normalized NHWC float32."""
    return normalize_images(images_u8_chw.permute(0, 2, 3, 1))
