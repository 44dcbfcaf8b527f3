"""Image encoders: the caption feature encoder and the 1000-concept tagger.

Counterpart of the JAX package's ``models/encoders.py`` and of
``prep_images`` in its ``train/steps.py``:

* the caption encoder is a ResNet minus fc and avgpool, then an adaptive
  average pool to (14, 14): (B, 14, 14, 2048), NHWC;
* the tagger is a ResNet, a global average pool, Linear(2048, tags) and a
  sigmoid (its dropout only acts in training, which is not ported).
"""

from __future__ import annotations

import torch

from ..core.config import TaggerConfig
from ..ops.adaptive_pool import adaptive_avg_pool2d
from . import resnet
from .layers import init_linear, linear

# ImageNet normalisation used by every reference dataloader.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def init_encoder_caption(gen: torch.Generator, arch: str = "resnet152",
                         dtype=torch.float32, device="cpu"):
    params, stats = resnet.init_resnet(gen, arch, dtype, device)
    return {"resnet": params}, {"resnet": stats}


def apply_encoder_caption(params, stats, images, *, train=False,
                          enc_image_size: int = 14,
                          arch: str = "resnet152"):
    """images (B, H, W, 3) normalized -> (B, S, S, 2048), new_stats."""
    feat, new_stats = resnet.apply_resnet(params["resnet"], stats["resnet"],
                                          images, train=train, arch=arch)
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
                         arch: str = "resnet152"):
    """images (B, H, W, 3) -> tag probabilities (B, semantic_size), stats."""
    feat, new_stats = resnet.apply_resnet(params["resnet"], stats["resnet"],
                                          images, train=train, arch=arch)
    pooled = feat.mean(dim=(1, 2))                      # global avg pool
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


def prep_images(images_u8_chw: torch.Tensor) -> torch.Tensor:
    """uint8 (B, 3, S, S) artifact layout -> normalized NHWC float32."""
    return normalize_images(images_u8_chw.permute(0, 2, 3, 1))
