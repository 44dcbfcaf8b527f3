"""The plain reference of the image encoders: ResNet-152 (He et al., 2016)
as the reference repository runs it, float32, TF32 off, NCHW.

The caption encoder is the ResNet without its pool and classifier, then
an adaptive average pool to 14 x 14; the tagger is the ResNet, a global
average pool, a linear layer to the tags and a sigmoid.  Images are
normalised by ImageNet's mean and deviation.  BatchNorm runs with given
statistics, or (:func:`calibrate`) with the batch's own, which it returns:
a randomly initialised ResNet needs statistics of its own activations.

It reads the benchmark's parameter trees (``portbench/weights.py``
``make_resnet``: the port's layout, OIHW kernels, stages of a first
block and a list of the rest) and imports nothing of the program.
``conv`` is the one convolution every layer goes through: exact by
default, or rounded to float8 (the control).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .decoder import fp8

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
EPS = 1e-5


def exact_conv(x, w, stride, padding):
    return F.conv2d(x, w, stride=stride, padding=padding)


def fp8_conv(x, w, stride, padding):
    return F.conv2d(fp8(x), fp8(w), stride=stride, padding=padding)


def normalise(images_u8: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) uint8 -> normalised float32, NCHW."""
    x = images_u8.float() / 255.0
    mean = torch.tensor(MEAN, device=x.device).reshape(1, 3, 1, 1)
    std = torch.tensor(STD, device=x.device).reshape(1, 3, 1, 1)
    return (x - mean) / std


class ResNet:
    def __init__(self, params, stats=None, conv=exact_conv):
        self.p, self.s, self.conv = params, stats, conv
        self.new = None

    def bn(self, x, p, s):
        """BatchNorm with the given statistics, or, calibrating, with the
        batch's (biased variance), recorded in self.new."""
        if self.new is not None:
            mean, var = x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3),
                                                    unbiased=False)
            self.new.append({"mean": mean, "var": var})
        else:
            mean, var = s["mean"], s["var"]
        inv = torch.rsqrt(var + EPS) * p["scale"]
        return (x - mean[None, :, None, None]) * inv[None, :, None, None] \
            + p["bias"][None, :, None, None]

    def block(self, x, p, s, stride):
        s = s or {}
        y = torch.relu(self.bn(self.conv(x, p["conv1"], 1, 0), p["bn1"],
                               s.get("bn1")))
        y = torch.relu(self.bn(self.conv(y, p["conv2"], stride, 1),
                               p["bn2"], s.get("bn2")))
        y = self.bn(self.conv(y, p["conv3"], 1, 0), p["bn3"], s.get("bn3"))
        if "downsample_conv" in p:
            x = self.bn(self.conv(x, p["downsample_conv"], stride, 0),
                        p["downsample_bn"], s.get("downsample_bn"))
        return torch.relu(y + x)

    def features(self, x):
        """x (B, 3, H, W) normalised -> (B, 2048, H/32, W/32)."""
        p, s = self.p, self.s or {}
        y = torch.relu(self.bn(self.conv(x, p["conv1"], 2, 3), p["bn1"],
                               s.get("bn1")))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        for k in range(1, 5):
            sp, ss = p[f"layer{k}"], s.get(f"layer{k}", {})
            y = self.block(y, sp["first"], ss.get("first"),
                           1 if k == 1 else 2)
            for i, bp in enumerate(sp["rest"]):
                y = self.block(y, bp, ss["rest"][i] if ss else None, 1)
        return y

    def calibrate(self, x):
        """The statistics of one pass over x with the batch's own, in the
        stats tree's layout."""
        self.new = []
        self.features(x)
        new, self.new = self.new, None
        return _as_tree(self.p, iter(new))


def _as_tree(params, it):
    """The recorded statistics in the order features() visits the
    BatchNorms, placed where the parameter tree has them."""
    out = {"bn1": next(it)}
    for k in range(1, 5):
        sp = params[f"layer{k}"]
        out[f"layer{k}"] = {"first": _block_stats(sp["first"], it),
                            "rest": [_block_stats(bp, it)
                                     for bp in sp["rest"]]}
    return out


def _block_stats(bp, it):
    st = {"bn1": next(it), "bn2": next(it), "bn3": next(it)}
    if "downsample_conv" in bp:
        st["downsample_bn"] = next(it)
    return st


def caption_features(net: ResNet, x, size: int = 14):
    """(B, 3, H, W) -> (B, size * size, 2048) pixels for the decoder."""
    y = F.adaptive_avg_pool2d(net.features(x), (size, size))
    return y.flatten(2).transpose(1, 2)


def tag_probabilities(net: ResNet, linear, x, mm=None):
    """(B, 3, H, W) -> (B, tags): sigmoid of the linear layer of the
    globally pooled features."""
    pooled = net.features(x).mean(dim=(2, 3))
    w = linear["w"]
    out = (mm(pooled, w) if mm is not None else pooled @ w) + linear["b"]
    return torch.sigmoid(out)
