"""ResNet-50/101/152 as plain functions on parameter dicts.

Counterpart of the JAX package's ``models/resnet.py``.  The public
:func:`apply_resnet` keeps the JAX layouts at its edges (NHWC images in,
NHWC features out); inside, the convolutions run NCHW through cuDNN on the
card.  The differences in the parameter tree, which ``models/jax_bridge.py``
converts:

* convolution kernels are OIHW (torch's layout), not HWIO;
* each stage is {"first": block with downsample, "rest": [blocks]}: a list
  of blocks where JAX stacks them for its ``lax.scan``.

BatchNorm has two of the JAX modes: ``train=False`` uses the running
statistics; ``"calibrate"`` normalises with the batch statistics and
returns them (biased) as the new statistics, so an eval pass afterwards
reproduces this pass exactly.  Batch statistics reduce in float32 whatever
the compute type.  The training mode (``train=True``, a momentum update of
the running statistics) comes with the training slice.  A randomly
initialised ResNet-152 needs calibrating before eval-mode features are
usable: with running statistics (0, 1) its activations grow block by block
to about 1e10.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
          "resnet152": (3, 8, 36, 3)}
WIDTHS = (64, 128, 256, 512)
EXPANSION = 4
BN_EPS = 1e-5


def _conv_init(gen, kh, kw, cin, cout, dtype, device):
    """Kaiming-normal fan_out (torchvision's conv init), OIHW."""
    std = (2.0 / (kh * kw * cout)) ** 0.5
    w = torch.randn((cout, cin, kh, kw), generator=gen) * std
    return w.to(device=device, dtype=dtype)


def _bn_init(c, dtype, device):
    kw = dict(dtype=dtype, device=device)
    return ({"scale": torch.ones(c, **kw), "bias": torch.zeros(c, **kw)},
            {"mean": torch.zeros(c, **kw), "var": torch.ones(c, **kw)})


def _block_init(gen, cin, width, cout, downsample: bool, dtype, device):
    bp: Dict[str, Any] = {
        "conv1": _conv_init(gen, 1, 1, cin, width, dtype, device),
        "conv2": _conv_init(gen, 3, 3, width, width, dtype, device),
        "conv3": _conv_init(gen, 1, 1, width, cout, dtype, device),
    }
    bs: Dict[str, Any] = {}
    bp["bn1"], bs["bn1"] = _bn_init(width, dtype, device)
    bp["bn2"], bs["bn2"] = _bn_init(width, dtype, device)
    bp["bn3"], bs["bn3"] = _bn_init(cout, dtype, device)
    if downsample:
        bp["downsample_conv"] = _conv_init(gen, 1, 1, cin, cout, dtype,
                                           device)
        bp["downsample_bn"], bs["downsample_bn"] = _bn_init(cout, dtype,
                                                            device)
    return bp, bs


def init_resnet(gen: torch.Generator, arch: str = "resnet152",
                dtype=torch.float32, device="cpu") -> Tuple[Dict, Dict]:
    """Returns (params, batch_stats)."""
    params: Dict[str, Any] = {
        "conv1": _conv_init(gen, 7, 7, 3, 64, dtype, device)}
    stats: Dict[str, Any] = {}
    params["bn1"], stats["bn1"] = _bn_init(64, dtype, device)
    cin = 64
    for stage, (n, width) in enumerate(zip(BLOCKS[arch], WIDTHS), start=1):
        cout = width * EXPANSION
        blocks = [_block_init(gen, cin if b == 0 else cout, width, cout,
                              downsample=b == 0, dtype=dtype, device=device)
                  for b in range(n)]
        params[f"layer{stage}"] = {"first": blocks[0][0],
                                   "rest": [p for p, _ in blocks[1:]]}
        stats[f"layer{stage}"] = {"first": blocks[0][1],
                                  "rest": [s for _, s in blocks[1:]]}
        cin = cout
    return params, stats


def _conv(x, w, stride: int, padding: int):
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding)


def _bn(x, p, s, train):
    """NCHW BatchNorm; returns (y, new_stats).  train: False (running
    statistics) or "calibrate" (see the module docstring)."""
    if train == "calibrate":
        xf = x.to(torch.float32)
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp_min(xf.var(dim=(0, 2, 3), unbiased=False), 0.0)
        new_s = {"mean": mean, "var": var}
    elif train is False:
        mean, var = s["mean"], s["var"]
        new_s = s
    else:
        raise ValueError(f"BatchNorm mode {train!r}: False or 'calibrate'")
    inv = torch.rsqrt(var + BN_EPS)

    def ch(v):
        return v.reshape(1, -1, 1, 1)

    y = (x - ch(mean)) * ch(inv * p["scale"]) + ch(p["bias"])
    return y.to(x.dtype), new_s


def _bottleneck(x, bp, bs, stride: int, train):
    new_s: Dict[str, Any] = {}
    out, new_s["bn1"] = _bn(_conv(x, bp["conv1"], 1, 0), bp["bn1"],
                            bs["bn1"], train)
    out = torch.relu(out)
    out, new_s["bn2"] = _bn(_conv(out, bp["conv2"], stride, 1), bp["bn2"],
                            bs["bn2"], train)
    out = torch.relu(out)
    out, new_s["bn3"] = _bn(_conv(out, bp["conv3"], 1, 0), bp["bn3"],
                            bs["bn3"], train)
    if "downsample_conv" in bp:
        identity, new_s["downsample_bn"] = _bn(
            _conv(x, bp["downsample_conv"], stride, 0), bp["downsample_bn"],
            bs["downsample_bn"], train)
    else:
        identity = x
    return torch.relu(out + identity), new_s


def apply_resnet(params, stats, x, *, train=False, arch: str = "resnet152"):
    """x: (B, H, W, 3) NHWC float -> features (B, H/32, W/32, 2048) NHWC.

    Returns (features, new_batch_stats).  The classifier head is omitted,
    as the reference strips it."""
    if len(params["layer3"]["rest"]) != BLOCKS[arch][2] - 1:
        raise ValueError(f"parameter tree does not match {arch}")
    new_stats: Dict[str, Any] = {}
    y = _conv(x.permute(0, 3, 1, 2), params["conv1"], 2, 3)
    y, new_stats["bn1"] = _bn(y, params["bn1"], stats["bn1"], train)
    y = F.max_pool2d(torch.relu(y), 3, stride=2, padding=1)
    for stage in range(1, len(BLOCKS[arch]) + 1):
        sp, ss = params[f"layer{stage}"], stats[f"layer{stage}"]
        y, first_s = _bottleneck(y, sp["first"], ss["first"],
                                 1 if stage == 1 else 2, train)
        rest_s = []
        for bp, bs in zip(sp["rest"], ss["rest"]):
            y, s = _bottleneck(y, bp, bs, 1, train)
            rest_s.append(s)
        new_stats[f"layer{stage}"] = {"first": first_s, "rest": rest_s}
    return y.permute(0, 2, 3, 1), new_stats


# ---------------------------------------------------------------------------
# torchvision state_dict interop
# ---------------------------------------------------------------------------

def load_torch_resnet(state_dict, arch: str = "resnet152",
                      dtype=torch.float32, device=None) -> Tuple[Dict, Dict]:
    """A torchvision resnet state_dict (tensors or arrays) -> (params,
    batch_stats).  The tree keeps torchvision's OIHW kernels, so this is a
    renaming into {"first", "rest": [...]} stages; values are cast to
    ``dtype`` and moved to ``device`` (None: where they are)."""
    def arr(name):
        v = state_dict[name]
        v = v.detach() if torch.is_tensor(v) else torch.tensor(v)
        return v.to(device=device, dtype=dtype)

    def bn(name):
        return ({"scale": arr(name + ".weight"), "bias": arr(name + ".bias")},
                {"mean": arr(name + ".running_mean"),
                 "var": arr(name + ".running_var")})

    def block(pre, downsample):
        bp: Dict[str, Any] = {}
        bs: Dict[str, Any] = {}
        for i in (1, 2, 3):
            bp[f"conv{i}"] = arr(f"{pre}.conv{i}.weight")
            bp[f"bn{i}"], bs[f"bn{i}"] = bn(f"{pre}.bn{i}")
        if downsample:
            bp["downsample_conv"] = arr(f"{pre}.downsample.0.weight")
            bp["downsample_bn"], bs["downsample_bn"] = bn(
                f"{pre}.downsample.1")
        return bp, bs

    params: Dict[str, Any] = {"conv1": arr("conv1.weight")}
    stats: Dict[str, Any] = {}
    params["bn1"], stats["bn1"] = bn("bn1")
    for stage, n in enumerate(BLOCKS[arch], start=1):
        first_p, first_s = block(
            f"layer{stage}.0",
            downsample=f"layer{stage}.0.downsample.0.weight" in state_dict)
        rest = [block(f"layer{stage}.{b}", False) for b in range(1, n)]
        params[f"layer{stage}"] = {"first": first_p,
                                   "rest": [p for p, _ in rest]}
        stats[f"layer{stage}"] = {"first": first_s,
                                  "rest": [s for _, s in rest]}
    return params, stats
