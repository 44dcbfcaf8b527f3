"""ResNet-50/101/152 as plain functions on parameter dicts.

Counterpart of the JAX package's ``models/resnet.py``.  The public
:func:`apply_resnet` keeps the JAX layouts at its edges (NHWC images in,
NHWC features out); inside, the tensors are (B, C, H, W) for torch's
operators, stored NCHW, or NHWC (channels_last) on the inference path
below.  The differences in the parameter tree, which
``models/jax_bridge.py`` converts:

* convolution kernels are OIHW (torch's layout), not HWIO;
* each stage is {"first": block with downsample, "rest": [blocks]}: a list
  of blocks where JAX stacks them for its ``lax.scan``.

BatchNorm has the three JAX modes: ``train=False`` uses the running
statistics; ``train=True`` normalises with the batch statistics and moves
the running statistics toward them by torch's momentum 0.1, with the
unbiased variance; ``"calibrate"`` normalises with the batch statistics and
returns them (biased) as the new statistics, so an eval pass afterwards
reproduces this pass exactly.  Batch statistics reduce in float32 whatever
the compute type, and the new statistics are state, computed without
gradient.  A randomly initialised ResNet-152 needs calibrating before
eval-mode features are usable: with running statistics (0, 1) its
activations grow block by block to about 1e10.

``remat`` rematerialises the bottlenecks under autograd, as JAX's
``jax.checkpoint`` does (``torch.utils.checkpoint``, non-reentrant):
``True`` / ``"blocks"`` keeps each block's input and recomputes the block
in the backward; ``"convs"`` also keeps the convolution outputs and
recomputes only BatchNorm and ReLU.  Both give the gradients of no
rematerialisation; the new statistics are the forward's.

``bn_group``, a process group, makes the train-mode statistics span the
global batch of a data-parallel group (synchronised BatchNorm, the
steps of ``train/steps.py`` under a mesh), as JAX's partitioned step
reduces them over the whole batch; None keeps them to the local rows.

An eval pass without autograd (``train=False`` under ``torch.no_grad()``
or ``torch.inference_mode()``, as the serving engine runs it) takes the
inference path instead, :func:`_infer`: every activation channels_last
(NHWC storage), so cuDNN runs its NHWC kernels with no layout transposes
around them (the serving engine stores the convolution kernels
channels_last once, as its state goes to the device; an NCHW kernel is
converted inside each convolution), and one pass after each convolution, ``ops/bn_act.py`` (a CUDA kernel on the card), for its
BatchNorm, the shortcut and the ReLU, written over the convolution's
output and rounded where the composition rounds, so the features are the
composition's.  The downsample convolution's BatchNorm rides in conv3's
pass.  Training, calibration, synchronised BatchNorm, remat and an eval
pass with autograd on run the composition of :func:`_bn`, ``relu`` and
the add.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from ..ops.bn_act import bn_act

BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
          "resnet152": (3, 8, 36, 3)}
WIDTHS = (64, 128, 256, 512)
EXPANSION = 4
BN_EPS = 1e-5
BN_MOMENTUM = 0.1
REMAT_MODES = (False, True, "blocks", "convs")


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


def _ch(v):
    return v.reshape(1, -1, 1, 1)


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch of a process group, in
    float32: (x, scale, bias) -> (y, mean, biased variance).

    Two all_reduces a pass, each taken after the one before it: the sum,
    then the centred squares in the forward; the cotangent's sum, then
    its centred product with the normalised input in the backward:
    dx = scale inv (g - mean(g) - xhat mean((g - mean(g)) xhat)).  Each
    rank's rows sit away from the global mean, so a rank's sums of
    uncentred terms are large and cancel only across the ranks; centring
    first keeps the result as accurate as one device's.  The scale's
    gradient is each rank's share of sum((g - mean(g)) xhat) (the same
    total: xhat sums to zero), the bias's its share of sum(g); the step
    sums both over the ranks with the other gradients."""

    @staticmethod
    def forward(ctx, x, scale, bias, group):
        xf = x.to(torch.float32)
        n = xf.shape[0] * xf.shape[2] * xf.shape[3] * dist.get_world_size(
            group)
        total = xf.sum(dim=(0, 2, 3))
        dist.all_reduce(total, group=group)
        mean = total / n
        centred = xf - _ch(mean)
        sq = (centred * centred).sum(dim=(0, 2, 3))
        dist.all_reduce(sq, group=group)
        var = torch.clamp_min(sq / n, 0.0)
        inv = torch.rsqrt(var + BN_EPS)
        xhat = centred * _ch(inv)
        y = xhat * _ch(scale.to(torch.float32)) + _ch(bias.to(torch.float32))
        ctx.save_for_backward(xhat, inv, scale)
        ctx.group, ctx.n, ctx.x_dtype = group, n, x.dtype
        ctx.bias_dtype = bias.dtype
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        xhat, inv, scale = ctx.saved_tensors
        gy = gy.to(torch.float32)
        gsum = gy.sum(dim=(0, 2, 3))
        gmean = gsum.clone()
        dist.all_reduce(gmean, group=ctx.group)
        gc = gy - _ch(gmean / ctx.n)
        dscale = (gc * xhat).sum(dim=(0, 2, 3))
        dx = None
        if ctx.needs_input_grad[0]:
            m2 = dscale.clone()
            dist.all_reduce(m2, group=ctx.group)
            dx = ((gc - xhat * _ch(m2 / ctx.n))
                  * _ch(scale.to(torch.float32) * inv)).to(ctx.x_dtype)
        return dx, dscale.to(scale.dtype), gsum.to(ctx.bias_dtype), None


def _bn(x, p, s, train, group=None):
    """NCHW BatchNorm; returns (y, new_stats).  train: False, True or
    "calibrate" (see the module docstring); group: the process group
    whose global batch the train-mode statistics span, each rank holding
    an equal share of the rows (:class:`_SyncBatchNorm`), or None."""
    y = None
    if train:
        if group is not None:
            y, m, v = _SyncBatchNorm.apply(x, p["scale"], p["bias"], group)
            n = (x.shape[0] * x.shape[2] * x.shape[3]
                 * dist.get_world_size(group))
        else:
            # the batch statistics reduce in float32; the clamp keeps a
            # cancelled variance from going negative
            xf = x.to(torch.float32)
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp_min(xf.var(dim=(0, 2, 3), unbiased=False), 0.0)
            n = x.shape[0] * x.shape[2] * x.shape[3]
            m, v = mean.detach(), var.detach()
        if train == "calibrate":
            new_s = {"mean": m, "var": v}
        elif train is True:
            unbiased = v * n / max(n - 1, 1)
            new_s = {
                "mean": (1 - BN_MOMENTUM) * s["mean"] + BN_MOMENTUM * m,
                "var": (1 - BN_MOMENTUM) * s["var"] + BN_MOMENTUM * unbiased,
            }
        else:
            raise ValueError(f"BatchNorm mode {train!r}: False, True or "
                             "'calibrate'")
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    if y is None:
        inv = torch.rsqrt(var + BN_EPS)
        y = (x - _ch(mean)) * _ch(inv * p["scale"]) + _ch(p["bias"])
    return y.to(x.dtype), new_s


def _bottleneck(x, bp, bs, stride: int, train, group):
    new_s: Dict[str, Any] = {}
    out, new_s["bn1"] = _bn(_conv(x, bp["conv1"], 1, 0), bp["bn1"],
                            bs["bn1"], train, group)
    out = torch.relu(out)
    out, new_s["bn2"] = _bn(_conv(out, bp["conv2"], stride, 1), bp["bn2"],
                            bs["bn2"], train, group)
    out = torch.relu(out)
    out, new_s["bn3"] = _bn(_conv(out, bp["conv3"], 1, 0), bp["bn3"],
                            bs["bn3"], train, group)
    if "downsample_conv" in bp:
        identity, new_s["downsample_bn"] = _bn(
            _conv(x, bp["downsample_conv"], stride, 0), bp["downsample_bn"],
            bs["downsample_bn"], train, group)
    else:
        identity = x
    return torch.relu(out + identity), new_s


def _save_convs():
    """Selective checkpointing that keeps the convolution outputs and
    recomputes the rest (remat="convs")."""
    def policy(ctx, op, *args, **kwargs):
        if op is torch.ops.aten.convolution.default:
            return ckpt.CheckpointPolicy.MUST_SAVE
        return ckpt.CheckpointPolicy.PREFER_RECOMPUTE

    return ckpt.create_selective_checkpoint_contexts(policy)


def _block_fn(remat):
    """The bottleneck, rematerialised under autograd per ``remat``."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat {remat!r}: one of {REMAT_MODES}")
    if not remat:
        return _bottleneck
    kw = {"context_fn": _save_convs} if remat == "convs" else {}

    def block(x, bp, bs, stride, train, group):
        return ckpt.checkpoint(_bottleneck, x, bp, bs, stride, train, group,
                               use_reentrant=False, **kw)

    return block


def _infer_block(x, bp, bs, stride: int):
    """The bottleneck of the inference path on a channels_last x: each
    convolution's output normalised in place by one ``bn_act`` pass, conv3's
    with the shortcut (x, or the downsample convolution's raw output and its
    BatchNorm) and the ReLU."""
    out = bn_act(_conv(x, bp["conv1"], 1, 0), bp["bn1"], bs["bn1"],
                 eps=BN_EPS)
    out = bn_act(_conv(out, bp["conv2"], stride, 1), bp["bn2"],
                 bs["bn2"], eps=BN_EPS)
    out = _conv(out, bp["conv3"], 1, 0)
    if "downsample_conv" in bp:
        down = (_conv(x, bp["downsample_conv"], stride, 0),
                bp["downsample_bn"], bs["downsample_bn"])
        return bn_act(out, bp["bn3"], bs["bn3"], eps=BN_EPS, down=down)
    return bn_act(out, bp["bn3"], bs["bn3"], eps=BN_EPS, residual=x)


def _infer(params, stats, x, arch: str):
    """The eval pass without autograd (module docstring): NHWC x -> NHWC
    features, channels_last throughout."""
    y = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    y = bn_act(_conv(y, params["conv1"], 2, 3), params["bn1"],
               stats["bn1"], eps=BN_EPS)
    y = F.max_pool2d(y, 3, stride=2, padding=1)
    for stage in range(1, len(BLOCKS[arch]) + 1):
        sp, ss = params[f"layer{stage}"], stats[f"layer{stage}"]
        y = _infer_block(y, sp["first"], ss["first"], 1 if stage == 1 else 2)
        for bp, bs in zip(sp["rest"], ss["rest"]):
            y = _infer_block(y, bp, bs, 1)
    return y.permute(0, 2, 3, 1)


def apply_resnet(params, stats, x, *, train=False, arch: str = "resnet152",
                 remat=False, bn_group=None):
    """x: (B, H, W, 3) NHWC float -> features (B, H/32, W/32, 2048) NHWC.

    Returns (features, new_batch_stats).  The classifier head is omitted,
    as the reference strips it.  remat: False, True / "blocks" or "convs";
    bn_group: the data-parallel group of synchronised BatchNorm, or None
    (see the module docstring).  An eval pass without autograd takes the
    inference path and returns ``stats`` as they came."""
    if len(params["layer3"]["rest"]) != BLOCKS[arch][2] - 1:
        raise ValueError(f"parameter tree does not match {arch}")
    if train is False and not torch.is_grad_enabled():
        return _infer(params, stats, x, arch), stats
    block = _block_fn(remat)
    new_stats: Dict[str, Any] = {}
    y = _conv(x.permute(0, 3, 1, 2), params["conv1"], 2, 3)
    y, new_stats["bn1"] = _bn(y, params["bn1"], stats["bn1"], train,
                              bn_group)
    y = F.max_pool2d(torch.relu(y), 3, stride=2, padding=1)
    for stage in range(1, len(BLOCKS[arch]) + 1):
        sp, ss = params[f"layer{stage}"], stats[f"layer{stage}"]
        y, first_s = block(y, sp["first"], ss["first"],
                           1 if stage == 1 else 2, train, bn_group)
        rest_s = []
        for bp, bs in zip(sp["rest"], ss["rest"]):
            y, s = block(y, bp, bs, 1, train, bn_group)
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
