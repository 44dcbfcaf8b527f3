"""The ResNet's eval-mode pass after each convolution (``csrc/bn_act.cu``).

``relu(bn(x) + shortcut)`` over a convolution's channels_last output, with
BatchNorm on its running statistics, ``(x - mean) * (rsqrt(var + eps) *
scale) + bias``, and the shortcut nothing, the block's input, or the
downsample convolution's output under its own BatchNorm.  It rounds where
``models/resnet.py``'s composition of ``_bn``, ``relu`` and the add rounds
(each operation in the promoted type of the activations and the
statistics), as the JAX package's eval BatchNorm does, so a bf16 pass gives
the composition's values.  ``models/resnet.py``'s inference path runs it
once after each convolution but the downsample one: 151 launches a
ResNet-152.

Replaces no kernel of the JAX package, where XLA fuses the eval-mode
BatchNorm, the residual add and the ReLU itself.  What bounds it (bytes)
and what its design does about that is noted at the top of the source.

:func:`bn_act` launches the kernel for CUDA tensors and raises where it
cannot; only tensors on the CPU take :func:`bn_act_plain`.
"""

from __future__ import annotations

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_STATS = ("mean", "var")
_AFFINE = ("scale", "bias")


def _vectors(p, s):
    return [s[k] for k in _STATS] + [p[k] for k in _AFFINE]


def _affine(x, p, s, eps):
    """bn(x) as ``models/resnet.py _bn`` computes it in eval mode."""
    mean, var, scale, bias = (v.reshape(1, -1, 1, 1) for v in _vectors(p, s))
    return ((x - mean) * (torch.rsqrt(var + eps) * scale) + bias).to(x.dtype)


def bn_act_plain(x, p, s, *, eps: float, residual=None, down=None):
    """The same function in plain PyTorch, returning a new tensor: x (B, C,
    H, W); p {"scale", "bias"}, s {"mean", "var"} (C,) each; residual a
    tensor shaped as x, or down (d, p_d, s_d), d shaped as x."""
    y = _affine(x, p, s, eps)
    if residual is not None:
        y = y + residual
    if down is not None:
        d, dp, ds = down
        y = y + _affine(d, dp, ds, eps)
    return torch.relu(y)


def _check(x, p, s, residual, down):
    """Raises on what the kernel does not take; returns the activations
    (x, then r or d) and the BatchNorm vectors (x's, then d's)."""
    if residual is not None and down is not None:
        raise ValueError("bn_act takes a residual or a downsample, not both")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    C = x.shape[1]
    if C % 8 != 0:
        raise ValueError(f"C = {C}: the kernel moves 8 channels a vector")
    acts, vecs = [x], _vectors(p, s)
    if residual is not None:
        acts.append(residual)
    if down is not None:
        acts.append(down[0])
        vecs += _vectors(down[1], down[2])
    for t in acts:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{tuple(t.shape)} {t.dtype} on {t.device} "
                             f"beside x {tuple(x.shape)} {x.dtype} on "
                             f"{x.device}")
        if not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError("bn_act takes channels_last tensors")
    for v in vecs:
        if v.shape != (C,) or v.dtype != vecs[0].dtype or \
                v.device != x.device or not v.is_contiguous():
            raise ValueError(f"a BatchNorm vector {tuple(v.shape)} {v.dtype} "
                             f"on {v.device}: each must be ({C},), "
                             f"contiguous, of one type, on {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in acts + vecs):
        raise RuntimeError("bn_act has no backward: call it without "
                           "autograd")
    return acts, vecs


def bn_act(x, p, s, *, eps: float, residual=None, down=None):
    """``relu(bn(x) [+ residual | + bn_d(d)])`` written over x, which is
    returned; shapes as :func:`bn_act_plain`, every activation
    channels_last.  The kernel on CUDA tensors (float32 or bfloat16
    activations and statistics, counted in ``bn_act.launches``),
    :func:`bn_act_plain` copied into x on CPU tensors."""
    acts, vecs = _check(x, p, s, residual, down)
    if x.device.type == "cpu":
        return x.copy_(bn_act_plain(x, p, s, eps=eps, residual=residual,
                                    down=down))
    if x.device.type != "cuda":
        raise RuntimeError(f"bn_act: no kernel for {x.device}")
    if x.dtype not in _DTYPES or vecs[0].dtype not in _DTYPES:
        raise TypeError(f"bn_act takes float32 or bfloat16, got {x.dtype} "
                        f"activations and {vecs[0].dtype} statistics")
    if any(t.data_ptr() % 16 for t in acts):
        raise ValueError("bn_act takes 16-byte aligned activations")
    mode = 2 if down is not None else 1 if residual is not None else 0
    B, C, H, W = x.shape
    rc = _build.load("bn_act").iic_bn_act(
        _DTYPES[x.dtype], _DTYPES[vecs[0].dtype], mode, x.data_ptr(),
        x.data_ptr(), acts[1].data_ptr() if mode else None,
        *[v.data_ptr() for v in vecs], *[None] * (8 - len(vecs)),
        B * H * W, C, eps, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "bn_act")
    bn_act.launches += 1
    return x


bn_act.launches = 0
