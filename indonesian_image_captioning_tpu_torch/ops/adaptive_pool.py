"""Adaptive average pooling, NHWC in and out.

Counterpart of the JAX package's ``ops/adaptive_pool.py``, which writes
torch's ``AdaptiveAvgPool2d`` as two matmuls with averaging matrices.  Here
it is torch's own operator.  Input bin i of n maps to output
``[floor(i*n/o), ceil((i+1)*n/o))``; at 256-pixel images the 8x8 ResNet map
is pooled UP to 14x14 with overlapping windows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def adaptive_avg_pool2d(x: torch.Tensor, out_hw) -> torch.Tensor:
    """x: (B, H, W, C) -> (B, out_h, out_w, C), torch-exact."""
    y = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), tuple(out_hw))
    return y.permute(0, 2, 3, 1)
