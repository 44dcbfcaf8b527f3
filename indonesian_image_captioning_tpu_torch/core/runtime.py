"""Device selection and float32 precision for the port.

Counterpart of the JAX package's ``core/runtime.py`` (which sets up XLA's
compilation cache).  Here the process-level concerns are which device runs
the model and that float32 stays float32: cuDNN runs float32 convolutions
in TF32 by default, which keeps about three decimal digits.
"""

from __future__ import annotations

import torch


def setup_precision() -> None:
    """Turn TF32 off for float32 matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def get_device(name: str = "cuda") -> torch.device:
    """Resolve a device name and set float32 precision for it.

    The port's entry points run on the card unless the caller asks for the
    CPU by name: "cuda" (or "cuda:N", or "auto", its alias) raises when no
    CUDA device exists, and never falls back to the CPU.  "cpu" is the CPU.
    """
    if name == "auto":
        name = "cuda"
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not "
                           "available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    setup_precision()
    return device
