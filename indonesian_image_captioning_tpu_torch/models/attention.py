"""Additive (Bahdanau-style) soft attention over image positions.

Counterpart of the JAX package's ``models/attention.py``:

    att   = full_att(relu(enc_att(enc) + dec_att(h)[:, None, :]))
    alpha = softmax(att over positions)
    awe   = sum_p alpha_p * enc_p

``enc_att(enc)`` is loop-invariant across decode steps, so it is computed
once by :func:`precompute` (a plain matmul).  :func:`attend` is the plain
version of the attention kernel (``ops/attention_cuda.py``).
"""

from __future__ import annotations

import torch

from .layers import init_linear, linear


def init_attention(gen: torch.Generator, encoder_dim: int, decoder_dim: int,
                   attention_dim: int, dtype=torch.float32, device="cpu"):
    return {
        "encoder_att": init_linear(gen, encoder_dim, attention_dim, dtype,
                                   device),
        "decoder_att": init_linear(gen, decoder_dim, attention_dim, dtype,
                                   device),
        "full_att": init_linear(gen, attention_dim, 1, dtype, device),
    }


def precompute(params, enc: torch.Tensor) -> torch.Tensor:
    """Loop-invariant encoder projection: (..., P, E) -> (..., P, A)."""
    return linear(params["encoder_att"], enc)


def attend(params, enc, enc_att, h):
    """One attention step.

    enc: (..., P, E);  enc_att: (..., P, A);  h: (..., D).  Leading dims
    broadcast, so (B, 1, P, ·) encodings serve (B, K, D) beam states.
    Returns (awe (..., E), alpha (..., P)).
    """
    dec = linear(params["decoder_att"], h)                    # (..., A)
    e = torch.relu(enc_att + dec.unsqueeze(-2))               # (..., P, A)
    att = linear(params["full_att"], e).squeeze(-1)           # (..., P)
    alpha = torch.softmax(att, dim=-1)
    awe = (alpha.unsqueeze(-2) @ enc).squeeze(-2)             # (..., E)
    return awe, alpha
