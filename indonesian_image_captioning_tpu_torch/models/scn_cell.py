"""Semantic Compositional Network cell (counterpart of the JAX package's
``models/scn_cell.py``, whose docstring derives the math).

Per gate g in (i, f, o, c):

    x_g      = ((x @ ia_g) * (s @ ib_g)) @ ic_g^T + b_ig
    preact_g = ((h @ ha_g) * (s @ hb_g)) @ hc_g^T + x_g + b_hg

Parameter layout, as in JAX (gate order i, f, o, c):

    w_x  : (input,    4*factor)     w_h  : (hidden,   4*factor)
    w_xs : (semantic, 4*factor)     w_hs : (semantic, 4*factor)
    w_xp : (4, factor, hidden)      w_hp : (4, factor, hidden)
    b_x  : (4, hidden)              b_h  : (4, hidden)

The tag projections are loop invariants: :func:`semantic_projections` runs
once per caption and :func:`scn_step` takes its result.
"""

from __future__ import annotations

import torch

from .layers import uniform


def init_scn_cell(gen: torch.Generator, input_size: int, hidden_size: int,
                  semantic_size: int, factor_size: int,
                  dtype=torch.float32, device="cpu"):
    """Uniform(-1/sqrt(hidden), +1/sqrt(hidden)) for every parameter."""
    bound = 1.0 / (hidden_size ** 0.5)
    f4 = 4 * factor_size
    shapes = {
        "w_x": (input_size, f4),
        "w_xs": (semantic_size, f4),
        "w_xp": (4, factor_size, hidden_size),
        "w_h": (hidden_size, f4),
        "w_hs": (semantic_size, f4),
        "w_hp": (4, factor_size, hidden_size),
        "b_x": (4, hidden_size),
        "b_h": (4, hidden_size),
    }
    return {k: uniform(gen, s, bound, dtype, device)
            for k, s in shapes.items()}


def _factor(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., D) @ (D, 4F) -> (..., 4, F)."""
    y = x @ w
    return y.reshape(*y.shape[:-1], 4, w.shape[-1] // 4)


def semantic_projections(params, sem: torch.Tensor):
    """(..., S) -> ((..., 4, F), (..., 4, F)); once per sequence."""
    return _factor(sem, params["w_xs"]), _factor(sem, params["w_hs"])


def input_factor(params, x: torch.Tensor) -> torch.Tensor:
    """Input-path factor projection: (..., In) -> (..., 4, F)."""
    return _factor(x, params["w_x"])


def scn_step(params, x_fac, sem_x, sem_h, h, c):
    """One SCN recurrence given precomputed factors.

    x_fac, sem_x, sem_h: (..., 4, F);  h, c: (..., H).
    Returns (h_next, c_next).  Gate products accumulate in float32 and the
    pre-activations are cast back to h's type, as in JAX.
    """
    f32 = torch.float32
    xg = torch.einsum("...gf,gfh->...gh", (x_fac * sem_x).to(f32),
                      params["w_xp"].to(f32)) + params["b_x"].to(f32)
    h_fac = _factor(h, params["w_h"]) * sem_h
    hg = torch.einsum("...gf,gfh->...gh", h_fac.to(f32),
                      params["w_hp"].to(f32)) + params["b_h"].to(f32)
    pre = (xg + hg).to(h.dtype)
    i = torch.sigmoid(pre[..., 0, :])
    f = torch.sigmoid(pre[..., 1, :])
    o = torch.sigmoid(pre[..., 2, :])
    g = torch.tanh(pre[..., 3, :])
    c_next = f * c + i * g
    h_next = o * torch.tanh(c_next)
    return h_next, c_next


# ---------------------------------------------------------------------------
# The reference's (torch) layout, for checkpoint interop.
# ---------------------------------------------------------------------------

def from_torch_layout(weight_ia, weight_ib, weight_ic, weight_ha, weight_hb,
                      weight_hc, bias_ih, bias_hh):
    """Reference SCNCell tensors (models/scn_cell.py:29-45 of the
    reference) -> the layout above: (H, 4F) output projections become
    (4, F, H), (4H,) biases (4, H); contiguous, where the tensors lie."""
    def proj(w):  # (H, 4F) -> (4, F, H)
        return w.reshape(w.shape[0], 4, -1).permute(1, 2, 0).contiguous()

    def bias(b):  # (4H,) -> (4, H)
        return b.reshape(4, -1).contiguous()

    return {
        "w_x": weight_ia,
        "w_xs": weight_ib,
        "w_xp": proj(weight_ic),
        "w_h": weight_ha,
        "w_hs": weight_hb,
        "w_hp": proj(weight_hc),
        "b_x": bias(bias_ih),
        "b_h": bias(bias_hh),
    }


def to_torch_layout(params):
    """Inverse of :func:`from_torch_layout` (for exporting checkpoints)."""
    def proj(w):  # (4, F, H) -> (H, 4F)
        g, f, h = w.shape
        return w.permute(2, 0, 1).reshape(h, g * f).contiguous()

    return {
        "weight_ia": params["w_x"],
        "weight_ib": params["w_xs"],
        "weight_ic": proj(params["w_xp"]),
        "weight_ha": params["w_h"],
        "weight_hb": params["w_hs"],
        "weight_hc": proj(params["w_hp"]),
        "bias_ih": params["b_x"].reshape(-1),
        "bias_hh": params["b_h"].reshape(-1),
    }
