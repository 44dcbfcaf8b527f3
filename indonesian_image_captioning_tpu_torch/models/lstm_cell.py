"""Plain LSTM cell with torch ``nn.LSTMCell`` semantics (counterpart of the
JAX package's ``models/lstm_cell.py``).

Gate order in the fused weights is torch's (i, f, g, o), which differs from
the SCN cell's (i, f, o, c).  Weights are stored (in, 4H).
"""

from __future__ import annotations

import torch

from .layers import uniform


def init_lstm_cell(gen: torch.Generator, input_size: int, hidden_size: int,
                   dtype=torch.float32, device="cpu"):
    """torch nn.LSTMCell default: all params uniform(+-1/sqrt(hidden))."""
    bound = 1.0 / (hidden_size ** 0.5)
    shapes = {
        "w_ih": (input_size, 4 * hidden_size),
        "w_hh": (hidden_size, 4 * hidden_size),
        "b_ih": (4 * hidden_size,),
        "b_hh": (4 * hidden_size,),
    }
    return {k: uniform(gen, s, bound, dtype, device)
            for k, s in shapes.items()}


def lstm_step(params, x, h, c):
    """One LSTM step: x (..., In), h/c (..., H) -> (h_next, c_next)."""
    hidden = h.shape[-1]
    pre = (x @ params["w_ih"] + params["b_ih"]
           + h @ params["w_hh"] + params["b_hh"])
    i, f, g, o = (pre[..., k * hidden:(k + 1) * hidden] for k in range(4))
    c_next = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_next = torch.sigmoid(o) * torch.tanh(c_next)
    return h_next, c_next


def from_torch_layout(weight_ih, weight_hh, bias_ih, bias_hh):
    """torch LSTMCell stores weight_ih (4H, In); transpose into (In, 4H),
    contiguous, where the tensors lie."""
    return {
        "w_ih": weight_ih.T.contiguous(),
        "w_hh": weight_hh.T.contiguous(),
        "b_ih": bias_ih,
        "b_hh": bias_hh,
    }


def to_torch_layout(params):
    return {
        "weight_ih": params["w_ih"].T.contiguous(),
        "weight_hh": params["w_hh"].T.contiguous(),
        "bias_ih": params["b_ih"],
        "bias_hh": params["b_hh"],
    }
