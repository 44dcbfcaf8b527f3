"""The plain reference of the caption decoders: float32 PyTorch, TF32 off.

A frozen, independent copy of the mathematics of the reference
repository's decoders (rayandrew/indonesian-image-captioning, after
sgrvinod's Show, Attend and Tell code): soft attention over the 14 x 14
encoder pixels (Xu et al., ICML 2015), gated by f_beta, into either a
Semantic Compositional Network cell (Gan et al., CVPR 2017: each gate's
input and hidden products factored through the tag vector) or a plain
LSTM cell, and a linear head over the vocabulary.  It imports nothing of
the program under test.

It reads the benchmark's parameter tree (``portbench/weights.py``: the
port's names and layout) and computes in float32 whatever type the tree
holds.  ``mm`` is the one product every matrix multiplication goes
through: exact float32 by default, or :func:`fp8_mm`, which rounds both
operands to float8 e4m3 with a per-tensor scale (the control: the next
precision below bfloat16).
"""

from __future__ import annotations

import contextlib

import torch

F32 = torch.float32


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32 on the card inside the block; the
    flags as they were after it."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def exact_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude maps to e4m3's 448), back in float32; the gradient passes
    the rounding unchanged."""
    d = x.detach()
    scale = 448.0 / d.abs().amax().clamp(min=1e-30)
    q = (d * scale).to(torch.float8_e4m3fn).to(F32) / scale
    return x + (q - d)


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(fp8(a), fp8(b))


def as_f32(tree):
    """A float32 copy of a nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: as_f32(v) for k, v in tree.items()}
    return tree.detach().to(F32)


class Decoder:
    """One decoder family over a float32 parameter tree."""

    def __init__(self, params, model: dict, mm=exact_mm):
        self.p = params
        self.model_type = model["model_type"]
        self.mm = mm

    @property
    def scn(self) -> bool:
        return self.model_type in ("pure_scn", "attention_scn")

    @property
    def attends(self) -> bool:
        return self.model_type in ("pure_attention", "attention_scn")

    def linear(self, p, x):
        return self.mm(x, p["w"]) + p["b"]

    def prepare(self, enc, tags):
        """The loop invariants of a batch: enc (N, P, E) and tags (N, S),
        float32 -> a dict of the flat encoding, its attention projection,
        the tag factors and the initial (h, c)."""
        inv = {"enc": enc}
        if self.attends:
            inv["ea"] = self.linear(self.p["attention"]["encoder_att"], enc)
        if self.scn:
            cell = self.p["decode_step"]
            F = cell["w_xs"].shape[1] // 4
            inv["sx"] = self.mm(tags, cell["w_xs"]).reshape(-1, 4, F)
            inv["sh"] = self.mm(tags, cell["w_hs"]).reshape(-1, 4, F)
        mean = enc.mean(dim=1)
        inv["h"] = self.linear(self.p["init_h"], mean)
        inv["c"] = self.linear(self.p["init_c"], mean)
        return inv

    def attend(self, inv, h):
        """h (N, K, D) -> (awe (N, K, E) gated by f_beta, alpha (N, K, P))."""
        att = self.p["attention"]
        dec = self.linear(att["decoder_att"], h)                # (N, K, A)
        e = torch.relu(inv["ea"][:, None] + dec[:, :, None])   # (N,K,P,A)
        score = self.linear(att["full_att"], e).squeeze(-1)    # (N, K, P)
        alpha = torch.softmax(score, dim=-1)
        awe = self.mm(alpha, inv["enc"])                       # (N, K, E)
        gate = torch.sigmoid(self.linear(self.p["f_beta"], h))
        return gate * awe, alpha

    def cell(self, inv, x, h, c):
        """One step of the SCN or LSTM cell on (N, K, ...) rows."""
        p = self.p["decode_step"]
        if self.scn:
            F = p["w_x"].shape[1] // 4
            sx, sh = inv["sx"][:, None], inv["sh"][:, None]    # (N,1,4,F)
            xf = self.mm(x, p["w_x"]).reshape(*x.shape[:-1], 4, F) * sx
            hf = self.mm(h, p["w_h"]).reshape(*h.shape[:-1], 4, F) * sh
            pre = (self.gates(xf, p["w_xp"]) + p["b_x"]
                   + self.gates(hf, p["w_hp"]) + p["b_h"])      # (N,K,4,D)
            i, f, o, g = pre.unbind(-2)
        else:
            pre = (self.mm(x, p["w_ih"]) + p["b_ih"]
                   + self.mm(h, p["w_hh"]) + p["b_hh"])
            i, f, g, o = pre.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    def gates(self, y, w):
        """Each gate's factor through its own projection: y (..., 4, F),
        w (4, F, D) -> (..., 4, D), as one batched product over the
        gates."""
        lead = y.shape[:-2]
        y4 = y.reshape(-1, 4, y.shape[-1]).transpose(0, 1)     # (4, n, F)
        out = self.mm(y4, w)                                    # (4, n, D)
        return out.transpose(0, 1).reshape(*lead, 4, w.shape[-1])

    def step(self, inv, words, h, c):
        """One decode step: words (N, K) -> (logits (N, K, V), h, c,
        alpha or None)."""
        x = self.p["embedding"][words.long()]
        alpha = None
        if self.attends:
            awe, alpha = self.attend(inv, h)
            x = torch.cat([x, awe], dim=-1)
        h, c = self.cell(inv, x, h, c)
        return self.linear(self.p["fc"], h), h, c, alpha

    def teacher_forced(self, enc, tags, caps, steps: int):
        """Run `steps` steps over the given token prefixes: caps (N, >=
        steps) ids, caps[:, t] the input of step t -> (logits (N, steps,
        V), alphas (N, steps, P) or None)."""
        inv = self.prepare(enc, tags)
        h, c = inv["h"][:, None], inv["c"][:, None]
        logits, alphas = [], []
        for t in range(steps):
            lg, h, c, alpha = self.step(inv, caps[:, t:t + 1], h, c)
            logits.append(lg[:, 0])
            if alpha is not None:
                alphas.append(alpha[:, 0])
        return (torch.stack(logits, dim=1),
                torch.stack(alphas, dim=1) if alphas else None)
