"""The plain reference of the caption train step: float32, TF32 off.

One step, as the reference repository trains its decoders: the decoder
teacher-forced over each caption (the inputs are the caption's tokens
from ``<start>``; the targets the tokens after them), the cross-entropy
averaged over the valid tokens of the whole batch, plus alpha_c times the
doubly stochastic attention penalty, (1 - sum_t alpha)^2 averaged over
pixels and over the rows, for the attention families; then each gradient
element clamped to +-grad_clip and one Adam step (b1 0.9, b2 0.999, eps
1e-8 outside the square root, bias-corrected).

Where the configuration computes the decoder in bfloat16 from float32
master weights (``decoder_dtype``), the program takes bfloat16 weights
and features: the reference rounds the weights and the features to
bfloat16 itself, as the program derives them, and computes everything
else in float32 (the gradient passes the rounding unchanged to the
master weights).  The batch runs in blocks of rows whose
summed terms are divided by the whole batch's counts, so the gradients
add over the blocks; each block runs only as many steps as its longest
caption needs (the masked steps after it add nothing).
"""

from __future__ import annotations

import torch

from .decoder import Decoder, exact_mm

BF16 = torch.bfloat16


def _rounded(tree):
    """The tree as a bfloat16 forward sees it: each leaf rounded to
    bfloat16, its gradient passed straight to the float32 leaf."""
    if isinstance(tree, dict):
        return {k: _rounded(v) for k, v in tree.items()}
    return tree + (tree.detach().to(BF16).float() - tree.detach())


def _same(x):
    return x


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


class TrainReference:
    """Float32 master weights, Adam's moments and the step count."""

    def __init__(self, params, model: dict, train: dict, mm=exact_mm,
                 block: int = 256):
        self.params = {k: _clone(v) for k, v in params.items()}
        self.model = model
        self.lr = train["decoder_lr"]
        self.clip = train["grad_clip"]
        self.alpha_c = train["alpha_c"]
        bf16 = train["decoder_dtype"] == "bfloat16"
        self.weights = _rounded if bf16 else _same
        self.inputs = (lambda x: x.to(BF16).float()) if bf16 else _same
        self.mm = mm
        self.block = block
        self.m = [torch.zeros_like(p) for p in _leaves(self.params)]
        self.v = [torch.zeros_like(p) for p in _leaves(self.params)]
        self.t = 0

    def step(self, enc, tags, caps, caplens):
        """enc (B, P, E) or (B, H, W, E), tags (B, S) float32; caps (B,
        L), caplens (B,).  Returns (loss, the clamped gradient of each
        leaf, in tree order)."""
        enc = enc.reshape(enc.shape[0], -1, enc.shape[-1])
        leaves = _leaves(self.params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        B = caps.shape[0]
        T = self.model["max_caption_len"] - 1
        mask = (torch.arange(T, device=caps.device)[None]
                < (caplens[:, None] - 1)).float()
        n_tok = mask.sum()
        n_rows = (mask.sum(1) > 0).float().sum()
        total = 0.0
        for lo in range(0, B, self.block):
            sl = slice(lo, lo + self.block)
            dec = Decoder(self.weights(self.params), self.model, self.mm)
            steps = int(caplens[sl].max()) - 1
            mk = mask[sl, :steps]
            logits, alphas = dec.teacher_forced(
                self.inputs(enc[sl]), self.inputs(tags[sl]),
                caps[sl], steps)
            logp = torch.log_softmax(logits, dim=-1)
            tgt = caps[sl, 1:steps + 1].long()
            nll = -logp.gather(2, tgt[..., None])[..., 0]
            loss = (nll * mk).sum() / n_tok
            if alphas is not None and self.alpha_c:
                cover = (alphas * mk[..., None]).sum(1)           # (b, P)
                valid = (mk.sum(1) > 0).float()
                pen = ((1.0 - cover) ** 2).mean(1)
                loss = loss + self.alpha_c * (pen * valid).sum() / n_rows
            loss.backward()
            total += float(loss.detach())
        grads = []
        with torch.no_grad():
            self.t += 1
            b1, b2 = 0.9, 0.999
            for p, m, v in zip(leaves, self.m, self.v):
                g = p.grad.clamp(-self.clip, self.clip)
                grads.append(g)
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                mh = m / (1 - b1 ** self.t)
                vh = v / (1 - b2 ** self.t)
                p.sub_(self.lr * mh / (vh.sqrt() + 1e-8))
                p.requires_grad_(False)
                p.grad = None
        return total, grads


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().to(torch.float32).clone()


def leaf_gaps(prog, ref):
    """Per leaf, the gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the
    median leaf.  prog, ref: lists of tensors in one order."""
    rn = torch.stack([r.double().norm() for r in ref])
    pn = torch.stack([p.double().norm() for p in prog])
    floor = torch.maximum(rn, rn.median())
    return ((pn - rn).abs() / floor).tolist()
