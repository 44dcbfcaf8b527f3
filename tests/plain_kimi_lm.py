"""The plain reference of Kimi-VL-A3B's language model as a caption
decoder: float32 PyTorch, TF32 off, no kernel, no cache, no batching of
beams.  It imports nothing but torch.

The language model is DeepSeek-V3's block at Kimi-VL-A3B-Instruct's
published config (its keys: ``hidden_size``, ``num_attention_heads``,
``qk_nope_head_dim``, ``qk_rope_head_dim``, ``v_head_dim``,
``kv_lora_rank``, ``n_routed_experts``, ``num_experts_per_tok``,
``n_shared_experts``, ``moe_intermediate_size``, ``intermediate_size``,
``first_k_dense_replace``, ``routed_scaling_factor``, ``norm_topk_prob``,
``rms_norm_eps``, ``rope_theta``, ``vocab_size``), written from
DeepSeek-V2 (arXiv:2405.04434) and DeepSeek-V3 (arXiv:2412.19437) and the
published modelling code (``modeling_deepseek.py``):

* multi-head latent attention in its full, non-absorbed form: q =
  q_proj(x) (no q LoRA), [c, k_pe] = kv_a(x), c RMSNormed, [k_nope, v] =
  kv_b(c) per head, the rope parts of q and k rotated as the modelling
  code rotates them (the 64 values viewed as 32 pairs and de-interleaved,
  then x cos + rotate_half(x) sin, inv_freq = theta^(-2i/64)), k_pe shared
  by the heads, causal softmax(q k^T (nope + rope)^-0.5) v, o_proj;
* the router of ``topk_method = noaux_tc`` with one group: float32
  sigmoid scores, the experts of the top k of scores + bias, the unbiased
  scores of those normalised (+1e-20) and scaled; routed and shared
  SwiGLU experts; the first ``first_k_dense_replace`` layers a dense
  SwiGLU MLP;
* RMSNorm as the modelling code's (float32 variance, eps inside the
  root), the final norm and the untied head.

Departures, each noted: the experts are run one at a time over the rows
that chose them (the modelling code's ``moe_infer`` groups them so too;
ties in the top k go to the lower expert id, where ``torch.topk`` leaves
their order open); the MoonViT tower is replaced by the caption system's
ResNet-152 grid (196 tokens of 2,048) through a LayerNorm-MLP projector
(LayerNorm, Linear, exact GELU, Linear), as Kimi-VL's projector is one; the
prompt is the 196 image tokens and ``<start>``.

The parameter tree is the caption system's (names below; every weight
(out, in) as nn.Linear stores it; a mixture layer's experts stacked as
groups, the routed ones first and then the shared expert's slices of the
expert width, each group's gate and up rows interleaved: row 2j the
gate's j, row 2j + 1 the up's j).  Leaves may be bf16: each is cast to
float32 where it is used, one layer (one expert) at a time, so that the
reference fits beside the program's weights on the card.

``mm`` is the one product every matrix multiplication goes through
(exact float32 by default; the benchmark's control passes a float8 one).
"""

from __future__ import annotations

import torch

F32 = torch.float32


def exact_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


class KimiLM:
    """The reference over a parameter tree and a dict of the config's
    keys (plus ``encoder_dim``)."""

    def __init__(self, params, cfg: dict, mm=exact_mm):
        self.p, self.c, self.mm = params, cfg, mm

    # -- pieces
    def lin(self, x, w, b=None):
        y = self.mm(x, w.to(F32).t())
        return y if b is None else y + b.to(F32)

    def rmsnorm(self, x, w):
        var = x.pow(2).mean(-1, keepdim=True)
        return w.to(F32) * (x * torch.rsqrt(var + self.c["rms_norm_eps"]))

    def rope(self, x, pos):
        """x (n, h, S, d) at positions pos (S,)."""
        d = x.shape[-1]
        inv = 1.0 / (self.c["rope_theta"] ** (
            torch.arange(0, d, 2, dtype=F32, device=x.device) / d))
        freqs = torch.outer(pos.to(F32), inv)
        emb = torch.cat([freqs, freqs], -1)
        cos, sin = emb.cos(), emb.sin()
        n, h, s, _ = x.shape
        x = x.view(n, h, s, d // 2, 2).transpose(4, 3).reshape(n, h, s, d)
        rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
        return x * cos + rot * sin

    def swiglu(self, x, gate_up, down):
        gu = self.lin(x, gate_up)
        g, u = gu[..., 0::2], gu[..., 1::2]
        return self.lin(torch.nn.functional.silu(g) * u, down)

    def attention(self, lp, x):
        """x (n, S, H) normed -> (n, S, H)."""
        c = self.c
        n, S, _ = x.shape
        nh, dn = c["num_attention_heads"], c["qk_nope_head_dim"]
        dr, dv, r = c["qk_rope_head_dim"], c["v_head_dim"], c["kv_lora_rank"]
        q = self.lin(x, lp["q_w"]).view(n, S, nh, dn + dr).transpose(1, 2)
        q_nope, q_pe = q[..., :dn], q[..., dn:]
        kva = self.lin(x, lp["kv_a_w"])
        lat, k_pe = kva[..., :r], kva[..., r:]
        kv = self.lin(self.rmsnorm(lat, lp["kv_norm"]), lp["kv_b_w"])
        kv = kv.view(n, S, nh, dn + dv).transpose(1, 2)
        k_nope, v = kv[..., :dn], kv[..., dn:]
        pos = torch.arange(S, device=x.device)
        q_pe = self.rope(q_pe, pos)
        k_pe = self.rope(k_pe.view(n, S, 1, dr).transpose(1, 2), pos)
        qq = torch.cat([q_nope, q_pe], -1)
        kk = torch.cat([k_nope, k_pe.expand(n, nh, S, dr)], -1)
        s = self.mm(qq, kk.transpose(-1, -2)) * (dn + dr) ** -0.5
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1)
        p = torch.softmax(s.masked_fill(causal, float("-inf")), -1)
        o = self.mm(p, v).transpose(1, 2).reshape(n, S, nh * dv)
        return self.lin(o, lp["o_w"])

    def route(self, lp, x):
        """x (N, H) -> (ids (N, k), weights (N, k))."""
        c = self.c
        scores = torch.sigmoid(self.lin(x, lp["router_w"]))
        choice = scores + lp["router_bias"].to(F32)[None]
        ids = torch.sort(choice, dim=-1, descending=True,
                         stable=True).indices[:, :c["num_experts_per_tok"]]
        w = scores.gather(1, ids)
        if c["norm_topk_prob"]:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return ids, w * c["routed_scaling_factor"]

    def moe(self, lp, x):
        """x (n, S, H) normed -> (n, S, H)."""
        c = self.c
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        ids, w = self.route(lp, x)
        y = torch.zeros_like(x)
        E = c["n_routed_experts"]
        for e in range(E):
            tok, slot = (ids == e).nonzero(as_tuple=True)
            if tok.numel():
                out = self.swiglu(x[tok], lp["gate_up_w"][e],
                                  lp["down_w"][e])
                y.index_add_(0, tok, w[tok, slot][:, None] * out)
        for g in range(E, E + c["n_shared_experts"]):
            y = y + self.swiglu(x, lp["gate_up_w"][g], lp["down_w"][g])
        return y.view(shape)

    # -- the model
    def tokens(self, enc, seqs, steps: int):
        """enc (n, P, E) and the captions' first `steps` ids -> the input
        rows (n, P + steps, H): the image tokens, then the ids'
        embeddings."""
        pj = self.p["projector"]
        x = torch.nn.functional.layer_norm(
            enc.to(F32), (enc.shape[-1],), pj["norm_w"].to(F32),
            pj["norm_b"].to(F32), 1e-5)
        x = self.lin(x, pj["fc1_w"], pj["fc1_b"])
        x = self.lin(torch.nn.functional.gelu(x), pj["fc2_w"], pj["fc2_b"])
        words = self.p["embed"][seqs[:, :steps].long()].to(F32)
        return torch.cat([x, words], 1)

    def forward(self, x):
        """Input rows (n, S, H) -> final normed states (n, S, H)."""
        c = self.c
        for i in range(c["num_hidden_layers"]):
            lp = self.p["layers"][str(i)]
            x = x + self.attention(lp, self.rmsnorm(x, lp["input_norm"]))
            h = self.rmsnorm(x, lp["post_norm"])
            if i < c["first_k_dense_replace"]:
                x = x + self.swiglu(h, lp["gate_up_w"], lp["down_w"])
            else:
                x = x + self.moe(lp, h)
        return self.rmsnorm(x, self.p["norm"])

    def teacher_forced(self, enc, tags, seqs, steps: int):
        """The caption judge's contract: enc (n, P, E), tags (ignored),
        seqs (n, >= steps) ids with seqs[:, 0] = <start> -> (logits (n,
        steps, V) of the next token after each of the first `steps` ids,
        None)."""
        x = self.forward(self.tokens(enc, seqs, steps))
        P = enc.shape[1]
        h = x[:, P:P + steps]
        return self.lin(h, self.p["head"]), None
