"""Seeded weights of the latent-attention / mixture-of-experts caption
decoder (``configs/kimi_vl_a3b.bf16.json``), made on the device.

The tree has the names, shapes and layout of the port's
(``models/kimi_lm.py`` ``param_layout``): every weight (out, in); a
mixture layer's experts stacked as groups, the routed experts and then
the shared expert's slices of the expert width, each group's gate and up
rows interleaved.  The plain reference (``reference/kimi_lm.py``) reads
the same tree.  The initialisation (the configuration's "assumed"): every
weight N(0, 1) / sqrt(fan in), the head at HEAD_SCALE times that (logits
of a unit-RMS state spread by about HEAD_SCALE), the embedding N(0, 1),
the router N(0, 1) / sqrt(hidden) and its correction bias N(0, BIAS_STD^2)
in float32, the norms' scales one and every bias zero.  Each leaf is its
own draw of one device generator, in float32, cast to the serving type.
"""

from __future__ import annotations

import math

import torch

HEAD_SCALE = 3.0
BIAS_STD = 0.05


def layout(c: dict):
    """[(path, shape, kind)] of the tree's leaves, from the
    configuration's keys."""
    H, E, V = c["hidden_size"], c["encoder_dim"], c["vocab_size"]
    nh = c["num_attention_heads"]
    dn, dr, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    r, F, I = c["kv_lora_rank"], c["moe_intermediate_size"], \
        c["intermediate_size"]
    G = c["n_routed_experts"] + c["n_shared_experts"]
    out = [("embed", (V, H), "embed"),
           ("projector/norm_w", (E,), "ones"),
           ("projector/norm_b", (E,), "zeros"),
           ("projector/fc1_w", (H, E), "w"), ("projector/fc1_b", (H,), "zeros"),
           ("projector/fc2_w", (H, H), "w"), ("projector/fc2_b", (H,), "zeros")]
    for i in range(c["num_hidden_layers"]):
        p = f"layers/{i}/"
        out += [(p + "input_norm", (H,), "ones"),
                (p + "q_w", (nh * (dn + dr), H), "w"),
                (p + "kv_a_w", (r + dr, H), "w"),
                (p + "kv_norm", (r,), "ones"),
                (p + "kv_b_w", (nh * (dn + dv), r), "w"),
                (p + "o_w", (H, nh * dv), "w"),
                (p + "post_norm", (H,), "ones")]
        if i >= c["first_k_dense_replace"]:
            out += [(p + "router_w", (c["n_routed_experts"], H), "router"),
                    (p + "router_bias", (c["n_routed_experts"],), "bias"),
                    (p + "gate_up_w", (G, 2 * F, H), "w"),
                    (p + "down_w", (G, H, F), "w")]
        else:
            out += [(p + "gate_up_w", (2 * I, H), "w"),
                    (p + "down_w", (H, I), "w")]
    out += [("norm", (H,), "ones"), ("head", (V, H), "head")]
    return out


def std(kind: str, shape) -> float:
    if kind in ("w", "router"):
        return 1.0 / math.sqrt(shape[-1])
    if kind == "head":
        return HEAD_SCALE / math.sqrt(shape[-1])
    if kind == "embed":
        return 1.0
    return BIAS_STD


def make(c: dict, seed: int, dtype, device):
    """The tree on device, from the seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tree = {}
    for path, shape, kind in layout(c):
        if kind == "ones":
            leaf = torch.ones(shape, device=device, dtype=dtype)
        elif kind == "zeros":
            leaf = torch.zeros(shape, device=device, dtype=dtype)
        else:
            leaf = torch.randn(shape, generator=gen, device=device)
            leaf.mul_(std(kind, shape))
            if kind not in ("router", "bias"):
                leaf = leaf.to(dtype)
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf.contiguous()
    return tree
