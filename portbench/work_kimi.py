"""Operations and bytes of the latent-attention / mixture-of-experts
caption decode (``configs/kimi_vl_a3b.bf16.json``), from the
configuration's keys and the decode's shape alone.

Each count is the least work of the mathematics, whatever implements it:

* a decode is a prefill of the B images' P-token prefixes (causal
  attention over the decompressed keys, the dense layer and the mixture
  layers on B P tokens) and cached steps, one a generated token, at the
  lanes alive in each (``live``: lanes per cached step; suffix length j + 1
  at step j);
* the mixture (``moe_work``): every expert group's weights (the routed
  experts and the shared expert's slices) read once a layer a call (the
  prefill once, each step once), each (token, group) row read in and its
  output written once (bf16); 6 H F operations a row (gate, up, down);
* the decode's attention (``mla_work``): the prefix's cache rows (latent
  and rotary key, bf16) read once an image a layer a step, each live
  lane's suffix rows, its queries (latent and rope parts) and its latent
  output; scores over the latent and rope parts and P V over the latent;
* model FLOPs (``decode_flops``): 2 x the multiply-adds of every product
  a token passes (the projector, q, kv_a, kv_b -- or, in the decode,
  W_UK and W_UV absorbed, the same count -- o, the dense MLP or the
  router and the chosen and shared experts, the head where a token's
  logits are needed) and of its attention.

Peaks: ``work.py``'s (one H100 SXM at 700 W: 989 TFLOP/s bf16, 3.35 TB/s).
"""

from __future__ import annotations

ISZ = 2          # bf16


def _d(c: dict):
    return dict(H=c["hidden_size"], nh=c["num_attention_heads"],
                dn=c["qk_nope_head_dim"], dr=c["qk_rope_head_dim"],
                dv=c["v_head_dim"], r=c["kv_lora_rank"],
                F=c["moe_intermediate_size"], I=c["intermediate_size"],
                E=c["n_routed_experts"], k=c["num_experts_per_tok"],
                S=c["n_shared_experts"], L=c["num_hidden_layers"],
                Ld=c["first_k_dense_replace"], V=c["vocab_size"],
                Enc=c["encoder_dim"])


def prefix_len(c: dict) -> int:
    return c["enc_image_size"] ** 2 + 1


def moe_call(c: dict, tokens: int):
    """(bytes, operations) of one mixture layer on `tokens` tokens."""
    d = _d(c)
    rows = tokens * (d["k"] + d["S"])
    weights = (d["E"] + d["S"]) * 3 * d["H"] * d["F"]
    nbytes = ISZ * (weights + 2 * rows * d["H"])
    return nbytes, 6 * d["H"] * d["F"] * rows


def moe_work(c: dict, B: int, live):
    """(bytes, operations) of every mixture layer of one decode: the
    prefill's B P tokens, then each cached step's live lanes."""
    d = _d(c)
    layers = d["L"] - d["Ld"]
    nb, fl = moe_call(c, B * prefix_len(c))
    for n in live:
        b1, f1 = moe_call(c, n)
        nb, fl = nb + b1, fl + f1
    return layers * nb, layers * fl


def mla_work(c: dict, B: int, live):
    """(bytes, operations) of the decode's attention over every cached
    step (suffix length j + 1 at step j) and layer."""
    d = _d(c)
    P, D = prefix_len(c), d["r"] + d["dr"]
    nbytes = flops = 0
    for j, n in enumerate(live):
        ctx = P + j + 1
        nbytes += ISZ * (B * P * D + n * (j + 1) * D
                         + n * d["nh"] * (D + d["r"]))
        flops += 2 * n * d["nh"] * ctx * (D + d["r"])
    return d["L"] * nbytes, d["L"] * flops


def token_flops(c: dict) -> int:
    """Model FLOPs of one token through every layer's products (no
    attention) and no head."""
    d = _d(c)
    attn = (d["H"] * d["nh"] * (d["dn"] + d["dr"]) + d["H"] * (d["r"]
            + d["dr"]) + d["r"] * d["nh"] * (d["dn"] + d["dv"])
            + d["nh"] * d["dv"] * d["H"])
    dense = 3 * d["H"] * d["I"]
    moe = d["H"] * d["E"] + 3 * d["H"] * d["F"] * (d["k"] + d["S"])
    return 2 * (d["L"] * attn + d["Ld"] * dense + (d["L"] - d["Ld"]) * moe)


def decode_flops(c: dict, B: int, live) -> int:
    """Model FLOPs of one decode of B images: the projector and the
    prefill (causal attention over the decompressed heads), the first
    token's head, then each cached step's live lanes (absorbed attention
    over prefix and suffix, the head)."""
    d = _d(c)
    P, D = prefix_len(c), d["r"] + d["dr"]
    head = 2 * d["H"] * d["V"]
    proj = 2 * (P - 1) * (d["Enc"] * d["H"] + d["H"] * d["H"])
    causal = sum(range(1, P + 1))
    pre = (P * token_flops(c) + 2 * d["L"] * d["nh"] * causal
           * (d["dn"] + d["dr"] + d["dv"]))
    flops = B * (proj + pre + head)
    for j, n in enumerate(live):
        ctx = P + j + 1
        flops += n * (token_flops(c) + head
                      + 2 * d["L"] * d["nh"] * ctx * (D + d["r"]))
    return flops
