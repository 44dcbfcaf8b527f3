"""Kimi-VL-A3B's language model as a caption decoder.

The DeepSeek-V3 block (Kimi-VL-A3B-Instruct's ``config.json``; DeepSeek-V2,
arXiv:2405.04434, for the latent attention; DeepSeek-V3, arXiv:2412.19437,
for the router) over the port's ResNet-152 grid:

* the 14 x 14 x 2,048 features go through a LayerNorm-MLP projector
  (LayerNorm, Linear E -> H, GELU, Linear H -> H) into 196 image tokens at
  positions 0-195, and ``<start>``'s embedding sits at 196: a prefix of
  197 tokens, which is prefilled once an image;
* each layer: RMSNorm, multi-head latent attention (q from the hidden
  state, no q LoRA; the kv LoRA's 512-wide latent, RMSNormed, and one
  64-wide rotary key shared by the heads; keys and values decompressed
  per head by ``kv_b``; scale (nope + rope)^-0.5), the residual, RMSNorm,
  then the leading ``first_k_dense_replace`` layers' dense SwiGLU MLP or
  the mixture of experts, and the residual;
* the mixture: float32 sigmoid scores of the router, the experts chosen by
  score plus ``e_score_correction_bias`` (top ``num_experts_per_tok``,
  the lowest expert id first among equal values, as lax.top_k orders
  ties), weighted by their unbiased scores normalised to sum one and
  scaled by ``routed_scaling_factor``; SwiGLU experts; the shared expert
  (``n_shared_experts`` x the expert width) added to every token;
* the final RMSNorm and the untied head over the vocabulary.

The decode attends through a cache: the prefix's latent and rotary key
(the attention's whole state, ``kv_lora_rank + qk_rope_head_dim`` values
a position a layer) stored once per image and shared by its beam lanes,
and each generated token's in a slot of its own, which a lane reaches
through an int table (lane, position) -> slot.  The beam reorders that
table, never the cache.  The decode's attention is the absorbed form:
the query's nope part multiplied into the latent by ``W_UK``, the output
taken out of it by ``W_UV``.

The parameter tree (:func:`param_layout`) keeps every weight as
``nn.Linear`` stores it, (out, in).  The experts of a mixture layer are
stacked as groups: the routed experts 0 .. n_routed - 1, then the shared
expert's ``n_shared_experts`` slices of the expert width, each a group of
its own (a SwiGLU MLP of width n x F is the sum of n MLPs of width F over
its column blocks); a group's gate and up rows are interleaved (row 2j
the gate's j, row 2j + 1 the up's j).

Ops: ``ops/lm_cuda.py``; on CUDA tensors the card's kernels (bfloat16
only), on the CPU their plain versions.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.profiling import annotate
from ..ops import lm_cuda

MODEL_TYPE = "kimi_lm"


@dataclasses.dataclass(frozen=True)
class KimiLMConfig:
    """The language model's published widths (the catalog's names), the
    caption decoder's input (the ResNet grid) and the serving type."""

    model_type: str = MODEL_TYPE
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 2.446
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    first_k_dense_replace: int = 1
    norm_topk_prob: bool = True
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800000.0
    encoder_dim: int = 2048
    enc_image_size: int = 14
    dtype: str = "float32"
    encoder_arch: str = "resnet152"
    semantic_dim: int = 0               # no tags

    uses_tags = False
    uses_attention = False              # no alphas to record

    @property
    def num_pixels(self) -> int:
        return self.enc_image_size ** 2

    @property
    def prefix_len(self) -> int:
        """The image tokens and <start>."""
        return self.num_pixels + 1

    @property
    def latent_dim(self) -> int:
        """What the cache holds a position a layer."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def groups(self) -> int:
        """Expert groups of a mixture layer: routed, then shared slices."""
        return self.n_routed_experts + self.n_shared_experts

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace

    @classmethod
    def of(cls, section: dict, **overrides) -> "KimiLMConfig":
        """A config from a dict holding the catalog's keys (and others,
        ignored)."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in section.items() if k in names}
        kw.update(overrides)
        return cls(**kw)


def is_lm(cfg) -> bool:
    return getattr(cfg, "model_type", None) == MODEL_TYPE


# --------------------------------------------------------------- params ----

def param_layout(cfg: KimiLMConfig):
    """[(path, shape, kind)] of the tree's leaves in order.  kind: "w" a
    weight read x @ w.T, "head" the vocabulary head, "embed" the embedding
    table, "ones" / "zeros" the norms' scales and shifts (and the
    projector's biases), "router" the router (float32), "bias" the
    correction bias (float32)."""
    H, E, V = cfg.hidden_size, cfg.encoder_dim, cfg.vocab_size
    nh, dq, dv = cfg.num_attention_heads, cfg.q_head_dim, cfg.v_head_dim
    r, dr, dn = cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.qk_nope_head_dim
    F, G, I = cfg.moe_intermediate_size, cfg.groups, cfg.intermediate_size
    out = [("embed", (V, H), "embed"),
           ("projector/norm_w", (E,), "ones"),
           ("projector/norm_b", (E,), "zeros"),
           ("projector/fc1_w", (H, E), "w"), ("projector/fc1_b", (H,), "zeros"),
           ("projector/fc2_w", (H, H), "w"), ("projector/fc2_b", (H,), "zeros")]
    for i in range(cfg.num_hidden_layers):
        p = f"layers/{i}/"
        out += [(p + "input_norm", (H,), "ones"),
                (p + "q_w", (nh * dq, H), "w"),
                (p + "kv_a_w", (r + dr, H), "w"),
                (p + "kv_norm", (r,), "ones"),
                (p + "kv_b_w", (nh * (dn + dv), r), "w"),
                (p + "o_w", (H, nh * dv), "w"),
                (p + "post_norm", (H,), "ones")]
        if cfg.is_moe(i):
            out += [(p + "router_w", (cfg.n_routed_experts, H), "router"),
                    (p + "router_bias", (cfg.n_routed_experts,), "bias"),
                    (p + "gate_up_w", (G, 2 * F, H), "w"),
                    (p + "down_w", (G, H, F), "w")]
        else:
            out += [(p + "gate_up_w", (2 * I, H), "w"),
                    (p + "down_w", (H, I), "w")]
    out += [("norm", (H,), "ones"), ("head", (V, H), "head")]
    return out


def layer(params, i: int):
    return params["layers"][str(i)]


def cast_params(params, dtype):
    """Every leaf but the router's in dtype."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = cast_params(v, dtype)
        elif k in ("router_w", "router_bias"):
            out[k] = v.float()
        else:
            out[k] = v.to(dtype)
    return out


# ------------------------------------------------------------ the model ----

def rope_tables(cfg: KimiLMConfig, positions: torch.Tensor):
    """cos, sin (n, dr) float32 at the given positions (the published
    rotary embedding: inv_freq over even indices, the angles repeated)."""
    dr = cfg.qk_rope_head_dim
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, dr, 2, dtype=torch.float32, device=positions.device) / dr))
    ang = positions.to(torch.float32)[:, None] * inv[None]
    emb = torch.cat([ang, ang], dim=-1)
    return emb.cos(), emb.sin()


def project_image(params, cfg: KimiLMConfig, enc):
    """enc (B, P, E) -> image tokens (B, P, H) in enc's type."""
    p = params["projector"]
    x = torch.nn.functional.layer_norm(
        enc.float(), (cfg.encoder_dim,), p["norm_w"].float(),
        p["norm_b"].float(), 1e-5).to(enc.dtype)
    x = lm_cuda.linear(x, p["fc1_w"], bias=p["fc1_b"])
    x = torch.nn.functional.gelu(x.float()).to(enc.dtype)
    return lm_cuda.linear(x, p["fc2_w"], bias=p["fc2_b"])


def _mlp_or_moe(params, cfg, i, h, x):
    """The feed-forward half of layer i on normed rows h, added to x."""
    lp = layer(params, i)
    if cfg.is_moe(i):
        return lm_cuda.moe(h, lp, cfg, residual=x)
    return lm_cuda.dense_mlp(h, lp["gate_up_w"], lp["down_w"], residual=x)


PREFILL_CHUNK = 64     # images a prefill pass (bounds its intermediates)


def prefill(params, cfg: KimiLMConfig, enc, start_id: int, prefix_out):
    """The prefix of every image through every layer.

    enc (B, P, E) -> the last position's logits (B, V) float32; fills
    prefix_out (L, B, Pc, latent) with each position's normed latent and
    rotary key (Pc >= P; the rows past the prefix are left zero).  Images
    go through PREFILL_CHUNK at a time.  Causal attention over the
    decompressed keys and values (scaled_dot_product_attention)."""
    B = enc.shape[0]
    out = []
    for lo in range(0, B, PREFILL_CHUNK):
        hi = min(B, lo + PREFILL_CHUNK)
        out.append(_prefill_chunk(params, cfg, enc[lo:hi], start_id,
                                  prefix_out[:, lo:hi]))
    return torch.cat(out, 0)


def _prefill_chunk(params, cfg, enc, start_id, cache):
    B, P = enc.shape[0], cfg.prefix_len
    H, nh, dn, dr = (cfg.hidden_size, cfg.num_attention_heads,
                     cfg.qk_nope_head_dim, cfg.qk_rope_head_dim)
    dv, r = cfg.v_head_dim, cfg.kv_lora_rank
    img = project_image(params, cfg, enc)
    start = params["embed"][start_id].to(img.dtype)
    x = torch.cat([img, start.expand(B, 1, H)], 1).reshape(B * P, H)
    cos, sin = rope_tables(cfg, torch.arange(P, device=enc.device))
    cos, sin = cos.repeat(B, 1), sin.repeat(B, 1)
    for i in range(cfg.num_hidden_layers):
        lp = layer(params, i)
        with annotate("iic.lm.attn"):
            h = lm_cuda.rmsnorm(x, lp["input_norm"], cfg.rms_norm_eps)
            q = lm_cuda.linear(h, lp["q_w"])                # (BP, nh*dq)
            kva = lm_cuda.linear(h, lp["kv_a_w"])          # (BP, r+dr)
            lat = lm_cuda.latent_rope(q, kva, lp["kv_norm"], cos, sin, cfg)
            cache[i, :, :P] = lat.reshape(B, P, -1)
            kv = lm_cuda.linear(lat[:, :r].contiguous(), lp["kv_b_w"])
            kv = kv.reshape(B, P, nh, dn + dv)
            qh = q.reshape(B, P, nh, dn + dr).transpose(1, 2)
            k_pe = lat[:, r:].reshape(B, 1, P, dr).expand(B, nh, P, dr)
            k = torch.cat([kv[..., :dn].transpose(1, 2), k_pe], -1)
            v = kv[..., dn:].transpose(1, 2)
            att = torch.nn.functional.scaled_dot_product_attention(
                qh, k, v, is_causal=True, scale=cfg.q_head_dim ** -0.5)
            att = att.transpose(1, 2).reshape(B * P, nh * dv).contiguous()
            x = lm_cuda.linear(att, lp["o_w"], residual=x)
        h = lm_cuda.rmsnorm(x, lp["post_norm"], cfg.rms_norm_eps)
        x = _mlp_or_moe(params, cfg, i, h, x)
    last = x.reshape(B, P, H)[:, -1].contiguous()
    with annotate("iic.lm.head"):
        h = lm_cuda.rmsnorm(last, params["norm"], cfg.rms_norm_eps)
        return lm_cuda.linear(h, params["head"], out_f32=True)


def absorbed(params, cfg: KimiLMConfig):
    """Per layer, W_UK packed for the absorbed query: (nh, r, dn), the
    transpose of kv_b's key rows (made once per parameter tree)."""
    nh, dn, dv, r = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                     cfg.v_head_dim, cfg.kv_lora_rank)
    out = []
    for i in range(cfg.num_hidden_layers):
        kvb = layer(params, i)["kv_b_w"].reshape(nh, dn + dv, r)
        out.append(kvb[:, :dn].transpose(1, 2).contiguous())
    return out


class Decoder:
    """The decode state of one batch: the prefix cache, the suffix slots
    and the absorbed weights; :meth:`step` runs one cached step."""

    def __init__(self, params, cfg: KimiLMConfig, enc, *, start_id: int,
                 beam_size: int, max_steps: int):
        B, dev = enc.shape[0], enc.device
        self.params, self.cfg = params, cfg
        self.B, self.K, self.T = B, beam_size, max_steps
        L, D = cfg.num_hidden_layers, cfg.latent_dim
        Pc = lm_cuda.prefix_rows(cfg.prefix_len)
        self.prefix = torch.zeros((L, B, Pc, D), dtype=enc.dtype, device=dev)
        # a slot per lane and suffix position: (lane, j) -> lane * T + j
        self.slots = torch.empty((L, B * beam_size * max_steps, D),
                                 dtype=enc.dtype, device=dev)
        self.wuk = absorbed(params, cfg)
        with annotate("iic.lm.prefill"):
            self.first = prefill(params, cfg, enc, start_id, self.prefix)

    def step(self, words, table, j: int):
        """One cached step of every lane: words (R,) the tokens at suffix
        position j (absolute 197 + j), table (R, T) the lanes' slots of
        positions 0 .. j - 1 -> (logits (R, V) float32, the table with
        position j's slot)."""
        cfg, p = self.cfg, self.params
        R, T = words.shape[0], self.T
        dev = words.device
        nh, dn, dv, r = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                         cfg.v_head_dim, cfg.kv_lora_rank)
        if lm_cuda.keep_rows:
            lm_cuda.last_rows.clear()       # this step's rows replace them
        slot = torch.arange(R, device=dev, dtype=torch.int32) * T + j
        table = table.clone()
        table[:, j] = slot
        pos = torch.full((1,), cfg.prefix_len + j, device=dev)
        cos, sin = rope_tables(cfg, pos)
        x = p["embed"][words.long()].contiguous()
        for i in range(cfg.num_hidden_layers):
            lp = layer(p, i)
            with annotate("iic.lm.attn"):
                h = lm_cuda.rmsnorm(x, lp["input_norm"], cfg.rms_norm_eps)
                q = lm_cuda.linear(h, lp["q_w"])
                kva = lm_cuda.linear(h, lp["kv_a_w"])
                lat = lm_cuda.latent_rope(q, kva, lp["kv_norm"],
                                          cos.expand(R, -1),
                                          sin.expand(R, -1), cfg)
                self.slots[i, slot.long()] = lat
                qlat = lm_cuda.absorb_query(q, self.wuk[i], cfg)
                olat = lm_cuda.mla_decode(
                    qlat, q, self.prefix[i], cfg.prefix_len, self.slots[i],
                    table, j + 1, cfg)
                o = lm_cuda.absorb_output(olat, lp["kv_b_w"], cfg)
                x = lm_cuda.linear(o, lp["o_w"], residual=x)
            h = lm_cuda.rmsnorm(x, lp["post_norm"], cfg.rms_norm_eps)
            x = _mlp_or_moe(p, cfg, i, h, x)
        with annotate("iic.lm.head"):
            h = lm_cuda.rmsnorm(x, p["norm"], cfg.rms_norm_eps)
            return lm_cuda.linear(h, p["head"], out_f32=True), table


def make_beam_step(params, cfg: KimiLMConfig, enc, *, start_id: int,
                   beam_size: int, max_steps: int):
    """(init_state_fn, step_fn) for ``decode/beam.beam_search``.

    The state is the lanes' slot table (B, K, T) int32, which the beam
    reorders; the caches stay where they are.  The first call returns the
    prefill's head (the prefix ends in <start>); each later one feeds the
    lanes' previous words through one cached step.  The head is sparse:
    each lane's top K log-probabilities and ids (float32, ties to the
    lowest id)."""
    dec = Decoder(params, cfg, enc, start_id=start_id, beam_size=beam_size,
                  max_steps=max_steps)
    B, K, T = dec.B, beam_size, max_steps
    calls = {"n": 0}

    def init_state_fn(k):
        return {"table": torch.zeros((B, k, T), dtype=torch.int32,
                                     device=enc.device)}

    def step_fn(state, prev_words):
        n = calls["n"]
        calls["n"] += 1
        if n == 0:
            with annotate("iic.lm.head"):
                vals, ids = lm_cuda.head_topk(dec.first, K)
            return ((vals[:, None].expand(B, K, K),
                     ids[:, None].expand(B, K, K)), state, {})
        logits, table = dec.step(prev_words.reshape(B * K),
                                 state["table"].reshape(B * K, T), n - 1)
        with annotate("iic.lm.head"):
            vals, ids = lm_cuda.head_topk(logits, K)
        return ((vals.reshape(B, K, K), ids.reshape(B, K, K)),
                {"table": table.reshape(B, K, T)}, {})

    return init_state_fn, step_fn
