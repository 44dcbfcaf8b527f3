"""Caption decoders for beam search: PureSCN, PureAttention, AttentionSCN.

Counterpart of the JAX package's ``models/decoders.py`` for the serving
path: initialisation, the hoisted loop invariants and the two ways to
build a beam step.  Parameters are nested dicts of tensors whose names mirror the
JAX tree (embedding / decode_step / init_h / init_c / f_beta / fc /
attention).

* :func:`make_beam_step` -- the step engine: embedding lookup, attention
  (kernel 1 or the plain :func:`models.attention.attend`), f_beta gate, the
  SCN or LSTM cell, the vocab head and a per-lane top-K of the log-softmax
  (the sparse head of ``decode/beam.py``).  It can record alphas.
* :func:`_make_fused_beam_step` -- one whole step per call of kernel 2
  (``ops/step_cuda.py``); no alphas.
"""

from __future__ import annotations

import torch

from ..core.config import ModelConfig
from . import attention as attn
from . import lstm_cell, scn_cell
from .layers import init_linear, linear, uniform

MODEL_TYPES = ("pure_scn", "pure_attention", "attention_scn")
SCN_BASED_MODELS = frozenset({"pure_scn", "attention_scn"})
ATTENTION_IMPLS = ("auto", "xla", "xla_pk", "pallas", "pallas_mxu")


def cell_input_dim(cfg: ModelConfig) -> int:
    """Cell input width: the embedding, plus the attention-weighted
    encoding for the attention models."""
    return cfg.embed_dim + (cfg.encoder_dim if cfg.uses_attention else 0)


def init_decoder(gen: torch.Generator, cfg: ModelConfig,
                 dtype=torch.float32, device="cpu"):
    if cfg.model_type not in MODEL_TYPES:
        raise ValueError(f"unknown model_type {cfg.model_type!r}")
    if cfg.vocab_size <= 0:
        raise ValueError("cfg.vocab_size must be set before init")
    params = {
        "embedding": uniform(gen, (cfg.vocab_size, cfg.embed_dim), 0.1,
                             dtype, device),
        "init_h": init_linear(gen, cfg.encoder_dim, cfg.decoder_dim, dtype,
                              device),
        "init_c": init_linear(gen, cfg.encoder_dim, cfg.decoder_dim, dtype,
                              device),
        "fc": {
            "w": uniform(gen, (cfg.decoder_dim, cfg.vocab_size), 0.1, dtype,
                         device),
            "b": torch.zeros((cfg.vocab_size,), dtype=dtype, device=device),
        },
    }
    if cfg.uses_attention:
        params["attention"] = attn.init_attention(
            gen, cfg.encoder_dim, cfg.decoder_dim, cfg.attention_dim, dtype,
            device)
        params["f_beta"] = init_linear(gen, cfg.decoder_dim, cfg.encoder_dim,
                                       dtype, device)
    if cfg.model_type in SCN_BASED_MODELS:
        params["decode_step"] = scn_cell.init_scn_cell(
            gen, cell_input_dim(cfg), cfg.decoder_dim, cfg.semantic_dim,
            cfg.factored_dim, dtype, device)
    else:
        params["decode_step"] = lstm_cell.init_lstm_cell(
            gen, cell_input_dim(cfg), cfg.decoder_dim, dtype, device)
    return params


def cast_params(params, dtype):
    """Cast every leaf of a decoder parameter tree (e.g. bf16 serving)."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    return params.to(dtype)


def flatten_encoding(enc: torch.Tensor, encoder_dim: int) -> torch.Tensor:
    """(B, H, W, E) or (B, P, E) -> (B, P, E)."""
    return enc.reshape(enc.shape[0], -1, encoder_dim)


def init_hidden_state(params, enc_flat):
    """Mean image feature -> init_h/init_c linears: (..., P, E) -> (h, c)."""
    mean = enc_flat.mean(dim=-2)
    return linear(params["init_h"], mean), linear(params["init_c"], mean)


def _split_wx(params, cfg: ModelConfig):
    """Split the SCN input weight into its embedding and awe slabs."""
    w_x = params["decode_step"]["w_x"]
    return w_x[: cfg.embed_dim], w_x[cfg.embed_dim:]


def _gate_factor(y):
    """(..., 4F) -> (..., 4, F)."""
    return y.reshape(*y.shape[:-1], 4, y.shape[-1] // 4)


def resolve_attention_impl(cfg: ModelConfig, device: torch.device) -> str:
    """cfg.attention_impl -> "kernel" (kernel 1) or "plain" (``attend``).

    "auto" is the kernel on CUDA and the plain version on the CPU.  The
    JAX package's two kernel names, "pallas" and "pallas_mxu", compute the
    same values and map to the one kernel (which runs its plain version on
    CPU tensors); "xla" and "xla_pk" map to the plain version."""
    impl = cfg.attention_impl
    if impl not in ATTENTION_IMPLS:
        raise ValueError(f"unknown attention_impl {impl!r}")
    if impl == "auto":
        return "kernel" if device.type == "cuda" else "plain"
    return "kernel" if impl.startswith("pallas") else "plain"


def make_beam_step(params, cfg: ModelConfig, enc, tags, *,
                   fused_step: bool = False):
    """Build (init_state, step_fn) for the beam engine (decode/beam.py).

    enc: (B, H, W, E) or (B, P, E);  tags: (B, S).  State tensors carry a
    (B, K, ...) leading shape.  step_fn(state, prev_words) returns (head,
    new_state, emit): head is the sparse pair (cand_vals, cand_ids) (B, K,
    K), or the dense log-probabilities (B, K, V) when cfg.sparse_head is
    off; emit holds the attention alphas (B, K, P) of attention models.

    fused_step=True runs each step as one call of kernel 2 and emits no
    alphas.
    """
    if fused_step:
        return _make_fused_beam_step(params, cfg, enc, tags)
    from ..ops.attention_cuda import attend_fused_mxu
    from ..ops.topk import row_topk

    cell = params["decode_step"]
    is_scn = cfg.model_type in SCN_BASED_MODELS
    enc_flat = flatten_encoding(enc, cfg.encoder_dim)       # (B, P, E)
    B = enc_flat.shape[0]
    attention_impl = resolve_attention_impl(cfg, enc_flat.device)

    inv = {}
    if is_scn:
        sx, sh = scn_cell.semantic_projections(cell, tags)
        inv["sem_x"], inv["sem_h"] = sx[:, None], sh[:, None]
    if cfg.uses_attention:
        enc_att = attn.precompute(params["attention"], enc_flat)
        inv["enc"] = enc_flat.contiguous()
        inv["enc_att"] = enc_att.contiguous()
        if is_scn:
            inv["w_x_emb"], inv["w_x_awe"] = _split_wx(params, cfg)

    h0, c0 = init_hidden_state(params, enc_flat)            # (B, D)

    def init_state(beam_size: int):
        def tile(x):
            return x[:, None].expand(B, beam_size, *x.shape[1:]).contiguous()
        return {"h": tile(h0), "c": tile(c0)}

    def step_fn(state, prev_words):
        h, c = state["h"], state["c"]                       # (B, K, D)
        emb = params["embedding"][prev_words]               # (B, K, Emb)
        emit = {}
        if cfg.uses_attention:
            if attention_impl == "kernel":
                awe, alpha = attend_fused_mxu(
                    params["attention"], inv["enc"], inv["enc_att"], h)
            else:
                awe, alpha = attn.attend(
                    params["attention"], inv["enc"][:, None],
                    inv["enc_att"][:, None], h)
            gate = torch.sigmoid(linear(params["f_beta"], h))
            awe = gate * awe
            emit["alpha"] = alpha                           # (B, K, P)
            if is_scn:
                x_fac = (_gate_factor(emb @ inv["w_x_emb"])
                         + _gate_factor(awe @ inv["w_x_awe"]))
                h, c = scn_cell.scn_step(cell, x_fac, inv["sem_x"],
                                         inv["sem_h"], h, c)
            else:
                x = torch.cat([emb, awe], dim=-1)
                h, c = lstm_cell.lstm_step(cell, x, h, c)
        else:
            h, c = scn_cell.scn_step(cell, scn_cell.input_factor(cell, emb),
                                     inv["sem_x"], inv["sem_h"], h, c)
        logits = linear(params["fc"], h)                    # (B, K, V)
        if cfg.sparse_head:
            # Per-lane top-K of the log-softmax: at most K flat winners come
            # from one lane, so the beam's merge of K*K candidates is exact.
            _, K, V = logits.shape
            flat = torch.log_softmax(logits.reshape(B * K, V), dim=-1)
            topv, topi = row_topk(flat, K, cfg.topk_backend)
            return ((topv.reshape(B, K, K), topi.reshape(B, K, K)),
                    {"h": h, "c": c}, emit)
        return torch.log_softmax(logits, dim=-1), {"h": h, "c": c}, emit

    return init_state, step_fn


def _make_fused_beam_step(params, cfg: ModelConfig, enc, tags):
    """(init_state, step_fn) backed by kernel 2, for all three families:
    attention_scn (attention + SCN), pure_attention (attention + torch
    LSTM) and pure_scn (SCN only: no encoder state reaches the kernel)."""
    from ..ops.step_cuda import (fused_decode_step, fused_decode_step_noattn,
                                 pack_step_weights)

    if cfg.model_type not in MODEL_TYPES:
        raise NotImplementedError(f"fused_step: unknown {cfg.model_type}")
    cell = params["decode_step"]
    is_scn = cfg.model_type in SCN_BASED_MODELS
    enc_flat = flatten_encoding(enc, cfg.encoder_dim)       # (B, P, E)
    B = enc_flat.shape[0]
    dt = enc_flat.dtype
    D = cfg.decoder_dim
    F4 = 4 * cfg.factored_dim

    enc_inputs = (None, None)
    if cfg.uses_attention:
        enc_att = attn.precompute(params["attention"], enc_flat)
        enc_inputs = (enc_flat.contiguous(), enc_att.to(dt).contiguous())
    weights = pack_step_weights(params, cfg, dt)
    if is_scn:
        sx, sh = scn_cell.semantic_projections(cell, tags)  # (B, 4, F)
        sx, sh = sx.reshape(B, F4), sh.reshape(B, F4)
    h0, c0 = init_hidden_state(params, enc_flat)            # (B, D)
    per_row = {}                        # beam size -> (semx, semh) rows

    def init_state(beam_size: int):
        K = beam_size
        if is_scn:
            per_row[K] = tuple(s.repeat_interleave(K, dim=0).to(dt)
                               .contiguous() for s in (sx, sh))
        else:
            per_row[K] = (None, None)
        return {"h": h0[:, None].expand(B, K, D).to(dt).contiguous(),
                "c": c0[:, None].expand(B, K, D).to(dt).contiguous()}

    def step_fn(state, prev_words):
        h = state["h"]                                      # (B, K, D)
        _, K, _ = h.shape
        emb_rows = params["embedding"][prev_words].reshape(B * K, -1)
        semx, semh = per_row[K]
        args = (emb_rows.to(dt).contiguous(), h.reshape(B * K, D),
                state["c"].reshape(B * K, D), semx, semh)
        if cfg.uses_attention:
            topv, topi, lse, h_new, c_new = fused_decode_step(
                weights, *enc_inputs, *args,
                cell="scn" if is_scn else "lstm")
        else:
            topv, topi, lse, h_new, c_new = fused_decode_step_noattn(
                weights, *args, beam_k=K)
        cand_vals = (topv - lse).reshape(B, K, K)           # f32 logprobs
        cand_ids = topi.reshape(B, K, K)
        new_state = {"h": h_new.reshape(B, K, D),
                     "c": c_new.reshape(B, K, D)}
        return (cand_vals, cand_ids), new_state, {}

    return init_state, step_fn
