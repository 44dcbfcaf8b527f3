"""Caption decoders: PureSCN, PureAttention, AttentionSCN.

Counterpart of the JAX package's ``models/decoders.py``: initialisation,
the hoisted loop invariants, the teacher-forced training forward and the
two ways to build a beam step.  Parameters are nested dicts of tensors
whose names mirror the JAX tree (embedding / decode_step / init_h / init_c
/ f_beta / fc / attention).

* :func:`teacher_forcing` -- the training forward over a whole caption
  batch: a fixed-shape scan over T = max_caption_len - 1 steps with a
  validity mask, either the eager scan (plain autograd, all three
  families) or kernels 8 and 9 (``ops/train_cuda.py``, the two
  attention-bearing families), then the vocab head outside the scan.  The
  embedding lookup's backward is the one-hot product or, under
  ``embed_grad_impl="pallas"``, kernel 14 (``ops/embed_grad_cuda.py``),
  for either scan.

* :func:`make_beam_step` -- the step engine: embedding lookup, attention
  (kernel 1 or the plain :func:`models.attention.attend`; kernel 5 or its
  plain version on the int8 state of ``enc_quant="int8"``), f_beta gate,
  the SCN or LSTM cell (kernel 12, ``ops/scn_cuda.py``, under
  ``fused_cell=True``), the vocab head and a per-lane top-K of the
  log-softmax (the sparse head of ``decode/beam.py``).  It can record
  alphas.
* :func:`_make_fused_beam_step` -- one whole step per call of kernel 2
  (``ops/step_cuda.py``; 6b for pure_scn, 6c on the int8 state); no
  alphas.  ``fused_cell`` does not reach it, as in JAX.
"""

from __future__ import annotations

import torch

from typing import Optional

from ..core import meshes
from ..core.config import ModelConfig
from . import attention as attn
from . import lstm_cell, scn_cell
from .layers import dropout, init_linear, linear, uniform

MODEL_TYPES = ("pure_scn", "pure_attention", "attention_scn")
SCN_BASED_MODELS = frozenset({"pure_scn", "attention_scn"})
ATT_BASED_MODELS = frozenset({"pure_attention", "attention_scn"})
ATTENTION_IMPLS = ("auto", "xla", "xla_pk", "pallas", "pallas_mxu")
ENC_QUANTS = ("none", "int8")
TRAIN_SCAN_IMPLS = ("auto", "xla", "fused")
EMBED_GRAD_IMPLS = ("auto", "onehot", "pallas")
_ONEHOT_TILE = 2048


class _EmbedLookup(torch.autograd.Function):
    """Row gather whose backward contracts the one-hot of the ids against
    the cotangent, dtable = one_hot(ids)^T @ g, in float32 (the JAX
    package's custom VJP): a deterministic product instead of a scatter of
    duplicate-heavy caption ids.  Past 2^30 one-hot elements it runs in
    vocabulary tiles of 2048, each tile one product.

    With ``col0`` (a block of a vocabulary sharded over a model axis,
    global rows [col0, col0 + len(table))) the ids are shifted by col0;
    ids outside the block gather zeros and their one-hot row is zero, so
    their gradient goes to no row of this block."""

    @staticmethod
    def forward(ctx, table, ids, col0=None):
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        if col0 is None:
            ctx.save_for_backward(ids)
            return table[ids]
        local = ids - col0
        ctx.save_for_backward(local)
        mine = (local >= 0) & (local < table.shape[0])
        rows = table[local.clamp(0, table.shape[0] - 1)]
        return torch.where(mine[..., None], rows, torch.zeros_like(rows))

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        V = ctx.table_shape[0]
        gf = g.reshape(-1, g.shape[-1])
        ids = ids.reshape(-1)
        step = V if gf.shape[0] * V <= (1 << 30) else _ONEHOT_TILE
        tiles = []
        for v0 in range(0, V, step):
            cols = torch.arange(v0, min(V, v0 + step), device=ids.device)
            oh = (ids[:, None] == cols[None, :]).to(gf.dtype)
            tiles.append(oh.to(torch.float32).T @ gf.to(torch.float32))
        return torch.cat(tiles).to(ctx.table_dtype), None, None


def embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                 col0=None) -> torch.Tensor:
    """table[ids], with the one-hot product as its backward; with col0,
    the lookup in a vocabulary block (zeros for ids outside it)."""
    return _EmbedLookup.apply(table, ids.long(), col0)


class _ScatterLookup(_EmbedLookup):
    """The same row gather, whose backward is kernel 14
    (``ops/embed_grad_cuda.py``, the JAX package's ``_scatter_lookup``):
    one pass over the cotangent rows into the (V, E) float32 table, no
    (N, V) one-hot.  On CPU tensors the kernel's plain version,
    ``index_add_`` over the ids inside the table, runs instead.  With
    col0 the kernel takes the shifted ids and drops those outside the
    block."""

    @staticmethod
    def backward(ctx, g):
        from ..ops.embed_grad_cuda import embed_grad_scatter
        (ids,) = ctx.saved_tensors
        gf = g.reshape(-1, g.shape[-1])
        if gf.dtype not in (torch.float32, torch.bfloat16):
            gf = gf.to(torch.float32)
        d = embed_grad_scatter(ids.reshape(-1).to(torch.int32).contiguous(),
                               gf.contiguous(), ctx.table_shape[0])
        return d.to(ctx.table_dtype), None, None


def embed_lookup_kernel(table: torch.Tensor, ids: torch.Tensor,
                        col0=None) -> torch.Tensor:
    """table[ids], with kernel 14 (``embed_grad_scatter``) as its
    backward; col0 as in :func:`embed_lookup`."""
    return _ScatterLookup.apply(table, ids.long(), col0)


def resolve_embed_grad_impl(cfg: ModelConfig) -> str:
    """cfg.embed_grad_impl -> "onehot" or "pallas", as in JAX: "auto" is
    "onehot" (the JAX package measured no gain from the kernel in its
    step); "pallas" is kernel 14 in the embedding's backward, on a
    vocabulary block too (the JAX package keeps "onehot" for a sharded
    table, whose kernel has no partitioning rules; here each rank calls
    the kernel on its block)."""
    impl = cfg.embed_grad_impl
    if impl not in EMBED_GRAD_IMPLS:
        raise ValueError(f"unknown embed_grad_impl {impl!r}")
    return "pallas" if impl == "pallas" else "onehot"


def resolve_train_scan_impl(cfg: ModelConfig, device: torch.device,
                            dtype=torch.float32,
                            enc_grad: bool = False) -> str:
    """cfg.train_scan_impl -> "fused" (kernels 8 and 9) or "xla" (the eager
    scan).

    "auto" is "fused" for attention_scn and pure_attention on CUDA
    tensors, and "xla" on the CPU.  pure_scn always takes the eager scan
    (its scan reads no encoder state, as in JAX), and so does enc_grad=True
    (the kernels give the frozen encoder no gradient).  An explicit
    "fused" on CPU tensors runs the kernels' plain versions."""
    from ..ops import train_cuda
    impl = cfg.train_scan_impl
    if impl not in TRAIN_SCAN_IMPLS:
        raise ValueError(f"unknown train_scan_impl {impl!r}")
    if enc_grad or not train_cuda.feasible(cfg, dtype):
        return "xla"
    if impl == "auto":
        return "fused" if device.type == "cuda" else "xla"
    return impl


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


def teacher_forcing(params, cfg: ModelConfig, enc, tags, caps, caplens, *,
                    dropout_gen: Optional[torch.Generator] = None,
                    train: bool = False, enc_grad: bool = False,
                    return_hidden: bool = False, mesh=None):
    """Teacher-forced forward over the whole caption batch.

    enc (B, H, W, E) or (B, P, E); tags (B, S) (ignored by pure_attention);
    caps (B, L) int token ids, L = cfg.max_caption_len; caplens (B,)
    caption lengths including <start> and <end>.  Returns a dict:
    predictions (B, T, V) logits, T = L - 1; alphas (B, T, P) or None;
    mask (B, T) validity (t < caplen - 1).  return_hidden=True skips the
    vocab head and returns the post-dropout hidden states (B, T, D) as
    "hidden" instead of predictions, the input of the chunked head.

    Dropout (train=True) draws from dropout_gen, a torch.Generator; its
    numbers differ from JAX's, so the tests compare with dropout off.

    With a mesh whose model axis is past 1 (``core/meshes.py``), fc and
    the embedding are this rank's vocabulary block: the lookup gathers
    the block's rows and sums them over the model group, the scan runs on
    this rank's rows with the replicated weights, and the hidden states
    enter the head through ``enter_vocab_region``; "predictions" are the
    block's (B, T, V/M) logits."""
    cell = params["decode_step"]
    is_scn = cfg.model_type in SCN_BASED_MODELS
    T = cfg.max_caption_len - 1
    enc_flat = flatten_encoding(enc, cfg.encoder_dim)
    lookup = (embed_lookup_kernel if resolve_embed_grad_impl(cfg) == "pallas"
              else embed_lookup)
    table = params["embedding"]
    col0 = (mesh.model_index * table.shape[0]
            if meshes.model_size(mesh) > 1 else None)
    emb = meshes.sum_over_model(lookup(table, caps[:, :T], col0),
                                mesh)                       # (B, T, Emb)
    impl = resolve_train_scan_impl(cfg, enc_flat.device, enc_flat.dtype,
                                   enc_grad)
    if impl == "fused":
        from ..ops.train_cuda import fused_teacher_forcing_scan
        h_all, alphas = fused_teacher_forcing_scan(params, cfg, enc_flat,
                                                   tags, emb)
        return _head_and_mask(params, cfg, h_all, alphas, caplens,
                              dropout_gen, train, return_hidden, mesh)

    h, c = init_hidden_state(params, enc_flat)
    if is_scn:
        sem_x, sem_h = scn_cell.semantic_projections(cell, tags)
    if cfg.uses_attention:
        enc_att = attn.precompute(params["attention"], enc_flat)
        if is_scn:
            w_x_emb, w_x_awe = _split_wx(params, cfg)
            emb_fac = _gate_factor(emb @ w_x_emb)           # (B, T, 4, F)
    else:
        x_fac_all = scn_cell.input_factor(cell, emb)        # (B, T, 4, F)
    hs, alphas = [], []
    for t in range(T):
        if cfg.uses_attention:
            awe, alpha = attn.attend(params["attention"], enc_flat, enc_att,
                                     h)
            awe = torch.sigmoid(linear(params["f_beta"], h)) * awe
            alphas.append(alpha)
            if is_scn:
                x_fac = emb_fac[:, t] + _gate_factor(awe @ w_x_awe)
                h, c = scn_cell.scn_step(cell, x_fac, sem_x, sem_h, h, c)
            else:
                h, c = lstm_cell.lstm_step(
                    cell, torch.cat([emb[:, t], awe], dim=-1), h, c)
        else:
            h, c = scn_cell.scn_step(cell, x_fac_all[:, t], sem_x, sem_h, h,
                                     c)
        hs.append(h)
    h_all = torch.stack(hs, dim=1)                          # (B, T, D)
    alphas = torch.stack(alphas, dim=1) if alphas else None
    return _head_and_mask(params, cfg, h_all, alphas, caplens, dropout_gen,
                          train, return_hidden, mesh)


def _head_and_mask(params, cfg: ModelConfig, h_all, alphas, caplens,
                   dropout_gen, train: bool, return_hidden: bool = False,
                   mesh=None):
    """Dropout, the validity mask and the vocab head, outside the scan (one
    (B*T, D) x (D, V) product; V/M columns on a model axis)."""
    T = h_all.shape[1]
    h_drop = meshes.enter_vocab_region(
        dropout(dropout_gen, h_all, cfg.dropout if train else 0.0), mesh)
    ts = torch.arange(T, device=h_all.device)
    mask = ts[None, :] < (caplens.to(h_all.device)[:, None] - 1)
    if return_hidden:
        return {"hidden": h_drop, "alphas": alphas,
                "mask": mask.to(torch.float32)}
    predictions = linear(params["fc"], h_drop)              # (B, T, V)
    return {"predictions": predictions, "alphas": alphas,
            "mask": mask.to(predictions.dtype)}


def load_pretrained_embeddings(params, embeddings):
    """Replace the embedding table (same shape; cast to its type)."""
    emb = torch.as_tensor(embeddings)
    table = params["embedding"]
    if tuple(emb.shape) != tuple(table.shape):
        raise ValueError(f"embedding shape {tuple(emb.shape)} != "
                         f"{tuple(table.shape)}")
    return {**params, "embedding": emb.to(table.device, table.dtype)}


def trainable_mask(params, fine_tune_embeddings: bool = True):
    """A tree of booleans over params for the optimizer: the embedding
    table is frozen unless fine_tune_embeddings."""
    def ones(t):
        return {k: ones(v) for k, v in t.items()} if isinstance(t, dict) \
            else True

    mask = ones(params)
    if not fine_tune_embeddings:
        mask["embedding"] = False
    return mask


def resolve_attention_impl(cfg: ModelConfig, device: torch.device) -> str:
    """cfg.attention_impl -> "kernel" (kernel 1; kernel 5 on the int8
    state) or "plain" (``attend``; ``attend_quant_ref`` on the int8 state).

    "auto" is the kernel on CUDA and the plain version on the CPU.  The
    JAX package's two kernel names, "pallas" and "pallas_mxu", compute the
    same values and map to the one kernel (which runs its plain version on
    CPU tensors); "xla" and "xla_pk" map to the plain version.  Kernels 1
    and 5 take any beam width (ops/attention_cuda.py attend_plan)."""
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

    fused_step=True runs each step as one call of kernel 2 (6c on the
    int8 state) and emits no alphas.
    """
    if cfg.enc_quant not in ENC_QUANTS:
        raise ValueError(f"unknown enc_quant {cfg.enc_quant!r}")
    if fused_step:
        return _make_fused_beam_step(params, cfg, enc, tags)
    from ..ops.attention_cuda import attend_fused_mxu
    from ..ops.attention_q_cuda import attend_quant, quantize_pixels
    from ..ops.scn_cuda import scn_step_fused
    from ..ops.topk import row_topk

    cell = params["decode_step"]
    is_scn = cfg.model_type in SCN_BASED_MODELS
    enc_flat = flatten_encoding(enc, cfg.encoder_dim)       # (B, P, E)
    B = enc_flat.shape[0]
    attention_impl = resolve_attention_impl(cfg, enc_flat.device)
    quant = cfg.enc_quant == "int8"

    inv = {}
    if is_scn:
        sx, sh = scn_cell.semantic_projections(cell, tags)
        inv["sem_x"], inv["sem_h"] = sx[:, None], sh[:, None]
    if cfg.uses_attention:
        enc_att = attn.precompute(params["attention"], enc_flat)
        if quant:
            # the serving mode: the loop-invariant state stored int8 with
            # per-pixel scales, quantized once per decode
            inv["enc_q"], inv["enc_s"] = quantize_pixels(enc_flat)
            inv["ea_q"], inv["ea_s"] = quantize_pixels(enc_att)
        else:
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
            if quant:
                awe, alpha = attend_quant(
                    params["attention"], inv["enc_q"], inv["enc_s"],
                    inv["ea_q"], inv["ea_s"], h,
                    kernel=attention_impl == "kernel")
            elif attention_impl == "kernel":
                awe, alpha = attend_fused_mxu(
                    params["attention"], inv["enc"], inv["enc_att"], h)
            else:
                awe, alpha = attn.attend(
                    params["attention"], inv["enc"][:, None],
                    inv["enc_att"][:, None], h)
            gate = torch.sigmoid(linear(params["f_beta"], h))
            awe = gate * awe
            emit["alpha"] = alpha                           # (B, K, P)
            if is_scn and cfg.fused_cell:
                h, c = scn_step_fused(cell, torch.cat([emb, awe], dim=-1),
                                      inv["sem_x"], inv["sem_h"], h, c)
            elif is_scn:
                x_fac = (_gate_factor(emb @ inv["w_x_emb"])
                         + _gate_factor(awe @ inv["w_x_awe"]))
                h, c = scn_cell.scn_step(cell, x_fac, inv["sem_x"],
                                         inv["sem_h"], h, c)
            else:
                x = torch.cat([emb, awe], dim=-1)
                h, c = lstm_cell.lstm_step(cell, x, h, c)
        elif cfg.fused_cell:
            h, c = scn_step_fused(cell, emb, inv["sem_x"], inv["sem_h"], h, c)
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
    LSTM) and pure_scn (kernel 6b, SCN only: no encoder state reaches the
    kernel).  Under enc_quant="int8" the attention families run kernel
    6c on the int8 state."""
    from ..ops.attention_q_cuda import quantize_pixels
    from ..ops.step_cuda import (fused_decode_step, fused_decode_step_noattn,
                                 fused_decode_step_q, pack_step_weights)

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
    step_kernel = fused_decode_step
    if cfg.uses_attention:
        enc_att = attn.precompute(params["attention"], enc_flat)
        if cfg.enc_quant == "int8":
            enc_inputs = quantize_pixels(enc_flat) + quantize_pixels(enc_att)
            step_kernel = fused_decode_step_q
        else:
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
            topv, topi, lse, h_new, c_new = step_kernel(
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
