"""High-level decode entry points tying the decoders to the beam engine
(counterpart of the JAX package's ``decode/api.py``).

The decode ladder of the port: "fused_step" (kernel 2, one whole beam step
per call) where it applies, else "steps" (the step engine, whose attention
is kernel 1 on CUDA).  Names whose kernel is not ported yet raise
``NotImplementedError`` rather than fall down the ladder.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.config import BeamConfig, ModelConfig
from ..models import decoders
from .beam import beam_search

DECODE_IMPLS = ("auto", "steps", "fused_step", "fused_span", "fused")
_NOT_PORTED = "not ported yet (ROADMAP.md, kernels still to port)"


def check_ported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a config that names an unported
    kernel."""
    if cfg.decode_impl in ("fused_span", "fused"):
        kernel = {"fused_span": "fused_decode_span",
                  "fused": "beam_decode_records"}[cfg.decode_impl]
        raise NotImplementedError(
            f'decode_impl="{cfg.decode_impl}": the kernel {kernel} is '
            + _NOT_PORTED)
    if cfg.enc_quant == "int8":
        raise NotImplementedError(
            'enc_quant="int8": the kernels attend_fused_q and '
            "fused_decode_step_q are " + _NOT_PORTED)
    if cfg.fused_cell:
        raise NotImplementedError(
            "fused_cell=True: the kernel scn_step_fused is " + _NOT_PORTED)
    if cfg.topk_backend == "pallas":
        raise NotImplementedError(
            'topk_backend="pallas": the kernel row_topk_pallas is '
            + _NOT_PORTED)


def resolve_decode_impl(cfg: ModelConfig, *, record_alphas: bool,
                        device: torch.device) -> str:
    """cfg.decode_impl -> "fused_step" or "steps".

    "auto" is "fused_step" on CUDA when alphas are not recorded, else
    "steps" (always "steps" on the CPU, as in the JAX package).  An
    explicit "fused_step" runs kernel 2 (its plain version on CPU tensors)
    unless alphas are recorded, which only the step engine emits."""
    if cfg.decode_impl not in DECODE_IMPLS:
        raise ValueError(f"unknown decode_impl {cfg.decode_impl!r}")
    check_ported(cfg)
    if cfg.model_type not in decoders.MODEL_TYPES:
        raise ValueError(f"unknown model_type {cfg.model_type!r}")
    impl = cfg.decode_impl
    if impl == "auto":
        impl = "fused_step" if device.type == "cuda" else "steps"
    if record_alphas:
        impl = "steps"
    return impl


def caption_beam_search(params, cfg: ModelConfig, enc, tags, *,
                        start_id: int, end_id: int,
                        beam_cfg: BeamConfig = BeamConfig(),
                        record_alphas: bool = False
                        ) -> Dict[str, torch.Tensor]:
    """Beam-decode a batch of encoded images.

    enc:  (B, H, W, E) or (B, P, E) encoder output
    tags: (B, S) tag probabilities (ignored by pure_attention; pass zeros)
    Returns a dict with sequences (B, L), lengths (B,), scores (B,), the
    completion pools, ``decode_impl`` (the rung that ran), ``steps`` and,
    with record_alphas, the per-step attention ``alpha`` (B, L, P).
    Parameters are cast to the encoding's type when they differ.
    """
    enc_flat = decoders.flatten_encoding(enc, cfg.encoder_dim)
    impl = resolve_decode_impl(cfg, record_alphas=record_alphas,
                               device=enc_flat.device)
    if params["embedding"].dtype != enc_flat.dtype:
        params = decoders.cast_params(params, enc_flat.dtype)
    tags = tags.to(enc_flat.dtype)
    init_state_fn, step_fn = decoders.make_beam_step(
        params, cfg, enc_flat, tags, fused_step=impl == "fused_step")
    emit_specs = {}
    if record_alphas and cfg.uses_attention:
        emit_specs["alpha"] = (enc_flat.shape[1],)
    out = beam_search(
        step_fn,
        init_state_fn(beam_cfg.beam_size),
        batch_size=enc_flat.shape[0],
        beam_size=beam_cfg.beam_size,
        vocab_size=cfg.vocab_size,
        start_id=start_id,
        end_id=end_id,
        max_steps=beam_cfg.max_steps,
        seq_len=beam_cfg.max_steps + 1,
        emit_specs=emit_specs,
        length_penalty=beam_cfg.length_penalty,
        topk_backend=cfg.topk_backend,
        device=enc_flat.device,
    )
    out["decode_impl"] = impl
    return out


def sequences_to_tokens(sequences, lengths, rev_word_map,
                        skip_ids=()) -> list[list[str]]:
    """Host-side detokenisation skipping special ids."""
    out = []
    seqs = sequences.cpu().tolist()
    lens = lengths.cpu().tolist()
    for seq, n in zip(seqs, lens):
        out.append([rev_word_map[int(w)] for w in seq[:int(n)]
                    if int(w) not in skip_ids])
    return out
