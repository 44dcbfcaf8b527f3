"""High-level decode entry points tying the decoders to the beam engine
(counterpart of the JAX package's ``decode/api.py``).

The decode ladder of the port, best first, as the JAX ladder
(``decode/api.py:19-160`` there) without its TPU tile and VMEM tests:

* "fused_span" -- kernel 7 (``ops/span_cuda.py``): S = cfg.decode_span
  beam steps per call, the selection on the card, records replayed by
  ``decode/replay.py``; attention_scn and pure_attention without alphas;
* "fused_step" -- kernel 2, one whole beam step per call (6b for
  pure_scn, 6c on the int8 state); no alphas;
* "steps" -- the step engine, whose attention is kernel 1 on CUDA (kernel
  5 on the int8 state) and whose SCN cell is kernel 12 under
  ``fused_cell=True``; the only rung that records alphas.

"auto" walks it on CUDA and is "steps" on the CPU.  An explicit rung that
does not apply falls down the ladder.  "fused" names kernel 13
(``ops/decode_cuda.py``, the whole decode in one call) for attention_scn
without alphas, else the step engine, as in JAX.  On CPU tensors the
fused rungs run their kernels' plain versions.  One difference from JAX,
by design: JAX takes "fused_span" only where a TPU image tile with
G*K % 8 == 0 divides the batch (so bucket 1 falls to "fused_step"); the
port has no such tile and takes it at every batch size.

``enc_quant="int8"`` (the int8 encoder state) makes "fused_span"
ineligible, as in JAX, so "auto" on CUDA is "fused_step" (kernel 6c) and,
with alphas, "steps" (kernel 5).  "fused" under int8 runs the unquantized
megakernel, as in JAX, whose eligibility test ignores ``enc_quant``.
``fused_cell=True`` changes only the step engine, as in JAX: the fused
rungs ignore it.

Beam width.  JAX's kernels take any K, and so do the port's: the
attention kernels (1 and 5) as lane groups of eight, the head top-K of
kernels 2, 6b and 6c and the beam selection of kernels 7 and 13 by
rounds that look past the last winner, kernel 10 in passes of 32 slots.
So no beam width moves a rung.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.config import BeamConfig, ModelConfig
from ..models import decoders
from .beam import beam_search

DECODE_IMPLS = ("auto", "steps", "fused_step", "fused_span", "fused")
SPAN_MODELS = ("attention_scn", "pure_attention")


def resolve_decode_impl(cfg: ModelConfig, *, record_alphas: bool,
                        device: torch.device) -> str:
    """cfg.decode_impl -> the rung that runs: "fused_span", "fused_step",
    "fused" or "steps" (the module docstring gives the ladder)."""
    if cfg.decode_impl not in DECODE_IMPLS:
        raise ValueError(f"unknown decode_impl {cfg.decode_impl!r}")
    if cfg.enc_quant not in decoders.ENC_QUANTS:
        raise ValueError(f"unknown enc_quant {cfg.enc_quant!r}")
    if cfg.model_type not in decoders.MODEL_TYPES:
        raise ValueError(f"unknown model_type {cfg.model_type!r}")
    on_card = device.type == "cuda"
    span_ok = (cfg.model_type in SPAN_MODELS and not record_alphas
               and cfg.enc_quant != "int8")
    impl = cfg.decode_impl
    if impl == "auto":
        impl = "fused_span" if on_card else "steps"
    if impl == "fused_span" and not span_ok:
        impl = "fused_step" if on_card else "steps"
    if impl == "fused" and (cfg.model_type != "attention_scn"
                            or record_alphas):
        impl = "steps"
    if impl == "fused_step" and record_alphas:
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
    completion pools, ``decode_impl`` (the rung that ran), ``steps``,
    ``decode_calls`` (calls of the rung's kernel, or of the step engine's
    step) and, with record_alphas, the per-step attention ``alpha``
    (B, L, P).  Parameters are cast to the encoding's type when they
    differ.
    """
    enc_flat = decoders.flatten_encoding(enc, cfg.encoder_dim)
    impl = resolve_decode_impl(cfg, record_alphas=record_alphas,
                               device=enc_flat.device)
    if params["embedding"].dtype != enc_flat.dtype:
        params = decoders.cast_params(params, enc_flat.dtype)
    tags = tags.to(enc_flat.dtype)
    K, T = beam_cfg.beam_size, beam_cfg.max_steps
    if impl in ("fused_span", "fused"):
        from .replay import replay_beam_records
        kw = dict(beam_size=K, start_id=start_id, end_id=end_id,
                  max_steps=T)
        if impl == "fused_span":
            from ..ops.span_cuda import beam_decode_span_records
            records = beam_decode_span_records(params, cfg, enc_flat, tags,
                                               span=cfg.decode_span, **kw)
            calls = records["calls"]
        else:
            from ..ops.decode_cuda import beam_decode_records
            records = beam_decode_records(params, cfg, enc_flat, tags, **kw)
            calls = 1
        out = replay_beam_records(records, start_id=start_id, end_id=end_id,
                                  seq_len=T + 1,
                                  length_penalty=beam_cfg.length_penalty)
        out.update(decode_impl=impl, decode_calls=calls)
        return out
    init_state_fn, step_fn = decoders.make_beam_step(
        params, cfg, enc_flat, tags, fused_step=impl == "fused_step")
    emit_specs = {}
    if record_alphas and cfg.uses_attention:
        emit_specs["alpha"] = (enc_flat.shape[1],)
    out = beam_search(
        step_fn,
        init_state_fn(K),
        batch_size=enc_flat.shape[0],
        beam_size=K,
        vocab_size=cfg.vocab_size,
        start_id=start_id,
        end_id=end_id,
        max_steps=T,
        seq_len=T + 1,
        emit_specs=emit_specs,
        length_penalty=beam_cfg.length_penalty,
        topk_backend=cfg.topk_backend,
        device=enc_flat.device,
    )
    out.update(decode_impl=impl, decode_calls=out["steps"])
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
