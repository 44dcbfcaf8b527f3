"""Kernel 13: the whole beam decode in one call (``csrc/span.cu``
``iic_decode_records``).

Replaces ``ops/decode_pallas.py::beam_decode_records`` of the JAX package
(body ``_make_kernel``): every step (at most 51) of an ``attention_scn``
decode, the selection on the card, and per-step selection records --
words, parents (B, T, K) int32, vals (B, T, K) float32 -- for
``decode/replay.py``.  The step is kernel 7's (``ops/span_cuda.py``) with
the megakernel's own numerics and rules, as its Pallas body has them:

* the head keeps the raw logits: ``lse = log sum exp(lg - max) + max`` and
  ``topv = lg - lse`` (``decode_pallas.py:223-234``), not the max-shifted
  form of kernels 2 and 7;
* an image whose lanes are all dead at the start of a step is frozen
  (``act_r``): its scores, previous words and state stay;
* the early exit is on the card: no host read inside the decode.  The
  steps after the last image died write nothing, so their records keep
  words 0, parents 0 and vals NEG.  (The TPU kernel exits per image chunk
  and never writes a skipped chunk's records.)

The vocab is not padded, so the NEG-padded head bias of the Pallas
wrapper has no column to act on.  The wrapper runs
:func:`beam_decode_records_plain` only for CPU tensors; for CUDA tensors
it launches the chain or raises.
"""

from __future__ import annotations

from typing import Dict

import torch

from .span_cuda import (NEG, check_inputs, decode_inputs, initial_carry,
                        launch_chain, select_plain)
from .step_cuda import step_logits_plain
from .topk import row_topk_iterative


def _records(B: int, T: int, K: int, device) -> Dict[str, torch.Tensor]:
    i32 = dict(dtype=torch.int32, device=device)
    return {"words": torch.zeros((B, T, K), **i32),
            "parents": torch.zeros((B, T, K), **i32),
            "vals": torch.full((B, T, K), NEG, dtype=torch.float32,
                               device=device)}


def decode_records_plain(weights, emb_tab, enc, ea, semx, semh, h, c, sc, pw,
                         alive, *, steps: int, end_id: int):
    """The megakernel's math in plain PyTorch over ``steps`` steps from the
    given state, with the early exit (one host read per step).  Returns
    the records (B, steps, K)."""
    B = alive.shape[0]
    K = h.shape[0] // B
    V = emb_tab.shape[0]
    rec = _records(B, steps, K, h.device)
    for t in range(steps):
        if not bool((alive > 0).any()):
            break
        ids = pw.reshape(-1).long()
        if bool(((ids < 0) | (ids >= V)).any()):
            raise ValueError(f"a previous word outside [0, {V})")
        lg, h_new, c_new = step_logits_plain(
            weights, enc, ea, emb_tab[ids], h, c, semx, semh, cell="scn")
        m = lg.max(dim=1, keepdim=True).values
        lse = torch.log(torch.exp(lg - m).sum(dim=1, keepdim=True)) + m
        top, topi = row_topk_iterative(lg, K)
        words, parents, vals, sc, pw, alive, src = select_plain(
            top - lse, topi.to(torch.int32), None, sc, pw, alive,
            end_id=end_id, freeze=True)
        h, c = h_new[src], c_new[src]
        rec["words"][:, t], rec["parents"][:, t] = words, parents
        rec["vals"][:, t] = vals
    return rec


def beam_decode_records_plain(params, cfg, enc_flat, tags, *, beam_size: int,
                              start_id: int, end_id: int,
                              max_steps: int = 51) -> Dict[str, torch.Tensor]:
    """:func:`beam_decode_records`'s result in plain PyTorch."""
    return _run(params, cfg, enc_flat, tags, beam_size, start_id, end_id,
                max_steps, plain=True)


def beam_decode_records(params, cfg, enc_flat, tags, *, beam_size: int,
                        start_id: int, end_id: int,
                        max_steps: int = 51) -> Dict[str, torch.Tensor]:
    """Run the whole decode; returns selection records for
    ``decode/replay.py``: {"words": (B, T, K) int32, "parents": (B, T, K)
    int32, "vals": (B, T, K) float32}.  Kernel 13 on CUDA tensors, the
    plain version on CPU tensors.  enc_flat (B, P, E); tags (B, S)."""
    return _run(params, cfg, enc_flat, tags, beam_size, start_id, end_id,
                max_steps, plain=enc_flat.device.type == "cpu")


def _run(params, cfg, enc_flat, tags, K, start_id, end_id, T, *, plain):
    if cfg.model_type != "attention_scn":
        raise NotImplementedError("fused decode supports attention_scn")
    B = enc_flat.shape[0]
    dev = enc_flat.device
    ins = decode_inputs(params, cfg, enc_flat, tags, K)
    sc, pw, alive = initial_carry(B, K, start_id, dev)
    args = (ins["weights"], ins["emb_tab"], ins["enc"], ins["ea"],
            ins["semx"], ins["semh"], ins["h"], ins["c"], sc, pw, alive)
    check_inputs(*args, "scn")
    if plain:
        return decode_records_plain(*args, steps=T, end_id=end_id)
    if dev.type != "cuda":
        raise RuntimeError(f"beam_decode_records: no kernel for {dev}")
    state = {"h": ins["h"], "c": ins["c"], "sc": sc, "pw": pw,
             "alive": alive}
    rec = _records(B, T, K, dev)
    live = torch.zeros(T + 1, dtype=torch.int32, device=dev)
    live[0] = 1
    launch_chain("iic_decode_records", ins["weights"], ins["emb_tab"],
                 ins["enc"], ins["ea"], ins["semx"], ins["semh"], state,
                 state, rec, steps=T, end_id=end_id, cell="scn",
                 stream=torch.cuda.current_stream(dev).cuda_stream,
                 live=live)
    beam_decode_records.launches += 1
    return rec


beam_decode_records.launches = 0
